"""Parity of graal_tpu_torch.pipeline (repeat detection and copy extension)
and of the port's repeat problems with the JAX package.

- ``detect_repeats_coverage`` / ``detect_repeats`` / ``extend_with_repeats``
  are host numpy on both sides and must give identical results: on the
  recipes of tests/test_pipeline.py and on the flagship bin matrix with
  one amplified bin.
- ``entry.repeat_problem`` follows the JAX package's repeat recipe
  (tests/test_pallas.py ``_repeat_problem`` at the flagship width): state,
  copy-expanded table, observed map and neighbour table equal the same
  recipe built from the JAX package's functions.
- ``entry.scale_repeat_problem`` is benchmarks/bench_scale_repeats.py's
  recipe, and ``add_scale_repeats`` equals the JAX function.
"""

import numpy as np
import pytest

from graal_tpu import pipeline as jpipe
from graal_tpu.core import mcmc as jm
from graal_tpu.core.state import GenomeState as JState
from graal_tpu.core.subfrags import build_sub_frag_table
from graal_tpu.utils import synthetic as jsyn
from graal_tpu.utils import synthetic_sparse as jss
from graal_tpu_torch import entry as tentry
from graal_tpu_torch import pipeline as tpipe
from graal_tpu_torch.utils.synthetic import bin_level_matrix
from tests.test_torch_sparse import assert_sparse_equal
from tests.test_torch_state import assert_states_equal

TABLE_FIELDS = ("owner", "data_id", "len_kb", "accu", "prefix_kb", "suffix_kb")


def assert_tables_equal(got, want):
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).cpu().numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert (got.n_data_sub, got.n_frags_per_bins, got.has_repeats) == \
        (want.n_data_sub, want.n_frags_per_bins, want.has_repeats)


def _outlier_matrix():
    """tests/test_pipeline.py::test_detect_repeats_flags_outlier's matrix."""
    rng = np.random.default_rng(0)
    m = rng.poisson(3.0, (40, 40)).astype(np.float64)
    m[7, :] *= 14
    m[:, 7] *= 14
    np.fill_diagonal(m, 0)
    return m


def _flagship_matrix():
    """The flagship problem's bin matrix with bin 100's contacts amplified
    14-fold."""
    _, table, _, obs, _ = tentry.problem(device="cpu")
    m = bin_level_matrix(obs, table).astype(np.float64)
    m[100, :] *= 14
    m[:, 100] *= 14
    return m


@pytest.mark.parametrize("build", [_outlier_matrix, _flagship_matrix],
                         ids=["outlier40", "flagship"])
def test_detect_repeats_identical(build):
    m = build()
    for allow in (True, False):
        assert tpipe.detect_repeats(m, allow) == jpipe.detect_repeats(m, allow)
    cov = m.sum(0) * 0.37
    assert tpipe.detect_repeats_coverage(cov, True) == jpipe.detect_repeats_coverage(cov, True)
    dups = tpipe.detect_repeats(m, True)
    assert dups and all(n >= 1 for _, n in dups)


def test_extend_with_repeats_identical():
    n = 6
    soa = dict(pos=np.arange(n) % 3, id_c=np.arange(n) // 3,
               start_bp=(np.arange(n) % 3) * 100, len_bp=np.full(n, 100),
               circ=np.zeros(n), l_cont=np.full(n, 3),
               l_cont_bp=np.full(n, 300), n_accu=np.ones(n),
               ori=np.ones(n), rep=np.zeros(n), activ=np.ones(n),
               id_d=np.arange(n))
    for dups in ([(2, 2)], [(0, 1), (4, 3)], []):
        got = tpipe.extend_with_repeats(soa, dups)
        want = jpipe.extend_with_repeats(soa, dups)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype
    out = tpipe.extend_with_repeats(soa, [(2, 2)])
    assert out["rep"][2] == 1 and list(out["id_d"][-2:]) == [2, 2]


def _jax_repeat_problem(n_bins, n_contigs, n_dups, seed):
    """The JAX-side recipe of entry.repeat_problem."""
    state, table = jsyn.make_genome(n_bins, n_contigs, subs_per_bin=3, seed=seed)
    soa = {f: np.asarray(getattr(state, f)) for f in state._fields}
    soa["n_accu"] = np.ones(n_bins, np.int64)
    dup_bins = np.linspace(5, n_bins - 6, n_dups).astype(int)
    soa = jpipe.extend_with_repeats(soa, [(int(b), 1) for b in dup_bins])
    sub_ids = np.zeros((n_bins, 4), np.int64)
    sub_len = np.zeros((n_bins, 3))
    sub_acc = np.zeros((n_bins, 3))
    lens = np.asarray(table.len_kb)
    for b in range(n_bins):
        sub_ids[b, 3] = 3
        for s in range(3):
            sub_ids[b, s] = 3 * b + s
            sub_len[b, s] = lens[3 * b + s]
            sub_acc[b, s] = 1.0
    rtable = build_sub_frag_table(sub_ids, sub_len, sub_acc, soa["id_d"])
    return JState.from_soa(soa), rtable, table


def test_repeat_problem_matches_jax_recipe():
    n_bins, n_contigs, n_dups = 40, 4, 4
    state, table, params, obs, nb = tentry.repeat_problem(n_bins, n_contigs, n_dups, seed=2,
                                                          device="cpu")
    j_state, j_table, j_base = _jax_repeat_problem(n_bins, n_contigs, n_dups, seed=2)
    assert_states_equal(state, j_state)
    assert_tables_equal(table, j_table)
    assert table.n_subs == 3 * (n_bins + n_dups) and table.n_data_sub == 3 * n_bins
    j_params = jsyn.default_params()
    assert params.astuple_np() == j_params.astuple_np()
    j_obs = jsyn.simulate_contacts(j_state, j_table, j_params, seed=2)
    np.testing.assert_array_equal(obs, j_obs)
    j_nb = jm.build_neighbour_table(jsyn.bin_level_matrix(obs, j_base),
                                    np.asarray(j_state.id_d), j_state.n_frags)
    for f in ("xk", "pk", "dispatcher", "blacklist"):
        np.testing.assert_array_equal(getattr(nb, f).numpy(), np.asarray(getattr(j_nb, f)))
    assert (nb.n_bins, nb.max_copies) == (n_bins, 2)


def test_scale_repeat_problem_matches_jax_recipe():
    n, n_dups = 400, 6
    truth, shuf, table, params, sobs, id_d = tentry.scale_repeat_problem(n, n_dups, device="cpu")
    j_base, j_btable = jss.make_scale_genome(n, 4, seed=31)
    j_params = jss.scale_params()
    dup_bins = tuple(int(b) for b in np.linspace(11, n - 17, n_dups).astype(int))
    j_state, j_table, j_id_d = jss.add_scale_repeats(j_base, j_btable, dup_bins)
    assert_states_equal(truth, j_state)
    assert_tables_equal(table, j_table)
    np.testing.assert_array_equal(id_d, j_id_d)
    assert_states_equal(shuf, jss.shuffle_genome(j_state, 8, seed=32))
    assert_sparse_equal(sobs, jss.simulate_sparse_contacts(j_base, j_btable, j_params, seed=31))
    assert int(truth.rep.sum()) == 2 * n_dups
