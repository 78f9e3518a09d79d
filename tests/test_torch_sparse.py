"""Parity of graal_tpu_torch.core.sparse and utils.synthetic_sparse with the
JAX package.

The CSR fields, the band width and the synthetic-sparse generator are
numpy on both sides and must be equal. The sparse likelihood sums in f64
over (K, chunk) band slabs where the JAX package sums in f32 one offset at
a time, so it is held to JAX at rtol 1e-5, and to the port's own dense
likelihood at the JAX test's tolerance (rtol 2e-4, atol 0.5,
tests/test_sparse.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from graal_tpu.core import mcmc as jm
from graal_tpu.core import sparse as js
from graal_tpu.utils import synthetic_sparse as jss
from graal_tpu.utils.synthetic import default_params, make_genome, simulate_contacts
from graal_tpu_torch import convert
from graal_tpu_torch.core import likelihood as tl
from graal_tpu_torch.core import sparse as ts
from graal_tpu_torch.utils import synthetic_sparse as tss
from tests.test_torch_state import assert_states_equal, to_port

RTOL_JAX = 1e-5
SOBS_FIELDS = ("rows", "cols", "vals", "row_start")


def assert_sparse_equal(got, want):
    for f in SOBS_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert (got.row_cap, got.n) == (want.row_cap, want.n)
    assert got.logfact_const == want.logfact_const


def test_sparse_from_coo_fields_equal():
    rng = np.random.default_rng(0)
    n = 60
    rows = rng.integers(0, n, 900)
    cols = rng.integers(0, n, 900)
    vals = rng.poisson(6.0, 900).astype(np.float64) + rng.integers(0, 2, 900) * 20
    want = js.sparse_from_coo(rows, cols, vals, n)
    assert_sparse_equal(ts.sparse_from_coo(rows, cols, vals, n), want)
    # the converter drops the TPU-only packed storage and keeps the rest
    assert_sparse_equal(convert.sparse_from_numpy(want._asdict()), want)
    np.testing.assert_array_equal(ts.logfact_entries(vals), js.logfact_entries(vals))


def test_subsample_and_dense_constructors_equal():
    state, table = make_genome(n_bins=20, n_contigs=2, subs_per_bin=3, seed=3)
    obs = simulate_contacts(state, table, default_params(fact=4000.0), seed=3)
    want = js.sparse_from_dense(obs)
    got = ts.sparse_from_dense(obs)
    assert_sparse_equal(got, want)
    assert_sparse_equal(ts.subsample_sparse(got, 0.5, seed=4),
                        js.subsample_sparse(want, 0.5, seed=4))


@pytest.mark.parametrize("d_max,margin", [(900.0, 2.0), (300.0, 1.0), (5.0, 2.0)])
def test_band_width_equal(d_max, margin):
    lens = np.random.default_rng(1).uniform(0.5, 8.0, 500)
    assert ts.band_width(torch.as_tensor(lens), d_max, margin=margin) == \
        js.band_width(lens, d_max, margin=margin)


def test_synthetic_sparse_matches():
    js_state, jt = jss.make_scale_genome(300, 3, seed=5)
    ts_state, tt = tss.make_scale_genome(300, 3, seed=5)
    assert_states_equal(ts_state, js_state)
    for f in ("owner", "data_id", "len_kb", "accu", "prefix_kb", "suffix_kb"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)))
    assert (tt.n_data_sub, tt.n_frags_per_bins, tt.has_repeats) == \
        (jt.n_data_sub, jt.n_frags_per_bins, jt.has_repeats)
    jp, tp = jss.scale_params(), tss.scale_params()
    assert tp.astuple_np() == jp.astuple_np()
    assert_sparse_equal(tss.simulate_sparse_contacts(ts_state, tt, tp, seed=5),
                        jss.simulate_sparse_contacts(js_state, jt, jp, seed=5))
    assert_states_equal(tss.shuffle_genome(ts_state, 12, seed=6),
                        jss.shuffle_genome(js_state, 12, seed=6))
    assert tss.thin_coverage(tp, 0.3).astuple_np() == jss.thin_coverage(jp, 0.3).astuple_np()


def _dense48():
    state, table = make_genome(n_bins=48, n_contigs=4, subs_per_bin=3, seed=6)
    params = default_params(fact=4000.0)
    obs = simulate_contacts(state, table, params, seed=6)
    states = [state, jm.explode_genome(state),
              jm.apply_mutation(state, 5, 30, 4)]
    return table, params, js.sparse_from_dense(obs), states, obs


def _scale400():
    state, table = jss.make_scale_genome(400, 4, seed=7)
    params = jss.scale_params()
    sobs = jss.simulate_sparse_contacts(state, table, params, seed=7)
    return table, params, sobs, [state, jss.shuffle_genome(state, 16, seed=8)], None


@pytest.mark.parametrize("build", [_dense48, _scale400], ids=["48x3", "scale400"])
def test_sparse_loglik_matches_jax(build):
    jt, jp, jsobs, states, obs = build()
    tt = convert.table_from_numpy(jt._asdict())
    tp = convert.params_from_numpy(jp._asdict())
    tsobs = convert.sparse_from_numpy(jsobs._asdict())
    w = js.band_width(np.asarray(jt.len_kb), float(jp.d_max))
    fn_j = js.make_sparse_loglik(jt, jsobs, w)
    # a small slab budget so that the band is walked in several slabs
    fn_t = ts.make_sparse_loglik(tt, tsobs, w, max_cells=tt.n_subs * 7)
    for i, st in enumerate(states):
        got = float(fn_t(to_port(st), tp))
        np.testing.assert_allclose(got, float(fn_j(st, jp)), rtol=RTOL_JAX,
                                   err_msg=f"state {i}")
        if obs is not None:
            dense = float(tl.log_likelihood(to_port(st), tt, torch.as_tensor(obs), tp))
            np.testing.assert_allclose(got, dense, rtol=2e-4, atol=0.5)


def test_genome_sort_order_and_obs_fn_match():
    jt, jp, jsobs, states, obs = _dense48()
    tt = convert.table_from_numpy(jt._asdict())
    tsobs = convert.sparse_from_numpy(jsobs._asdict())
    for st in states:
        order_j, mid_j = js.genome_sort_order(st, jt)
        order_t, mid_t = ts.genome_sort_order(to_port(st), tt)
        np.testing.assert_array_equal(mid_t.numpy(), np.asarray(mid_j))
        np.testing.assert_array_equal(order_t.numpy(), np.asarray(order_j))
    rows = np.array([3, 17, 40, 41, 90, 143, 143 + 5], np.int32)   # last one padding
    want = np.asarray(js.make_sparse_obs_fn(jsobs, len(rows))(jnp.asarray(rows)))
    got = ts.make_sparse_obs_fn(tsobs, len(rows))(torch.as_tensor(rows)).numpy()
    np.testing.assert_array_equal(got, want)
    valid = rows < obs.shape[0]
    np.testing.assert_array_equal(got[np.ix_(valid, valid)], obs[np.ix_(rows[valid], rows[valid])])


def test_repeat_tables_raise():
    """The copy-summing sparse likelihood scores a repeat table (equal to
    the dense likelihood at the JAX test's tolerance), and the chr1-scale
    runner refuses one without id_d."""
    from graal_tpu_torch.scale import ScaleRunner

    base, base_table = tss.make_scale_genome(60, 2, seed=5)
    params = tss.scale_params()
    sobs = tss.simulate_sparse_contacts(base, base_table, params, seed=5)
    state, table, id_d = tss.add_scale_repeats(base, base_table, (7, 30))
    w = ts.band_width(table.len_kb, float(params.d_max))
    obs = np.zeros((60, 60), np.float32)
    obs[sobs.rows.numpy(), sobs.cols.numpy()] = sobs.vals.numpy()
    for st in (state, tss.shuffle_genome(state, 6, seed=1)):
        got = float(ts.make_sparse_loglik(table, sobs, w)(st, params))
        dense = float(tl.log_likelihood(st, table, torch.as_tensor(obs), params))
        np.testing.assert_allclose(got, dense, rtol=2e-4, atol=0.5)
    with pytest.raises(ValueError):
        ScaleRunner(table, sobs, params)
    ScaleRunner(table, sobs, params, id_d=id_d)
