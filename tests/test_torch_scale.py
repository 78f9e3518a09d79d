"""The port's chr1-scale runner (graal_tpu_torch.scale) on the CPU.

- ``entry.scale_problem`` builds the JAX package's chr1-scale recipe
  (make_scale_genome / simulate_sparse_contacts / shuffle_genome with the
  bench_scale.py seeds and counts) bit for bit.
- ScaleRunner's set-up (neighbour table, band width, covered d_max) and the
  tier helpers equal the JAX runner's.
- ``run`` at the tests/test_scale.py nuisance-sampling size (200 bins, 2
  contigs, shuffled into 10 pieces; f_max_min 32-64), with the steps per
  cycle capped to keep the CPU time down: invariants hold, the likelihood
  is finite and rises, the anchored likelihood equals a fresh sparse
  evaluation (rtol 1e-6, atol 1, as tests/test_scale.py), a second run with
  the same seed is identical, and extremity-first ordering repairs the
  genome on a subsampled cycle. The JAX runner draws from threefry keys, so
  whole runs are compared with themselves, not with JAX.
"""

import numpy as np
import pytest
import torch

from graal_tpu import scale as jscale
from graal_tpu.utils import synthetic_sparse as jss
from graal_tpu_torch import entry as tentry
from graal_tpu_torch import scale as tscale
from graal_tpu_torch.core.state import check_invariants
from tests.test_torch_sparse import assert_sparse_equal
from tests.test_torch_state import assert_states_equal


@pytest.fixture(scope="module")
def problem():
    return tentry.scale_problem(200, n_contigs=2, n_pieces=10, seed=41, shuffle_seed=42,
                               device="cpu")


def test_scale_problem_matches_jax_recipe():
    truth, shuf, table, params, sobs = tentry.scale_problem(400, device="cpu")
    j_truth, j_table = jss.make_scale_genome(400, 4, seed=31)
    j_params = jss.scale_params()
    assert_states_equal(truth, j_truth)
    assert_states_equal(shuf, jss.shuffle_genome(j_truth, 8, seed=32))
    np.testing.assert_array_equal(table.len_kb.numpy(), np.asarray(j_table.len_kb))
    assert params.astuple_np() == j_params.astuple_np()
    assert_sparse_equal(sobs, jss.simulate_sparse_contacts(j_truth, j_table, j_params, seed=31))


def test_runner_setup_matches_jax(problem):
    truth, shuf, table, params, sobs = problem
    j_truth, j_table = jss.make_scale_genome(200, 2, seed=41)
    j_sobs = jss.simulate_sparse_contacts(j_truth, j_table, jss.scale_params(), seed=41)
    j_shuf = jss.shuffle_genome(j_truth, 10, seed=42)
    jr = jscale.ScaleRunner(j_table, j_sobs, jss.scale_params())
    tr = tscale.ScaleRunner(table, sobs, params)
    assert (tr.w, tr.max_covered_d_max) == (jr.w, jr.max_covered_d_max)
    for f in ("xk", "pk", "dispatcher", "blacklist"):
        np.testing.assert_array_equal(getattr(tr.nb, f).numpy(), np.asarray(getattr(jr.nb, f)))
    assert tscale.max_contig_subs(shuf, table) == jscale.max_contig_subs(j_shuf, j_table)
    np.testing.assert_array_equal(tscale.contig_frags_per_frag(shuf),
                                  jscale.contig_frags_per_frag(j_shuf))
    for x in (1, 2, 3, 100, 1024, 1025):
        assert tscale._next_pow2(x) == jscale._next_pow2(x)


def test_run_assembles_and_is_reproducible(problem):
    truth, shuf, table, params, sobs = problem
    runs = []
    for _ in range(2):
        runner = tscale.ScaleRunner(table, sobs, params)
        l0 = float(runner.anchor_fn()(shuf, params))
        final, out_params, m = runner.run(shuf, n_cycles=2, steps_per_cycle=60,
                                          f_max_min=32, sample_param=True, seed=9,
                                          progress=False, init_truth=truth)
        runs.append((final, out_params, m))
        assert runner.obs_grid.n_launches == runner.mini_grid.n_launches == 0
    final, out_params, m = runs[0]
    check_invariants(final)
    assert np.all(np.isfinite(m["likelihood"]))
    assert m["likelihood"][-1] > l0, (l0, m["likelihood"])
    assert len(m["dist_init_genome"]) == 2 and m["n_contigs"][-1] < 10
    assert all(t >= 32 for tiers in m["tiers"] for t in tiers)
    assert float(out_params.fact) > 0 and float(out_params.v_inter) > 0
    # the anchored likelihood equals a fresh sparse evaluation
    fresh = float(tscale.ScaleRunner(table, sobs, params).anchor_fn()(final, out_params))
    np.testing.assert_allclose(m["likelihood"][-1], fresh, rtol=1e-6, atol=1.0)
    # the same seed gives the same run
    assert all(torch.equal(a, b) for a, b in zip(final, runs[1][0]))
    assert m["likelihood"] == runs[1][2]["likelihood"]
    assert out_params.astuple_np() == runs[1][1].astuple_np()


def test_extremity_order_on_subsampled_cycle(problem):
    truth, shuf, table, params, sobs = problem
    runner = tscale.ScaleRunner(table, sobs, params)
    l0 = float(runner.anchor_fn()(shuf, params))
    nc0 = int(shuf.n_contigs())
    final, _, m = runner.run(shuf, n_cycles=1, steps_per_cycle=30, f_max_min=64,
                             seed=3, progress=False, order_mode="extremity")
    check_invariants(final)
    assert m["n_contigs"][-1] < nc0, (nc0, m["n_contigs"])
    assert m["likelihood"][-1] > l0
    with pytest.raises(ValueError):
        runner.run(shuf, n_cycles=1, order_mode="sorted")
