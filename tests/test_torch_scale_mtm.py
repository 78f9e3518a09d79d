"""The port's chr1-scale refinement, ``ScaleRunner.run_mtm``, on the CPU:
MTM, MH, and MTM on a repeat table (the repeat engine v2 with the MH
catalogue), as tests/test_mtm.py's scale tests assert on the JAX package.
"""

import pytest

from graal_tpu_torch.core.state import check_invariants


@pytest.mark.parametrize("variant,with_repeats", [("mtm", False), ("mh", False),
                                                  ("mtm", True)])
def test_scale_run_mtm_refines(variant, with_repeats):
    """ScaleRunner.run_mtm at 120 bins (tests/test_mtm.py's scale MTM / MH
    and repeat tests, on the port, 2 cycles of 40 steps): from a shuffled
    genome the re-anchored likelihood rises, the invariants hold, and the
    returned likelihood is a fresh evaluation of the final genome."""
    from graal_tpu_torch.scale import ScaleRunner
    from graal_tpu_torch.utils import synthetic_sparse as tss

    params = tss.scale_params()
    base, base_table = tss.make_scale_genome(120, 3, seed=13)
    sobs = tss.simulate_sparse_contacts(base, base_table, params, seed=13)
    if with_repeats:
        state, table, id_d = tss.add_scale_repeats(base, base_table, (9, 55, 100))
        runner = ScaleRunner(table, sobs, params, id_d=id_d)
    else:
        state, runner = base, ScaleRunner(base_table, sobs, params)
    pert = tss.shuffle_genome(state, 6, seed=14)
    ll0 = float(runner.anchor_fn()(pert, params))
    final, l_t, m = runner.run_mtm(pert, n_cycles=2, steps_per_cycle=40, f_max_min=32,
                                   seed=5, variant=variant, progress=False)
    check_invariants(final)
    assert l_t > ll0
    assert 0.0 <= m["accept_rate"][-1] <= 1.0 and len(m["f_max"]) == 2
    assert abs(l_t - float(runner.anchor_fn()(final, params))) < 1e-3
