"""Parity of the repeat delta engine v2 (graal_tpu_torch.core.delta_repeats),
the copy-summing sparse likelihood and the repeat routing of the step and
the chr1-scale runner with the JAX package, on the CPU.

- ``build_copy_table`` and ``split_observed_for_repeats`` are host numpy and
  must equal the JAX functions.
- v2's dll is held to the JAX v2 (its jnp CPU path) at rtol 1e-4,
  atol 1e-2 (the delta tests' bound: the port sums corrections in f64,
  JAX in f32), and to the port's own full copy-summed likelihood difference
  at the JAX test's rtol 1e-3, atol 0.35 (tests/test_delta_repeats.py).
  Cases of tests/test_delta_repeats.py: random pairs, a repeat copy (with a
  non-trivial swap_activity), an inactive copy in the base genome, a
  circular contig. Candidates, rows and overflow flags must be bit-equal.
- Delta EM steps on a repeat table, on shared draws: the same decisions,
  bit-identical states, carried likelihood at rtol 1e-5.
- The copy-summing sparse likelihood equals the JAX one (rtol 1e-5) and the
  dense ``log_likelihood`` (rtol 2e-4, atol 0.5, tests/test_sparse.py).
- The engine refuses a genome that breaks its exactness contract.
- ``ScaleRunner`` with ``id_d`` at 200 bins (tests/test_scale.py's repeat
  size): the neighbour tables equal the JAX runner's, the likelihood rises
  and the invariants hold.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graal_tpu import scale as jscale
from graal_tpu.core import delta as jd
from graal_tpu.core import delta_repeats as jdr
from graal_tpu.core import mcmc as jm
from graal_tpu.core import sparse as js
from graal_tpu.utils import synthetic_sparse as jss
from graal_tpu_torch import convert
from graal_tpu_torch import scale as tscale
from graal_tpu_torch.core import delta as td
from graal_tpu_torch.core import delta_repeats as tdr
from graal_tpu_torch.core import likelihood as tl
from graal_tpu_torch.core import mcmc as tm
from graal_tpu_torch.core import sparse as ts
from graal_tpu_torch.core.candidates import build_candidates
from graal_tpu_torch.core.state import check_invariants
from graal_tpu_torch.utils import synthetic_sparse as tss
from tests.test_delta_repeats import _repeat_problem
from tests.test_torch_delta import step_draws
from tests.test_torch_sparse import assert_sparse_equal
from tests.test_torch_state import assert_states_equal, to_port

DLL_RTOL, DLL_ATOL = 1e-4, 1e-2
FULL_RTOL, FULL_ATOL = 1e-3, 0.35
LL_RTOL = 1e-5
F_MAX = 24
DELTA = 4


def _port(state, table, params, obs):
    sobs = js.sparse_from_dense(obs)
    return dict(state=state, table=table, params=params, obs=obs, sobs=sobs,
                ts=to_port(state), tt=convert.table_from_numpy(table._asdict()),
                tp=convert.params_from_numpy(params._asdict()),
                tsobs=convert.sparse_from_numpy(sobs._asdict()))


@pytest.fixture(scope="module")
def problem():
    return _port(*_repeat_problem())


@pytest.fixture(scope="module")
def inactive_problem():
    return _port(*_repeat_problem(seed=12, deactivate=(30,)))


def test_copy_table_and_split_match(problem):
    p = problem
    want = jdr.build_copy_table(p["table"])
    got = tdr.build_copy_table(p["tt"])
    np.testing.assert_array_equal(got.copy_start.numpy(), np.asarray(want.copy_start))
    np.testing.assert_array_equal(got.copy_rows.numpy(), np.asarray(want.copy_rows))
    assert got.c_max == want.c_max == 2
    w_dup, w_single, w_mixed, w_dd = jdr.split_observed_for_repeats(p["table"], p["sobs"])
    g_dup, g_single, g_mixed, g_dd = tdr.split_observed_for_repeats(p["tt"], p["tsobs"])
    np.testing.assert_array_equal(g_dup, w_dup)
    assert_sparse_equal(g_single, w_single)
    assert_sparse_equal(g_mixed, w_mixed)
    assert g_mixed.vals.numel() > 0 and g_dd[0].numel() > 0
    for g, w in zip(g_dd, w_dd):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _circular(p):
    state = p["state"]
    in0 = np.asarray(state.id_c) == 0
    circ = np.asarray(state.circ).copy()
    circ[in0] = 1
    return _port(state._replace(circ=jnp.asarray(circ, jnp.int32)), p["table"], p["params"],
                 p["obs"]), [(int(np.nonzero(in0)[0][1]), int(np.nonzero(~in0)[0][0]))]


def _case(case, problem, inactive_problem):
    p = problem
    rep = np.nonzero(np.asarray(p["state"].rep) == 1)[0]
    if case == "random":
        rng = np.random.default_rng(0)
        n = p["state"].n_frags
        return p, [(int(rng.integers(n)), int(rng.integers(n))) for _ in range(3)]
    if case == "repeat_copy":
        return p, [(int(rep[-1]), 5), (int(rep[0]), int(rep[-1])), (3, 8)]
    if case == "inactive_copy":
        q = inactive_problem
        rep = np.nonzero(np.asarray(q["state"].rep) == 1)[0]
        return q, [(30, 4), (int(rep[0]), 30), (7, 19)]
    return _circular(p)


@pytest.fixture(scope="module")
def jax_v2():
    """Compiled JAX v2 scorers, by problem."""
    return {}


@pytest.mark.parametrize("case", ["random", "repeat_copy", "inactive_copy", "circular"])
def test_v2_matches_jax_and_full_difference(problem, inactive_problem, jax_v2, case):
    p, pairs = _case(case, problem, inactive_problem)
    key = id(p["table"]), id(p["obs"])
    if key not in jax_v2:
        jax_v2[key] = jax.jit(jdr.make_repeat_delta_scorer_v2(p["table"], F_MAX, p["sobs"]))
    score_j = jax_v2[key]
    score_t = tdr.make_repeat_delta_scorer_v2(p["tt"], F_MAX, p["tsobs"], p["ts"].rep)
    ts_, tt, tp = p["ts"], p["tt"], p["tp"]
    max_id = jnp.max(p["state"].id_c)
    l0 = float(tl.log_likelihood(ts_, tt, torch.as_tensor(p["obs"]), tp))
    for f_a, f_b in pairs:
        want = score_j(p["state"], jnp.int32(f_a), jnp.int32(f_b), p["params"], max_id)
        got = score_t(ts_, f_a, f_b, tp, torch.tensor(int(max_id)))
        msg = f"{case} f_a={f_a} f_b={f_b}"
        assert not bool(got[4]) and not bool(want[4]), msg
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]), err_msg=msg)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]), err_msg=msg)
        assert_states_equal(got[1], want[1], msg)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=DLL_RTOL,
                                   atol=DLL_ATOL, err_msg=msg)
        cands = build_candidates(ts_, torch.tensor(f_a), torch.tensor([f_b]))
        full = tl.log_likelihood(type(ts_)(*[x[0] for x in cands]), tt,
                                 torch.as_tensor(p["obs"]), tp).numpy() - l0
        np.testing.assert_allclose(got[0].numpy(), full, rtol=FULL_RTOL, atol=FULL_ATOL,
                                   err_msg=msg)


def _step_nb(p):
    """tests/test_delta_repeats.py::test_repeat_delta_step_routing's
    neighbour table (fragment-level contacts through id_d)."""
    n_bins = p["table"].n_data_sub // 2
    obs = np.asarray(p["obs"])
    bin_mat = obs.reshape(n_bins, 2, n_bins, 2).sum(axis=(1, 3)).astype(np.float64)
    id_d = np.asarray(p["state"].id_d)
    return jm.build_neighbour_table(bin_mat[np.ix_(id_d, id_d)], id_d, p["state"].n_frags)


def test_delta_em_steps_match_jax(problem):
    p = problem
    nb = _step_nb(p)
    t_nb = convert.neighbour_table_from_numpy(nb._asdict())
    step_j = jax.jit(jd.make_delta_em_step(p["table"], None, nb, DELTA, F_MAX, sobs=p["sobs"]))
    step_t = td.make_delta_em_step(p["tt"], None, t_nb, DELTA, F_MAX, sobs=p["tsobs"],
                                   rep=p["ts"].rep)
    n_top = nb.pk.shape[1]
    n_slots = tm.n_slots(t_nb, DELTA)
    rep = np.nonzero(np.asarray(p["state"].rep) == 1)[0]
    cur = p["state"]
    l_j = jnp.float32(-5000.0)
    l_t = torch.tensor(np.float32(-5000.0))
    key = jax.random.key(2)
    moved_rep = 0
    for f_a in (int(rep[-1]), 0, int(rep[0]), 11, 17, int(rep[-2]), 25, 3):
        key, sub = jax.random.split(key)
        new_j, l_j, (op_j, fb_j, nov_j) = step_j(cur, sub, p["params"], l_j, jnp.int32(f_a),
                                                 jnp.float32(1.0))
        new_t, l_t, (op_t, fb_t, nov_t) = step_t(to_port(cur), step_draws(sub, n_top, n_slots),
                                                 p["tp"], l_t, torch.tensor(f_a), 1.0)
        msg = f"f_a={f_a}"
        assert (int(op_t), int(fb_t), int(nov_t)) == (int(op_j), int(fb_j), int(nov_j)), msg
        assert_states_equal(new_t, new_j, msg)
        np.testing.assert_allclose(float(l_t), float(l_j), rtol=LL_RTOL, err_msg=msg)
        moved_rep += int(op_t) >= 0 and f_a in rep
        cur = new_j
    assert moved_rep > 0
    check_invariants(to_port(cur))


def test_delta_cycle_carry_tracks_anchor(problem):
    """A repeat-table delta cycle (make_delta_em_cycle's default dense
    anchor): the carried likelihood equals a fresh evaluation of the final
    state (the JAX test's bound, rtol 1e-4, atol 0.5)."""
    p = problem
    t_nb = convert.neighbour_table_from_numpy(_step_nb(p)._asdict())
    cycle = td.make_delta_em_cycle(p["tt"], p["obs"], t_nb, DELTA, F_MAX, rep=p["ts"].rep)
    l0 = tl.log_likelihood(p["ts"], p["tt"], torch.as_tensor(p["obs"]), p["tp"])
    gen = torch.Generator().manual_seed(1)
    order = torch.randperm(p["ts"].n_frags, generator=gen)[:12]
    st, l_anchor, (lls, ops_, fbs, overs, ncs) = cycle(p["ts"], gen, p["tp"], order, l0, 1.0)
    check_invariants(st)
    assert int((ops_ >= 0).sum()) > 0
    np.testing.assert_allclose(float(lls[-1]), float(l_anchor), rtol=1e-4, atol=0.5)


def _variants(p):
    state = p["state"]
    n = state.n_frags
    deact = state._replace(activ=jnp.asarray(np.where(np.arange(n) == n - 1, 0,
                                                      np.asarray(state.activ)), jnp.int32))
    return [state, jm.explode_genome(state), deact, _circular(p)[0]["state"],
            jm.apply_mutation(state, int(n - 1), 4, 3)]


def test_sparse_loglik_repeats_matches(problem):
    p = problem
    w = js.band_width(np.asarray(p["table"].len_kb), float(p["params"].d_max))
    fn_j = js.make_sparse_loglik(p["table"], p["sobs"], w)
    # a small pair budget: the observed entries and the band in several chunks
    fn_t = ts.make_sparse_loglik(p["tt"], p["tsobs"], w, max_cells=4 * 37)
    for i, st in enumerate(_variants(p)):
        got = float(fn_t(to_port(st), p["tp"]))
        np.testing.assert_allclose(got, float(fn_j(st, p["params"])), rtol=LL_RTOL,
                                   err_msg=f"state {i}")
        dense = float(tl.log_likelihood(to_port(st), p["tt"], torch.as_tensor(p["obs"]),
                                        p["tp"]))
        np.testing.assert_allclose(got, dense, rtol=2e-4, atol=0.5, err_msg=f"state {i}")


def test_contract_is_checked(problem):
    p = problem
    rep = p["ts"].rep.clone()
    with pytest.raises(ValueError, match="rep flags"):
        tdr.make_repeat_delta_scorer_v2(p["tt"], F_MAX, p["tsobs"], None)
    rep[0] = 1                                 # fragment 0's bins are single-copy
    with pytest.raises(ValueError, match="single copy"):
        tdr.make_repeat_delta_scorer_v2(p["tt"], F_MAX, p["tsobs"], rep)
    t_nb = convert.neighbour_table_from_numpy(_step_nb(p)._asdict())
    with pytest.raises(ValueError):
        td.make_delta_em_step(p["tt"], p["obs"], t_nb, DELTA, F_MAX, rep=rep)
    # the production flags pass
    tdr.check_exactness_contract(p["tt"], p["ts"].rep)


@pytest.fixture(scope="module")
def scale_repeats():
    params = tss.scale_params()
    base, base_table = tss.make_scale_genome(200, 4, seed=41)
    sobs = tss.simulate_sparse_contacts(base, base_table, params, seed=41)
    state, table, id_d = tss.add_scale_repeats(base, base_table, (11, 60, 150))
    return dict(params=params, sobs=sobs, state=state, table=table, id_d=id_d,
                shuf=tss.shuffle_genome(state, 12, seed=42))


def test_scale_runner_setup_with_repeats_matches_jax(scale_repeats):
    s = scale_repeats
    j_params = jss.scale_params()
    j_base, j_btable = jss.make_scale_genome(200, 4, seed=41)
    j_sobs = jss.simulate_sparse_contacts(j_base, j_btable, j_params, seed=41)
    _, j_table, j_id_d = jss.add_scale_repeats(j_base, j_btable, (11, 60, 150))
    jr = jscale.ScaleRunner(j_table, j_sobs, j_params, id_d=j_id_d)
    tr = tscale.ScaleRunner(s["table"], s["sobs"], s["params"], id_d=s["id_d"])
    for f in ("xk", "pk", "dispatcher", "blacklist"):
        np.testing.assert_array_equal(getattr(tr.nb, f).numpy(), np.asarray(getattr(jr.nb, f)))
    assert (tr.nb.n_bins, tr.nb.max_copies) == (jr.nb.n_bins, jr.nb.max_copies) == (200, 2)
    assert (tr.w, tr.max_covered_d_max) == (jr.w, jr.max_covered_d_max)
    with pytest.raises(ValueError):
        tscale.ScaleRunner(s["table"], s["sobs"], s["params"])       # no id_d


def test_scale_runner_with_repeats(scale_repeats):
    s = scale_repeats
    runner = tscale.ScaleRunner(s["table"], s["sobs"], s["params"], id_d=s["id_d"])
    l0 = float(runner.anchor_fn()(s["shuf"], s["params"]))
    final, _, m = runner.run(s["shuf"], n_cycles=2, steps_per_cycle=60, f_max_min=32,
                             seed=7, progress=False)
    check_invariants(final)
    assert m["likelihood"][-1] > l0, (l0, m["likelihood"])
    fresh = float(tscale.ScaleRunner(s["table"], s["sobs"], s["params"], id_d=s["id_d"])
                  .anchor_fn()(final, s["params"]))
    np.testing.assert_allclose(m["likelihood"][-1], fresh, rtol=1e-6, atol=1.0)
    assert runner.mini_grid.n_launches == runner.obs_grid.n_launches == 0


def test_scale_runner_checks_the_exactness_contract(scale_repeats):
    """The runner holds the repeat engine's contract against the genome it
    runs on: a cycle needs the rep flags, and a rep-flagged fragment with a
    single-copy bin raises before any step."""
    s = scale_repeats
    runner = tscale.ScaleRunner(s["table"], s["sobs"], s["params"], id_d=s["id_d"])
    rep = s["shuf"].rep.clone()
    rep[0] = 1                                      # bin 0 has a single copy
    bad = s["shuf"]._replace(rep=rep)
    with pytest.raises(ValueError):
        runner.cycle_for(32, DELTA)
    with pytest.raises(ValueError):
        runner.cycle_for(32, DELTA, rep=rep)
    with pytest.raises(ValueError):
        runner.run(bad, n_cycles=1, steps_per_cycle=4, f_max_min=32, progress=False)
    assert runner.cycle_for(32, DELTA, rep=s["shuf"].rep) is \
        runner.cycle_for(32, DELTA, rep=s["state"].rep)
