"""The captured cycle (graal_tpu_torch.core.graphs.Scan) on the CPU.

A scan runs its step body on buffers it owns: the carry, the call's
constants, and the per-step inputs gathered at a device step index, with
the per-step outputs written at that index. On the card the body is
replayed as a CUDA graph; on the CPU the same body runs step by step, which
is what these tests drive. On shared draws (split from the JAX keys as the
JAX cycles split them), against the JAX package's jitted and scanned
cycles:

- dense EM with nuisance sampling (``core.mcmc.make_em_cycle``), two cycles
  through one cycle object, the second at another f_t and with perturbed
  parameters: decisions and states bit for bit, likelihoods and parameters
  at rtol 1e-5 (tests/test_torch_mcmc.py's bounds);
- a delta cycle of one chain (``core.delta.make_delta_em_cycle``, sparse,
  no re-anchor), chunks of 24, 16 and 30 steps through one cycle object
  (the buffers reused, then grown): states bit for bit, carried
  likelihood at rtol 1e-5;
- the same on a chains axis (C = 3, per-chain parameters and
  temperatures), each chain against the JAX cycle of that chain alone;
- the v2 repeat engine's delta cycle.

And: one cycle object called twice with new f_t, parameters and order
gives what two freshly built cycles give, bit for bit; ``capture=True``
without a card raises; a wrapper's launch counts, which live on the
device so that a graph's replays advance them.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graal_tpu.core import delta as jd
from graal_tpu.core import likelihood as jl
from graal_tpu.core import mcmc as jm
from graal_tpu.core import sparse as js
from graal_tpu.core.model import RippeParams as JParams
from graal_tpu.utils.synthetic import (bin_level_matrix, default_params, make_genome,
                                       simulate_contacts)
from graal_tpu_torch import convert
from graal_tpu_torch.core import delta as td
from graal_tpu_torch.core import graphs
from graal_tpu_torch.core import likelihood as tl
from graal_tpu_torch.core import mcmc as tm
from graal_tpu_torch.core.model import RippeParams
from graal_tpu_torch.core.state import GenomeState, check_invariants
from graal_tpu_torch.ops.counts import Counted, LaunchCount
from tests.test_delta_repeats import _repeat_problem
from tests.test_torch_delta import jax_delta_draws, walked_state
from tests.test_torch_delta_repeats import _port, _step_nb
from tests.test_torch_mcmc import assert_params_close, jax_cycle_draws, port_draws
from tests.test_torch_state import assert_states_equal, to_port

RTOL = 1e-5
DELTA = 4
F_MAX = 16
C = 3


@pytest.fixture(scope="module")
def dense():
    state, table = make_genome(n_bins=24, n_contigs=3, subs_per_bin=3, seed=2)
    params = default_params(fact=5000.0)
    obs = simulate_contacts(state, table, params, seed=2)
    n = state.n_frags
    nb = jm.build_neighbour_table(bin_level_matrix(obs, table), np.arange(n), n,
                                  blacklisted=[5])
    return dict(state=state, table=table, params=params, obs=obs, nb=nb,
                t_table=convert.table_from_numpy(table._asdict()),
                t_params=convert.params_from_numpy(params._asdict()),
                t_nb=convert.neighbour_table_from_numpy(nb._asdict()))


@pytest.fixture(scope="module")
def sparse():
    state, table = make_genome(n_bins=36, n_contigs=6, subs_per_bin=3, seed=4)
    params = default_params(fact=4000.0)
    obs = simulate_contacts(state, table, params, seed=4)
    n = state.n_frags
    nb = jm.build_neighbour_table(bin_level_matrix(obs, table), np.arange(n), n,
                                  blacklisted=[9])
    sobs = js.sparse_from_dense(obs)
    return dict(state=state, table=table, params=params, obs=obs, nb=nb, sobs=sobs,
                t_table=convert.table_from_numpy(table._asdict()),
                t_params=convert.params_from_numpy(params._asdict()),
                t_nb=convert.neighbour_table_from_numpy(nb._asdict()),
                t_sobs=convert.sparse_from_numpy(sobs._asdict()))


def scaled(params, s):
    """JAX and port parameters with fact scaled by ``s`` (f32)."""
    return params._replace(fact=np.float32(float(params.fact) * s))


def delta_draws(key, n_steps, nb, t_nb):
    u_nb, gum = jax_delta_draws(key, n_steps, nb.pk.shape[1], tm.n_slots(t_nb, DELTA))
    return tm.StepDraws(torch.as_tensor(np.array(u_nb)), torch.as_tensor(np.array(gum)),
                        None, None, None)


def test_dense_cycles_with_nuisance_match_jax(dense):
    """Two EM cycles of one cycle object (nuisance on): the second at
    f_t = 0.7 on the first's parameters with fact x 1.01."""
    p = dense
    n = p["state"].n_frags
    cycle_j = jm.make_em_cycle(p["table"], p["obs"], p["nb"], 3, sample_param=True)
    cycle_t = tm.make_em_cycle(p["t_table"], p["obs"], p["t_nb"], 3, sample_param=True)
    assert not cycle_t.scan.capture
    n_slots = tm.n_slots(p["t_nb"], 3)
    cur_j = jm.explode_genome(p["state"])
    cur_t = to_port(cur_j)
    l_j = jl.log_likelihood(cur_j, p["table"], p["obs"], p["params"])
    l_t = torch.tensor(np.float32(l_j))
    par_j, par_t = p["params"], p["t_params"]
    rng = np.random.default_rng(5)
    key = jax.random.key(9)
    for c, f_t in enumerate((1.0, 0.7)):
        key, k_cycle = jax.random.split(key)
        if c:
            par_j = par_j._replace(fact=par_j.fact * jnp.float32(1.01))
            par_t = par_t._replace(fact=par_t.fact * 1.01)
        order = rng.permutation(n).astype(np.int32)
        cur_j, par_j, l_j, m_j = cycle_j(cur_j, k_cycle, par_j, jnp.asarray(order), l_j,
                                         jnp.float32(f_t))
        draws = port_draws(jax_cycle_draws(k_cycle, n, p["nb"].pk.shape[1], n_slots))
        cur_t, par_t, l_t, m_t = cycle_t(cur_t, draws, par_t, torch.as_tensor(order), l_t,
                                         f_t)
        msg = f"cycle {c}"
        for f in ("op_sampled", "id_f_sampled", "id_f_a", "n_contigs", "success"):
            np.testing.assert_array_equal(getattr(m_t, f).numpy(),
                                          np.asarray(getattr(m_j, f)), err_msg=f"{f} {msg}")
        assert_states_equal(cur_t, cur_j, msg)
        np.testing.assert_allclose(m_t.likelihood.numpy(), np.asarray(m_j.likelihood),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(l_t), float(l_j), rtol=RTOL)
        assert_params_close(par_t, par_j)
        assert int(m_t.success.sum()) > 0
    check_invariants(cur_t)


def test_delta_cycle_one_chain_matches_jax(sparse):
    """Chunks of 24, 16 and 30 steps through one delta cycle object: the
    second reuses the buffers sized by the first, the third grows them."""
    p = sparse
    n = p["state"].n_frags
    cycle_j = jd.make_delta_em_cycle(p["table"], None, p["nb"], DELTA, F_MAX, sobs=p["sobs"],
                                     anchor_fn=False)
    cycle_t = td.make_delta_em_cycle(p["t_table"], None, p["t_nb"], DELTA, F_MAX,
                                     sobs=p["t_sobs"], anchor_fn=False)
    cur_j = walked_state(p["state"], seed=1)
    cur_t = to_port(cur_j)
    l_j = jl.log_likelihood(cur_j, p["table"], p["obs"], p["params"])
    l_t = torch.tensor(np.float32(l_j))
    rng = np.random.default_rng(3)
    key = jax.random.key(4)
    caps = []
    for c, steps in enumerate((24, 16, 30)):
        key, k_cycle = jax.random.split(key)
        order = rng.permutation(n)[:steps].astype(np.int32)
        cur_j, l_j, out_j = cycle_j(cur_j, k_cycle, p["params"], jnp.asarray(order), l_j,
                                    jnp.float32(1.0))
        cur_t, l_t, out_t = cycle_t(cur_t, delta_draws(k_cycle, steps, p["nb"], p["t_nb"]),
                                    p["t_params"], torch.as_tensor(order), l_t, 1.0)
        caps.append(cycle_t.scan.cap)
        for name, g, w in zip(("ops", "fbs", "overs", "ncs"), out_t[1:], out_j[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{name} {c}")
        assert out_t[0].shape == (steps,)
        assert_states_equal(cur_t, cur_j, f"chunk {c}")
        np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]), rtol=RTOL)
        np.testing.assert_allclose(float(l_t), float(l_j), rtol=RTOL)
    assert caps == [24, 24, 30]
    check_invariants(cur_t)


def test_delta_cycle_chains_axis_matches_jax(sparse):
    """C = 3 chains (per-chain parameters, a ladder of temperatures) in one
    chains-axis cycle; each chain against the JAX cycle of that chain
    alone on its own key's draws."""
    p = sparse
    n = p["state"].n_frags
    steps = 20
    cycle_j = jax.jit(jd.make_delta_em_cycle(p["table"], None, p["nb"], DELTA, F_MAX,
                                             sobs=p["sobs"], anchor_fn=False))
    cycle_t = td.make_delta_em_cycle(p["t_table"], None, p["t_nb"], DELTA, F_MAX,
                                     sobs=p["t_sobs"], anchor_fn=False)
    starts = [walked_state(p["state"], seed=1), jm.explode_genome(p["state"]), p["state"]]
    scales = np.float32([1.0, 1.01, 0.99])
    ladder = np.float32([1.0, 2.0, 4.0])
    j_par = [scaled(p["params"], s) for s in scales]
    l0 = np.float32([jl.log_likelihood(s, p["table"], p["obs"], q) for s, q in zip(starts,
                                                                                  j_par)])
    orders = np.stack([np.random.default_rng(10 + c).permutation(n)[:steps]
                       for c in range(C)]).astype(np.int32)
    keys = jax.random.split(jax.random.key(6), C)
    want = [cycle_j(starts[c], keys[c], j_par[c], jnp.asarray(orders[c]), jnp.float32(l0[c]),
                    jnp.float32(ladder[c])) for c in range(C)]
    per = [delta_draws(keys[c], steps, p["nb"], p["t_nb"]) for c in range(C)]
    draws = tm.StepDraws(torch.stack([d.u_nb for d in per], 1),
                         torch.stack([d.gumbel for d in per], 1), None, None, None)
    t_states = GenomeState(*[torch.stack(xs) for xs in zip(*[to_port(s) for s in starts])])
    t_par = RippeParams(*[torch.stack([torch.as_tensor(np.float32(getattr(q, f)))
                                       for q in j_par]) for f in JParams._fields])
    cur, l_t, outs = cycle_t(t_states, draws, t_par, torch.as_tensor(orders),
                             torch.as_tensor(l0), torch.as_tensor(ladder))
    assert outs[0].shape == (steps, C)
    for c in range(C):
        cur_j, l_j, out_j = want[c]
        assert_states_equal(GenomeState(*[x[c] for x in cur]), cur_j, f"chain {c}")
        for name, g, w in zip(("ops", "fbs", "overs", "ncs"), outs[1:], out_j[1:]):
            np.testing.assert_array_equal(g[:, c].numpy(), np.asarray(w),
                                          err_msg=f"{name} chain {c}")
        np.testing.assert_allclose(outs[0][:, c].numpy(), np.asarray(out_j[0]), rtol=RTOL)
        np.testing.assert_allclose(float(l_t[c]), float(l_j), rtol=RTOL)
    assert not torch.equal(cur.id_c, t_states.id_c)


def test_repeat_delta_cycle_matches_jax():
    """The v2 repeat engine's cycle (copy corrections chain by chain on top
    of B2's single-copy majority) on shared draws."""
    p = _port(*_repeat_problem())
    nb = _step_nb(p)
    t_nb = convert.neighbour_table_from_numpy(nb._asdict())
    f_max = 24
    cycle_j = jd.make_delta_em_cycle(p["table"], None, nb, DELTA, f_max, sobs=p["sobs"],
                                     anchor_fn=False)
    cycle_t = td.make_delta_em_cycle(p["tt"], None, t_nb, DELTA, f_max, sobs=p["tsobs"],
                                     anchor_fn=False, rep=p["ts"].rep)
    n = p["state"].n_frags
    rep = np.nonzero(np.asarray(p["state"].rep) == 1)[0]
    # every repeat copy, then the other fragments
    order = np.concatenate([rep, np.random.default_rng(2).permutation(
        np.setdiff1d(np.arange(n), rep))])[:24].astype(np.int32)
    l0 = jl.log_likelihood(p["state"], p["table"], p["obs"], p["params"])
    key = jax.random.key(12)
    cur_j, l_j, out_j = cycle_j(p["state"], key, p["params"], jnp.asarray(order), l0,
                                jnp.float32(1.0))
    cur_t, l_t, out_t = cycle_t(p["ts"], delta_draws(key, len(order), nb, t_nb), p["tp"],
                                torch.as_tensor(order), torch.tensor(np.float32(l0)), 1.0)
    for name, g, w in zip(("ops", "fbs", "overs", "ncs"), out_t[1:], out_j[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert_states_equal(cur_t, cur_j, "repeat cycle")
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]), rtol=RTOL)
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=RTOL)
    assert int((out_t[1][:len(rep)] >= 0).sum()) > 0       # a repeat copy moved
    check_invariants(cur_t)


def _two_calls(kind, p):
    """(build, start carry, calls) of a cycle of ``kind``: two calls at
    different f_t, parameter scales (fact x s) and orders, the second
    (delta) with fewer steps."""
    gen = torch.Generator().manual_seed(7)
    n = p["state"].n_frags
    tp = p["t_params"]
    if kind == "dense":
        start = tm.explode_genome(to_port(p["state"]))
        l0 = tl.log_likelihood(start, p["t_table"], torch.as_tensor(p["obs"]), tp)

        def build():
            return tm.make_em_cycle(p["t_table"], p["obs"], p["t_nb"], 3, sample_param=True)

        calls = [(torch.randperm(n, generator=gen), tm.draw_step_inputs(gen, p["t_nb"], 3, (n,)),
                  f_t, s) for f_t, s in ((1.0, 1.0), (0.6, 1.03))]
        return build, (start, tp, l0), calls
    lead = (C,) if kind == "chains" else ()
    start = to_port(walked_state(p["state"], seed=2))
    if lead:
        start = GenomeState(*[torch.stack([x] * C) for x in start])
        tp = RippeParams(*[x * torch.tensor([1.0, 1.01, 0.99]) for x in tp])

    def build():
        return td.make_delta_em_cycle(p["t_table"], None, p["t_nb"], DELTA, F_MAX,
                                      sobs=p["t_sobs"], anchor_fn=False)

    calls = []
    for steps, f_t, s in ((18, 1.0, 1.0), (12, 0.6, 1.03)):
        order = torch.stack([torch.randperm(n, generator=gen)[:steps] for _ in range(C)])
        calls.append((order if lead else order[0],
                      tm.draw_step_inputs(gen, p["t_nb"], DELTA, (steps,) + lead),
                      torch.tensor([f_t, 2 * f_t, 4 * f_t]) if lead else f_t, s))
    return build, (start, tp, torch.full(lead, -1000.0)), calls


def _flat(tree):
    return [x for t in tree for x in _flat(t)] if isinstance(tree, tuple) else [tree]


@pytest.mark.parametrize("kind", ["dense", "delta", "chains"])
def test_cycle_reloads_its_buffers_on_every_call(dense, sparse, kind):
    """One cycle object called twice (the second call with another f_t,
    other parameters, another order and, for delta, fewer steps) equals a
    fresh cycle object for each call, bit for bit."""
    p = dense if kind == "dense" else sparse
    build, (cur, params, l_t), calls = _two_calls(kind, p)
    start_idc = cur.id_c
    one = build()
    for order, draws, f_t, s in calls:
        par = params._replace(fact=params.fact * s)
        outs = [cycle(cur, draws, par, order, l_t, f_t) for cycle in (one, build())]
        a, b = (_flat(o) for o in outs)
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert x.shape == y.shape and torch.equal(x, y)
        if kind == "dense":
            cur, params, l_t, _ = outs[0]
        else:
            cur, l_t, _ = outs[0]
    assert not torch.equal(cur.id_c, start_idc)


def test_capture_without_a_card_raises(dense, sparse):
    p = dense
    with pytest.raises(ValueError, match="capture needs a CUDA device"):
        tm.make_em_cycle(p["t_table"], p["obs"], p["t_nb"], 3, capture=True)
    q = sparse
    with pytest.raises(ValueError, match="capture needs a CUDA device"):
        td.make_delta_em_cycle(q["t_table"], None, q["t_nb"], DELTA, F_MAX, sobs=q["t_sobs"],
                               anchor_fn=False, capture=True)
    with pytest.raises(ValueError, match="capture needs a CUDA device"):
        graphs.Scan(lambda c, k, x: (c, x), "cpu", capture=True)


def test_scan_outputs_are_its_own_copies_and_keep_the_carry_shape():
    """A scan's returned carry and outputs do not alias its buffers (a
    later call leaves them intact); a step that changes a carry leaf's
    shape raises."""
    def body(carry, k, x):
        (a,) = carry
        return (a + k * x,), a * 2

    scan = graphs.Scan(body, "cpu")
    (a1,), ys1 = scan((torch.zeros(2),), torch.tensor(1.0), torch.ones(3, 2))
    keep = (a1.clone(), ys1.clone())
    scan((torch.ones(2),), 2.0, torch.ones(2, 2))
    assert torch.equal(a1, keep[0]) and torch.equal(ys1, keep[1])
    assert torch.equal(a1, torch.full((2,), 3.0))
    assert torch.equal(ys1[:, 0], torch.tensor([0.0, 2.0, 4.0]))   # each step's carry in
    bad = graphs.Scan(lambda c, k, x: ((c[0].sum(),), x), "cpu")
    with pytest.raises(ValueError, match="shape"):
        bad((torch.zeros(2),), 0.0, torch.ones(1, 2))
    with pytest.raises(ValueError, match="at least one step"):
        scan((torch.zeros(2),), 1.0, torch.ones(0, 2))


class _Wrapper(Counted):
    def __init__(self):
        self.launches = LaunchCount()


def test_launch_counts_are_kept_beside_the_launch():
    """A wrapper's counts: one add to an int64 on the launch's device per
    launch (what a captured step repeats on every replay), read by key and
    in all; assigning 0 zeroes them, and no other value may be assigned."""
    w, dev = _Wrapper(), torch.device("cpu")
    assert w.n_launches == 0 and not w.launches.by_key()
    for _ in range(3):
        w.launches.add(dev, (65, 9))
    w.launches.add(dev, (1, 9))
    assert w.launches.by_key() == Counter({(65, 9): 3, (1, 9): 1})
    assert w.n_launches == 4
    assert all(c.dtype == torch.int64 and c.device == dev
               for c in w.launches.counters.values())
    w.n_launches = 0
    assert w.n_launches == 0 and not w.launches.by_key()
    with pytest.raises(ValueError, match="only set to 0"):
        w.n_launches = 5
    w.launches.add(dev)
    assert w.launches.by_key() == Counter({None: 1}) and w.n_launches == 1


def test_runner_releases_its_graphs_when_a_run_ends():
    """ScaleRunner.run and run_chains leave no cycle holding graphs or
    buffers (on the card a scan's graphs hold the step's peak memory): every
    scan of the runner is released when the run returns, and a cycle
    called again builds anew."""
    from graal_tpu_torch.entry import scale_problem
    from graal_tpu_torch.scale import ScaleRunner

    truth, shuf, table, params, sobs = scale_problem(200, n_contigs=2, n_pieces=10,
                                                     device="cpu")
    runner = ScaleRunner(table, sobs, params)
    runner.run(shuf, n_cycles=1, steps_per_cycle=24, f_max_min=32, progress=False)
    runner.run_chains(shuf, n_chains=2, n_cycles=1, steps_per_cycle=12, f_max_min=32,
                      progress=False)
    scans = [c.scan for c in runner._cycles.values()]
    assert len(scans) >= 2 and all(s.key is None and s.carry_bufs is None for s in scans)
    cycle = runner.cycle_for(32, DELTA)
    gen = torch.Generator().manual_seed(0)
    order = torch.randperm(shuf.n_frags, generator=gen)[:8]
    out = cycle(shuf, gen, params, order, runner.anchor_fn()(shuf, params), 1.0)
    assert cycle.scan.key is not None and out[2][0].shape == (8,)
