"""The sampler cycles that run as scans (graal_tpu_torch.core.graphs.Scan)
besides the EM and delta cycles, on the CPU.

Each cycle is built with ``capture=False``: the step body that a captured
CUDA graph replays on the card, run step by step on the scan's buffers.
On shared draws (split from the JAX keys as the JAX cycles split them),
against the JAX package's jitted and scanned cycles:

- the tempered dense cycle (``parallel.tempering.make_tempered_cycle``),
  C = 3 chains at their own temperatures, two calls of one cycle object,
  the second at a lower ladder;
- the dense MTM and MH cycles (``core.mtm.make_mtm_cycle``), two calls of
  one cycle object, the second at another f_t;
- the delta MTM and MH cycles (``core.mtm.make_delta_mtm_cycle``) on a
  repeat-free table and on a repeat table (the repeat engine v2), against
  the cycle the JAX ``ScaleRunner.run_mtm`` jits;
- the ``ScaleRunner`` cycle end (``cycle_end``: the re-anchor and the
  nuisance step, one genome and a chains axis) on injected draws, against
  the JAX runner's anchor and nuisance step.

States, accept flags and contig counts bit for bit; likelihoods and
parameters at rtol 1e-5 (tests/test_torch_mcmc.py's bounds).

And: one cycle object called twice (a new f_t, new parameters, a shorter
second call) gives what two freshly built cycles give, bit for bit;
``capture=True`` without a card raises; ``ScaleRunner.run_mtm`` releases
its scans' graphs when its bucket changes and when it ends.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graal_tpu import scale as jscale
from graal_tpu.core import likelihood as jl
from graal_tpu.core import mcmc as jm
from graal_tpu.core import mtm as jmtm
from graal_tpu.core.model import RippeParams as JParams
from graal_tpu.core.state import GenomeState as JState
from graal_tpu.parallel import tempering as jt
from graal_tpu.utils import synthetic_sparse as jss
from graal_tpu_torch import entry as tentry
from graal_tpu_torch.core import mcmc as tm
from graal_tpu_torch.core import mtm as tmtm
from graal_tpu_torch.core.model import RippeParams
from graal_tpu_torch.core.state import GenomeState, check_invariants
from graal_tpu_torch.parallel import tempering as tt
from graal_tpu_torch.scale import ScaleRunner
from tests.test_torch_mcmc import assert_params_close
from tests.test_torch_mtm import dense, jax_move_draws, t  # noqa: F401
from tests.test_torch_mtm_delta import F_MAX, delta_setup
from tests.test_torch_state import assert_states_equal, to_port
from tests.test_torch_tempering import jax_chain_draws, problem  # noqa: F401

RTOL = 1e-5
DELTA = 4
C = 3


@pytest.fixture(scope="module")
def plain():
    return delta_setup("plain")


@pytest.fixture(scope="module")
def repeats():
    return delta_setup("repeats")


def _chains(states_t, c):
    return [GenomeState(*[x[k] for x in states_t]) for k in range(c)]


def test_tempered_cycle_two_calls_match_jax(problem):
    """One tempered cycle object, C = 3 chains: a sweep on the ladder up to
    T = 4, then another at 0.8 x the ladder; each call against a JAX cycle
    call on the same keys (the shorter call is in
    test_cycle_reloads_its_buffers_on_every_call: one JAX compile here)."""
    p = problem
    n = p["state"].n_frags
    start = jm.explode_genome(p["state"])
    states_j = JState(*[jnp.stack([x] * C) for x in start])
    l_j = jnp.full((C,), jl.log_likelihood(start, p["table"], p["obs"], p["params"]),
                   jnp.float32)
    cycle_j = jt.make_tempered_cycle(p["table"], p["obs"], p["nb"], DELTA)
    cycle_t = tt.make_tempered_cycle(p["tt"], p["obs"], p["tnb"], DELTA, capture=False)
    assert not cycle_t.scan.capture
    states_t, l_t = GenomeState(*[t(x) for x in states_j]), t(l_j)
    key = jax.random.key(21)
    for call, scale in enumerate((1.0, 0.8)):
        key, k_perm, k_cycle = jax.random.split(key, 3)
        orders = jnp.stack([jax.random.permutation(k, n) for k in jax.random.split(k_perm, C)])
        keys = jax.random.split(k_cycle, C)
        ladder = jt.temperature_ladder(C, t_max=4.0) * np.float32(scale)
        states_j, l_j, nc_j = cycle_j(states_j, keys, p["params"], orders, l_j,
                                      jnp.asarray(ladder))
        u, g = jax_chain_draws(keys, n, p["nb"].pk.shape[1], tm.n_slots(p["tnb"], DELTA))
        states_t, l_t, nc_t = cycle_t(states_t, tt.ChainDraws(t(u), t(g)), p["tp"], t(orders),
                                      l_t, torch.as_tensor(ladder))
        for ch, got in enumerate(_chains(states_t, C)):
            assert_states_equal(got, JState(*[x[ch] for x in states_j]), f"{call} chain {ch}")
            check_invariants(got)
        np.testing.assert_array_equal(nc_t.numpy(), np.asarray(nc_j))
        np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), rtol=RTOL)
    assert cycle_t.scan.cap == n


@pytest.mark.parametrize("variant", ["mtm", "mh"])
def test_dense_mtm_cycle_two_calls_match_jax(dense, variant):  # noqa: F811
    """One dense MTM / MH cycle object: a sweep at f_t = 1, then another at
    f_t = 0.7 (a Python float: the scan's 0-d f32 constant)."""
    d = dense
    n = d["state"].n_frags
    cycle_j = jmtm.make_mtm_cycle(d["table"], d["obs"], d["jump"], variant=variant)
    cycle_t = tmtm.make_mtm_cycle(d["tt"], d["obs"], d["tj"], variant=variant, capture=False)
    assert not cycle_t.scan.capture
    n_slots = tmtm.n_move_slots(d["tj"])
    cur_j, cur_t = d["cur"], to_port(d["cur"])
    l_j = jnp.float32(d["l0"])
    l_t = torch.tensor(np.float32(d["l0"]))
    key = jax.random.key(3)
    n_acc = 0
    for call, f_t in enumerate((1.0, 0.7)):
        key, k1, k2 = jax.random.split(key, 3)
        order = jax.random.permutation(k1, n)
        cur_j, l_j, (lls_j, acc_j, ncs_j) = cycle_j(cur_j, k2, d["params"], order, l_j,
                                                    jnp.float32(f_t))
        gum, u = jax_move_draws(k2, n, n_slots)
        cur_t, l_t, (lls_t, acc_t, ncs_t) = cycle_t(cur_t, tmtm.MoveDraws(t(gum), t(u)),
                                                    d["tp"], t(order), l_t, f_t)
        msg = f"{variant} call {call}"
        np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j), err_msg=msg)
        np.testing.assert_array_equal(ncs_t.numpy(), np.asarray(ncs_j), err_msg=msg)
        np.testing.assert_allclose(lls_t.numpy(), np.asarray(lls_j), rtol=RTOL, err_msg=msg)
        np.testing.assert_allclose(float(l_t), float(l_j), rtol=RTOL, err_msg=msg)
        assert_states_equal(cur_t, cur_j, msg)
        n_acc += int(acc_t.sum())
    check_invariants(cur_t)
    assert n_acc > 0


def jax_delta_cycle(p, variant):
    """The delta MTM / MH cycle the JAX ``ScaleRunner.run_mtm`` jits (a
    lax.scan of the step, key, sub = split(key) a step), with each step's
    carried likelihood among its outputs."""
    make = jmtm.make_delta_mtm_step if variant == "mtm" else jmtm.make_delta_mh_step
    step = make(p["table"], p["jump"], F_MAX, p["sobs"])

    @jax.jit
    def cycle(state, key, params, order, l_t, f_t):
        def body(carry, f_a):
            state, key, l_t = carry
            key, sub = jax.random.split(key)
            state, l_t, acc, nc = step(state, sub, params, l_t, f_a, f_t)
            return (state, key, l_t), (l_t, acc, nc)

        (state, _, l_t), ys = jax.lax.scan(body, (state, key, l_t), order)
        return state, l_t, ys

    return cycle


@pytest.mark.parametrize("kind", ["plain", "repeats"])
@pytest.mark.parametrize("variant", ["mtm", "mh"])
def test_delta_mtm_cycle_matches_jax(plain, repeats, variant, kind):
    """12 delta MTM / MH steps from a walked genome (B4 + B2's plain
    versions; the repeat engine v2 on the repeat table)."""
    p = plain if kind == "plain" else repeats
    n = p["state"].n_frags
    steps = 12
    order = np.random.default_rng(5).permutation(n)[:steps].astype(np.int32)
    key = jax.random.key(17 + (variant == "mh"))
    cur_j, l_j, (lls_j, acc_j, ncs_j) = jax_delta_cycle(p, variant)(
        p["start"], key, p["params"], jnp.asarray(order), jnp.float32(p["l0"]),
        jnp.float32(1.0))
    cycle_t = tmtm.make_delta_mtm_cycle(p["tt"], p["tj"], F_MAX, p["tsobs"], variant=variant,
                                        rep=p["ts"].rep, capture=False)
    assert not cycle_t.scan.capture
    gum, u = jax_move_draws(key, steps, tmtm.n_move_slots(p["tj"]))
    cur_t, l_t, (lls_t, acc_t, ncs_t) = cycle_t(
        to_port(p["start"]), tmtm.MoveDraws(t(gum), t(u)), p["tp"], torch.as_tensor(order),
        torch.tensor(np.float32(p["l0"])), 1.0)
    msg = f"{kind} {variant}"
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j), err_msg=msg)
    np.testing.assert_array_equal(ncs_t.numpy(), np.asarray(ncs_j), err_msg=msg)
    np.testing.assert_allclose(lls_t.numpy(), np.asarray(lls_j), rtol=RTOL, err_msg=msg)
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=RTOL, err_msg=msg)
    assert_states_equal(cur_t, cur_j, msg)
    check_invariants(cur_t)
    assert int(acc_t.sum()) > 0


# ---------------------------------------------------------------------------
# The ScaleRunner cycle end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runners():
    """The port's and the JAX package's runners on one 200-bin problem (2
    contigs, shuffled into 10 pieces), and three distinct starts."""
    truth, shuf, table, params, sobs = tentry.scale_problem(
        200, n_contigs=2, n_pieces=10, seed=41, shuffle_seed=42, device="cpu")
    j_truth, j_table = jss.make_scale_genome(200, 2, seed=41)
    j_sobs = jss.simulate_sparse_contacts(j_truth, j_table, jss.scale_params(), seed=41)
    starts = [jss.shuffle_genome(j_truth, 10, seed=42 + c) for c in range(C)]
    return dict(tr=ScaleRunner(table, sobs, params), params=params,
                jr=jscale.ScaleRunner(j_table, j_sobs, jss.scale_params()),
                j_params=jss.scale_params(), starts=starts)


def nuisance_draws(keys):
    """The nuisance draws of each key, split as the JAX proposer splits it
    (k_mod, k_eps, k_u = split(key, 3)): (id_modif, eps, u), each (len(keys),)."""
    def one(key):
        k_mod, k_eps, k_u = jax.random.split(key, 3)
        return (jax.random.randint(k_mod, (), 0, 4), jax.random.normal(k_eps, ()),
                jax.random.uniform(k_u, ()))

    return jax.vmap(one)(keys)


def port_nuisance(draws, lead=None):
    id_modif, eps, u = (torch.as_tensor(np.array(x)) for x in draws)
    out = tm.NuisanceDraws(id_modif.long(), eps, u)
    return out if lead is None else tm.NuisanceDraws(*[x[lead] for x in out])


def test_run_cycle_end_matches_jax(runners):
    """ScaleRunner.run's cycle end (one end object, 8 calls on the same
    genome, the parameters carried from call to call, f_t 1.0 and 0.6):
    against the JAX runner's anchor and nuisance step on the same keys;
    without nuisance sampling, the anchor alone and the parameters as
    given."""
    r = runners
    tr, jr = r["tr"], r["jr"]
    state_j = r["starts"][0]
    state_t = to_port(state_j)
    anchor_j, nuis_j = jr.anchor_fn(), jr.nuisance_step()
    end = tr.cycle_end(True)
    assert not end.scan.capture
    par_j, par_t = r["j_params"], r["params"]
    keys = jax.random.split(jax.random.key(8), 8)
    draws = nuisance_draws(keys)
    accepted = 0
    for i, key in enumerate(keys):
        f_t = (1.0, 0.6)[i % 2]
        l_anchor_j = anchor_j(state_j, par_j)
        par_j, l_j, acc = nuis_j(state_j, key, par_j, l_anchor_j, jnp.float32(f_t))
        par_t, l_anchor_t, l_t = end(state_t, par_t, f_t, port_nuisance(draws, i))
        np.testing.assert_allclose(float(l_anchor_t), float(l_anchor_j), rtol=RTOL)
        np.testing.assert_allclose(float(l_t), float(l_j), rtol=RTOL)
        assert_params_close(par_t, par_j)
        accepted += bool(acc)
    assert 0 < accepted < len(keys)
    out, l_anchor_t, l_t = tr.cycle_end(False)(state_t, r["params"], 1.0, None)
    assert torch.equal(l_anchor_t, l_t)
    np.testing.assert_allclose(float(l_t), float(anchor_j(state_j, r["j_params"])), rtol=RTOL)
    assert all(torch.equal(a, torch.as_tensor(b)) for a, b in zip(out, r["params"]))


def test_chains_cycle_end_matches_jax(runners):
    """ScaleRunner.run_chains's cycle end: C = 3 chains (distinct shuffles,
    per-chain parameters, a ladder of temperatures), each chain's
    re-anchor and nuisance step on its own key, against the JAX runner's
    vmapped anchor, proposer and acceptance."""
    r = runners
    tr, jr = r["tr"], r["jr"]
    anchor = jax.jit(jax.vmap(jr.anchor_fn()))
    propose = jax.jit(jax.vmap(jm.make_nuisance_proposer(d_max_cap=jr.max_covered_d_max)))
    accept = jax.jit(jax.vmap(jm.nuisance_accept))
    states_j = JState(*[jnp.stack(xs) for xs in zip(*r["starts"])])
    scales = np.float32([1.0, 1.01, 0.99])
    par_j = JParams(*[jnp.asarray(np.float32(x) * scales) for x in r["j_params"]])
    par_t = RippeParams(*[torch.as_tensor(np.asarray(x)) for x in par_j])
    ladder = jt.temperature_ladder(C, t_max=4.0)
    keys = jax.random.split(jax.random.key(11), C)
    l_anchor_j = anchor(states_j, par_j)
    test, ok, k_u = propose(keys, par_j)
    par_j, l_j, acc_j = accept(k_u, test, par_j, anchor(states_j, test), l_anchor_j,
                               jnp.asarray(ladder), ok)
    states_t = GenomeState(*[torch.stack(xs) for xs in zip(*[to_port(s) for s in r["starts"]])])
    par_t, l_anchor_t, l_t = tr.cycle_end(True, chains=True)(
        states_t, par_t, torch.as_tensor(ladder), port_nuisance(nuisance_draws(keys)))
    np.testing.assert_allclose(l_anchor_t.numpy(), np.asarray(l_anchor_j), rtol=RTOL)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), rtol=RTOL)
    for c in range(C):
        assert_params_close(RippeParams(*[x[c] for x in par_t]),
                            JParams(*[x[c] for x in par_j]))


# ---------------------------------------------------------------------------
# Reload, capture and release
# ---------------------------------------------------------------------------

def _flat(tree):
    return [x for t_ in tree for x in _flat(t_)] if isinstance(tree, tuple) else [tree]


def _calls(kind, problem, dense, plain):  # noqa: F811
    """(build, start carry, calls) of a cycle of ``kind``: two calls, the
    second with another f_t, parameters (fact x 1.03) and fewer steps."""
    gen = torch.Generator().manual_seed(7)
    if kind == "tempered":
        p = problem
        start = tm.explode_genome(to_port(p["state"]))
        states = GenomeState(*[torch.stack([x] * C) for x in start])
        n = start.n_frags

        def build():
            return tt.make_tempered_cycle(p["tt"], p["obs"], p["tnb"], DELTA, capture=False)

        ladder = torch.as_tensor(jt.temperature_ladder(C, t_max=4.0))
        calls = [(torch.stack([torch.randperm(n, generator=gen)[:steps] for _ in range(C)]),
                  tt.draw_chain_inputs(gen, p["tnb"], DELTA, C, (steps,)), ladder * s, s)
                 for steps, s in ((16, 1.0), (9, 1.03))]
        return build, (states, p["tp"], torch.full((C,), -1000.0)), calls
    p = dense if kind == "mtm" else plain
    tj = p["tj"]
    start = to_port(p["cur"] if kind == "mtm" else p["start"])
    n = start.n_frags

    def build():
        if kind == "mtm":
            return tmtm.make_mtm_cycle(p["tt"], p["obs"], tj, capture=False)
        return tmtm.make_delta_mtm_cycle(p["tt"], tj, F_MAX, p["tsobs"], variant="mh",
                                         rep=start.rep, capture=False)

    calls = [(torch.randperm(n, generator=gen)[:steps],
              tmtm.draw_move_inputs(gen, tj, (steps,)), f_t, s)
             for steps, f_t, s in ((12, 1.0, 1.0), (7, 0.6, 1.03))]
    return build, (start, p["tp"], torch.tensor(np.float32(p["l0"]))), calls


@pytest.mark.parametrize("kind", ["tempered", "mtm", "delta_mh"])
def test_cycle_reloads_its_buffers_on_every_call(problem, dense, plain, kind):  # noqa: F811
    """One cycle object called twice equals a fresh cycle object for each
    call, bit for bit."""
    build, (cur, params, l_t), calls = _calls(kind, problem, dense, plain)
    start_idc = cur.id_c
    one = build()
    for order, draws, f_t, s in calls:
        par = params._replace(fact=params.fact * s)
        outs = [cycle(cur, draws, par, order, l_t, f_t) for cycle in (one, build())]
        a, b = (_flat(o) for o in outs)
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert x.shape == y.shape and torch.equal(x, y)
        cur, l_t = outs[0][0], outs[0][1]
    assert one.scan.cap == (16 if kind == "tempered" else 12)
    assert not torch.equal(cur.id_c, start_idc)


def test_capture_without_a_card_raises(problem, dense, plain):  # noqa: F811
    with pytest.raises(ValueError, match="capture needs a CUDA device"):
        tt.make_tempered_cycle(problem["tt"], problem["obs"], problem["tnb"], DELTA,
                               capture=True)
    with pytest.raises(ValueError, match="capture needs a CUDA device"):
        tmtm.make_mtm_cycle(dense["tt"], dense["obs"], dense["tj"], capture=True)
    with pytest.raises(ValueError, match="capture needs a CUDA device"):
        tmtm.make_delta_mtm_cycle(plain["tt"], plain["tj"], F_MAX, plain["tsobs"],
                                  capture=True)


def test_run_mtm_releases_its_graphs(runners, monkeypatch):
    """ScaleRunner.run_mtm over two cycles whose buckets differ (128, then
    256): when a cycle of a bucket runs, no other scan of the runner holds
    buffers or a graph (on the card a scan's graph holds the step's peak
    memory), and none does once the run returns."""
    from graal_tpu_torch import scale as tscale

    tr = runners["tr"]
    sizes = iter([40, 100])
    monkeypatch.setattr(tscale, "max_contig_subs", lambda state, table: next(sizes))
    held = []
    real_make = tmtm.make_delta_mtm_cycle

    def spying_make(*args, **kw):
        cycle = real_make(*args, **kw)

        def call(*a):
            held.append([k for k, c in tr._cycles.items()
                         if k[0] == "mtm" and c.scan.key is not None and c is not spy])
            return cycle(*a)

        spy = call
        call.scan = cycle.scan
        return call

    monkeypatch.setattr(tmtm, "make_delta_mtm_cycle", spying_make)
    start = to_port(runners["starts"][1])
    _, _, m = tr.run_mtm(start, n_cycles=2, steps_per_cycle=6, f_max_min=32, variant="mh",
                         progress=False)
    assert m["f_max"] == [128, 256]
    assert held == [[], []]
    assert all(c.scan.key is None and c.scan.carry_bufs is None for c in tr._cycles.values())
    assert {k[1] for k in tr._cycles if k[0] == "mtm"} == {128, 256}
