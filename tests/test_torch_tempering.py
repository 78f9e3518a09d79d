"""Parity of graal_tpu_torch.parallel.tempering with the JAX package.

- The ladder, ``exchange_best`` and ``pt_swap`` (on the uniforms the JAX
  swap drew from its key) equal the JAX ones; ``pt_swap`` is Metropolis.
- ``sample_neighbours`` / ``select_score_slot`` and the EM step with a
  leading chains axis give each chain's single-chain result, bit for bit.
- The step and cycle builders, given no scorer on a CUDA table, build the
  kernel scorer, not the plain likelihood.
- One tempered cycle of 3 chains on shared draws (each chain's uniforms
  and Gumbel noise split from its key as the JAX vmapped cycle splits
  them) gives the JAX cycle's states bit for bit and its likelihoods at
  rtol 1e-5; the chains are scored in one scorer call a step.
- ``run_tempered`` climbs as tests/test_tempering.py asserts.
"""

import functools
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graal_tpu.core import likelihood as jl
from graal_tpu.core import mcmc as jm
from graal_tpu.core.state import GenomeState as JState
from graal_tpu.parallel import tempering as jt
from graal_tpu_torch import convert
from graal_tpu_torch.core import mcmc as tm
from graal_tpu_torch.core.state import GenomeState as TState
from graal_tpu_torch.core.state import check_invariants
from graal_tpu_torch.parallel import tempering as tt
from tests.conftest import make_random_state
from tests.test_mcmc import make_problem
from tests.test_torch_state import assert_states_equal, to_port

LL_RTOL = 1e-5
DELTA = 4


def t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def problem():
    state, table, params, obs = make_problem(seed=4, n=16)
    n = state.n_frags
    nb = jm.build_neighbour_table(obs, np.arange(n), n, blacklisted=[6])
    return dict(state=state, table=table, params=params, obs=obs, nb=nb,
                tt=convert.table_from_numpy(table._asdict()),
                tp=convert.params_from_numpy(params._asdict()),
                tnb=convert.neighbour_table_from_numpy(nb._asdict()))


def test_ladder_matches():
    for c, hi in ((1, 4.0), (3, 4.0), (4, 8.0), (6, 2.5)):
        np.testing.assert_array_equal(tt.temperature_ladder(c, 1.0, hi),
                                      jt.temperature_ladder(c, 1.0, hi))


def test_exchange_best_matches(problem):
    js_ = jm.explode_genome(problem["state"])
    states_j = JState(*[jnp.stack([x] * 4) for x in js_])
    states_j = states_j._replace(start_bp=states_j.start_bp + jnp.arange(4)[:, None])
    l_ts = jnp.asarray([-100.0, -90.0, -10.0, -50.0], jnp.float32)
    want, want_l = jt.exchange_best(states_j, l_ts)
    got, got_l = tt.exchange_best(TState(*[t(x) for x in states_j]), t(l_ts))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    for f, a, b in zip(js_._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)


def test_pt_swap_matches_and_is_metropolis():
    n_chains, n = 5, 6
    rng = np.random.default_rng(0)
    states = TState(*[torch.as_tensor(rng.integers(0, 50, (n_chains, n)), dtype=torch.int32)
                      for _ in range(11)])
    states_j = JState(*[jnp.asarray(x.numpy()) for x in states])
    ladder = tt.temperature_ladder(n_chains, 1.0, 8.0)
    for s in range(40):
        l_ts = rng.normal(-1000.0, 30.0, n_chains).astype(np.float32)
        key = jax.random.key(s)
        out_j, l_j, acc_j = jt.pt_swap(states_j, jnp.asarray(l_ts), jnp.asarray(ladder), key,
                                      s % 2)
        u = t(jax.random.uniform(key, (n_chains - 1,)))
        out_t, l_t, acc_t = tt.pt_swap(states, torch.as_tensor(l_ts), ladder, u, s % 2)
        np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j), err_msg=str(s))
        np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))
        for a, b in zip(out_t, out_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # an uphill swap for the cold chain is always taken; parity 1 never
    # touches pair (0, 1)
    l_up = torch.tensor([-1000.0, -10.0, -2000.0, -2000.0, -2000.0])
    for s in range(20):
        g = torch.Generator().manual_seed(s)
        _, l_out, acc = tt.pt_swap(states, l_up, ladder, g, 0)
        assert bool(acc[0]) and float(l_out[0]) == -10.0
        _, _, acc = tt.pt_swap(states, l_up, ladder, g, 1)
        assert not bool(acc[0])


def test_chain_batched_draws_match_single_chain(problem):
    rng = np.random.default_rng(3)
    p = problem
    n = p["state"].n_frags
    chains = [make_random_state(rng, n, int(rng.integers(2, 6))) for _ in range(4)]
    states = TState(*[torch.stack(xs) for xs in zip(*[to_port(s) for s in chains])])
    gen = torch.Generator().manual_seed(1)
    n_top = p["tnb"].pk.shape[1]
    for trial in range(10):
        f_a = torch.randint(0, n, (4,), generator=gen)
        u = torch.rand(4, n_top, generator=gen)
        ids, valid = tm.sample_neighbours(u, f_a, states, p["tnb"], DELTA)
        m = ids.shape[1]
        score = torch.randn(4, m, 13, generator=gen) * 30.0 - 1000.0
        gum = -torch.log(-torch.log(torch.rand(4, m * 13, generator=gen)))
        f_t = torch.tensor([1.0, 1.5, 2.0, 4.0])
        sel = tm.select_score_slot(gum, score, valid, f_t)
        for c in range(4):
            one = TState(*[x[c] for x in states])
            ids1, valid1 = tm.sample_neighbours(u[c], f_a[c], one, p["tnb"], DELTA)
            assert torch.equal(ids1, ids[c]) and torch.equal(valid1, valid[c]), (trial, c)
            sel1 = tm.select_score_slot(gum[c], score[c], valid[c], f_t[c])
            assert int(sel1) == int(sel[c]), (trial, c)


def test_chain_batched_em_step_matches_single_chain(problem):
    """make_em_step on a chains axis (one scorer call for every chain) takes
    each chain's step as the single-chain step does: states, scores, ops and
    partners equal, blacklisted fragment 6 included."""
    rng = np.random.default_rng(5)
    p = problem
    n = p["state"].n_frags
    chains = [make_random_state(rng, n, int(rng.integers(2, 6))) for _ in range(4)]
    states = TState(*[torch.stack(xs) for xs in zip(*[to_port(s) for s in chains])])
    scorer = CountingScorer(p["tt"], p["obs"])
    step = tm.make_em_step(p["tt"], p["obs"], p["tnb"], DELTA, scorer=scorer)
    gen = torch.Generator().manual_seed(2)
    f_t = torch.tensor([1.0, 1.5, 2.0, 4.0])
    for trial in range(6):
        f_a = torch.randint(0, n, (4,), generator=gen)
        f_a[trial % 4] = 6
        draws = tm.draw_step_inputs(gen, p["tnb"], DELTA, (4,))
        scorer.batches.clear()
        out, (score, op, fb) = step(states, draws, p["tp"], f_a, f_t)
        assert scorer.batches == [4 * tm.n_slots(p["tnb"], DELTA)]
        for c in range(4):
            one = TState(*[x[c] for x in states])
            out1, (score1, op1, fb1) = step(one, tm.StepDraws(*[x[c] for x in draws]),
                                            p["tp"], f_a[c], f_t[c])
            msg = f"trial {trial} chain {c}"
            for a, b in zip(out1, out):
                assert torch.equal(a, b[c]), msg
            assert torch.equal(score1, score[c]) and torch.equal(op1, op[c]), msg
            assert torch.equal(fb1, fb[c]), msg
        states = out


@pytest.mark.parametrize("builder", ["em_step", "em_cycle", "nuisance_step", "tempered_cycle",
                                     "mtm_step", "mh_step", "mtm_cycle"])
def test_default_scorer_on_a_cuda_table_is_the_kernel(problem, monkeypatch, builder):
    """A builder given no scorer on a CUDA table builds the kernel scorer
    (make_dense_scorer: B1, or B3 for a repeat table), never the plain
    dense likelihood."""
    from graal_tpu_torch.core import mtm as tmtm
    from graal_tpu_torch.ops import likelihood_cuda

    built = []
    monkeypatch.setattr(likelihood_cuda, "make_dense_scorer",
                        lambda table, obs, device: built.append(device) or "kernel")
    p = problem
    table = p["tt"]._replace(owner=SimpleNamespace(device=torch.device("cuda", 0)))
    jump = tmtm.JumpTable(*[None] * len(tmtm.JumpTable._fields))
    make = {"em_step": lambda: tm.make_em_step(table, p["obs"], p["tnb"], DELTA),
            "em_cycle": lambda: tm.make_em_cycle(table, p["obs"], p["tnb"], DELTA),
            "nuisance_step": lambda: tm.make_nuisance_step(table, p["obs"]),
            "tempered_cycle": lambda: tt.make_tempered_cycle(table, p["obs"], p["tnb"], DELTA),
            "mtm_step": lambda: tmtm.make_mtm_step(table, p["obs"], jump),
            "mh_step": lambda: tmtm.make_mh_step(table, p["obs"], jump),
            "mtm_cycle": lambda: tmtm.make_mtm_cycle(table, p["obs"], jump)}[builder]
    make()
    assert built and all(d == torch.device("cuda", 0) for d in built)
    # on a CPU table the default stays the plain likelihood
    built.clear()
    assert tm._default_scorer(p["tt"], p["obs"], torch.float32) != "kernel" and not built


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def jax_chain_draws(keys, n_steps, n_top, n_slots):
    """Every chain's draws of ``n_steps`` tempered-cycle steps, split as the
    JAX one_chain body (key, sub = split(key)) and make_em_step (k_nb,
    k_sel = split(sub)) split them: ((steps, C, n_top), (steps, C,
    n_slots))."""
    def one(key):
        def body(key, _):
            key, sub = jax.random.split(key)
            k_nb, k_sel = jax.random.split(sub)
            return key, (jax.random.uniform(k_nb, (n_top,)),
                         jax.random.gumbel(k_sel, (n_slots,)))
        return jax.lax.scan(body, key, None, length=n_steps)[1]
    u, g = jax.vmap(one)(keys)
    return jnp.swapaxes(u, 0, 1), jnp.swapaxes(g, 0, 1)


class CountingScorer:
    """The plain dense likelihood, counting its calls and batch sizes."""

    def __init__(self, table, obs):
        self.score = tm._default_scorer(table, obs, torch.float32)
        self.batches = []

    def __call__(self, states, params):
        self.batches.append(states.pos.shape[0])
        return self.score(states, params)


def test_tempered_cycle_matches_jax(problem):
    p = problem
    n = p["state"].n_frags
    c = 3
    start = jm.explode_genome(p["state"])
    states_j = JState(*[jnp.stack([x] * c) for x in start])
    l0 = jl.log_likelihood(start, p["table"], p["obs"], p["params"])
    l_j = jnp.full((c,), l0, jnp.float32)
    ladder = jt.temperature_ladder(c, t_max=4.0)
    key = jax.random.key(9)
    k_perm, k_cycle = jax.random.split(key)
    orders = jax.vmap(lambda k: jax.random.permutation(k, n))(jax.random.split(k_perm, c))
    keys = jax.random.split(k_cycle, c)
    cycle_j = jt.make_tempered_cycle(p["table"], p["obs"], p["nb"], DELTA)
    out_j, lo_j, nc_j = cycle_j(states_j, keys, p["params"], orders, l_j, jnp.asarray(ladder))

    u, g = jax_chain_draws(keys, n, p["nb"].pk.shape[1], tm.n_slots(p["tnb"], DELTA))
    scorer = CountingScorer(p["tt"], p["obs"])
    cycle_t = tt.make_tempered_cycle(p["tt"], p["obs"], p["tnb"], DELTA, scorer=scorer)
    states_t = TState(*[t(x) for x in states_j])
    out_t, lo_t, nc_t = cycle_t(states_t, tt.ChainDraws(t(u), t(g)), p["tp"], t(orders),
                                t(l_j), torch.as_tensor(ladder))
    for ch in range(c):
        assert_states_equal(TState(*[x[ch] for x in out_t]),
                            JState(*[x[ch] for x in out_j]), f"chain {ch}")
        check_invariants(TState(*[x[ch] for x in out_t]))
    np.testing.assert_array_equal(nc_t.numpy(), np.asarray(nc_j))
    np.testing.assert_allclose(lo_t.numpy(), np.asarray(lo_j), rtol=LL_RTOL)
    # one scorer call a step for all chains
    assert scorer.batches == [c * tm.n_slots(p["tnb"], DELTA)] * n


def test_run_tempered_climbs(problem):
    """tests/test_tempering.py::test_tempered_run_single_device on the port."""
    p = problem
    scrambled = tm.explode_genome(to_port(p["state"]))
    final, l_cold, pt = tt.run_tempered(p["tt"], p["obs"], p["tnb"], scrambled, p["tp"],
                                        n_chains=3, n_cycles=5, delta=DELTA,
                                        exchange_every=2, progress=False)
    check_invariants(final)
    ll0 = float(jl.log_likelihood(jm.explode_genome(p["state"]), p["table"], p["obs"],
                                  p["params"]))
    ll_true = float(jl.log_likelihood(p["state"], p["table"], p["obs"], p["params"]))
    assert float(l_cold) > ll0 + 0.7 * (ll_true - ll0)
    assert pt["trace"].shape == (5, 3) and len(pt["swaps"]) == 5
    for ch in range(3):
        check_invariants(TState(*[x[ch] for x in pt["chain_states"]]))
    # the consolidated cold state's likelihood is the best chain's
    assert float(l_cold) == float(pt["trace"][-1].max())
