"""Parity of graal_tpu_torch.core.mcmc with the JAX package.

The random inputs differ by generator (JAX threefry vs torch Philox), so
the port is fed the draws the JAX step consumed: the neighbour-sampling
uniforms, the Gumbel vector of the categorical draw and (id_modif, eps, u)
of the nuisance step, derived from the JAX keys along the same split
schedule as ``graal_tpu.core.mcmc.make_em_cycle``. Given the same draws,
every decision must be identical: committed (op, fB) and states bit for
bit; the carried likelihood and the nuisance parameters (f32
transcendentals, ulp-level differences between XLA-CPU and torch) at
rtol 1e-5.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from graal_tpu.core import likelihood as jl
from graal_tpu.core import mcmc as jm
from graal_tpu.utils.synthetic import default_params, make_genome, simulate_contacts
from graal_tpu_torch import convert
from graal_tpu_torch.core import likelihood as tl
from graal_tpu_torch.core import mcmc as tm
from graal_tpu_torch.core.state import GenomeState as TState
from graal_tpu_torch.core.state import check_invariants
from tests.conftest import make_random_state
from tests.test_torch_state import assert_states_equal, to_port

RTOL = 1e-5
DELTA = 3


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def jax_cycle_draws(key, n_steps, n_top, n_slots):
    """The draws of ``n_steps`` cycle steps from ``key``, split exactly as
    make_em_cycle / make_em_step / make_nuisance_proposer split it."""
    def body(key, _):
        key, k_step, k_nuis = jax.random.split(key, 3)
        k_nb, k_sel = jax.random.split(k_step)
        k_mod, k_eps, k_u = jax.random.split(k_nuis, 3)
        return key, (jax.random.uniform(k_nb, (n_top,)),
                     jax.random.gumbel(k_sel, (n_slots,)),
                     jax.random.randint(k_mod, (), 0, 4),
                     jax.random.normal(k_eps, ()),
                     jax.random.uniform(k_u, ()))
    return jax.lax.scan(body, key, None, length=n_steps)[1]


def t(x):
    """A torch tensor holding a copy of a JAX / numpy array."""
    return torch.as_tensor(np.array(x))


def port_draws(jax_draws):
    u_nb, gum, idm, eps, u = [np.array(x) for x in jax_draws]
    return tm.StepDraws(torch.as_tensor(u_nb), torch.as_tensor(gum),
                        torch.as_tensor(idm.astype(np.int64)),
                        torch.as_tensor(eps), torch.as_tensor(u))


@pytest.fixture(scope="module")
def problem():
    state, table = make_genome(n_bins=24, n_contigs=3, subs_per_bin=3, seed=2)
    params = default_params(fact=5000.0)
    obs = simulate_contacts(state, table, params, seed=2)
    n = state.n_frags
    nb = jm.build_neighbour_table(obs_bins(obs, table), np.arange(n), n,
                                  blacklisted=[5])
    return dict(state=state, table=table, params=params, obs=obs, nb=nb,
                t_table=convert.table_from_numpy(table._asdict()),
                t_params=convert.params_from_numpy(params._asdict()),
                t_nb=convert.neighbour_table_from_numpy(nb._asdict()))


def obs_bins(obs, table):
    from graal_tpu.utils.synthetic import bin_level_matrix
    return bin_level_matrix(obs, table)


def assert_params_close(tp, jp):
    for f in jp._fields:
        np.testing.assert_allclose(float(getattr(tp, f)), float(getattr(jp, f)),
                                   rtol=RTOL, err_msg=f)


def test_neighbour_table_equal():
    rng = np.random.default_rng(0)
    m = rng.poisson(2.0, (30, 30)).astype(np.float32)
    m = np.triu(m, 1) + np.triu(m, 1).T
    m[7] = 0.0                          # a contact-free row
    m[:, 7] = 0.0
    id_d = np.concatenate([np.arange(30), [4, 4, 9]])
    for mat in (m, sp.csr_matrix(m)):
        want = jm.build_neighbour_table(mat, id_d, 33, blacklisted=[2, 31])
        got = tm.build_neighbour_table(mat, id_d, 33, blacklisted=[2, 31])
        for f in ("xk", "pk", "dispatcher", "blacklist"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)), err_msg=f)
        assert (got.n_bins, got.max_copies) == (want.n_bins, want.max_copies)


def test_sample_neighbours_matches():
    rng = np.random.default_rng(1)
    js = make_random_state(rng, 20, 4)
    m = rng.poisson(1.0, (20, 20)).astype(np.float32)
    m = np.triu(m, 1) + np.triu(m, 1).T
    m[3, :] = 0.0
    m[:, 3] = 0.0
    m[3, 8] = m[8, 3] = 5.0             # row 3: one partner, -inf ties in top-k
    nb = jm.build_neighbour_table(m, np.arange(20), 20, blacklisted=[11])
    tnb = convert.neighbour_table_from_numpy(nb._asdict())
    ts = to_port(js)
    sample = jax.jit(jm.sample_neighbours, static_argnames=("delta",))
    key = jax.random.key(3)
    for f_a in [3] + list(range(20)):
        key, sub = jax.random.split(key)
        want_ids, want_valid = sample(sub, jnp.int32(f_a), js, nb, delta=4)
        u = t(jax.random.uniform(sub, (nb.pk.shape[1],)))
        ids, valid = tm.sample_neighbours(u, torch.tensor(f_a), ts, tnb, 4)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))


def test_select_score_slot_matches():
    rng = np.random.default_rng(2)
    key = jax.random.key(5)
    cases = []
    for i in range(40):
        m = 5
        score = rng.normal(-1000.0, rng.choice([0.5, 5.0, 50.0]), (m, 13)).astype(np.float32)
        valid = rng.random(m) < 0.7
        if i % 10 == 0:
            valid[:] = False                  # only slot 0's eject/flip remain
        if i % 10 == 1:
            score[:] = -1000.0                # all equal: the p = 0/0 guard
        cases.append((score, valid, float(rng.choice([1.0, 0.3, 3.0]))))
    for score, valid, f_t in cases:
        key, sub = jax.random.split(key)
        want = int(jm.select_score_slot(sub, jnp.asarray(score), jnp.asarray(valid),
                                        jnp.float32(f_t)))
        gum = t(jax.random.gumbel(sub, (score.size,)))
        got = tm.select_score_slot(gum, torch.as_tensor(score),
                                   torch.as_tensor(valid), f_t)
        assert int(got) == want


def test_solve_d_max_and_proposals(problem):
    jp, tp = problem["params"], problem["t_params"]
    for v in (0.1, 0.05, 0.5):
        np.testing.assert_allclose(
            float(tm.solve_d_max(tp, torch.tensor(np.float32(v)))),
            float(jm.solve_d_max(jp, jnp.float32(v))), rtol=RTOL)
    propose_j = jax.jit(jm.make_nuisance_proposer())

    def propose_t(id_modif, eps, params):
        return tm.nuisance_propose(id_modif, eps, params)[:2]

    key = jax.random.key(9)
    seen = set()
    for _ in range(24):
        key, sub = jax.random.split(key)
        want, want_ok, _ = propose_j(sub, jp)
        k_mod, k_eps, _ = jax.random.split(sub, 3)
        idm = int(jax.random.randint(k_mod, (), 0, 4))
        eps = float(jax.random.normal(k_eps, ()))
        seen.add(idm)
        got, ok = propose_t(torch.tensor(idm), torch.tensor(np.float32(eps)), tp)
        assert bool(ok) == bool(want_ok)
        assert_params_close(got, want)
    assert seen == {0, 1, 2, 3}


def test_one_em_step_matches(problem):
    p = problem
    step_j = jax.jit(jm.make_em_step(p["table"], p["obs"], p["nb"], DELTA))
    step_t = tm.make_em_step(p["t_table"], p["obs"], p["t_nb"], DELTA)
    n_slots = tm.n_slots(p["t_nb"], DELTA)
    n_top = p["nb"].pk.shape[1]
    cur = jm.explode_genome(p["state"])
    key = jax.random.key(11)
    for f_a in (0, 7, 5, 13, 20):            # 5 is blacklisted
        key, k_step = jax.random.split(key)
        new_j, (score_j, op_j, fb_j) = step_j(cur, k_step, p["params"],
                                              jnp.int32(f_a), jnp.float32(1.0))
        k_nb, k_sel = jax.random.split(k_step)
        draws = tm.StepDraws(
            t(jax.random.uniform(k_nb, (n_top,))),
            t(jax.random.gumbel(k_sel, (n_slots,))),
            None, None, None)
        new_t, (score_t, op_t, fb_t) = step_t(to_port(cur), draws, p["t_params"],
                                              torch.tensor(f_a), 1.0)
        assert (int(op_t), int(fb_t)) == (int(op_j), int(fb_j)), f"f_a={f_a}"
        assert_states_equal(new_t, new_j, f"f_a={f_a}")
        if f_a == 5:
            assert int(op_t) == -1 and float(score_t) == -np.inf
        else:
            np.testing.assert_allclose(float(score_t), float(score_j), rtol=RTOL)
        cur = new_j


@pytest.mark.parametrize("sample_param", [False, True])
def test_two_cycles_match(problem, sample_param):
    p = problem
    n = p["state"].n_frags
    cycle_j = jm.make_em_cycle(p["table"], p["obs"], p["nb"], DELTA,
                               sample_param=sample_param)
    cycle_t = tm.make_em_cycle(p["t_table"], p["obs"], p["t_nb"], DELTA,
                               sample_param=sample_param)
    n_slots = tm.n_slots(p["t_nb"], DELTA)
    n_top = p["nb"].pk.shape[1]
    cur_j = jm.explode_genome(p["state"])
    cur_t = to_port(cur_j)
    l_j = jl.log_likelihood(cur_j, p["table"], p["obs"], p["params"])
    l_t = tl.log_likelihood(cur_t, p["t_table"], torch.as_tensor(p["obs"]),
                            p["t_params"])
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=RTOL)
    par_j, par_t = p["params"], p["t_params"]
    rng = np.random.default_rng(17)
    key = jax.random.key(21)
    for c in range(2):
        key, k_cycle = jax.random.split(key)
        order = rng.permutation(n).astype(np.int32)
        cur_j, par_j, l_j, m_j = cycle_j(cur_j, k_cycle, par_j, jnp.asarray(order),
                                         l_j, jnp.float32(1.0))
        draws = port_draws(jax_cycle_draws(k_cycle, n, n_top, n_slots))
        cur_t, par_t, l_t, m_t = cycle_t(cur_t, draws, par_t, torch.as_tensor(order),
                                         l_t, 1.0)
        np.testing.assert_array_equal(m_t.op_sampled.numpy(),
                                      np.asarray(m_j.op_sampled), err_msg=f"cycle {c}")
        np.testing.assert_array_equal(m_t.id_f_sampled.numpy(),
                                      np.asarray(m_j.id_f_sampled))
        np.testing.assert_array_equal(m_t.n_contigs.numpy(), np.asarray(m_j.n_contigs))
        np.testing.assert_array_equal(m_t.success.numpy(), np.asarray(m_j.success))
        assert_states_equal(cur_t, cur_j, f"cycle {c}")
        np.testing.assert_allclose(m_t.likelihood.numpy(), np.asarray(m_j.likelihood),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(l_t), float(l_j), rtol=RTOL)
        assert_params_close(par_t, par_j)
    check_invariants(cur_t)


def test_replay_of_jax_run(problem):
    """A JAX run's mutation log replayed through the port's apply_mutation
    reproduces the JAX states step by step."""
    p = problem
    n = p["state"].n_frags
    cycle_j = jm.make_em_cycle(p["table"], p["obs"], p["nb"], DELTA,
                               sample_param=False)
    start = jm.explode_genome(p["state"])
    l0 = jl.log_likelihood(start, p["table"], p["obs"], p["params"])
    order = jnp.asarray(np.random.default_rng(4).permutation(n).astype(np.int32))
    final_j, _, _, m = cycle_j(start, jax.random.key(8), p["params"], order, l0,
                               jnp.float32(1.0))
    cur = to_port(start)
    for f_a, f_b, op in zip(np.asarray(m.id_f_a), np.asarray(m.id_f_sampled),
                            np.asarray(m.op_sampled)):
        if op >= 0:
            cur = tm.apply_mutation(cur, int(f_a), int(f_b), int(op))
    assert_states_equal(cur, final_j)


def test_explode_genome_matches():
    js = make_random_state(np.random.default_rng(6), 18, 4, with_circ=True)
    assert_states_equal(tm.explode_genome(to_port(js)), jm.explode_genome(js))
    batch = TState(*[torch.stack([x, x]) for x in to_port(js)])
    out = tm.explode_genome(batch)
    assert_states_equal(TState(*[x[1] for x in out]), jm.explode_genome(js))


def test_generator_driven_cycle_is_deterministic(problem):
    p = problem
    n = p["state"].n_frags
    cycle = tm.make_em_cycle(p["t_table"], p["obs"], p["t_nb"], DELTA)
    start = tm.explode_genome(to_port(p["state"]))
    l0 = tl.log_likelihood(start, p["t_table"], torch.as_tensor(p["obs"]),
                           p["t_params"])
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(3)
        order = torch.randperm(n, generator=gen)
        outs.append(cycle(start, gen, p["t_params"], order, l0, 1.0))
    for a, b in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a, b)
    assert torch.equal(outs[0][2], outs[1][2])
    check_invariants(outs[0][0])
