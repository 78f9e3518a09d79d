"""The delta engine on a chains axis, against single-chain steps and JAX.

- ``core.delta.make_delta_em_step`` with a leading chains axis (states
  (C, n), one parameter set per chain, a ladder of temperatures) equals C
  single-chain steps on the same draws: states bit for bit, the deltas and
  decisions equal; repeat-free (one B4 and one B2 call a step for all
  chains, M = C x slots) and repeat (the v2 engine, its copy corrections
  chain by chain). Parameters reach B2's plain version as one (M, 10)
  row per neighbour slot (shared parameters as equal rows); a (10,)
  vector gives the same bits as the same vector broadcast to (M, 10) in
  B2's plain version, and shared parameters give those of equal
  per-chain ones in the banded expected-mass path.
- One chunk of the JAX package's ``make_sharded_delta_cycle`` on a 1 x 1
  mesh with ``per_chain_params=True`` and the port's chains-axis cycle, on
  the draws the JAX keys give each chain: states bit for bit, carried
  likelihoods at rtol 1e-5.
- The chains' sparse anchor (``core.sparse.make_sparse_loglik`` on a
  chains axis with per-chain params) against JAX ``jax.vmap(anchor)``,
  repeat-free and repeat, at the tolerance of tests/test_torch_scale.py
  (rtol 1e-6, atol 1), and equal to the single-genome anchor chain by
  chain.
- The nuisance proposer on a chains axis equals each chain's own
  proposal, and ``pt_swap`` moves a plain tuple (genomes, per-chain
  params) as the JAX ``pt_swap`` does (the fault of ROADMAP section C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graal_tpu import scale as jscale
from graal_tpu.core import mcmc as jm
from graal_tpu.core import sparse as js
from graal_tpu.core.model import RippeParams as JParams
from graal_tpu.core.state import GenomeState as JState
from graal_tpu.parallel import tempering as jtemp
from graal_tpu.parallel.sharding import make_mesh as j_make_mesh
from graal_tpu.parallel.sharding import make_sharded_delta_cycle as j_sharded_cycle
from graal_tpu.utils import synthetic_sparse as jss
from graal_tpu_torch import entry as tentry
from graal_tpu_torch import scale as tscale
from graal_tpu_torch.core import delta as td
from graal_tpu_torch.core import mcmc as tm
from graal_tpu_torch.core import sparse as ts
from graal_tpu_torch.core.model import RippeParams
from graal_tpu_torch.core.state import GenomeState, check_invariants
from graal_tpu_torch.ops import mini_grid_cuda
from graal_tpu_torch.parallel import tempering as ttemp
from tests.test_torch_delta import jax_delta_draws
from tests.test_torch_state import assert_states_equal, to_port

DELTA = 4
C = 3
LL_RTOL = 1e-5


def chain_params(params, scales=(1.0, 1.01, 0.99)):
    return RippeParams(*[torch.stack([x * s for s in scales]) for x in params])


def stack_states(states):
    return GenomeState(*[torch.stack(xs) for xs in zip(*states)])


def chain(x, c):
    return type(x)(*[y[c] for y in x])


@pytest.fixture(scope="module")
def problem():
    truth, shuf, table, params, sobs = tentry.scale_problem(
        200, n_contigs=2, n_pieces=10, seed=41, shuffle_seed=42, device="cpu")
    runner = tscale.ScaleRunner(table, sobs, params)
    starts = stack_states([shuf, tm.explode_genome(shuf), truth])
    return dict(truth=truth, shuf=shuf, table=table, params=params, sobs=sobs,
                runner=runner, starts=starts)


@pytest.fixture(scope="module")
def repeat_problem():
    truth, shuf, table, params, sobs, id_d = tentry.scale_repeat_problem(
        240, n_dups=6, device="cpu")
    runner = tscale.ScaleRunner(table, sobs, params, id_d=id_d)
    starts = stack_states([shuf, tm.explode_genome(shuf), shuf])
    return dict(truth=truth, shuf=shuf, table=table, params=params, sobs=sobs,
                runner=runner, starts=starts)


def check_steps_equal_single(step, states, nb, params_c, n_frags, n_steps, seed):
    """``n_steps`` chains-axis steps, each held to C single-chain steps on
    the chain's slice of the same draws. Returns the final states and the
    ops of every step."""
    gen = torch.Generator().manual_seed(seed)
    ladder = torch.tensor([1.0, 2.0, 4.0])
    ops = []
    for it in range(n_steps):
        draws = ttemp.draw_chain_inputs(gen, nb, DELTA, C)
        f_a = torch.randint(0, n_frags, (C,), generator=gen)
        new, l_new, outs = step(states, draws, params_c, torch.zeros(C), f_a, ladder)
        for c in range(C):
            one = step(chain(states, c), tm.StepDraws(draws.u_nb[c], draws.gumbel[c], None,
                                                       None, None),
                       chain(params_c, c), torch.zeros(()), f_a[c], float(ladder[c]))
            for a, b in zip(new, one[0]):
                assert torch.equal(a[c], b), (it, c)
            assert torch.equal(l_new[c], one[1]), (it, c, l_new[c], one[1])
            for a, b in zip(outs, one[2]):
                assert torch.equal(a[c], b), (it, c)
        ops.append(outs[0])
        states = new
    for c in range(C):
        check_invariants(chain(states, c))
    return states, torch.stack(ops)


def test_chains_step_equals_single_chain_steps(problem):
    p = problem
    r = p["runner"]
    step = td.make_delta_em_step(p["table"], None, r.nb, DELTA, 64, sobs=p["sobs"],
                                 obs_grid=r.obs_grid, mini_grid=r.mini_grid)
    states, ops = check_steps_equal_single(step, p["starts"], r.nb, chain_params(p["params"]),
                                           p["shuf"].n_frags, 8, seed=3)
    assert (ops[:, :2] >= 0).any(), "no chain committed a move"
    assert not torch.equal(states.id_c[0], states.id_c[1])


def test_repeat_chains_step_equals_single_chain_steps(repeat_problem):
    p = repeat_problem
    r = p["runner"]
    step = td.make_delta_em_step(p["table"], None, r.nb, DELTA, 64, sobs=p["sobs"],
                                 rep=p["shuf"].rep)
    _, ops = check_steps_equal_single(step, p["starts"], r.nb, chain_params(p["params"]),
                                      p["shuf"].n_frags, 8, seed=5)
    assert (ops >= 0).sum() >= 4


def test_per_chain_params_reach_b2_as_rows(problem, monkeypatch):
    """One B2 call a step serves every chain, with an (M, 10) parameter
    matrix whose row m is slot m's chain's vector; shared params give
    every row the one vector."""
    p = problem
    seen = []
    plain = mini_grid_cuda.MiniGridScorer.plain

    def spy(self, *args):
        seen.append(args[-1])
        return plain(self, *args)

    monkeypatch.setattr(mini_grid_cuda.MiniGridScorer, "plain", spy)
    r = p["runner"]
    step = td.make_delta_em_step(p["table"], None, r.nb, DELTA, 64, sobs=p["sobs"])
    gen = torch.Generator().manual_seed(1)
    pc = chain_params(p["params"])
    draws = ttemp.draw_chain_inputs(gen, r.nb, DELTA, C)
    step(p["starts"], draws, pc, torch.zeros(C), torch.tensor([3, 50, 120]), 1.0)
    m = tm.n_slots(r.nb, DELTA) // 13
    assert len(seen) == 1 and seen[0].shape == (C * m, 10)
    from graal_tpu_torch.ops.likelihood_cuda import params_vector

    log_nfpb = td.make_delta_scorer(p["table"], None, 64, sobs=p["sobs"]).log_nfpb
    assert torch.equal(seen[0], params_vector(pc, log_nfpb).repeat_interleave(m, 0))
    seen.clear()
    step(p["starts"], draws, p["params"], torch.zeros(C), torch.tensor([3, 50, 120]), 1.0)
    assert len(seen) == 1 and torch.equal(
        seen[0], params_vector(p["params"], log_nfpb).expand(C * m, 10))


def test_b2_plain_shared_vector_equals_broadcast_rows(problem):
    """A (10,) parameter vector and the same vector on every row of (M, 10)
    give the same bits in B2's plain version; in the banded path shared
    params give the bits of per-chain params that are all equal."""
    p = problem
    r = p["runner"]
    sc = td.make_delta_scorer(p["table"], None, 64, sobs=p["sobs"], band_w=6)
    states = p["starts"]
    f_a = torch.tensor([3, 50, 120])
    ids, valid = tm.sample_neighbours(torch.rand(C, r.nb.pk.shape[1],
                                                 generator=torch.Generator().manual_seed(2)),
                                      f_a, states, r.nb, DELTA)
    rows, rvalid, _ = td.extract_rows_union(states, f_a, ids, sc.f_max)
    _, vec, ob, pvec = sc.inputs(states, f_a, ids, rows, rvalid, p["params"],
                                 states.id_c.amax(-1))
    one = pvec[0]
    assert pvec.shape == (vec.mid.shape[0], 10) and torch.equal(pvec, one.expand_as(pvec))
    args = td.DeltaScorer.mini_grid_args(vec, ob, pvec)
    for a, b in zip(mini_grid_cuda.mini_grid_plain(*args),
                    mini_grid_cuda.mini_grid_plain(*args[:-1], one)):
        assert torch.equal(a, b)
    over = torch.zeros(ids.shape, dtype=torch.bool)
    same = chain_params(p["params"], scales=(1.0, 1.0, 1.0))
    max_id = states.id_c.amax(-1)
    assert torch.equal(sc.score(states, f_a, ids, rows, rvalid, over, p["params"], max_id)[0],
                       sc.score(states, f_a, ids, rows, rvalid, over, same, max_id)[0])


def test_banded_chains_score_equals_single(problem):
    """The banded expected-mass path (band_w set literally) on a chains
    axis with per-chain params equals each chain scored alone."""
    p = problem
    r = p["runner"]
    sc = td.make_delta_scorer(p["table"], None, 64, sobs=p["sobs"], band_w=6)
    states, pc = p["starts"], chain_params(p["params"])
    f_a = torch.tensor([7, 77, 150])
    ids, valid = tm.sample_neighbours(torch.rand(C, r.nb.pk.shape[1],
                                                 generator=torch.Generator().manual_seed(4)),
                                      f_a, states, r.nb, DELTA)
    rows, rvalid, over = td.extract_rows_union(states, f_a, ids, sc.f_max)
    dll, cands, *_ = sc.score(states, f_a, ids, rows, rvalid, over, pc, states.id_c.amax(-1))
    for c in range(C):
        st = chain(states, c)
        r1, v1, o1 = td.extract_rows_union(st, f_a[c], ids[c], sc.f_max)
        assert torch.equal(r1, rows[c]) and torch.equal(o1, over[c])
        d1, c1, *_ = sc.score(st, f_a[c], ids[c], r1, v1, o1, chain(pc, c), st.id_c.amax())
        assert torch.equal(dll[c], d1)
        for a, b in zip(cands, c1):
            assert torch.equal(a[c], b)


def jax_problem():
    j_truth, j_table = jss.make_scale_genome(200, 2, seed=41)
    j_params = jss.scale_params()
    j_sobs = jss.simulate_sparse_contacts(j_truth, j_table, j_params, seed=41)
    j_shuf = jss.shuffle_genome(j_truth, 10, seed=42)
    return j_truth, j_shuf, j_table, j_params, j_sobs


def test_chains_cycle_matches_jax_sharded_delta_cycle(problem):
    """One chunk of the JAX chains cycle (1 x 1 mesh, per-chain params)
    and the port's chains-axis cycle on the draws the JAX keys give each
    chain."""
    p = problem
    j_truth, j_shuf, j_table, j_params, j_sobs = jax_problem()
    jr = jscale.ScaleRunner(j_table, j_sobs, j_params)
    f_max, n_steps = 64, 20
    mesh = j_make_mesh(n_chains=1, n_rows=1, devices=jax.devices()[:1])
    j_cycle = j_sharded_cycle(mesh, j_table, jr.nb, DELTA, f_max, sobs=j_sobs,
                              per_chain_params=True)
    scales = np.float32([1.0, 1.01, 0.99])
    j_states = JState(*[jnp.stack([a, b, c]) for a, b, c in zip(
        j_shuf, jax.jit(jm.explode_genome)(j_shuf), j_truth)])
    j_pc = JParams(*[jnp.asarray(np.float32(x) * scales) for x in j_params])
    local = jax.jit(js.make_sparse_loglik(j_table, j_sobs, jr.w))
    l0 = jnp.asarray([local(JState(*[x[c] for x in j_states]), JParams(*[x[c] for x in j_pc]))
                      for c in range(C)])
    ladder = jnp.asarray(jtemp.temperature_ladder(C, t_max=4.0))
    orders = np.stack([np.random.default_rng(c).permutation(200)[:n_steps]
                       for c in range(C)]).astype(np.int32)
    keys = jax.random.split(jax.random.key(8), C)
    j_out, j_l = j_cycle(j_states, keys, j_pc, jnp.asarray(orders), l0, ladder)

    r = p["runner"]
    n_top = r.nb.pk.shape[1]
    n_slots = tm.n_slots(r.nb, DELTA)
    per = [jax_delta_draws(keys[c], n_steps, n_top, n_slots) for c in range(C)]
    draws = ttemp.ChainDraws(torch.as_tensor(np.stack([np.array(u) for u, _ in per], 1)),
                             torch.as_tensor(np.stack([np.array(g) for _, g in per], 1)))
    t_states = stack_states([to_port(JState(*[x[c] for x in j_states])) for c in range(C)])
    t_pc = RippeParams(*[torch.as_tensor(np.array(x)) for x in j_pc])
    cycle = td.make_delta_em_cycle(p["table"], None, r.nb, DELTA, f_max, sobs=p["sobs"],
                                   anchor_fn=False, band_w=r.w)
    t_out, t_l, _ = cycle(t_states, draws, t_pc, torch.as_tensor(orders),
                          torch.as_tensor(np.asarray(l0)), torch.as_tensor(np.asarray(ladder)))
    assert_states_equal(t_out, j_out, "chains cycle")
    np.testing.assert_allclose(t_l.numpy(), np.asarray(j_l), rtol=LL_RTOL)
    assert not np.array_equal(np.asarray(j_out.id_c[0]), np.asarray(j_states.id_c[0]))


@pytest.mark.parametrize("repeats", [False, True], ids=["plain", "repeat"])
def test_chains_sparse_anchor_matches_jax_vmap(problem, repeat_problem, repeats):
    if repeats:
        base, base_table = jss.make_scale_genome(240, 4, seed=31)
        j_params = jss.scale_params()
        j_sobs = jss.simulate_sparse_contacts(base, base_table, j_params, seed=31)
        dup = tuple(int(b) for b in np.linspace(11, 240 - 17, 6).astype(int))
        j_truth, j_table, _ = jss.add_scale_repeats(base, base_table, dup)
        j_shuf = jss.shuffle_genome(j_truth, 8, seed=32)
        p = repeat_problem
    else:
        j_truth, j_shuf, j_table, j_params, j_sobs = jax_problem()
        p = problem
    w = p["runner"].w
    deact = j_shuf._replace(activ=j_shuf.activ.at[j_shuf.n_frags - 1].set(0 if repeats else 1))
    j_states = JState(*[jnp.stack(xs) for xs in zip(j_truth, j_shuf, deact)])
    scales = np.float32([1.0, 1.01, 0.99])
    j_pc = JParams(*[jnp.asarray(np.float32(x) * scales) for x in j_params])
    want = np.asarray(jax.jit(jax.vmap(js.make_sparse_loglik(j_table, j_sobs, w)))(
        j_states, j_pc))
    fn = ts.make_sparse_loglik(p["table"], p["sobs"], w)
    t_states = stack_states([to_port(JState(*[x[c] for x in j_states])) for c in range(C)])
    t_pc = RippeParams(*[torch.as_tensor(np.array(x)) for x in j_pc])
    got = fn(t_states, t_pc)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1.0)
    assert len(np.unique(want.round(2))) == C
    for c in range(C):   # each chain as the single-genome anchor gives it
        assert torch.equal(got[c], fn(chain(t_states, c), chain(t_pc, c)))


def test_nuisance_proposer_on_chains_equals_each_chain(problem):
    pc = chain_params(problem["params"], (1.0, 1.2, 0.8))
    id_modif = torch.tensor([0, 2, 3])
    eps = torch.tensor([0.3, -1.2, 0.7])
    test, ok, _ = tm.nuisance_propose(id_modif, eps, pc, d_max_cap=5000.0)
    u = torch.tensor([0.1, 0.5, 0.9])
    l_star, l_t, f_t = torch.tensor([-10.0, -12.0, -9.0]), torch.tensor([-11.0, -11.0, -11.0]), \
        torch.tensor([1.0, 2.0, 4.0])
    out, l_out, acc = tm.nuisance_accept(u, test, pc, l_star, l_t, f_t, ok)
    for c in range(C):
        t1, ok1, _ = tm.nuisance_propose(id_modif[c], eps[c], chain(pc, c), d_max_cap=5000.0)
        assert all(torch.equal(a[c], b) for a, b in zip(test, t1)) and torch.equal(ok[c], ok1)
        o1, l1, a1 = tm.nuisance_accept(u[c], t1, chain(pc, c), l_star[c], l_t[c], f_t[c], ok1)
        assert all(torch.equal(a[c], b) for a, b in zip(out, o1))
        assert torch.equal(l_out[c], l1) and torch.equal(acc[c], a1)


def test_pt_swap_moves_a_plain_tuple_like_jax(problem):
    """``pt_swap((genomes, params), ...)`` migrates both as a unit, as the
    JAX ``pt_swap`` does on any pytree (the port's gather raised on a
    plain tuple; ROADMAP section C)."""
    j_truth, j_shuf, _, j_params, _ = jax_problem()
    n = 4
    j_states = JState(*[jnp.stack([a] * 2 + [b] * 2) for a, b in zip(j_truth, j_shuf)])
    j_pc = JParams(*[jnp.asarray(np.float32(x) * np.float32([1.0, 1.1, 1.2, 1.3]))
                     for x in j_params])
    l_ts = jnp.asarray([-100.0, -90.0, -101.0, -80.0], jnp.float32)
    ladder = jnp.asarray(jtemp.temperature_ladder(n, t_max=4.0))
    key = jax.random.key(0)
    for parity in (0, 1):
        (js_, jp_), jl, jacc = jtemp.pt_swap((j_states, j_pc), l_ts, ladder, key, parity)
        u = torch.as_tensor(np.array(jax.random.uniform(key, (n - 1,))))
        t_states = stack_states([to_port(JState(*[x[c] for x in j_states])) for c in range(n)])
        t_pc = RippeParams(*[torch.as_tensor(np.array(x)) for x in j_pc])
        (ts_, tp_), tl, tacc = ttemp.pt_swap((t_states, t_pc), torch.as_tensor(np.asarray(l_ts)),
                                             torch.as_tensor(np.asarray(ladder)), u, parity)
        assert_states_equal(ts_, js_)
        for a, b in zip(tp_, jp_):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
