"""The step kernels' public functions (D1-D3) against the JAX package.

On a card the neighbour draw (``core.mcmc.sample_neighbours``, D2), the
selection and commit of the dense and delta steps
(``core.mcmc.select_commit_dense``, ``core.delta.select_commit_delta``, D3)
and the nuisance move (``core.mcmc.nuisance_propose`` /
``nuisance_accept``, D1) run on the kernels of ``csrc/step.cu``
(``ops.step_cuda.STEP``); elsewhere on their plain versions. Here, on the
CPU, the public functions take the plain versions through that dispatch
and are held to ``graal_tpu.core.mcmc`` / ``graal_tpu.core.delta`` on
shared draws (the uniforms, Gumbel noise and nuisance draws split from the
JAX keys), with inputs made from numpy seeds: ids, valid masks, slots and
states bit for bit; parameters at ``tests/test_torch_mcmc.py``'s rtol 1e-5
(f32 transcendentals differ by ulps between XLA-CPU and torch). Cases:
max_copies 1, 3 and 16, a blacklist and -inf ties in the draw; the tails'
all-overflow no-op, blacklisted fA and a chains axis with per-chain f_t;
every id_modif, the d_max cap, per-chain parameters, accept and reject.

Also: the wrapper's argument checks as pure functions on CPU tensors, its
refusal of CPU tensors, the card branch of each public function driven
through a stand-in wrapper (the plain versions behind the wrapper's own
checks) and the distinct-rows contract the delta commit relies on. The
cycles run again through the new dispatch against the JAX cycles are in
``tests/test_torch_step_cycles.py`` (each file one tier-1 worker's minute:
the JAX cycles' compiles take most of that one's). The kernels
themselves run only on a card (``chip_smoke.py`` phase 3d).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graal_tpu.core import candidates as jc
from graal_tpu.core import delta as jd
from graal_tpu.core import mcmc as jm
from graal_tpu.core import sparse as js
from graal_tpu.core.model import RippeParams as JParams
from graal_tpu.core.state import GenomeState as JState
from graal_tpu.utils.synthetic import (bin_level_matrix, default_params, make_genome,
                                       simulate_contacts)
from graal_tpu_torch import convert
from graal_tpu_torch.core import delta as td
from graal_tpu_torch.core import mcmc as tm
from graal_tpu_torch.core.candidates import build_candidates_plain
from graal_tpu_torch.core.model import RippeParams
from graal_tpu_torch.core.state import GenomeState as TState
from graal_tpu_torch.ops import step_cuda as sc
from graal_tpu_torch.ops.likelihood_cuda import params_vector
from tests.conftest import make_random_state
from tests.test_torch_delta import walked_state
from tests.test_torch_mcmc import RTOL
from tests.test_torch_state import assert_states_equal, to_port

DELTA = 4
N_OPS = 13
THRESH = jm.THRESH_OVERFLOW


def t(x):
    return torch.as_tensor(np.array(x))


def params_close(tp, jp, msg=""):
    """Parameter sets of any shape equal at RTOL, field by field."""
    for f in jp._fields:
        np.testing.assert_allclose(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)),
                                   rtol=RTOL, err_msg=f"{f} {msg}")


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


# ---- D2: the neighbour draw ----------------------------------------------------

def copy_problem(rng, extra):
    """A genome over 20 bins with ``extra`` ({bin: extra copies}) repeat
    copies, its bin matrix (row 3 with one partner: -inf ties in the top-k;
    row 5 contact-free) and rep flags on every fragment of a multi-copy
    bin."""
    n_bins = 20
    id_d = np.concatenate([np.arange(n_bins),
                           np.repeat(list(extra), list(extra.values()))]).astype(np.int32)
    n = len(id_d)
    m = rng.poisson(1.0, (n_bins, n_bins)).astype(np.float32)
    m = np.triu(m, 1) + np.triu(m, 1).T
    m[3, :] = m[:, 3] = 0.0
    m[3, 8] = m[8, 3] = 5.0
    m[5, :] = m[:, 5] = 0.0
    counts = np.bincount(id_d, minlength=n_bins)
    state = make_random_state(rng, n, 4)._replace(
        id_d=jnp.asarray(id_d), rep=jnp.asarray((counts[id_d] > 1).astype(np.int32)))
    return state, m, id_d, n


@pytest.mark.parametrize("extra,max_copies", [({}, 1), ({4: 2, 9: 1}, 3),
                                              ({7: 15, 2: 3}, 16)])
def test_sample_neighbours_matches_jax(extra, max_copies):
    rng = np.random.default_rng(len(extra) + max_copies)
    js_, m, id_d, n = copy_problem(rng, extra)
    nb = jm.build_neighbour_table(m, id_d, n, blacklisted=[2, n - 1, 11])
    assert nb.max_copies == max_copies
    tnb = convert.neighbour_table_from_numpy(nb._asdict())
    ts = to_port(js_)
    sample = _J_SAMPLE
    key = jax.random.key(max_copies)
    frags = list(range(n)) + [3, 5, n - 1]
    us, want = [], []
    for f_a in frags:
        key, sub = jax.random.split(key)
        want_ids, want_valid = sample(sub, jnp.int32(f_a), js_, nb, delta=DELTA)
        u = t(jax.random.uniform(sub, (nb.pk.shape[1],)))
        ids, valid = tm.sample_neighbours(u, torch.tensor(f_a), ts, tnb, DELTA)
        assert ids.dtype == torch.int32 and valid.dtype == torch.bool
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids), err_msg=f"f_a={f_a}")
        np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
        us.append(u)
        want.append((np.asarray(want_ids), np.asarray(want_valid)))
    # the chains axis: every draw at once, one chain each
    chains = TState(*[x.expand(len(frags), n) for x in ts])
    ids, valid = tm.sample_neighbours(torch.stack(us), torch.tensor(frags), chains, tnb, DELTA)
    np.testing.assert_array_equal(ids.numpy(), np.stack([w[0] for w in want]))
    np.testing.assert_array_equal(valid.numpy(), np.stack([w[1] for w in want]))
    assert ids.shape[1] == (DELTA + 1) * max_copies


# ---- D3: the dense step's selection and commit --------------------------------

@jax.jit
def jax_dense_tail(k_sel, state, cands, ll, ids, valid, f_a, f_t, blacklist):
    """The tail of graal_tpu/core/mcmc.py's EM step (its lines 244-260)."""
    sel = jm.select_score_slot(k_sel, ll, valid, f_t)
    sel_nb, sel_op = sel // N_OPS, sel % N_OPS
    new = jax.tree.map(lambda x: x[sel_nb, sel_op], cands)
    skip = blacklist[f_a]
    new = JState(*[jnp.where(skip, a, b) for a, b in zip(state, new)])
    return new, (jnp.where(skip, -jnp.inf, ll.reshape(-1)[sel]), jnp.where(skip, -1, sel_op),
                 jnp.where(skip, f_a, ids[sel_nb])), sel


_J_CANDS = jax.jit(jax.vmap(jc.build_candidates, in_axes=(None, None, 0)))
_J_SAMPLE = jax.jit(jm.sample_neighbours, static_argnames=("delta",))


def dense_case(p, rng, key, f_a, state, spread):
    """One step's tail inputs on ``state``: neighbours drawn as the EM step
    draws them, the JAX catalogue, scores around -1000 with ``spread``."""
    k_nb, k_sel = jax.random.split(key)
    ids_j, valid_j = _J_SAMPLE(k_nb, jnp.int32(f_a), state, p["nb"], delta=DELTA)
    cands = _J_CANDS(state, jnp.int32(f_a), ids_j)
    m = ids_j.shape[0]
    ll = rng.normal(-1000.0, spread, (m, N_OPS)).astype(np.float32)
    ll[rng.random((m, N_OPS)) < 0.2] -= 50.0          # outside the window
    return k_sel, ids_j, valid_j, cands, ll


def test_select_commit_dense_matches_jax(dense):
    p = dense
    rng = np.random.default_rng(3)
    key = jax.random.key(13)
    blacklist = np.asarray(p["nb"].blacklist).copy()
    cur = jm.explode_genome(p["state"])
    states = [cur, p["state"], walked_state(p["state"], seed=1)]
    tbl = torch.as_tensor(blacklist)
    rows = []
    for i, (f_a, spread, f_t) in enumerate(((0, 0.5, 1.0), (5, 5.0, 0.4), (13, 5.0, 2.5),
                                           (7, 50.0, 1.0), (20, 2.0, 0.7), (1, 0.0, 1.0))):
        st = states[i % 3]
        key, sub = jax.random.split(key)
        k_sel, ids_j, valid_j, cands, ll = dense_case(p, rng, sub, f_a, st, spread)
        want = jax_dense_tail(k_sel, st, cands, jnp.asarray(ll), ids_j, valid_j, jnp.int32(f_a),
                              jnp.float32(f_t), jnp.asarray(blacklist))
        m = ids_j.shape[0]
        gum = t(jax.random.gumbel(k_sel, (m * N_OPS,)))
        flat = TState(*[t(x).reshape(m * N_OPS, -1) for x in cands])
        ft = f_t if i % 2 else torch.tensor(np.float32(f_t))   # a float and a tensor
        new, (score, op, fb), sel = tm.select_commit_dense(
            to_port(st), flat, torch.as_tensor(ll), t(ids_j), t(valid_j),
            torch.tensor(f_a), gum, ft, tbl, THRESH)
        msg = f"case {i}, f_a={f_a}"
        assert_states_equal(new, want[0], msg)
        assert (float(score), int(op), int(fb), int(sel)) == \
            (float(want[1][0]), int(want[1][1]), int(want[1][2]), int(want[2])), msg
        assert (score.dtype, op.dtype, fb.dtype, sel.dtype) == \
            (torch.float32, torch.int64, torch.int64, torch.int64)
        if f_a == 5:
            assert int(op) == -1 and float(score) == -np.inf
        rows.append((to_port(st), flat, ll, t(ids_j), t(valid_j), f_a, gum, f_t, want))
    # a chains axis with per-chain f_t: one call, each chain as it went alone
    c = len(rows)
    new, (score, op, fb), sel = tm.select_commit_dense(
        TState(*[torch.stack(xs) for xs in zip(*[r[0] for r in rows])]),
        TState(*[torch.cat(xs) for xs in zip(*[r[1] for r in rows])]),
        torch.as_tensor(np.stack([r[2] for r in rows])), torch.stack([r[3] for r in rows]),
        torch.stack([r[4] for r in rows]), torch.tensor([r[5] for r in rows]),
        torch.stack([r[6] for r in rows]), torch.tensor([r[7] for r in rows],
                                                        dtype=torch.float32), tbl, THRESH)
    for k in range(c):
        want = rows[k][-1]
        assert_states_equal(TState(*[x[k] for x in new]), want[0], f"chain {k}")
        assert (float(score[k]), int(op[k]), int(fb[k]), int(sel[k])) == \
            (float(want[1][0]), int(want[1][1]), int(want[1][2]), int(want[2])), f"chain {k}"


# ---- D3: the delta step's selection and commit --------------------------------

@jax.jit
def jax_delta_tail(k_sel, state, minis, rows, rows_valid, dll, ids, valid, overflow, f_a, f_t,
                   blacklist):
    """The tail of graal_tpu/core/delta.py's delta EM step (its lines
    806-840)."""
    m = ids.shape[0]
    slot_ok = jnp.broadcast_to(~overflow[:, None], (m, N_OPS))
    sel = jm.select_score_slot(k_sel, dll, valid, f_t, slot_valid=slot_ok)
    sel_nb, sel_op = sel // N_OPS, sel % N_OPS
    sel_mini = jax.tree.map(lambda x: x[sel_nb, sel_op], minis)
    new = jd.scatter_mini(state, sel_mini, rows[sel_nb], rows_valid[sel_nb])
    op_idx = jnp.arange(N_OPS)[None, :]
    nb_idx = jnp.arange(m)[:, None]
    base_ok = (valid[:, None] | ((nb_idx == 0) & (op_idx < 2))) & ~((op_idx < 2) & (nb_idx > 0))
    skip = blacklist[f_a] | ~jnp.any(base_ok & slot_ok)
    new = JState(*[jnp.where(skip, a, b) for a, b in zip(state, new)])
    return new, jnp.where(skip, 0.0, dll.reshape(-1)[sel]), (
        jnp.where(skip, -1, sel_op), jnp.where(skip, f_a, ids[sel_nb]), jnp.sum(overflow)), sel


def delta_inputs(p, f_max, frags, seed):
    """A chains step's tail inputs from the port's delta engine: one walked
    genome a chain, each chain's f_a, its neighbours and member rows at
    ``f_max``, the scored candidates."""
    rng = np.random.default_rng(seed)
    states = TState(*[torch.stack(xs) for xs in zip(*[
        to_port(walked_state(p["state"], seed=seed + k)) for k in range(len(frags))])])
    f_a = torch.tensor(frags)
    u = torch.as_tensor(rng.random((len(frags), p["nb"].pk.shape[1]), dtype=np.float32))
    ids, valid = tm.sample_neighbours(u, f_a, states, p["t_nb"], DELTA)
    scorer = td.make_delta_scorer(p["t_table"], None, f_max, sobs=p["t_sobs"])
    rows, rvalid, over = td.extract_rows_union(states, f_a, ids, scorer.f_max)
    dll, minis, rows, rows_valid, overflow = scorer.score(
        states, f_a, ids, rows, rvalid, over, p["t_params"], states.id_c.amax(-1))
    return states, f_a, ids, valid, dll, minis, rows, rows_valid, overflow


@pytest.mark.parametrize("case", ["overflowing", "all_overflow", "blacklisted"])
def test_select_commit_delta_matches_jax(sparse, case):
    p = sparse
    states, f_a, ids, valid, dll, minis, rows, rows_valid, overflow = delta_inputs(
        p, 8, [0, 13, 30], seed=5)
    blacklist = p["t_nb"].blacklist.clone()
    if case == "all_overflow":
        overflow = torch.ones_like(overflow)
    if case == "blacklisted":
        blacklist[13] = True
    if case == "overflowing":
        assert overflow.any() and not overflow.all()
    c, m = ids.shape
    keys = jax.random.split(jax.random.key(17), c)
    gum = torch.stack([t(jax.random.gumbel(k, (m * N_OPS,))) for k in keys])
    f_t = torch.tensor([1.0, 0.5, 3.0])
    new, d_sel, (op, fb, n_over), sel = td.select_commit_delta(
        states, minis, rows, rows_valid, dll, ids, valid, overflow, f_a, gum, f_t, blacklist,
        THRESH)
    assert (d_sel.dtype, op.dtype, fb.dtype, n_over.dtype, sel.dtype) == \
        (torch.float32, torch.int64, torch.int64, torch.int64, torch.int64)
    for k in range(c):
        st = JState(*[jnp.asarray(x[k].numpy()) for x in states])
        want = jax_delta_tail(keys[k], st, JState(*[jnp.asarray(x[k].numpy()) for x in minis]),
                              jnp.asarray(rows[k].numpy().astype(np.int32)),
                              jnp.asarray(rows_valid[k].numpy()), jnp.asarray(dll[k].numpy()),
                              jnp.asarray(ids[k].numpy()), jnp.asarray(valid[k].numpy()),
                              jnp.asarray(overflow[k].numpy()), jnp.int32(int(f_a[k])),
                              jnp.float32(float(f_t[k])), jnp.asarray(blacklist.numpy()))
        msg = f"{case}, chain {k}"
        assert_states_equal(TState(*[x[k] for x in new]), want[0], msg)
        assert (float(d_sel[k]), int(op[k]), int(fb[k]), int(n_over[k]), int(sel[k])) == \
            (float(want[1]), int(want[2][0]), int(want[2][1]), int(want[2][2]),
             int(want[3])), msg
    if case == "all_overflow":
        assert (op == -1).all() and (d_sel == 0).all()
        assert all(torch.equal(a, b) for a, b in zip(new, states))
    if case == "blacklisted":
        assert int(op[1]) == -1 and int(fb[1]) == 13


def test_delta_rows_are_distinct():
    """The contract the delta commit relies on (each chain's valid member
    rows of a neighbour slot are distinct, so no two writes collide):
    extract_rows_union and extract_rows_each on random genomes, chains
    axis, member sets larger and smaller than f_max."""
    rng = np.random.default_rng(8)
    for trial in range(6):
        n = 40
        states = TState(*[torch.stack(xs) for xs in zip(*[
            to_port(make_random_state(rng, n, int(rng.integers(2, 9)))) for _ in range(3)])])
        f_a = torch.as_tensor(rng.integers(0, n, 3))
        ids = torch.as_tensor(rng.integers(0, n, (3, 6)), dtype=torch.int32)
        for f_max in (4, 16, 40):
            for extract in (td.extract_rows_union, td.extract_rows_each):
                rows, valid, _ = extract(states, f_a, ids, f_max)
                for k in range(3):
                    for j in range(ids.shape[1]):
                        got = rows[k, j][valid[k, j]]
                        assert got.unique().numel() == got.numel(), \
                            f"{extract.__name__} trial {trial} f_max {f_max} chain {k} slot {j}"


# ---- D1: the nuisance move -----------------------------------------------------

def chain_params(params, c):
    """C parameter sets around ``params`` (JAX and port), each chain's own."""
    k = np.arange(c, dtype=np.float32)
    vals = dict(fact=params.fact * (1.0 + 0.25 * k), slope=params.slope + 0.02 * (k % 5),
                d_max=params.d_max * (1.0 + 0.1 * (k % 3)), v_inter=params.v_inter * (1 + 0.2 * k))
    jp = JParams(**{f: jnp.asarray(np.broadcast_to(np.float32(vals.get(f, getattr(params, f))),
                                                   (c,)).copy()) for f in JParams._fields})
    return jp, RippeParams(*[t(x) for x in jp])


_J_PROPOSE = jax.jit(jax.vmap(jm.make_nuisance_proposer()))


@pytest.mark.parametrize("cap", [None, "median"])
def test_nuisance_move_matches_jax(dense, cap):
    """Per-chain parameters (C = 64: every id_modif many times), the cap at
    the median proposed d_max (a quarter of the proposals cut), then the
    Metropolis test with accepts and rejects, against the JAX proposer and
    accept under jax.vmap."""
    c = 64
    jp, tp = chain_params(dense["params"], c)
    keys = jax.random.split(jax.random.key(31), c)
    sub = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    idm = jax.vmap(lambda k: jax.random.randint(k, (), 0, 4))(sub[:, 0])
    eps = jax.vmap(lambda k: jax.random.normal(k, ()))(sub[:, 1])
    u = jax.vmap(lambda k: jax.random.uniform(k, ()))(sub[:, 2])
    assert set(np.asarray(idm).tolist()) == {0, 1, 2, 3}
    d_max_cap = None
    want, want_ok, _ = _J_PROPOSE(keys, jp)
    if cap == "median":
        d_max_cap = float(np.median(np.asarray(want.d_max)))
        want, want_ok, _ = jax.jit(jax.vmap(jm.make_nuisance_proposer(d_max_cap)))(keys, jp)
    log_nfpb = torch.tensor(np.float32(0.3))
    got, ok, row = tm.nuisance_propose(t(idm).long(), t(eps), tp, d_max_cap, log_nfpb)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    params_close(got, want)
    assert ok.dtype == torch.bool and row.shape == (c, 10)
    # (a negative test v_inter puts a NaN in the row: equal as NaN)
    np.testing.assert_array_equal(row.numpy(), params_vector(got, log_nfpb).numpy())
    if cap == "median":
        assert 0 < int(ok.sum()) < c
    # a single chain: one set, 0-d draws
    for k in range(8):
        one = RippeParams(*[x[k] for x in tp])
        g1, ok1, _ = tm.nuisance_propose(t(idm[k]).long(), t(eps[k]), one, d_max_cap)
        assert bool(ok1) == bool(want_ok[k]) and g1.fact.dim() == 0
        params_close(g1, JParams(*[x[k] for x in want]), f"chain {k}")
    # the Metropolis test: l_star around l_t, per-chain f_t
    rng = np.random.default_rng(2)
    l_t = np.full(c, -1000.0, np.float32)
    l_star = (l_t + rng.normal(0.0, 1.5, c)).astype(np.float32)
    f_t = np.linspace(0.5, 2.0, c).astype(np.float32)
    want_p, want_l, want_acc = jax.jit(jax.vmap(jm.nuisance_accept))(
        sub[:, 2], want, jp, jnp.asarray(l_star), jnp.asarray(l_t), jnp.asarray(f_t), want_ok)
    out, l_out, acc = tm.nuisance_accept(t(u), got, tp, torch.as_tensor(l_star),
                                         torch.as_tensor(l_t), torch.as_tensor(f_t), ok)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
    np.testing.assert_array_equal(l_out.numpy(), np.asarray(want_l))
    params_close(out, want_p)
    assert 0 < int(acc.sum()) < c


# ---- the wrapper: argument checks, CPU refusal, the card branches ---------------

def _nb(n_bins=6, n_top=3, mc=2, n=8):
    return tm.NeighbourTable(xk=torch.zeros((n_bins, n_top), dtype=torch.int32),
                             pk=torch.zeros((n_bins, n_top)),
                             dispatcher=torch.zeros((n_bins, mc), dtype=torch.int32),
                             blacklist=torch.zeros(n, dtype=torch.bool), n_bins=n_bins,
                             max_copies=mc)


def _params(c=None):
    shape = () if c is None else (c,)
    return RippeParams(*[torch.ones(shape) for _ in RippeParams._fields])


def test_checks_accept_what_the_kernels_take():
    c, (idm, s_idm), _, par = sc.check_propose(torch.zeros(4, dtype=torch.int64),
                                               torch.zeros(4), _params(), 5000.0,
                                               torch.tensor(0.1))
    assert c == 4 and s_idm == 1 and all(s == 0 for _, s in par)
    assert sc.check_propose(torch.tensor(2), torch.tensor(0.5), _params(), None)[0] == 1
    c, acc_shape, shapes, f = sc.check_accept(torch.zeros(3), _params(3), _params(), torch.zeros(3),
                                              torch.tensor(-1.0), 0.5,
                                              torch.ones(3, dtype=torch.bool))
    assert (c, tuple(acc_shape)) == (3, (3,)) and f["l_t"][1] == 0 and f["u"][1] == 1
    assert f["ft"] == (None, 0, float(np.float32(1.0) / np.float32(0.5)))
    state = TState(*[torch.zeros(8, dtype=torch.int32) for _ in TState._fields])
    out = sc.check_neighbours(torch.zeros(3), torch.tensor(1), state.id_d, state.rep, _nb(),
                              DELTA)
    assert out[:3] == (1, (3 + 1) * 2, 3)      # delta cut to n_top
    packed = torch.zeros((5, 8, 2), dtype=torch.int32)
    out = sc.check_neighbours(torch.zeros((5, 3)), torch.arange(5), packed[..., 0],
                              packed[..., 1], _nb(), 2)
    assert out[:3] == (5, 6, 2) and out[5][1:] == (16, 2)
    score, ids = torch.zeros((2, 3, N_OPS)), torch.zeros((2, 3), dtype=torch.int32)
    valid, fa = torch.zeros((2, 3), dtype=torch.bool), torch.zeros(2, dtype=torch.int64)
    bl = torch.zeros(8, dtype=torch.bool)
    assert sc.check_select(score, ids, valid, fa, torch.zeros(39), 1.0, bl)[:3] == (2, 3, 0)
    assert sc.check_select(score, ids, valid, fa, torch.zeros((2, 39)), torch.ones(2), bl,
                           valid)[:3] == (2, 3, 39)
    st = TState(*[torch.zeros((2, 8), dtype=torch.int32) for _ in TState._fields])
    cands = TState(*[torch.zeros((1, 39, 8), dtype=torch.int32).expand(2, 39, 8)
                     for _ in TState._fields])
    assert sc.check_dense(st, cands, 2, 3) == 8
    minis = {f: torch.zeros((2, 3, N_OPS, 4), dtype=torch.int32) for f in sc.MUTABLE}
    assert sc.check_delta(st._asdict(), minis, torch.zeros((2, 3, 4), dtype=torch.int64),
                          torch.zeros((2, 3, 4), dtype=torch.bool), 2, 3) == 4


def _bad(name):
    """(check function, arguments) with one thing wrong."""
    i64, meta = torch.int64, torch.empty(4, device="meta")
    z4 = torch.zeros(4, dtype=i64)
    st8 = TState(*[torch.zeros(8, dtype=torch.int32) for _ in TState._fields])
    score, ids = torch.zeros((2, 3, N_OPS)), torch.zeros((2, 3), dtype=torch.int32)
    valid, fa = torch.zeros((2, 3), dtype=torch.bool), torch.zeros(2, dtype=i64)
    bl, g = torch.zeros(8, dtype=torch.bool), torch.zeros(39)
    st = TState(*[torch.zeros((2, 8), dtype=torch.int32) for _ in TState._fields])
    cands = TState(*[torch.zeros((2, 39, 8), dtype=torch.int32) for _ in TState._fields])
    minis = {f: torch.zeros((2, 3, N_OPS, 4), dtype=torch.int32) for f in sc.MUTABLE}
    rows, rv = torch.zeros((2, 3, 4), dtype=i64), torch.zeros((2, 3, 4), dtype=torch.bool)
    bad_nb = _nb()._replace(pk=torch.zeros((3, 6)).t())
    return {
        "propose_idm_dtype": (sc.check_propose, (z4.int(), torch.zeros(4), _params())),
        "propose_idm_2d": (sc.check_propose, (z4[None], torch.zeros((1, 4)), _params())),
        "propose_eps_shape": (sc.check_propose, (z4, torch.zeros(3), _params())),
        "propose_param_count": (sc.check_propose, (z4, torch.zeros(4), _params()[:7])),
        "propose_param_dtype": (sc.check_propose, (z4, torch.zeros(4),
                                                   _params()._replace(d=torch.tensor(1.0).double()))),
        "propose_param_count_c": (sc.check_propose, (z4, torch.zeros(4), _params(3))),
        "propose_cap": (sc.check_propose, (z4, torch.zeros(4), _params(), "5")),
        "propose_nfpb": (sc.check_propose, (z4, torch.zeros(4), _params(), None, torch.zeros(2))),
        "propose_device": (sc.check_propose, (z4, torch.zeros(4), _params()._replace(fact=meta))),
        "accept_broadcast": (sc.check_accept, (torch.zeros(3), _params(), _params(),
                                               torch.zeros(4), torch.zeros(3), 1.0,
                                               torch.ones(3, dtype=torch.bool))),
        "accept_dtype": (sc.check_accept, (torch.zeros(3), _params(), _params(),
                                           torch.zeros(3).double(), torch.zeros(3), 1.0,
                                           torch.ones(3, dtype=torch.bool))),
        "accept_ok_dtype": (sc.check_accept, (torch.zeros(3), _params(), _params(),
                                              torch.zeros(3), torch.zeros(3), 1.0,
                                              torch.ones(3))),
        "accept_ft": (sc.check_accept, (torch.zeros(3), _params(), _params(), torch.zeros(3),
                                        torch.zeros(3), "1", torch.ones(3, dtype=torch.bool))),
        "accept_ft_dtype": (sc.check_accept, (torch.zeros(3), _params(), _params(),
                                              torch.zeros(3), torch.zeros(3),
                                              torch.ones(3).double(),
                                              torch.ones(3, dtype=torch.bool))),
        "nb_fa_dtype": (sc.check_neighbours, (torch.zeros(3), torch.tensor(1, dtype=torch.int32),
                                              st8.id_d, st8.rep, _nb(), 2)),
        "nb_u_shape": (sc.check_neighbours, (torch.zeros(4), torch.tensor(1), st8.id_d,
                                             st8.rep, _nb(), 2)),
        "nb_u_chains": (sc.check_neighbours, (torch.zeros((2, 3)), torch.tensor(1), st8.id_d,
                                              st8.rep, _nb(), 2)),
        "nb_id_d_dtype": (sc.check_neighbours, (torch.zeros(3), torch.tensor(1),
                                                st8.id_d.long(), st8.rep, _nb(), 2)),
        "nb_rows": (sc.check_neighbours, (torch.zeros((2, 3)), torch.arange(2), st.id_d[:1],
                                          st.rep[:1], _nb(), 2)),
        "nb_table": (sc.check_neighbours, (torch.zeros(3), torch.tensor(1), st8.id_d, st8.rep,
                                           bad_nb, 2)),
        "nb_blacklist": (sc.check_neighbours, (torch.zeros(3), torch.tensor(1), st8.id_d,
                                               st8.rep, _nb(n=9), 2)),
        "nb_delta": (sc.check_neighbours, (torch.zeros(3), torch.tensor(1), st8.id_d, st8.rep,
                                           _nb(), 0)),
        "select_score": (sc.check_select, (score[..., :12], ids, valid, fa, g, 1.0, bl)),
        "select_ids": (sc.check_select, (score, ids.long(), valid, fa, g, 1.0, bl)),
        "select_fa": (sc.check_select, (score, ids, valid, fa[:1], g, 1.0, bl)),
        "select_gumbel": (sc.check_select, (score, ids, valid, fa, g[:38], 1.0, bl)),
        "select_gumbel_stride": (sc.check_select, (score, ids, valid, fa,
                                                   torch.zeros((2, 78))[:, ::2], 1.0, bl)),
        "select_overflow": (sc.check_select, (score, ids, valid, fa, g, 1.0, bl, valid[:1])),
        "select_blacklist": (sc.check_select, (score, ids, valid, fa, g, 1.0, bl.int())),
        "select_ft": (sc.check_select, (score, ids, valid, fa, g, torch.ones(3), bl)),
        "dense_width": (sc.check_dense, (st, TState(*[x[:, :, :7] for x in cands]), 2, 3)),
        "dense_slots": (sc.check_dense, (st, TState(*[x[:, :38] for x in cands]), 2, 3)),
        "dense_dtype": (sc.check_dense, (st._replace(ori=st.ori.long()), cands, 2, 3)),
        "dense_fields": (sc.check_dense, (st[:10], cands, 2, 3)),
        "delta_rows_dtype": (sc.check_delta, (st._asdict(), minis, rows.int(), rv, 2, 3)),
        "delta_rows_stride": (sc.check_delta, (st._asdict(), minis,
                                               torch.zeros((2, 3, 8), dtype=i64)[..., ::2], rv,
                                               2, 3)),
        "delta_mini_shape": (sc.check_delta, (st._asdict(), dict(minis, pos=minis["pos"][:, :2]),
                                              rows, rv, 2, 3)),
        "delta_dst": (sc.check_delta, (dict(st._asdict(), ori=st.ori[:1]), minis, rows, rv,
                                       2, 3)),
    }[name]


_BAD = ["propose_idm_dtype", "propose_idm_2d", "propose_eps_shape", "propose_param_count",
        "propose_param_dtype", "propose_param_count_c", "propose_cap", "propose_nfpb",
        "propose_device", "accept_broadcast", "accept_dtype", "accept_ok_dtype", "accept_ft",
        "accept_ft_dtype", "nb_fa_dtype", "nb_u_shape", "nb_u_chains", "nb_id_d_dtype",
        "nb_rows", "nb_table", "nb_blacklist", "nb_delta", "select_score", "select_ids",
        "select_fa", "select_gumbel", "select_gumbel_stride", "select_overflow",
        "select_blacklist", "select_ft", "dense_width", "dense_slots", "dense_dtype",
        "dense_fields", "delta_rows_dtype", "delta_rows_stride", "delta_mini_shape",
        "delta_dst"]


@pytest.mark.parametrize("name", _BAD)
def test_checks_refuse(name):
    fn, args = _bad(name)
    with pytest.raises(ValueError):
        fn(*args)


def test_wrapper_refuses_cpu_tensors():
    step = sc.StepKernels()
    st = TState(*[torch.zeros((1, 8), dtype=torch.int32) for _ in TState._fields])
    calls = [
        lambda: step.nuisance_propose(torch.zeros(2, dtype=torch.int64), torch.zeros(2),
                                      _params()),
        lambda: step.nuisance_accept(torch.zeros(1), _params(), _params(), torch.zeros(1),
                                     torch.zeros(1), 1.0, torch.ones(1, dtype=torch.bool)),
        lambda: step.neighbours(torch.zeros(3), torch.tensor(1), st.id_d[0], st.rep[0], _nb(), 2),
        lambda: step.select_dense(st, st, torch.zeros((1, 1, N_OPS)),
                                  torch.zeros((1, 1), dtype=torch.int32),
                                  torch.zeros((1, 1), dtype=torch.bool),
                                  torch.zeros(1, dtype=torch.int64), torch.zeros(13), 1.0,
                                  torch.zeros(8, dtype=torch.bool), THRESH),
        lambda: step.select_delta(st._asdict(), st._asdict(), None, None,
                                  torch.zeros((1, 1, N_OPS)), None, None, None, None, None,
                                  1.0, None, THRESH),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="card"):
            call()
    assert step.launches.by_key() == {}


class StandIn:
    """The wrapper's contract in plain torch: each method runs the wrapper's
    own argument check, then the plain version, and returns what the
    kernel's wrapper returns. Records the calls."""

    def __init__(self):
        self.calls = []

    def nuisance_propose(self, id_modif, eps, params, d_max_cap=None, log_nfpb=None):
        self.calls.append("nuisance_propose")
        sc.check_propose(id_modif, eps, params, d_max_cap, log_nfpb)
        test, ok, row = tm.nuisance_propose_plain(id_modif, eps, params, d_max_cap, log_nfpb)
        return (test.c1, test.slope, test.d_max, test.fact, test.v_inter), ok, row

    def nuisance_accept(self, u, test, params, l_star, l_t, f_t, in_support):
        self.calls.append("nuisance_accept")
        sc.check_accept(u, test, params, l_star, l_t, f_t, in_support)
        return tm.nuisance_accept_plain(u, test, params, l_star, l_t, f_t, in_support)

    def neighbours(self, u, f_a, id_d, rep, nb, delta):
        self.calls.append("neighbours")
        sc.check_neighbours(u, f_a, id_d, rep, nb, delta)
        state = TState(*[{"id_d": id_d, "rep": rep}.get(f, id_d) for f in TState._fields])
        return tm.sample_neighbours_plain(u, f_a, state, nb, delta)

    def select_dense(self, state, cands, score, ids, valid, f_a, gumbel, f_t, blacklist,
                     thresh):
        self.calls.append("select_dense")
        c, m = score.shape[:2]
        sc.check_select(score, ids, valid, f_a, gumbel, f_t, blacklist)
        sc.check_dense(state, cands, c, m)
        new, (s, op, fb), sel = tm.select_commit_dense_plain(
            state, TState(*[x.reshape(c * m * N_OPS, -1) for x in cands]), score, ids, valid,
            f_a, gumbel.expand(c, m * N_OPS), f_t, blacklist, thresh)
        return tuple(new), s, op, fb, sel

    def select_delta(self, dst, minis, rows, rows_valid, score, ids, valid, overflow, f_a,
                     gumbel, f_t, blacklist, thresh):
        self.calls.append("select_delta")
        c, m = score.shape[:2]
        sc.check_select(score, ids, valid, f_a, gumbel, f_t, blacklist, overflow)
        sc.check_delta(dst, minis, rows, rows_valid, c, m)
        new, d_sel, (op, fb, n_over), sel = td.select_commit_delta_plain(
            TState(**dst), TState(**minis), rows, rows_valid, score, ids, valid, overflow, f_a,
            gumbel, f_t, blacklist, thresh)
        for f in sc.MUTABLE:
            dst[f].copy_(getattr(new, f))
        return d_sel, op, fb, n_over, sel


def test_dispatch(dense, sparse, monkeypatch):
    """A CPU state never reaches the wrapper; the card branch of every
    public function (called directly) hands the wrapper what its checks
    accept, in the wrapper's chains-axis shapes, and gives the plain
    result bit for bit."""
    spy = StandIn()
    monkeypatch.setattr(tm, "STEP", spy)
    monkeypatch.setattr(td, "STEP", spy)
    p = dense
    rng = np.random.default_rng(4)
    ts = to_port(p["state"])
    u = torch.as_tensor(rng.random(p["nb"].pk.shape[1], dtype=np.float32))
    want = tm.sample_neighbours(u, torch.tensor(7), ts, p["t_nb"], DELTA)
    assert spy.calls == []
    got = tm._neighbours_on_card(u, torch.tensor(7), ts, p["t_nb"], DELTA)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the dense tail: one genome (0-d f_a) and a chains axis
    ids, valid = want
    m = ids.shape[0]
    flat = TState(*[x.reshape(m * N_OPS, -1) for x in
                    build_candidates_plain(ts, torch.tensor(7), ids)])
    ll = torch.as_tensor(rng.normal(-1000.0, 5.0, (m, N_OPS)).astype(np.float32))
    gum = torch.as_tensor(rng.gumbel(size=m * N_OPS).astype(np.float32))
    args = (ts, flat, ll, ids, valid, torch.tensor(7), gum, 0.6, p["t_nb"].blacklist, THRESH)
    want = tm.select_commit_dense(*args)
    got = tm._dense_on_card(*args)
    chains = (TState(*[x.expand(2, -1) for x in ts]), TState(*[torch.cat([x, x]) for x in flat]),
              ll.expand(2, m, N_OPS), ids.expand(2, m), valid.expand(2, m), torch.tensor([7, 7]),
              gum.expand(2, -1), torch.tensor([0.6, 0.6]), p["t_nb"].blacklist, THRESH)
    got_c = tm._dense_on_card(*chains)
    assert spy.calls == ["neighbours", "select_dense", "select_dense"]
    for g in (got, tuple(tuple(x[1] for x in part) if isinstance(part, tuple) else part[1]
                         for part in got_c)):
        assert all(torch.equal(a, b) for a, b in zip(g[0], want[0]))
        assert all(torch.equal(a, b) for a, b in zip(g[1], want[1]))
        assert torch.equal(g[2], want[2])
    # the nuisance move
    spy.calls.clear()
    par = p["t_params"]
    for k, (idm, e) in enumerate(((0, 0.3), (1, -0.7), (2, 1.1), (3, 0.2))):
        args = (torch.tensor(idm), torch.tensor(np.float32(e)), par, 900.0, torch.tensor(0.2))
        want = tm.nuisance_propose(*args)
        got = tm._propose_on_card(*args)
        assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        acc_args = (torch.tensor(0.4), got[0], par, torch.tensor(-999.0), torch.tensor(-1000.0),
                    0.8, got[1])
        want = tm.nuisance_accept(*acc_args)
        got = tm._accept_on_card(*acc_args)
        assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert spy.calls == ["nuisance_propose", "nuisance_accept"] * 4
    # the delta tail, into a copy and in place
    spy.calls.clear()
    states, f_a, ids, valid, dll, minis, rows, rows_valid, overflow = delta_inputs(
        sparse, 8, [0, 13, 30], seed=6)
    gum = torch.as_tensor(rng.gumbel(size=(3, ids.shape[1] * N_OPS)).astype(np.float32))
    args = (minis, rows, rows_valid, dll, ids, valid, overflow, f_a, gum, 1.0,
            sparse["t_nb"].blacklist, THRESH)
    want = td.select_commit_delta(states, *args)
    before = TState(*[x.clone() for x in states])
    got = td._delta_on_card(states, *args, False)
    assert all(torch.equal(a, b) for a, b in zip(states, before))   # a copy
    carry = TState(*[x.clone() for x in states])
    got_in = td._delta_on_card(carry, *args, True)
    assert got_in[0] is carry                                        # in place
    for g in (got, got_in):
        assert all(torch.equal(a, b) for a, b in zip(g[0], want[0]))
        assert torch.equal(g[1], want[1]) and torch.equal(g[3], want[3])
        assert all(torch.equal(a, b) for a, b in zip(g[2], want[2]))
    assert spy.calls == ["select_delta"] * 2
