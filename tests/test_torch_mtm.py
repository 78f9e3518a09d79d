"""Parity of graal_tpu_torch.core.mtm (dense MTM / MH) with the JAX package.

- The MH catalogue (``mh_candidates``) is integer state algebra and must be
  bit-identical to the JAX one, on full genomes (circular contigs, fA ==
  fB, extremities) and on gathered mini-states with the whole genome's
  ``max_id`` (the delta engine's use).
- The jump table, ``_prev_next``, ``_impossibility_mask`` and
  ``_neighbour_set`` are equal to the JAX ones.
- The draw bridge: ``jax.random.categorical(k, logits)`` is
  ``argmax(jax.random.gumbel(k, shape) + logits)``, so a port step fed that
  Gumbel vector and the step's acceptance uniform (split from the JAX key
  as the JAX step splits it) must make the JAX step's decisions.
- Dense MTM and MH steps, ``corrected`` False and True, on shared draws:
  states bit-identical, accept flags equal, carried likelihoods at rtol
  1e-5 (f32 transcendentals of XLA-CPU and torch).

Cycles and the delta steps are in tests/test_torch_mtm_delta.py.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from graal_tpu.core import candidates as jc
from graal_tpu.core import delta as jd
from graal_tpu.core import likelihood as jl
from graal_tpu.core import mcmc as jm
from graal_tpu.core import mtm as jmtm
from graal_tpu.core.state import GenomeState as JState
from graal_tpu_torch import convert
from graal_tpu_torch.core import candidates as tc
from graal_tpu_torch.core import delta as td
from graal_tpu_torch.core import mtm as tmtm
from graal_tpu_torch.core.state import GenomeState as TState
from graal_tpu_torch.core.state import check_invariants
from tests.conftest import make_random_state
from tests.test_mcmc import make_problem
from tests.test_torch_state import assert_states_equal, to_port

LL_RTOL = 1e-5
DELTA = 4


def t(x):
    return torch.as_tensor(np.array(x))


def assert_batch_equal(port_batch, jax_batch, msg=""):
    """Port candidates (m, 13, n) against the JAX ones of each neighbour."""
    for k, want in enumerate(jax_batch):
        assert_states_equal(TState(*[x[k] for x in port_batch]), want, f"{msg} nb {k}")


@pytest.mark.parametrize("with_circ", [False, True])
def test_mh_candidates_match(with_circ):
    rng = np.random.default_rng(3 + with_circ)
    cand = jax.jit(jc.mh_candidates)
    for trial in range(6):
        js_ = make_random_state(rng, 20, 4, with_circ=with_circ)
        ts_ = to_port(js_)
        n = js_.n_frags
        f_a = int(rng.integers(n))
        fbs = np.concatenate([rng.integers(0, n, 5), [f_a]]).astype(np.int32)
        want = [cand(js_, jnp.int32(f_a), jnp.int32(fb)) for fb in fbs]
        got = tc.mh_candidates(ts_, f_a, torch.as_tensor(fbs))
        assert_batch_equal(got, want, f"trial {trial}")


def test_mh_candidates_on_mini_states_match():
    """Gathered mini-states with the whole genome's max_id: the delta
    engine's call, bit for bit (the translocations' fresh ids come from the
    mini's own maximum, as in the JAX package)."""
    rng = np.random.default_rng(7)
    cand = jax.jit(jc.mh_candidates)
    for trial in range(4):
        js_ = make_random_state(rng, 24, 5, with_circ=trial % 2 == 1)
        ts_ = to_port(js_)
        n = js_.n_frags
        f_a = int(rng.integers(n))
        fbs = rng.integers(0, n, 4).astype(np.int32)
        max_id = jnp.max(js_.id_c)
        rows, valid, _ = td.extract_rows_each(ts_, torch.tensor(f_a), torch.as_tensor(fbs), 16)
        minis, = td.drop_chain(td.gather_mini(*td.lift_chain(ts_, rows, valid)))
        lf_a = (rows == f_a).int().argmax(-1)
        lf_b = (rows == torch.as_tensor(fbs)[:, None]).int().argmax(-1)
        got = tc.mh_candidates(minis, lf_a, lf_b, max_id=torch.as_tensor(np.array(max_id)))
        for k, fb in enumerate(fbs):
            r, v, _ = jd.extract_rows(js_, jnp.int32(f_a), jnp.int32(fb), 16)
            np.testing.assert_array_equal(rows[k].numpy(), np.asarray(r))
            mini = jd.gather_mini(js_, r, v)
            want = cand(mini, jnp.argmax(r == f_a).astype(jnp.int32),
                        jnp.argmax(r == fb).astype(jnp.int32), max_id)
            assert_states_equal(TState(*[x[k] for x in got]), want, f"trial {trial} nb {k}")


def test_build_jump_table_equal():
    rng = np.random.default_rng(0)
    m = rng.poisson(2.0, (30, 30)).astype(np.float32)
    m = np.triu(m, 1) + np.triu(m, 1).T
    m[7] = 0.0                          # a contact-free row: padded partners
    m[:, 7] = 0.0
    norm = rng.uniform(0.5, 3.0, 30)
    id_d = np.concatenate([np.arange(30), [4, 4, 9]])
    for mat in (m, sp.csr_matrix(m)):
        want = jmtm.build_jump_table(mat, norm, id_d, 33, 5)
        got = tmtm.build_jump_table(mat, norm, id_d, 33, 5)
        np.testing.assert_array_equal(got.frags.numpy(), np.asarray(want.frags))
        assert got.delta == want.delta
        back = convert.jump_table_from_numpy(want._asdict())
        assert torch.equal(back.frags, got.frags) and back.delta == 5


@pytest.mark.parametrize("with_circ", [False, True])
def test_prev_next_mask_and_neighbour_set_equal(with_circ):
    rng = np.random.default_rng(11 + with_circ)
    js_ = make_random_state(rng, 22, 4, with_circ=with_circ)
    ts_ = to_port(js_)
    n = js_.n_frags
    jump_j = jmtm.JumpTable(frags=jnp.asarray(rng.integers(0, n, (n, DELTA)), jnp.int32),
                            delta=DELTA)
    jump_t = convert.jump_table_from_numpy(jump_j._asdict())
    pn = jax.jit(jmtm._prev_next)
    mask = jax.jit(jmtm._impossibility_mask)
    nbset = jax.jit(lambda s, f: jmtm._neighbour_set(s, f, jump_j))
    for f in range(n):
        ft = torch.tensor(f)
        got = tmtm._prev_next(ts_, ft)
        want = pn(js_, jnp.int32(f))
        assert tuple(int(x) for x in got) == tuple(int(x) for x in want), f
        ids_j, valid_j = nbset(js_, jnp.int32(f))
        ids_t, valid_t = tmtm._neighbour_set(ts_, ft, jump_t)
        np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j), err_msg=str(f))
        np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j), err_msg=str(f))
        np.testing.assert_array_equal(tmtm._impossibility_mask(ts_, ft, ids_t).numpy(),
                                      np.asarray(mask(js_, jnp.int32(f), ids_j)),
                                      err_msg=str(f))


def test_categorical_is_gumbel_argmax():
    """The bridge, on the JAX side: the JAX step's categorical draw over the
    (delta + 2) x 13 slots is the argmax of its Gumbel noise plus the
    logits, zero-probability slots (log 1e-30) included."""
    rng = np.random.default_rng(5)
    n_slots = (DELTA + 2) * 13
    key = jax.random.key(0)
    for i in range(50):
        key, k = jax.random.split(key)
        p = rng.random(n_slots) * (rng.random(n_slots) < 0.4)
        p = jnp.asarray(p / max(p.sum(), 1e-30), jnp.float32)
        logits = jnp.log(jnp.where(p > 0, p, 1e-30))
        want = int(jax.random.categorical(k, logits))
        got = int(jnp.argmax(jax.random.gumbel(k, (n_slots,)) + logits))
        assert got == want, i
        tg = tmtm._categorical(t(p), t(jax.random.gumbel(k, (n_slots,))))
        assert int(tg) == want, i


@functools.partial(jax.jit, static_argnums=(1, 2))
def jax_move_draws(key, n_steps, n_slots):
    """The draws of ``n_steps`` MTM / MH cycle steps from ``key``, split as
    make_mtm_cycle (key, sub = split(key)) and the step (k_fwd, k_acc =
    split(sub)) split it."""
    def body(key, _):
        key, sub = jax.random.split(key)
        k_fwd, k_acc = jax.random.split(sub)
        return key, (jax.random.gumbel(k_fwd, (n_slots,)), jax.random.uniform(k_acc, ()))
    return jax.lax.scan(body, key, None, length=n_steps)[1]


def move_draws(key, n_slots):
    """One step's draws from its key (k_fwd, k_acc = split(key))."""
    k_fwd, k_acc = jax.random.split(key)
    return tmtm.MoveDraws(t(jax.random.gumbel(k_fwd, (n_slots,))),
                          t(jax.random.uniform(k_acc, ())))


@pytest.fixture(scope="module")
def dense():
    state, table, params, obs = make_problem(seed=2, n=16)
    n = state.n_frags
    jump = jmtm.build_jump_table(obs, np.ones(n), np.arange(n), n, DELTA)
    rng = np.random.default_rng(5)
    cur = state
    apply = jax.jit(jm.apply_mutation)
    for _ in range(4):      # a few mutations from the truth, as tests/test_mtm.py
        cur = apply(cur, int(rng.integers(n)), int(rng.integers(n)), int(rng.integers(13)))
    return dict(state=state, cur=cur, table=table, params=params, obs=obs, jump=jump,
                tt=convert.table_from_numpy(table._asdict()),
                tp=convert.params_from_numpy(params._asdict()),
                tj=convert.jump_table_from_numpy(jump._asdict()),
                l0=float(jl.log_likelihood(cur, table, obs, params)))


@pytest.mark.parametrize("corrected", [False, True])
@pytest.mark.parametrize("variant", ["mtm", "mh"])
def test_dense_steps_match_jax(dense, variant, corrected):
    d = dense
    make_j = jmtm.make_mtm_step if variant == "mtm" else jmtm.make_mh_step
    make_t = tmtm.make_mtm_step if variant == "mtm" else tmtm.make_mh_step
    step_j = jax.jit(make_j(d["table"], d["obs"], d["jump"], corrected=corrected))
    step_t = make_t(d["tt"], d["obs"], d["tj"], corrected=corrected)
    n_slots = tmtm.n_move_slots(d["tj"])
    cur = d["cur"]
    l_j = jnp.float32(d["l0"])
    l_t = torch.tensor(np.float32(d["l0"]))
    key = jax.random.key(13 + corrected)
    accepted = 0
    for f_a in (3, 0, 15, 7, 8, 12, 1, 5, 10, 14):
        key, sub = jax.random.split(key)
        new_j, l_j, acc_j, nc_j = step_j(cur, sub, d["params"], l_j, jnp.int32(f_a),
                                         jnp.float32(1.0))
        new_t, l_t, acc_t, nc_t = step_t(to_port(cur), move_draws(sub, n_slots), d["tp"], l_t,
                                         torch.tensor(f_a), 1.0)
        msg = f"{variant} corrected={corrected} f_a={f_a}"
        assert bool(acc_t) == bool(acc_j) and int(nc_t) == int(nc_j), msg
        assert_states_equal(new_t, new_j, msg)
        np.testing.assert_allclose(float(l_t), float(l_j), rtol=LL_RTOL, err_msg=msg)
        check_invariants(new_t)
        accepted += bool(acc_t)
        cur = new_j
    assert accepted > 0


def test_mh_catalogue_id_collision_matches_reference():
    """A fault of the reference, reproduced on purpose: on a mini-state,
    ``mh_candidates``' translocations take their fresh id from the mini's
    own maximum (graal_tpu/core/candidates.py:123, :133), not from the
    genome's. Here fA (tail) and fB (head) share a 2-fragment contig 3, and
    contig 4 lies outside the view: candidate 10 (cut after fA, cut before
    fB, paste) relabels contig 3 to 4 and circularises it, so written back
    it merges with contig 4 and breaks the invariants, in both packages
    alike (ROADMAP section C)."""
    soa = dict(pos=[0, 1, 0, 1], id_c=[3, 3, 4, 4], start_bp=[0, 1000, 0, 1000],
               len_bp=[1000] * 4, circ=[0] * 4, l_cont=[2] * 4, l_cont_bp=[2000] * 4)
    js_ = JState.from_soa(soa)
    ts_ = TState.from_soa(soa)
    f_a, f_b = 1, 0
    rows, valid, over = td.extract_rows_each(ts_, torch.tensor(f_a), torch.tensor([f_b]), 2)
    assert not bool(over[0]) and rows[0].tolist() == [0, 1]
    mini, = td.drop_chain(td.gather_mini(*td.lift_chain(ts_, rows, valid)))
    got = tc.mh_candidates(mini, torch.tensor([f_a]), torch.tensor([f_b]),
                           max_id=ts_.id_c.amax())
    r, v, _ = jd.extract_rows(js_, jnp.int32(f_a), jnp.int32(f_b), 2)
    want = jc.mh_candidates(jd.gather_mini(js_, r, v), jnp.int32(1), jnp.int32(0),
                            jnp.max(js_.id_c))
    for op in range(13):
        assert_states_equal(TState(*[x[0, op] for x in got]),
                            jax.tree.map(lambda x: x[op], want), f"op {op}")
    bad, = td.drop_chain(td.scatter_mini(*td.lift_chain(ts_, TState(*[x[0, 10] for x in got]),
                                                        rows[0], valid[0])))
    assert bad.id_c.tolist() == [4, 4, 4, 4] and bad.circ.tolist() == [1, 1, 0, 0]
    assert check_invariants(bad, raise_on_error=False)
    # the same move on the whole genome takes a fresh id: no collision
    full = tc.mh_candidates(ts_, f_a, torch.tensor([f_b]))
    assert not check_invariants(TState(*[x[0, 10] for x in full]), raise_on_error=False)
