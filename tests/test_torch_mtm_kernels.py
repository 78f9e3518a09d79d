"""The MTM / MH step kernels' public functions (E1-E3) against the JAX
package.

On a card the neighbour set and its masks (``core.mtm.move_set``, E1), the
forward weights, slot draw and proposal (``forward_dense`` /
``forward_delta``, E2) and the backward weights, acceptance and commit
(``accept_dense`` / ``accept_delta``, E3) run on the kernels of
``csrc/mtm.cu`` (``ops.mtm_cuda.MOVE``); elsewhere on their plain versions.
Here, on the CPU, the public functions take the plain versions through that
dispatch and are held to ``graal_tpu.core.mtm`` on shared draws (the Gumbel
row and the acceptance uniform split from the JAX keys, as
``tests/test_torch_mtm.py`` splits them): E1 to ``_prev_next`` /
``_neighbour_set`` / ``_impossibility_mask`` on every fragment of random
genomes (circular contigs, a one-fragment circle, a jump row holding the
pivot itself and a repeated partner), in both modes; E2 and E3 through the
steps they make up, dense MTM and MH (``corrected`` False and True) and
at the passes the plain code must keep as they are: a circular pivot, a
pivot whose every slot is discarded (the dense weights 0 / 0, the draw on
the Gumbel noise alone, the backward sum 0), a backward pass with no weight
after a forward one with some, accept and reject (the delta steps at the
edges, every forward neighbour overflowing f_max among them, and the dense
MTM step on a repeat table are in ``tests/test_torch_mtm_kernel_edges.py``;
``tests/test_torch_mtm.py`` and ``tests/test_torch_mtm_delta.py`` walk both
variants at both settings of ``corrected``). States,
ids, slots, accept flags and contig counts bit for bit; likelihoods at the
MTM tests' rtol 1e-5 (f32 transcendentals of XLA-CPU and torch).

Also: the wrapper's argument checks as pure functions on CPU tensors, its
refusal of CPU tensors, and the card branch of each public function driven
through a stand-in wrapper (the plain versions behind the wrapper's own
checks, the delta proposal written into the state in place and its rows
restored on a rejection, as the kernels do): whole steps through it equal
the plain steps bit for bit, eagerly (the input state untouched) and in
place (a rejection leaves the carry as it came in). The kernels themselves
run only on a card (``chip_smoke.py`` phase 3e); the cycles through the
stand-in are in ``tests/test_torch_mtm_kernel_cycles.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graal_tpu.core import likelihood as jl
from graal_tpu.core import mcmc as jm
from graal_tpu.core import mtm as jmtm
from graal_tpu.core.state import GenomeState as JState
from graal_tpu_torch import convert
from graal_tpu_torch.core import mtm as tmtm
from graal_tpu_torch.core.state import MUTABLE_FIELDS
from graal_tpu_torch.core.state import GenomeState as TState
from graal_tpu_torch.core.state import check_invariants
from graal_tpu_torch.ops import mtm_cuda as mc
from tests.conftest import make_random_state
from tests.test_mcmc import make_problem
from tests.test_torch_mtm import LL_RTOL, move_draws
from tests.test_torch_mtm_delta import delta_setup
from tests.test_torch_state import assert_states_equal, to_port

DELTA = 4
N_OPS = 13
F_MAX_SMALL = 8      # contig pairs of the delta problem (6 + 6 fragments) overflow


def jump_pair(frags):
    frags = np.asarray(frags, np.int32)
    jump_j = jmtm.JumpTable(frags=jnp.asarray(frags), delta=frags.shape[1])
    return jump_j, convert.jump_table_from_numpy(jump_j._asdict())


def edit(state: JState, **fields) -> JState:
    """``state`` with the given fields replaced (numpy arrays)."""
    return state._replace(**{k: jnp.asarray(np.asarray(v, np.int32)) for k, v in fields.items()})


def arranged(state: JState, contigs, circular=()) -> JState:
    """``state``'s fragments laid out as ``contigs`` (lists of fragment
    ids, in order, forward), those holding a fragment of ``circular``
    circular."""
    len_bp = np.asarray(state.len_bp)
    soa = {f: np.asarray(getattr(state, f)).copy() for f in state._fields}
    for c, members in enumerate(contigs):
        members = np.asarray(members)
        soa["pos"][members] = np.arange(len(members))
        soa["id_c"][members] = c + 1
        soa["start_bp"][members] = np.cumsum(len_bp[members]) - len_bp[members]
        soa["l_cont"][members] = len(members)
        soa["l_cont_bp"][members] = len_bp[members].sum()
        soa["circ"][members] = int(bool(set(members.tolist()) & set(circular)))
        soa["ori"][members] = 1
    return edit(state, **{f: soa[f] for f in ("pos", "id_c", "start_bp", "l_cont", "l_cont_bp",
                                             "circ", "ori")})


def circularised(state: JState, f: int) -> JState:
    """``state`` with the contig of ``f`` made circular."""
    circ = np.asarray(state.circ).copy()
    circ[np.asarray(state.id_c) == int(state.id_c[f])] = 1
    return edit(state, circ=circ)


# ---------------------------------------------------------------------------
# E1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_move_set_matches_jax(seed):
    """move_set on every fragment, both modes, against the JAX package's
    neighbour set, impossibility mask, largest id and contig count."""
    rng = np.random.default_rng(40 + seed)
    js_ = make_random_state(rng, 26, 6, with_circ=True)
    n = js_.n_frags
    if seed == 1:    # a one-fragment circle: its own prev and next, then invalid
        f = int(rng.integers(n))
        js_ = jm.apply_mutation(js_, f, f, 0)
        js_ = edit(js_, circ=np.where(np.arange(n) == f, 1, np.asarray(js_.circ)))
    frags = rng.integers(0, n, (n, DELTA))
    frags[::3, 0] = np.arange(n)[::3]               # the pivot among its partners
    frags[1::4, 2] = frags[1::4, 1]                 # a repeated partner
    jump_j, jump_t = jump_pair(frags)
    other = jm.apply_mutation(js_, 1, 2, 4)         # a moved genome for the mask-only mode
    ts_, to_ = to_port(js_), to_port(other)
    nbset = jax.jit(lambda s, f: jmtm._neighbour_set(s, f, jump_j))
    mask = jax.jit(jmtm._impossibility_mask)
    for f in range(n):
        ids_j, valid_j = nbset(js_, jnp.int32(f))
        want = np.asarray(mask(js_, jnp.int32(f), ids_j)) | ~np.asarray(valid_j)[:, None]
        ids, valid, discard, max_id, n_c = tmtm.move_set(ts_, torch.tensor(f), jump_t,
                                                          torch.tensor(f))
        assert ids.dtype == torch.int64 and max_id.dtype == torch.int32
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j), err_msg=str(f))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j), err_msg=str(f))
        np.testing.assert_array_equal(discard.numpy(), want, err_msg=str(f))
        assert int(max_id) == int(jnp.max(js_.id_c)) and int(n_c) == int(jnp.sum(js_.pos == 0))
        # the mask-only mode on the moved genome, pivoted elsewhere
        piv = (f + 3) % n
        got = tmtm.move_set(to_, None, jump_t, torch.tensor(piv), (ids, valid))
        want = np.asarray(mask(other, jnp.int32(piv), ids_j)) | ~np.asarray(valid_j)[:, None]
        assert got[0] is ids and got[1] is valid
        np.testing.assert_array_equal(got[2].numpy(), want, err_msg=f"mask {f}")
        assert int(got[3]) == int(jnp.max(other.id_c))
        assert int(got[4]) == int(jnp.sum(other.pos == 0))


# ---------------------------------------------------------------------------
# E2 and E3 through dense steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense():
    """The 16-fragment dense problem moved a few times, with a circular
    contig, and a singleton pivot (fragment 9) whose jump row is itself
    alone: every slot invalid. Fragments 11-14 are singletons whose rows
    are themselves alone, the partners of fragment 10 (a singleton too): a
    corrected MTM backward pass from one of them after an eject, flip or
    activity swap has no valid slot."""
    state, table, params, obs = make_problem(seed=2, n=16)
    n = state.n_frags
    cur = state
    for f_a, f_b, op in ((3, 7, 4), (12, 2, 9), (5, 6, 1)):
        cur = jm.apply_mutation(cur, f_a, f_b, op)
    for f in (9, 10, 11, 12, 13, 14):
        cur = jm.apply_mutation(cur, f, f, 0)
    cur = circularised(cur, 1)
    check_invariants(to_port(cur))
    frags = np.asarray(jmtm.build_jump_table(obs, np.ones(n), np.arange(n), n, DELTA).frags)
    frags = frags.copy()
    frags[9] = 9
    frags[10] = (11, 12, 13, 14)
    frags[11:15] = np.arange(11, 15)[:, None]
    frags[3, 1] = 3                                 # the pivot among its partners
    jump_j, jump_t = jump_pair(frags)
    return dict(cur=cur, table=table, params=params, obs=obs, jump=jump_j, tj=jump_t,
                tt=convert.table_from_numpy(table._asdict()),
                tp=convert.params_from_numpy(params._asdict()),
                l0=float(jl.log_likelihood(cur, table, obs, params)))


def circle_ends(state: JState, f: int):
    """The head and the tail of the contig of ``f``."""
    idc, pos = np.asarray(state.id_c), np.asarray(state.pos)
    members = np.nonzero(idc == idc[f])[0]
    return [int(members[pos[members] == 0][0]), int(members[pos[members] == len(members) - 1][0])]


def dense_parts(d, variant, corrected, state, draws, l_t, f_a, f_t):
    """A dense step composed of the public functions as make_mtm_step and
    make_mh_step compose them: (the step's outputs, the forward pass, the
    backward discard mask)."""
    scores_for = tmtm._make_scores_for(d["tt"], d["obs"], torch.float32, None)
    f_a = torch.tensor(f_a)
    nb_ids, nb_valid, discard_f, _, _ = tmtm.move_set(state, f_a, d["tj"], f_a)
    cands, ll_f = scores_for(state, f_a, nb_ids, d["tp"])
    fwd = tmtm.forward_dense(variant, ll_f, discard_f, f_t, draws.gumbel, nb_ids, cands)
    pivot = fwd.f_star if variant == "mtm" else f_a
    if corrected and variant == "mtm":
        bk_ids, _, discard_b, _, _ = tmtm.move_set(fwd.g_star, fwd.f_star, d["tj"], f_a)
    else:
        bk_ids = nb_ids
        discard_b = tmtm.move_set(fwd.g_star, None, d["tj"], f_a, (nb_ids, nb_valid))[2]
    _, ll_b = scores_for(fwd.g_star, pivot, bk_ids, d["tp"])
    out = tmtm.accept_dense(variant, ll_b, discard_b, fwd, state, l_t, f_t, draws.u_acc,
                            corrected)
    return out, fwd, discard_b


def temperature(f_t):
    """(the JAX step's f_t, the port's): 1 as a Python number, any other
    value as an f32 tensor (an IEEE division on both sides, as in a
    cycle)."""
    return jnp.float32(f_t), (1.0 if f_t == 1.0 else torch.tensor(np.float32(f_t)))


@pytest.mark.parametrize("variant, corrected", [("mtm", False), ("mtm", True), ("mh", False)])
def test_dense_steps_at_the_edges_match_jax(dense, variant, corrected):
    """Dense steps from one genome at a circular contig's ends, the
    all-discarded pivot, the pivot among its own partners, the singletons'
    pivot (at f_t 1e6: nearly flat weights, so the draw often leaves f*
    alone and a corrected MTM backward pass empty) and others, each against
    the JAX step on shared draws; make_mtm_step's (make_mh_step's) step
    equals its composition of the public functions."""
    d = dense
    make_j = jmtm.make_mtm_step if variant == "mtm" else jmtm.make_mh_step
    make_t = tmtm.make_mtm_step if variant == "mtm" else tmtm.make_mh_step
    step_j = jax.jit(make_j(d["table"], d["obs"], d["jump"], corrected=corrected))
    step_t = make_t(d["tt"], d["obs"], d["tj"], corrected=corrected)
    n_slots = tmtm.n_move_slots(d["tj"])
    probes = [(f, 1.0) for f in circle_ends(d["cur"], 1) + [9, 3, 0, 15]] \
        + [(6, 0.6)] + [(10, 1e6)] * 10
    cur, ts_ = d["cur"], to_port(d["cur"])
    l_j = jnp.float32(d["l0"])
    l_t = torch.tensor(np.float32(d["l0"]))
    key = jax.random.key(70 + 2 * corrected + (variant == "mh"))
    seen = dict(accept=0, reject=0, all_discarded=0, empty_backward=0)
    for f_a, f_t in probes:
        key, sub = jax.random.split(key)
        ft_j, ft_t = temperature(f_t)
        new_j, l_j2, acc_j, nc_j = step_j(cur, sub, d["params"], l_j, jnp.int32(f_a), ft_j)
        draws = move_draws(sub, n_slots)
        (new_t, l_t2, acc_t, nc_t, ratio), fwd, discard_b = dense_parts(
            d, variant, corrected, ts_, draws, l_t, f_a, ft_t)
        got = step_t(ts_, draws, d["tp"], l_t, torch.tensor(f_a), ft_t)
        assert all(torch.equal(a, b) for a, b in zip(got[0], new_t))
        assert all(torch.equal(a, b) for a, b in zip(got[1:], (l_t2, acc_t, nc_t)))
        msg = f"{variant} corrected={corrected} f_a={f_a}"
        assert bool(acc_t) == bool(acc_j) and int(nc_t) == int(nc_j), msg
        assert_states_equal(new_t, new_j, msg)
        np.testing.assert_allclose(float(l_t2), float(l_j2), rtol=LL_RTOL, err_msg=msg)
        check_invariants(new_t)
        if f_a == 9:     # every slot invalid: 0 / 0 weights, the Gumbel argmax
            assert not bool(tmtm.move_set(ts_, torch.tensor(9), d["tj"], torch.tensor(9))[1].any())
            assert int(fwd.omega) == int(torch.argmax(draws.gumbel)) and not bool(acc_t)
            seen["all_discarded"] += 1
        if bool(discard_b.all()) and float(fwd.sw) > 0:   # exp(mx_f + inf) sw_f / 0
            assert variant == "mtm" and float(ratio) == float("inf") and bool(acc_t), msg
            seen["empty_backward"] += 1
        seen["accept" if bool(acc_t) else "reject"] += 1
    assert seen["accept"] and seen["reject"] and seen["all_discarded"], seen
    if corrected and variant == "mtm":
        assert seen["empty_backward"], seen


# ---------------------------------------------------------------------------
# The delta problem (tests/test_torch_mtm_kernel_edges.py steps it against JAX)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sparse():
    """The 36-fragment delta problem laid out as a 12-fragment contig, a
    circular 6-fragment one, a linear 6-fragment one and 12 singletons:
    at f_max 8 every pair with the long contig overflows. Fragment 24's
    jump row is in the long contig (every forward neighbour overflows: the
    step is rejected), fragment 25's among singletons."""
    p = delta_setup("plain")
    start = arranged(p["state"], [list(range(12)), list(range(12, 18)), list(range(18, 24))]
                     + [[f] for f in range(24, 36)], circular=(12,))
    frags = np.asarray(p["jump"].frags).copy()
    frags[24] = (0, 3, 5, 7)
    frags[25] = (26, 27, 28, 29)
    p["jump"], p["tj"] = jump_pair(frags)
    p["start"], p["ts"] = start, to_port(start)
    check_invariants(p["ts"])
    return p


# ---------------------------------------------------------------------------
# The wrapper's checks, its refusal of CPU tensors, the card branches
# ---------------------------------------------------------------------------

def _state(n=8):
    return TState(*[torch.zeros(n, dtype=torch.int32) for _ in TState._fields])


def _fwd(delta=False):
    z = torch.zeros(())
    i64 = torch.zeros((), dtype=torch.int64)
    return tmtm.Forward(None, i64, i64, z, z, z, z,
                        torch.zeros((), dtype=torch.bool) if delta else None)


def test_checks_accept_what_the_kernels_take():
    st = _state()
    frags = torch.zeros((8, 3), dtype=torch.int32)
    i64 = torch.tensor(2)
    assert mc.check_set(st._asdict(), i64, frags, i64) == (8, 3, 5)
    strided = TState(*[torch.zeros(16, dtype=torch.int32)[::2] for _ in TState._fields])
    given = (torch.zeros(5, dtype=torch.int64), torch.zeros(5, dtype=torch.bool))
    assert mc.check_set(strided._asdict(), None, frags, i64, given) == (8, 3, 5)
    score, disc = torch.zeros((5, N_OPS)), torch.zeros((5, N_OPS), dtype=torch.bool)
    ids, gum = torch.zeros(5, dtype=torch.int64), torch.zeros(5 * N_OPS)
    assert mc.check_draw(score, disc, gum, ids, 0.5) == (5, (None, 0, float(np.float32(2.0))))
    m, (ft, _, inv) = mc.check_draw(score, disc, gum, ids, torch.tensor(0.7), torch.tensor(1.0),
                                    torch.zeros(5, dtype=torch.bool))
    assert m == 5 and ft is not None and inv == 0.0
    cands = TState(*[torch.zeros((65, 8), dtype=torch.int32) for _ in TState._fields])
    assert mc.check_catalogue(cands, 5, torch.device("cpu")) == 8
    strided8 = TState(*[torch.zeros(16, dtype=torch.int32)[::2] for _ in TState._fields])
    assert mc.check_commit(tuple(st), tuple(strided8), torch.device("cpu")) == 8
    minis = {f: torch.zeros((5, N_OPS, 4), dtype=torch.int32) for f in MUTABLE_FIELDS}
    rows, rv = torch.zeros((5, 4), dtype=torch.int64), torch.zeros((5, 4), dtype=torch.bool)
    assert mc.check_write(st._asdict(), minis, rows, rv, 5, torch.device("cpu")) == 4
    undo, n_in = torch.zeros((8, 4), dtype=torch.int32), torch.tensor(3)
    assert mc.check_restore(st._asdict(), rows, rv, undo, n_in, 5, torch.device("cpu")) == 4
    assert mc.check_accept(score, disc, _fwd(), torch.tensor(1.0), torch.tensor(0.5), 1.0)[0] == 5
    assert mc.check_accept(score, disc, _fwd(True), torch.tensor(1.0), torch.tensor(0.5), 1.0,
                           torch.zeros(5, dtype=torch.bool))[0] == 5


def _bad(name):
    """(check function, arguments) with one thing wrong."""
    cpu = torch.device("cpu")
    st = _state()
    frags = torch.zeros((8, 3), dtype=torch.int32)
    i64 = torch.tensor(2)
    given = (torch.zeros(5, dtype=torch.int64), torch.zeros(5, dtype=torch.bool))
    score, disc = torch.zeros((5, N_OPS)), torch.zeros((5, N_OPS), dtype=torch.bool)
    ids, gum = torch.zeros(5, dtype=torch.int64), torch.zeros(5 * N_OPS)
    cands = TState(*[torch.zeros((65, 8), dtype=torch.int32) for _ in TState._fields])
    minis = {f: torch.zeros((5, N_OPS, 4), dtype=torch.int32) for f in MUTABLE_FIELDS}
    rows, rv = torch.zeros((5, 4), dtype=torch.int64), torch.zeros((5, 4), dtype=torch.bool)
    undo, n_in = torch.zeros((8, 4), dtype=torch.int32), torch.tensor(3)
    l_t, u = torch.tensor(1.0), torch.tensor(0.5)
    return {
        "set_field_dtype": (mc.check_set, (st._replace(pos=st.pos.long())._asdict(), i64, frags,
                                           i64)),
        "set_field_length": (mc.check_set, (st._replace(circ=st.circ[:7])._asdict(), i64, frags,
                                            i64)),
        "set_frags_rows": (mc.check_set, (st._asdict(), i64, frags[:7], i64)),
        "set_frags_stride": (mc.check_set, (st._asdict(), i64,
                                            torch.zeros((8, 6), dtype=torch.int32)[:, ::2], i64)),
        "set_frags_dtype": (mc.check_set, (st._asdict(), i64, frags.long(), i64)),
        "set_delta": (mc.check_set, (st._asdict(), i64, torch.zeros((8, 63), dtype=torch.int32),
                                     i64)),
        "set_pivot_dtype": (mc.check_set, (st._asdict(), i64.int(), frags, i64)),
        "set_mask_pivot": (mc.check_set, (st._asdict(), i64, frags, i64[None])),
        "set_both_modes": (mc.check_set, (st._asdict(), i64, frags, i64, given)),
        "set_no_mode": (mc.check_set, (st._asdict(), None, frags, i64)),
        "set_given_length": (mc.check_set, (st._asdict(), None, frags, i64,
                                            (given[0][:4], given[1][:4]))),
        "set_given_dtype": (mc.check_set, (st._asdict(), None, frags, i64,
                                           (given[0], given[1].int()))),
        "draw_score_ops": (mc.check_draw, (score[:, :12], disc[:, :12], gum[:60], ids, 1.0)),
        "draw_score_dtype": (mc.check_draw, (score.double(), disc, gum, ids, 1.0)),
        "draw_slots": (mc.check_draw, (torch.zeros((65, N_OPS)),
                                       torch.zeros((65, N_OPS), dtype=torch.bool),
                                       torch.zeros(65 * N_OPS), torch.zeros(65, dtype=torch.int64),
                                       1.0)),
        "draw_discard": (mc.check_draw, (score, disc[:4], gum, ids, 1.0)),
        "draw_gumbel": (mc.check_draw, (score, disc, gum[:64], ids, 1.0)),
        "draw_gumbel_stride": (mc.check_draw, (score, disc, torch.zeros(130)[::2], ids, 1.0)),
        "draw_ids": (mc.check_draw, (score, disc, gum, ids.int(), 1.0)),
        "draw_ft": (mc.check_draw, (score, disc, gum, ids, "1")),
        "draw_ft_dtype": (mc.check_draw, (score, disc, gum, ids, torch.tensor(1.0).double())),
        "draw_base": (mc.check_draw, (score, disc, gum, ids, 1.0, torch.zeros(1))),
        "draw_overflow": (mc.check_draw, (score, disc, gum, ids, 1.0, l_t,
                                          torch.zeros(4, dtype=torch.bool))),
        "catalogue_fields": (mc.check_catalogue, (cands[:10], 5, cpu)),
        "catalogue_slots": (mc.check_catalogue, (TState(*[x[:64] for x in cands]), 5, cpu)),
        "write_rows_stride": (mc.check_write, (st._asdict(), minis,
                                               torch.zeros((5, 8), dtype=torch.int64)[:, ::2], rv,
                                               5, cpu)),
        "write_rows_valid": (mc.check_write, (st._asdict(), minis, rows, rv.int(), 5, cpu)),
        "write_mini_shape": (mc.check_write, (st._asdict(), dict(minis, ori=minis["ori"][:4]),
                                              rows, rv, 5, cpu)),
        "write_state": (mc.check_write, (st._replace(activ=st.activ[:7])._asdict(), minis, rows,
                                         rv, 5, cpu)),
        "commit_fields": (mc.check_commit, (tuple(st)[:10], tuple(st), cpu)),
        "commit_length": (mc.check_commit, (tuple(st), tuple(_state(7)), cpu)),
        "commit_dtype": (mc.check_commit, (tuple(st._replace(ori=st.ori.long())), tuple(st), cpu)),
        "restore_undo": (mc.check_restore, (st._asdict(), rows, rv, undo[:7], n_in, 5, cpu)),
        "restore_n_in": (mc.check_restore, (st._asdict(), rows, rv, undo, n_in.int(), 5, cpu)),
        "accept_l_t": (mc.check_accept, (score, disc, _fwd(), l_t.double(), u, 1.0)),
        "accept_u": (mc.check_accept, (score, disc, _fwd(), l_t, u[None], 1.0)),
        "accept_omega": (mc.check_accept, (score, disc, _fwd()._replace(omega=torch.tensor(0.0)),
                                           l_t, u, 1.0)),
        "accept_ok": (mc.check_accept, (score, disc, _fwd(), l_t, u, 1.0,
                                        torch.zeros(5, dtype=torch.bool))),
    }[name]


_BAD = ["set_field_dtype", "set_field_length", "set_frags_rows", "set_frags_stride",
        "set_frags_dtype", "set_delta", "set_pivot_dtype", "set_mask_pivot", "set_both_modes",
        "set_no_mode", "set_given_length", "set_given_dtype", "draw_score_ops",
        "draw_score_dtype", "draw_slots", "draw_discard", "draw_gumbel", "draw_gumbel_stride",
        "draw_ids", "draw_ft", "draw_ft_dtype", "draw_base", "draw_overflow",
        "catalogue_fields", "catalogue_slots", "write_rows_stride", "write_rows_valid",
        "write_mini_shape", "write_state", "commit_fields", "commit_length", "commit_dtype",
        "restore_undo", "restore_n_in", "accept_l_t", "accept_u", "accept_omega", "accept_ok"]


@pytest.mark.parametrize("name", _BAD)
def test_checks_refuse(name):
    fn, args = _bad(name)
    with pytest.raises(ValueError):
        fn(*args)


def test_wrapper_refuses_cpu_tensors():
    move = mc.MoveKernels()
    st = _state()
    score, disc = torch.zeros((5, N_OPS)), torch.zeros((5, N_OPS), dtype=torch.bool)
    ids, gum = torch.zeros(5, dtype=torch.int64), torch.zeros(5 * N_OPS)
    calls = [
        lambda: move.set(st._asdict(), torch.tensor(1), torch.zeros((8, 3), dtype=torch.int32),
                         torch.tensor(1)),
        lambda: move.draw_dense("mtm", score, disc, gum, ids, 1.0, tuple(st)),
        lambda: move.draw_delta("mh", score, torch.tensor(0.0), None, disc, gum, ids, 1.0, None,
                                None, None, st._asdict()),
        lambda: move.accept_dense("mtm", score, disc, _fwd(), tuple(st), tuple(st),
                                  torch.tensor(0.0), torch.tensor(0.5), 1.0, False),
        lambda: move.accept_delta("mh", score, None, disc, _fwd(True), st._asdict(), None, None,
                                  None, None, torch.tensor(0.0), torch.tensor(0.5), 1.0, True),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="card"):
            call()
    assert move.launches.by_key() == {}


class StandIn:
    """The wrapper's contract in plain torch: each method runs the wrapper's
    own argument checks, then the plain version, and returns what the
    kernel's wrapper returns; the delta draw writes the proposal into the
    state it is given and saves the values it overwrote, the delta
    acceptance writes them back on a rejection and counts the contigs from
    E1's count, as the kernels do. Records the calls."""

    def __init__(self):
        self.calls = []

    def set(self, fields, f_a, frags, mask_pivot, given=None):
        self.calls.append("set")
        mc.check_set(fields, f_a, frags, mask_pivot, given)
        return tmtm.move_set_plain(TState(**fields), f_a, tmtm.JumpTable(frags, frags.shape[1]),
                                   mask_pivot, given)

    def draw_dense(self, variant, score, discard, gumbel, ids, f_t, cands):
        self.calls.append("draw")
        m, _ = mc.check_draw(score, discard, gumbel, ids, f_t)
        mc.check_catalogue(cands, m, score.device)
        fwd = tmtm.forward_dense_plain(variant, score, discard, f_t, gumbel, ids, TState(*cands))
        return (tuple(fwd.g_star),) + tuple(fwd[1:7])

    def draw_delta(self, variant, score, l_t, overflow, discard, gumbel, ids, f_t, minis, rows,
                   rows_valid, dst):
        self.calls.append("draw")
        m, _ = mc.check_draw(score, discard, gumbel, ids, f_t, l_t, overflow)
        f_max = mc.check_write(dst, minis, rows, rows_valid, m, score.device)
        fwd = tmtm.forward_delta_plain(variant, score, l_t, overflow, discard, f_t, gumbel, ids,
                                       TState(**minis), rows, rows_valid, TState(**dst))
        nb = int(fwd.omega) // N_OPS
        at, r = rows_valid[nb], rows[nb][rows_valid[nb]]
        undo = torch.full((len(MUTABLE_FIELDS), f_max), -7, dtype=torch.int32)
        for k, f in enumerate(MUTABLE_FIELDS):
            undo[k, at] = dst[f][r]
            dst[f][r] = getattr(fwd.g_star, f)[r]
        return (undo,) + tuple(fwd[1:8])

    def accept_dense(self, variant, score, discard, fwd, g_star, state, l_t, u, f_t, corrected):
        self.calls.append("accept")
        mc.check_accept(score, discard, fwd, l_t, u, f_t)
        mc.check_commit(state, g_star, score.device)
        new, *out = tmtm.accept_dense_plain(variant, score, discard,
                                            fwd._replace(g_star=TState(*g_star)), TState(*state),
                                            l_t, f_t, u, corrected)
        return (tuple(new), *out)

    def accept_delta(self, variant, score, overflow, discard, fwd, dst, rows, rows_valid, undo,
                     n_in, l_t, u, f_t, corrected):
        self.calls.append("accept")
        m, _ = mc.check_accept(score, discard, fwd, l_t, u, f_t, overflow)
        mc.check_restore(dst, rows, rows_valid, undo, n_in, m, score.device)
        nb = int(fwd.omega) // N_OPS
        at, r = rows_valid[nb], rows[nb][rows_valid[nb]]
        before = {f: x.clone() for f, x in dst.items()}
        for k, f in enumerate(MUTABLE_FIELDS):
            before[f][r] = undo[k, at]
        new, l_out, accepted, n_c, ratio = tmtm.accept_delta_plain(
            variant, score, overflow, discard,
            fwd._replace(g_star=TState(**dst), undo=TState(**before)), l_t, f_t, u, corrected)
        heads = int((dst["pos"][r] == 0).sum()) - int((undo[0, at] == 0).sum())
        counted = n_in + (heads if bool(accepted) else 0)
        assert int(counted) == int(n_c)          # the kernel's count is the genome's
        if not bool(accepted):
            for k, f in enumerate(MUTABLE_FIELDS):
                dst[f][r] = undo[k, at]
        assert all(torch.equal(dst[f], getattr(new, f)) for f in MUTABLE_FIELDS)
        return l_out, accepted, counted, ratio


def route_to_card(monkeypatch, spy):
    """Send ``core.mtm``'s public functions to their card branches (CPU
    tensors included) and those to ``spy``."""
    monkeypatch.setattr(tmtm, "MOVE", spy)
    monkeypatch.setattr(tmtm, "move_set", lambda state, f_a, jump, mask_pivot, given=None:
                        tmtm._set_on_card(state, f_a, jump, mask_pivot, given))
    monkeypatch.setattr(tmtm, "forward_dense", tmtm._draw_dense_on_card)
    monkeypatch.setattr(tmtm, "accept_dense", tmtm._accept_dense_on_card)
    monkeypatch.setattr(tmtm, "forward_delta", lambda *a: tmtm._draw_delta_on_card(*a) if
                        len(a) == 13 else tmtm._draw_delta_on_card(*a, False))
    monkeypatch.setattr(tmtm, "accept_delta", tmtm._accept_delta_on_card)


def clone(state):
    return TState(*[x.clone() for x in state])


@pytest.mark.parametrize("corrected", [False, True])
@pytest.mark.parametrize("variant", ["mtm", "mh"])
def test_dispatch(dense, sparse, monkeypatch, variant, corrected):
    """The card branch of every public function (the wrapper a stand-in):
    dense and delta steps give the plain steps' results bit for bit; an
    eager delta step leaves its input untouched, an in-place one writes
    the carry (its own tensors) and a rejection leaves it as it came in."""
    d, p = dense, sparse
    builds = {
        "dense": (tmtm.make_mtm_step if variant == "mtm" else tmtm.make_mh_step)(
            d["tt"], d["obs"], d["tj"], corrected=corrected),
        "delta": (tmtm.make_delta_mtm_step if variant == "mtm" else tmtm.make_delta_mh_step)(
            p["tt"], p["tj"], F_MAX_SMALL * 2, p["tsobs"], corrected=corrected)}
    gen = torch.Generator().manual_seed(11 + corrected)
    cases = []
    for kind, start, jump, params, frags in (
            ("dense", to_port(d["cur"]), d["tj"], d["tp"], (9, 1, 10, 3, 0, 6, 15)),
            ("delta", p["ts"], p["tj"], p["tp"], (0, 5, 13, 22, 30, 35, 8))):
        l_t = torch.tensor(-1000.0 if kind == "dense" else -5000.0)
        for f_a in frags:
            draws = tmtm.draw_move_inputs(gen, jump)
            cases.append((kind, start, params, l_t, f_a, draws, (1.0, 0.7)[f_a % 2]))
    want = [builds[k](st, dr, par, l_t, torch.tensor(f), f_t)
            for k, st, par, l_t, f, dr, f_t in cases]
    spy = StandIn()
    route_to_card(monkeypatch, spy)
    seen = dict(accept=0, reject=0)
    for (kind, st, par, l_t, f, dr, f_t), w in zip(cases, want):
        before = clone(st)
        got = builds[kind](st, dr, par, l_t, torch.tensor(f), f_t)
        assert all(torch.equal(a, b) for a, b in zip(st, before))    # eager: a copy
        for g in ((got,) if kind == "dense" else
                  (got, builds[kind](clone(st), dr, par, l_t, torch.tensor(f), f_t,
                                     inplace=True))):
            assert all(torch.equal(a, b) for a, b in zip(g[0], w[0])), (kind, f)
            assert all(torch.equal(a, b) for a, b in zip(g[1:], w[1:])), (kind, f)
        if kind == "delta":
            carry = clone(st)
            new = builds[kind](carry, dr, par, l_t, torch.tensor(f), f_t, inplace=True)[0]
            assert all(a is b for a, b in zip(new[:3], carry[:3]))    # the carry itself
            if not bool(w[2]):
                assert all(torch.equal(a, b) for a, b in zip(carry, before))
        seen["accept" if bool(w[2]) else "reject"] += 1
    assert seen["accept"] and seen["reject"], seen
    n_steps = sum(1 if kind == "dense" else 3 for kind, *_ in cases)
    assert spy.calls == ["set", "draw", "set", "accept"] * n_steps
