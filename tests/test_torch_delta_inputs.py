"""The delta engine's per-call scorer inputs (kernels I1 and I2,
graal_tpu_torch/csrc/delta_inputs.cu, wrapper ops/delta_inputs_cuda.py) on
the CPU.

A CUDA kernel cannot run here, so I1's and I2's functions are held through
numpy transcriptions that read the wrapper's own argument blocks (pointers
and strides, as the kernels do):

- bit for bit against ``core.delta.slot_inputs_plain`` /
  ``sub_vectors_plain``, padding included, on union and per-neighbour
  rows, 1 and 3 chains with per-chain parameters, a circular contig, an
  inactive row, fragments of 1 to 3 sub rows, the repeat engine's
  ``key_of``, and neighbours absent from their rows (lf_b = 0); I2
  dividing by 1,000 as torch does on the CPU and, multiplying by the f32
  reciprocal as the kernel and torch on the card do, against the plain
  version's operations in that form;
- the plain engine, the repeat engine and the delta MH catalogue fed
  through the card's dispatch (the wrapper over a stand-in library whose
  entry points run the transcriptions and add one to the counter each
  block hands them, as the kernels do; no torch add counts a launch)
  against the JAX package's ``make_delta_scorer`` /
  ``make_repeat_delta_scorer_v2`` (the jnp oracles of tests/test_torch_delta.py
  and tests/test_torch_delta_repeats.py) at rtol 1e-4, atol 1e-2, with the
  candidates, rows and overflow bit-equal, and the scorers' own CPU path bit
  for bit;
- the wrapper's checks, its refusal of CPU tensors, and the ctypes mirrors
  of the argument blocks parsed from the .cu.
"""

import ctypes
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graal_tpu.core import delta as jd
from graal_tpu.core import delta_repeats as jdr
from graal_tpu.core import sparse as js
from graal_tpu.core.candidates import mh_candidates as j_mh_candidates
from graal_tpu.utils.synthetic import default_params, make_genome, simulate_contacts
from graal_tpu_torch import convert
from graal_tpu_torch.core import delta as td
from graal_tpu_torch.core import delta_repeats as tdr
from graal_tpu_torch.core.candidates import build_candidates, mh_candidates
from graal_tpu_torch.core.model import RippeParams
from graal_tpu_torch.core.state import GenomeState as TState
from graal_tpu_torch.ops import delta_inputs_cuda as di
from graal_tpu_torch.ops import likelihood_cuda as lc
from graal_tpu_torch.ops.counts import LaunchCount
from tests.test_delta_repeats import _repeat_problem
from tests.test_torch_delta import _case_states
from tests.test_torch_state import assert_states_equal, to_port

CSRC = Path(__file__).resolve().parents[1] / "graal_tpu_torch" / "csrc"
DLL_RTOL, DLL_ATOL = 1e-4, 1e-2
F_MAX = 16
REPEAT_F_MAX = 24


def _arr(ptr, dtype, count):
    """A numpy view of ``count`` elements at a raw address."""
    ct = np.ctypeslib.as_ctypes_type(np.dtype(dtype))
    return np.ctypeslib.as_array((ct * count).from_address(ptr))


def _read(ptr, dtype, idx):
    """The entries at indices ``idx`` of an array at a raw address."""
    return _arr(ptr, dtype, int(np.max(idx)) + 1)[idx]


def i1_transcribed(a: di.SlotArgs):
    """I1 in numpy from its argument block: each slot's first matches of fA
    and of its neighbour in its rows read at their strides (0 where none),
    its chain's max_id, and its chain's parameter row (``params_vector`` of
    the chain's values, read at the parameters' strides). Writes the
    block's outputs."""
    big_m = a.C * a.m
    s = np.arange(big_m)
    c, j = s // a.m, s % a.m
    i = np.arange(a.f_max)
    rows = _read(a.rows, np.int64, a.rows_cs * c[:, None] + a.rows_ms * j[:, None]
                 + a.rows_is * i[None, :])
    fa = _read(a.f_a, np.int64 if a.fa64 else np.int32, a.fa_s * c)
    fb = _read(a.ids, np.int64 if a.ids64 else np.int32, a.ids_cs * c + a.ids_ms * j)
    mx = _read(a.max_id, np.int64 if a.mx64 else np.int32, a.mx_s * c)

    def first(hit):
        return np.where(hit.any(-1), hit.argmax(-1), 0)

    lf = _arr(a.lf, np.int64, 2 * big_m)
    lf[:big_m] = first(rows == fa[:, None])
    lf[big_m:] = first(rows == fb[:, None])
    _arr(a.max_id_out, np.int64 if a.mx64 else np.int32, big_m)[:] = mx
    pvec = _arr(a.pvec, np.float32, big_m * di.N_ROW).reshape(big_m, di.N_ROW)
    log_nfpb = torch.tensor(_arr(a.log_nfpb, np.float32, 1)[0])
    for k in range(big_m):
        par = RippeParams(*[torch.tensor(_arr(a.par[q], np.float32, a.par_s[q] * (a.C - 1)
                                                 + 1)[a.par_s[q] * c[k]])
                               for q in range(di.N_PARAMS)])
        pvec[k] = lc.params_vector(par, log_nfpb).numpy()


def i2_transcribed(a: di.VecArgs, reciprocal: bool):
    """I2 in numpy from its argument block: each (slot, genome, sub row)
    from the slot's member row and validity read at their strides, the
    genome's fields at their strides and the tables at the clamped sub row,
    in the kernel's operation order (int32 -> f32 rounding to nearest, the
    scale by 1 / 1000, then (start_kb + w) + len_kb * 0.5). ``reciprocal``:
    scale by the block's f32 reciprocal (the kernel, torch on the card)
    instead of dividing by 1,000 (torch on the CPU). Writes the block's
    outputs."""
    big_m, r = a.C * a.m, a.R
    s = np.arange(big_m)[:, None, None]
    g = np.arange(di.N_GEN)[None, :, None]
    k = np.arange(r)[None, None, :]
    c, j = s // a.m, s % a.m
    i, t = k // a.s_max, k % a.s_max
    f = _read(a.rows, np.int64, a.rows_cs * c + a.rows_ms * j + a.rows_is * i)[:, 0]   # (M, R)
    ok = _read(a.valid, np.uint8, a.valid_cs * c + a.valid_ms * j + a.valid_is * i)[:, 0] != 0
    t2 = t[:, 0]
    sub = _read(a.sub_start, np.int64, f) + t2
    sub_valid = ok & (t2 < _read(a.sub_count, np.int64, f))
    sc = np.clip(sub, 0, a.K - 1)

    def field(q):
        return _read(a.g[q], np.int32, a.g_ss[q] * s + a.g_gs[q] * g + a.g_is[q] * i)

    def table(ptr):
        return _arr(ptr, np.float32, a.K)[sc][:, None, :]

    def kb(x):
        x = x.astype(np.float32)
        return x * np.float32(a.inv_kb) if reciprocal else x / np.float32(1000.0)

    start_bp, ori, id_c, circ, l_cont_bp, activ = (field(q) for q in range(len(di.READ)))
    w = np.where(ori == 1, table(a.prefix), table(a.suffix))
    mid = (kb(start_bp) + w) + table(a.len_kb) * np.float32(0.5)
    act = (activ == 1) & sub_valid[:, None, :]
    accu_sub = _arr(a.accu, np.float32, a.K)[sc]
    # torch's log on the plain version's own (M, R) layout: its vectorised
    # and scalar loops may differ in the last bit
    log_accu = torch.log(torch.from_numpy(np.ascontiguousarray(accu_sub))).numpy()
    la = np.where(act, log_accu[:, None, :], np.float32(-1e9))
    key = _arr(a.key_of, np.int64, a.K)[sc] if a.key_of else sc
    keys = np.where(act[:, 0], key, -1).astype(np.int32)
    n = big_m * di.N_GEN * r
    outs = [(a.mid, np.float32, mid), (a.idc, np.int32, id_c),
            (a.circ, np.float32, circ.astype(np.float32)), (a.stot, np.float32, kb(l_cont_bp)),
            (a.la, np.float32, la), (a.keys, np.int32, keys)]
    if a.act:
        outs += [(a.act, np.uint8, act.astype(np.uint8)), (a.circ_i, np.int32, circ),
                 (a.accu_sub, np.float32, accu_sub)]
    for ptr, dt, x in outs:
        assert x.dtype == dt and x.size in (n, big_m * r)
        _arr(ptr, dt, x.size)[:] = x.reshape(-1)


def _bump(ptr):
    ctypes.c_int64.from_address(ptr).value += 1


def _stand_in_slots(block, stream):
    """I1's entry point as the stand-in library runs it: the transcription,
    then one added to the block's counter, as the kernel adds it."""
    a = block._obj
    i1_transcribed(a)
    _bump(a.counter)
    return 0


def _stand_in_vectors(block, stream):
    """I2's, dividing by 1,000 as the plain version does on the CPU."""
    a = block._obj
    i2_transcribed(a, reciprocal=False)
    _bump(a.counter)
    return 0


STAND_IN = types.SimpleNamespace(delta_slots=_stand_in_slots, delta_vectors=_stand_in_vectors)


class StandIn(di.DeltaInputKernels):
    """The wrapper itself on CPU tensors (its checks, argument blocks and
    counters), its library replaced by :data:`STAND_IN`, whose entry points
    run the transcriptions and count the launches in the blocks' counters
    as the kernels do."""

    @staticmethod
    def _card(dev):
        pass


def route_to_card(monkeypatch):
    """Send every delta scorer's inputs through its card branches and a
    stand-in wrapper over the stand-in library; a torch add counting a
    launch beside the kernels fails the test."""
    def refuse(self, device, key=None):
        raise AssertionError(f"a torch add counted {key} beside a self-counting kernel")

    spy = StandIn()
    monkeypatch.setattr(di, "load_library", lambda: STAND_IN)
    monkeypatch.setattr(LaunchCount, "add", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(td, "INPUTS", spy)
    monkeypatch.setattr(td.DeltaScorer, "slot_inputs", td.DeltaScorer._slots_on_card)
    monkeypatch.setattr(td.DeltaScorer, "sub_vectors", td.DeltaScorer._vectors_on_card)
    return spy


@pytest.fixture(scope="module")
def problem():
    """The 36-bin problem of tests/test_torch_delta.py (3 subs a bin) and
    the repeat twin of tests/test_torch_delta_repeats.py, each with its
    JAX oracle scorers compiled once."""
    state, table = make_genome(n_bins=36, n_contigs=6, subs_per_bin=3, seed=4)
    params = default_params(fact=4000.0)
    obs = simulate_contacts(state, table, params, seed=4)
    sobs = js.sparse_from_dense(obs)
    rstate, rtable, rparams, robs = _repeat_problem()
    rsobs = js.sparse_from_dense(robs)
    oracle = dict(grid_impl="jnp", obs_impl="einsum")
    p = dict(state=state)
    walked = {k: _case_states(p, k) for k in ("sparse", "circular", "inactive")}
    return dict(
        state=state, walked=walked, table=table, params=params, sobs=sobs,
        t_table=convert.table_from_numpy(table._asdict()),
        t_params=convert.params_from_numpy(params._asdict()),
        t_sobs=convert.sparse_from_numpy(sobs._asdict()),
        rstate=rstate, rtable=rtable, rparams=rparams, rsobs=rsobs,
        rt_table=convert.table_from_numpy(rtable._asdict()),
        rt_params=convert.params_from_numpy(rparams._asdict()),
        rt_sobs=convert.sparse_from_numpy(rsobs._asdict()),
        em=jax.jit(jd.make_delta_scorer(table, None, F_MAX, sobs=sobs, **oracle)),
        mh=jax.jit(jd.make_delta_scorer(table, None, F_MAX, sobs=sobs,
                                        catalogue=j_mh_candidates, **oracle)),
        repeat=jax.jit(jdr.make_repeat_delta_scorer_v2(rtable, REPEAT_F_MAX, rsobs)))


def chains(states):
    """Port genomes stacked on a chains axis."""
    return TState(*[torch.stack(xs) for xs in zip(*[to_port(s) for s in states])])


def case(p, name):
    """(scorer, states (C, n), f_a (C,), ids (C, m), params, union,
    catalogue) of one transcription case."""
    gen = np.random.default_rng(len(name))
    walked = p["walked"]["sparse"]
    if name != "key_of":
        f_max = 4 if name == "f_b_absent" else F_MAX
        scorer = td.make_delta_scorer(p["t_table"], None, f_max, sobs=p["t_sobs"])
        if name == "varied_subs":     # 1 to 3 sub rows a fragment, of the 3 rows it spans
            counts = torch.as_tensor(gen.integers(1, 4, scorer.vt.sub_count.shape[0]))
            scorer.vt = scorer.vt._replace(sub_count=counts)
        params = p["t_params"]
        if name == "each_3_chains":
            states = chains([walked, p["state"], p["walked"]["circular"]])
            params = params._replace(fact=params.fact * torch.tensor([1.0, 1.1, 0.9]),
                                     d=params.d.expand(3).clone())
        else:
            states = chains([p["walked"][name] if name in ("circular", "inactive")
                             else walked])
        n, c = states.pos.shape[1], states.pos.shape[0]
        f_a = torch.as_tensor(gen.integers(n, size=c))
        ids = torch.as_tensor(gen.integers(n, size=(c, 5)), dtype=torch.int32
                              if name == "each_3_chains" else torch.int64)
        ids[:, 0] = f_a                                   # fA among its neighbours
        if name == "circular":
            f_a[0] = int(np.nonzero(states.circ[0].numpy() == 1)[0][0])
        if name == "inactive":
            f_a[0], ids[0, 1] = 2, 20
        union = name != "each_3_chains"
        return scorer, states, f_a, ids, params, union, (build_candidates if union
                                                         else mh_candidates)
    scorer = tdr.make_repeat_delta_scorer_v2(p["rt_table"], REPEAT_F_MAX, p["rt_sobs"],
                                             to_port(p["rstate"]).rep).plain
    states = chains([p["rstate"], p["rstate"]])
    n = states.pos.shape[1]
    rep = np.nonzero(states.rep[0].numpy() == 1)[0]
    f_a = torch.tensor([int(rep[-1]), 3])
    ids = torch.as_tensor(gen.integers(n, size=(2, 4)))
    ids[0, 0] = int(rep[0])
    return scorer, states, f_a, ids, p["rt_params"], False, build_candidates


CASES = ("union_1_chain", "each_3_chains", "circular", "inactive", "f_b_absent", "varied_subs",
         "key_of")


def bits(x):
    """``x``'s bytes as integers (bools and floats compared bit for bit)."""
    return {torch.bool: torch.uint8, torch.float32: torch.int32}.get(x.dtype, x.dtype) \
        and x.view({torch.bool: torch.uint8, torch.float32: torch.int32}.get(x.dtype, x.dtype))


@pytest.mark.parametrize("name", CASES)
def test_transcriptions_match_the_plain_versions(problem, name):
    """I1's and I2's index and rounding order, bit for bit the plain
    versions, padding included, on the rows' own strides (the extraction's
    output, and a column-major copy of it)."""
    scorer, states, f_a, ids, params, union, catalogue = case(problem, name)
    extract = td.extract_rows_union if union else td.extract_rows_each
    rows, valid, overflow = extract(states, f_a, ids, scorer.f_max)
    max_id = states.id_c.amax(-1)
    want = td.slot_inputs_plain(rows, f_a, ids, max_id, params, scorer.log_nfpb)
    c, m, f_max = rows.shape
    absent = ~(rows == ids[..., None]).any(-1).reshape(-1)
    if name == "f_b_absent":
        assert bool(absent.any()) and bool(overflow.any())
    for label, (r, v) in (("as extracted", (rows, valid)),
                          ("column-major", (rows.mT.contiguous().mT, valid.mT.contiguous().mT))):
        a, keep, got = di.slot_args(r, f_a, ids, max_id, params, scorer.log_nfpb)
        i1_transcribed(a)
        for g, w, what in zip(got, want, ("lf_a", "lf_b", "max_id", "pvec")):
            assert g.dtype == w.dtype and torch.equal(g, w), (name, label, what)
        assert bool((got[1][absent] == 0).all())
        mini = td.gather_mini(states, r, v)
        full = catalogue(TState(*[x.reshape(c * m, f_max) for x in mini]), got[0], got[1],
                         max_id=got[2], with_base=True)
        for extras in (False, True):
            pv = td.sub_vectors_plain(full, r, v, scorer.vt, extras)
            a, keep, vec = di.vector_args(full, r, v, scorer.vt, extras)
            i2_transcribed(a, reciprocal=False)
            for what, g, w in zip(di.SubVectors._fields, vec, pv):
                assert (g is None) == (w is None), what
                if w is not None:
                    assert g.dtype == w.dtype and torch.equal(bits(g), bits(w)), \
                        (name, label, extras, what)
            assert bool((vec.la > -1e9).any()) and bool((vec.keys >= 0).any())
            if name == "inactive":
                assert bool(((vec.la[:, 0] > -1e9) != (vec.keys >= 0)).sum() == 0)
            # the card's form: x * f32(1 / 1000)
            i2_transcribed(a, reciprocal=True)
            kb = torch.tensor(di.INV_KB)
            subs, _ = scorer.sub_rows(r.reshape(c * m, f_max), v.reshape(c * m, f_max))
            sc = subs.clamp(0, scorer.k_subs - 1)
            os_ = torch.arange(f_max).repeat_interleave(scorer.s_max)
            vt = scorer.vt
            mid = full.start_bp[..., os_].float() * kb \
                + torch.where(full.ori[..., os_] == 1, vt.prefix[sc][:, None],
                              vt.suffix[sc][:, None]) + vt.len_kb[sc][:, None] * 0.5
            assert torch.equal(vec.mid, mid), (name, label)
            assert torch.equal(vec.stot, full.l_cont_bp[..., os_].float() * kb)
            del keep
    if name == "key_of":
        assert scorer.vt.key_of is not None and scorer.extras
        assert not torch.equal(vec.keys, torch.where(vec.keys >= 0, sc.int(), -1))


def test_scorers_through_the_card_dispatch_match_jax(problem, monkeypatch):
    """The plain engine, the delta MH catalogue and the repeat engine with
    I1 / I2 through the card's dispatch (the transcriptions) against the
    JAX package's jnp oracles: candidates, rows and overflow bit-equal, dll
    at rtol 1e-4, atol 1e-2, and bit for bit the scorers' CPU path; a
    chains-axis call launches one I1 and one I2 for all its chains."""
    p = problem
    plain = {}
    em = td.make_delta_scorer(p["t_table"], None, F_MAX, sobs=p["t_sobs"])
    mh = td.make_delta_scorer(p["t_table"], None, F_MAX, sobs=p["t_sobs"],
                              catalogue=mh_candidates)
    rep = tdr.make_repeat_delta_scorer_v2(p["rt_table"], REPEAT_F_MAX, p["rt_sobs"],
                                          to_port(p["rstate"]).rep)
    rr = np.nonzero(np.asarray(p["rstate"].rep) == 1)[0]
    runs = [("em", em, p["em"], [(p["walked"][k], pair) for k in ("sparse", "circular",
                                                                  "inactive")
                                 for pair in ((2, 5), (20, 30), (7, 7))],
             p["params"], p["t_params"]),
            ("mh", mh, p["mh"], [(p["walked"]["sparse"], pair)
                                 for pair in ((3, 4), (0, 23), (12, 12))],
             p["params"], p["t_params"]),
            ("repeat", rep, p["repeat"], [(p["rstate"], pair)
                                          for pair in ((int(rr[-1]), 5), (int(rr[0]), int(rr[-1])),
                                                       (3, 8))],
             p["rparams"], p["rt_params"])]

    def score_all(route):
        spy = route_to_card(monkeypatch) if route else None
        out = {}
        for kind, scorer, _, cases, _, tparams in runs:
            for k, (state, (f_a, f_b)) in enumerate(cases):
                ts_ = to_port(state)
                out[kind, k] = scorer(ts_, f_a, f_b, tparams, ts_.id_c.amax())
        monkeypatch.undo()
        return out, spy

    plain, _ = score_all(False)
    routed, spy = score_all(True)
    assert spy.launches.by_key() == {"delta_slots": len(plain), "delta_vectors": len(plain)}
    for kind, _, oracle, cases, jparams, _ in runs:
        for k, (state, (f_a, f_b)) in enumerate(cases):
            got = routed[kind, k]
            want = oracle(state, jnp.int32(f_a), jnp.int32(f_b), jparams, jnp.max(state.id_c))
            msg = f"{kind} {k} f_a={f_a} f_b={f_b}"
            assert bool(got[4]) == bool(want[4]), msg
            np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]), err_msg=msg)
            np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]), err_msg=msg)
            assert_states_equal(got[1], want[1], msg)
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=DLL_RTOL,
                                       atol=DLL_ATOL, err_msg=msg)
            assert all(torch.equal(g, w) for g, w in zip(got[0:1] + tuple(got[1]),
                                                         plain[kind, k][0:1]
                                                         + tuple(plain[kind, k][1]))), msg
    # a chains-axis call: one launch of each for all chains
    s3 = chains([p["walked"]["sparse"], p["state"], p["walked"]["inactive"]])
    f_a = torch.tensor([2, 20, 31])
    ids = torch.tensor([[5, 2, 30, 11, 7], [21, 19, 3, 2, 20], [2, 7, 8, 9, 10]])
    rows, valid, over = td.extract_rows_union(s3, f_a, ids, F_MAX)
    pc = p["t_params"]._replace(fact=p["t_params"].fact * torch.tensor([1.0, 1.2, 0.8]))
    want = em.score(s3, f_a, ids, rows, valid, over, pc, s3.id_c.amax(-1))
    spy = route_to_card(monkeypatch)
    got = em.score(s3, f_a, ids, rows, valid, over, pc, s3.id_c.amax(-1))
    assert spy.launches.by_key() == {"delta_slots": 1, "delta_vectors": 1}
    assert torch.equal(got[0], want[0]) and all(torch.equal(g, w)
                                                for g, w in zip(got[1], want[1]))


@pytest.fixture(scope="module")
def good(problem):
    """One 3-chain call's arguments of I1 and of I2 that the checks
    accept: (scorer, slots, vectors); the tests change copies."""
    scorer, states, f_a, ids, params, _, catalogue = case(problem, "each_3_chains")
    rows, valid, _ = td.extract_rows_each(states, f_a, ids, scorer.f_max)
    c, m, f_max = rows.shape
    mini = td.gather_mini(states, rows, valid)
    max_id = states.id_c.amax(-1)
    lf_a, lf_b, mx, _ = td.slot_inputs_plain(rows, f_a, ids, max_id, params, scorer.log_nfpb)
    full = catalogue(TState(*[x.reshape(c * m, f_max) for x in mini]), lf_a, lf_b, max_id=mx,
                     with_base=True)
    return scorer, dict(rows=rows, f_a=f_a, ids=ids, max_id=max_id, params=params,
                        log_nfpb=scorer.log_nfpb), dict(full=full, rows=rows, valid=valid,
                                                        tables=scorer.vt)


BAD_SLOTS = {
    "rows int32": lambda a: a.update(rows=a["rows"].int()),
    "rows 2-d": lambda a: a.update(rows=a["rows"][0]),
    "f_a float": lambda a: a.update(f_a=a["f_a"].float()),
    "ids shape": lambda a: a.update(ids=a["ids"][:, :-1]),
    "max_id 0-d": lambda a: a.update(max_id=a["max_id"][0]),
    "f64 parameter": lambda a: a.update(params=a["params"]._replace(d=a["params"].d.double())),
    "2 sets for 3 chains": lambda a: a.update(params=a["params"]._replace(
        lm=a["params"].lm.expand(2))),
    "log_nfpb (1,)": lambda a: a.update(log_nfpb=a["log_nfpb"][None]),
    "too many slots": lambda a: a.update(rows=a["rows"][:1, :1].expand(di.MAX_SLOTS + 1, 1, -1),
                                         f_a=torch.zeros(di.MAX_SLOTS + 1, dtype=torch.int64),
                                         ids=torch.zeros((di.MAX_SLOTS + 1, 1),
                                                         dtype=torch.int64),
                                         max_id=torch.zeros(di.MAX_SLOTS + 1,
                                                            dtype=torch.int32)),
}
BAD_VECTORS = {
    "field int64": lambda a: a.update(full=a["full"]._replace(ori=a["full"].ori.long())),
    "field shape": lambda a: a.update(full=a["full"]._replace(circ=a["full"].circ[:, 1:])),
    "10 fields": lambda a: a.update(full=tuple(a["full"])[:10]),
    "valid int": lambda a: a.update(valid=a["valid"].int()),
    "valid shape": lambda a: a.update(valid=a["valid"][:, :-1]),
    "sub_start int32": lambda a: a.update(tables=a["tables"]._replace(
        sub_start=a["tables"].sub_start.int())),
    "prefix f64": lambda a: a.update(tables=a["tables"]._replace(
        prefix=a["tables"].prefix.double())),
    "strided accu": lambda a: a.update(tables=a["tables"]._replace(
        accu=torch.stack([a["tables"].accu] * 2, 1)[:, 0])),
    "key_of int32": lambda a: a.update(tables=a["tables"]._replace(
        key_of=torch.zeros_like(a["tables"].prefix, dtype=torch.int32))),
    "len_kb length": lambda a: a.update(tables=a["tables"]._replace(
        len_kb=a["tables"].len_kb[:-1])),
}


@pytest.mark.parametrize("name", sorted(BAD_SLOTS))
def test_slot_checks_refuse(good, name):
    slots = dict(good[1])
    BAD_SLOTS[name](slots)
    with pytest.raises(ValueError):
        di.check_slots(**slots)


@pytest.mark.parametrize("name", sorted(BAD_VECTORS))
def test_vector_checks_refuse(good, name):
    vectors = dict(good[2])
    BAD_VECTORS[name](vectors)
    with pytest.raises(ValueError):
        di.check_vectors(**vectors)


def test_checks_accept_and_wrapper_refuses_cpu(good):
    scorer, slots, vectors = good
    assert di.check_slots(**slots) == (3, 5, F_MAX)
    assert di.check_vectors(**vectors) == (3, 5, F_MAX, F_MAX * scorer.s_max, scorer.k_subs)
    with pytest.raises(ValueError, match="on a card"):
        di.INPUTS.slots(**slots)
    with pytest.raises(ValueError, match="on a card"):
        di.INPUTS.vectors(**vectors, extras=False)
    assert di.INPUTS.n_launches == 0


def _c_fields(struct):
    """The member names of ``struct`` in csrc/delta_inputs.cu, in order."""
    src = (CSRC / "delta_inputs.cu").read_text()
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, src, re.S).group(1)
    names = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line.endswith(";"):
            continue
        for part in line[:-1].split(","):
            names.append(re.sub(r"\[.*\]", "", part.strip().split()[-1]).lstrip("*"))
    return names


@pytest.mark.parametrize("struct, mirror, size", [("SlotArgs", di.SlotArgs, 280),
                                                  ("VecArgs", di.VecArgs, 424)])
def test_ctypes_mirrors_follow_the_c_structs(struct, mirror, size):
    assert _c_fields(struct) == [name for name, _ in mirror._fields_]
    assert ctypes.sizeof(mirror) == size
    src = (CSRC / "delta_inputs.cu").read_text()
    assert di.READ == tuple(re.search(r"enum Field \{(.*?)\}", src).group(1).lower()
                            .replace(" = 0", "").replace(" ", "").split(",")[:-1])


def test_shared_headers():
    """I1 writes its rows with params_row.cuh (D1's and H1's code) and I2
    its midpoints with sub_geometry.cuh (H1's): no kernel keeps its own
    copy."""
    for name in ("delta_inputs.cu", "vectors.cu"):
        src = (CSRC / name).read_text()
        assert '#include "sub_geometry.cuh"' in src and "sub_mid(" in src, name
        assert "__fadd_rn(__fadd_rn(" not in src, name
    src = (CSRC / "delta_inputs.cu").read_text()
    assert '#include "params_row.cuh"' in src and "write_params_row(" in src
    assert "log_k3fact" not in src
