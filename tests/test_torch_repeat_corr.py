"""Kernels F1 / F2 of the repeat engine's copy corrections
(graal_tpu_torch/ops/repeat_corr_cuda.py, csrc/repeat_corr.cu) on the CPU,
where the kernels cannot run: what surrounds them.

- The chains-axis ``RepeatDeltaScorer.score`` (every chain's corrections
  in one ``corrections`` call) on tests/test_delta_repeats.py's repeat
  problem, 3 chains on 3 genomes, each (chain, neighbour) held to JAX's
  ``make_repeat_delta_scorer_v2`` on the same inputs at DLL_RTOL, DLL_ATOL =
  1e-4, 1e-2 (tests/test_torch_delta_repeats.py: the port sums corrections
  in f64, JAX in f32), candidates and rows bit-equal, and to the same
  chain scored alone bit for bit. Cases: random pairs, a repeat copy, an
  inactive copy, a circular contig.
- The card branch (``RepeatDeltaScorer._corrections_on_card``) through a
  stand-in wrapper: the wrapper's argument checks, then the plain version
  (as tests/test_torch_step_kernels.py and test_torch_mtm_kernels.py hold
  D1-D3 and E1-E3). The repeat delta EM step
  (one chain and a chains axis), the delta MH step, the delta cycle and
  ``ScaleRunner.run`` give the plain runs' results bit for bit, with one
  wrapper call a scoring call and no call of ``_corrections`` outside it.
- F1's staged routing, transcribed: the valid prefix's length (the count
  of valid rows) and each copy row's slot by binary search over the
  ascending valid member rows equal the plain version's (n + 1) scatter
  ``inv_f``, padding rows and rows outside D included, at buckets that
  overflow and that do not (the bitmap router:
  tests/test_torch_f1_g2_design.py).
- Edge tables: no mixed entry, no multi-multi entry, pairs that overflow,
  fA with two subs a fragment (s_max 2), twelve copies a duplicated bin
  (the kernels take any number), each against JAX and through the
  stand-in.
- The copy sums' order: the plain version's ``_copy_sum`` is the left fold
  that F1 / F2 write out.
- The wrapper's checks: ``check_corrections`` on good and bad arguments,
  the refusal of CPU tensors, ``make_tables``' layout, and the ctypes
  mirrors' fields in the order of the C structs.
"""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graal_tpu.core import delta_repeats as jdr
from graal_tpu.core import mcmc as jm
from graal_tpu.core import sparse as js
from graal_tpu_torch import entry as tentry
from graal_tpu_torch import scale as tscale
from graal_tpu_torch.core import delta as td
from graal_tpu_torch.core import delta_repeats as tdr
from graal_tpu_torch.core import mcmc as tm
from graal_tpu_torch.core import mtm as tmtm
from graal_tpu_torch.core.state import GenomeState
from graal_tpu_torch.ops import repeat_corr_cuda as rc
from graal_tpu_torch.parallel import tempering as ttemp
from tests.test_delta_repeats import _repeat_problem
from tests.test_torch_delta_repeats import _case, _port
from tests.test_torch_state import assert_states_equal, to_port

DLL_RTOL, DLL_ATOL = 1e-4, 1e-2
F_MAX = 24
DELTA = 4
MTM_DELTA = 5
C = 3
ORIG_CORRECTIONS = tdr.RepeatDeltaScorer._corrections


@pytest.fixture(scope="module")
def problem():
    return _port(*_repeat_problem())


@pytest.fixture(scope="module")
def inactive_problem():
    return _port(*_repeat_problem(seed=12, deactivate=(30,)))


@pytest.fixture(scope="module")
def jax_v2():
    """Compiled JAX v2 scorers, by (problem, bucket)."""
    return {}


def jax_scorer(jax_v2, p, f_max=F_MAX):
    key = id(p["table"]), id(p["obs"]), f_max
    if key not in jax_v2:
        jax_v2[key] = jax.jit(jdr.make_repeat_delta_scorer_v2(p["table"], f_max, p["sobs"]))
    return jax_v2[key]


def chain_genomes(state):
    """Three genomes of one problem for a chains axis: the state, one
    mutation of it (a repeat copy's flip) and its exploded start."""
    n = state.n_frags
    return [state, jm.apply_mutation(state, int(n - 1), 4, 3), jm.explode_genome(state)]


def stack(states):
    return GenomeState(*[torch.stack(xs) for xs in zip(*states)])


def check_chains_score(p, pairs, jax_v2, f_max=F_MAX, msg=""):
    """The chains-axis score of 3 chains (chain k: genome k, f_a of pair k,
    neighbours the f_b of pairs k and k + 1) against JAX per (chain,
    neighbour) where the pair does not overflow (an overflowed slot is
    never selected), and against each chain scored alone."""
    score_j = jax_scorer(jax_v2, p, f_max)
    scorer = tdr.make_repeat_delta_scorer_v2(p["tt"], f_max, p["tsobs"], p["ts"].rep)
    genomes = chain_genomes(p["state"])
    states = stack([to_port(g) for g in genomes])
    f_a = torch.tensor([pairs[k % len(pairs)][0] for k in range(C)])
    ids = torch.tensor([[pairs[k % len(pairs)][1], pairs[(k + 1) % len(pairs)][1]]
                        for k in range(C)])
    max_id = states.id_c.amax(-1)
    rows, valid, over = td.extract_rows_each(states, f_a, ids, scorer.f_max)
    dll, cands, *_ = scorer.score(states, f_a, ids, rows, valid, over, p["tp"], max_id)
    assert dll.shape == (C, 2, 13)
    for k, g in enumerate(genomes):
        alone = scorer.score(GenomeState(*[x[k] for x in states]), f_a[k], ids[k], rows[k],
                             valid[k], over[k], p["tp"], max_id[k])
        assert torch.equal(alone[0], dll[k]), (msg, k)
        for i in range(2):
            want = score_j(g, jnp.int32(int(f_a[k])), jnp.int32(int(ids[k, i])), p["params"],
                           jnp.max(g.id_c))
            where = f"{msg} chain {k} f_a={int(f_a[k])} f_b={int(ids[k, i])}"
            np.testing.assert_array_equal(rows[k, i].numpy(), np.asarray(want[2]), err_msg=where)
            np.testing.assert_array_equal(valid[k, i].numpy(), np.asarray(want[3]),
                                          err_msg=where)
            assert bool(over[k, i]) == bool(want[4]), where
            assert_states_equal(GenomeState(*[x[k, i] for x in cands]), want[1], where)
            if bool(over[k, i]):              # never selected: its deltas are not compared
                continue
            np.testing.assert_allclose(dll[k, i].numpy(), np.asarray(want[0]), rtol=DLL_RTOL,
                                       atol=DLL_ATOL, err_msg=where)
    return scorer, over


@pytest.mark.parametrize("case", ["random", "repeat_copy", "inactive_copy", "circular"])
def test_chains_score_matches_jax(problem, inactive_problem, jax_v2, case):
    p, pairs = _case(case, problem, inactive_problem)
    if len(pairs) == 1:                   # the circular case: one pair, and two more
        pairs = pairs + [(3, 8), (int(np.nonzero(np.asarray(p["state"].rep))[0][0]), 5)]
    check_chains_score(p, pairs, jax_v2, msg=case)


# ---- the card branch through a stand-in wrapper ------------------------------

class StandIn:
    """The wrapper's contract in plain torch: its argument block (checks,
    scratch and outputs at the table's copy count), then the plain version
    of the engine the tables belong to (each engine built while the
    stand-in is routed is registered by its tables). Counts its calls;
    ``_corrections`` is reachable only from inside it."""

    def __init__(self):
        self.calls = 0
        self.active = False
        self.engines = {}

    def corrections(self, tables, state, f_a, rows, valid, geo, accu_sub, pvec, dll1):
        a, _, out = rc.call_args(tables, state, f_a, rows, valid, geo, accu_sub, pvec, dll1)
        assert a.t.c_max == tables.c_max and out[0].shape == (rows.shape[0] * rows.shape[1], 14)
        self.calls += 1
        self.active = True
        try:
            return self.engines[id(tables)].corrections_plain(state, f_a, rows, valid, geo,
                                                              accu_sub, pvec, dll1)
        finally:
            self.active = False


def route_to_card(monkeypatch, spy):
    """Send ``RepeatDeltaScorer.corrections`` to its card branch (CPU
    tensors included) and that to ``spy``; ``_corrections`` raises unless
    the stand-in calls it."""
    init = tdr.RepeatDeltaScorer.__init__

    def register(self, *args, **kw):
        init(self, *args, **kw)
        spy.engines[id(self.corr_tables)] = self

    def guarded(self, *args):
        assert spy.active, "the card branch reached _corrections"
        return ORIG_CORRECTIONS(self, *args)

    monkeypatch.setattr(tdr, "CORR", spy)
    monkeypatch.setattr(tdr.RepeatDeltaScorer, "__init__", register)
    monkeypatch.setattr(tdr.RepeatDeltaScorer, "corrections",
                        tdr.RepeatDeltaScorer._corrections_on_card)
    monkeypatch.setattr(tdr.RepeatDeltaScorer, "_corrections", guarded)


@pytest.fixture(scope="module")
def small():
    """tests/test_torch_chains_delta.py's repeat problem (240 bins, 6
    duplicated), its runner and 3 chain starts."""
    truth, shuf, table, params, sobs, id_d = tentry.scale_repeat_problem(240, n_dups=6,
                                                                         device="cpu")
    runner = tscale.ScaleRunner(table, sobs, params, id_d=id_d)
    starts = stack([shuf, tm.explode_genome(shuf), truth])
    return dict(truth=truth, shuf=shuf, table=table, params=params, sobs=sobs, runner=runner,
                starts=starts, id_d=id_d)


def trees_equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(trees_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(trees_equal(a[k], b[k]) for k in a)
    return a == b


def run_em_steps(s, chains, n_steps=6, seed=3):
    """Delta EM steps on the repeat table on shared draws: one chain (the
    shuffled start) or a chains axis of 3 (their own temperatures)."""
    r = s["runner"]
    step = td.make_delta_em_step(s["table"], None, r.nb, DELTA, 64, sobs=s["sobs"],
                                 rep=s["shuf"].rep)
    gen = torch.Generator().manual_seed(seed)
    rep = torch.nonzero(s["shuf"].rep == 1).reshape(-1)
    states = s["starts"] if chains else s["shuf"]
    l_t = torch.zeros(C) if chains else torch.zeros(())
    out = []
    for it in range(n_steps):
        if chains:
            draws = ttemp.draw_chain_inputs(gen, r.nb, DELTA, C)
            f_a = rep[torch.randint(len(rep), (C,), generator=gen)]
            f_t = torch.tensor([1.0, 2.0, 4.0])
        else:
            draws = tm.draw_step_inputs(gen, r.nb, DELTA)
            f_a = rep[int(torch.randint(len(rep), (), generator=gen))]
            f_t = 1.0
        states, l_t, outs = step(states, draws, s["params"], l_t, f_a, f_t)
        out.append((states, l_t, outs))
    return out, n_steps


def run_mh_steps(s, n_steps=6, seed=4):
    """Delta MH steps on the repeat table (two scoring calls a step)."""
    r = s["runner"]
    jump = r.jump_table(MTM_DELTA, s["shuf"].n_frags)
    step = tmtm.make_delta_mh_step(s["table"], jump, 64, s["sobs"], rep=s["shuf"].rep)
    gen = torch.Generator().manual_seed(seed)
    rep = torch.nonzero(s["shuf"].rep == 1).reshape(-1)
    state, l_t = s["shuf"], torch.tensor(-1000.0)
    out = []
    for it in range(n_steps):
        draws = tmtm.draw_move_inputs(gen, jump)
        f_a = rep[it % len(rep)] if it % 2 else torch.tensor(7 * it + 1)
        state, l_t, *rest = step(state, draws, s["params"], l_t, f_a, 1.0)
        out.append((state, l_t, rest))
    return out, 2 * n_steps


def run_cycle(s, n_steps=8, seed=5):
    """A repeat delta cycle (one scan of steps, eager on the CPU)."""
    r = s["runner"]
    cycle = td.make_delta_em_cycle(s["table"], None, r.nb, DELTA, 64, sobs=s["sobs"],
                                   anchor_fn=False, rep=s["shuf"].rep)
    gen = torch.Generator().manual_seed(seed)
    order = torch.randperm(s["shuf"].n_frags, generator=gen)[:n_steps]
    return cycle(s["shuf"], gen, s["params"], order, torch.tensor(-1000.0), 1.0), n_steps


def run_runner(s, seed=6):
    """ScaleRunner.run with id_d: 1 cycle of 12 extremity-first steps."""
    runner = tscale.ScaleRunner(s["table"], s["sobs"], s["params"], nb=s["runner"].nb,
                                id_d=s["id_d"])
    final, _, m = runner.run(s["shuf"], n_cycles=1, steps_per_cycle=12, f_max_min=32,
                             order_mode="extremity", seed=seed, progress=False)
    return (final, m["likelihood"], m["n_contigs"]), None


PATHS = {"em_step": lambda s: run_em_steps(s, False), "em_chains": lambda s: run_em_steps(s, True),
         "mh_step": run_mh_steps, "em_cycle": run_cycle, "runner": run_runner}


@pytest.mark.parametrize("path", list(PATHS))
def test_card_branch_through_stand_in(small, monkeypatch, path):
    """Every repeat delta path through the card branch (the wrapper a
    stand-in) gives the plain run's results bit for bit, with one wrapper
    call a scoring call and no call of ``_corrections`` outside it."""
    want, _ = PATHS[path](small)
    spy = StandIn()
    route_to_card(monkeypatch, spy)
    got, calls = PATHS[path](small)
    assert trees_equal(got, want), path
    if calls is None:
        assert spy.calls > 0
    else:
        assert spy.calls == calls, (spy.calls, calls)


# ---- F1's routing, transcribed -------------------------------------------------

def search_slots(rows, valid, frags):
    """F1's staged routing (csrc/repeat_corr.cu ``Router<STAGED>``),
    transcribed: the valid prefix's length as the count of valid rows, then
    each fragment's slot by a lower-bound binary search over the ascending
    valid rows (-1: not a member)."""
    nvalid = sum(bool(v) for v in valid)
    out = []
    for g in frags:
        lo, hi = 0, nvalid
        while lo < hi:
            mid = (lo + hi) >> 1
            if rows[mid] < g:
                lo = mid + 1
            else:
                hi = mid
        out.append(lo if lo < nvalid and rows[lo] == g else -1)
    return nvalid, out


@pytest.mark.parametrize("f_max", [4, 16, 64])
@pytest.mark.parametrize("genome", ["shuffled", "exploded", "truth"])
def test_routing_by_binary_search_equals_inv_f(small, f_max, genome):
    s = small
    state = {"shuffled": s["shuf"], "exploded": tm.explode_genome(s["shuf"]),
             "truth": s["truth"]}[genome]
    n = state.n_frags
    gen = torch.Generator().manual_seed(f_max)
    f_a = torch.randint(n, (), generator=gen)
    ids = torch.randint(n, (6,), generator=gen)
    rows, valid, over = td.extract_rows_each(state, f_a, ids, f_max)
    scorer = tdr.make_repeat_delta_scorer_v2(s["table"], f_max, s["sobs"], state.rep)
    t = scorer.corr_tables
    krows = torch.arange(t.owner.shape[0])
    for i in range(len(ids)):
        inv_f = torch.full((n + 1,), -1, dtype=torch.int64)
        inv_f.scatter_(0, torch.where(valid[i], rows[i], n), torch.arange(rows.shape[1]))
        nvalid, slots = search_slots(rows[i].tolist(), valid[i].tolist(), range(n))
        assert nvalid == int(valid[i].sum())
        assert bool(valid[i][:nvalid].all()) and not bool(valid[i][nvalid:].any())  # a prefix
        assert slots == inv_f[:n].tolist(), (genome, f_max, i)
        # the mini rows of every copy row, as F1 forms them from the slot
        in_d, mrow = scorer.route(inv_f[None, :n], krows, shared=True)
        slot = torch.tensor(slots)[t.owner.long()]
        got = (slot.clamp_min(0) * t.s_max + (krows - t.sub_start.long()[t.owner.long()])) \
            .clamp(0, scorer.r_max - 1)
        assert torch.equal(slot >= 0, in_d[0])
        assert torch.equal(got, mrow[0])
    if f_max == 4 and genome != "exploded":
        assert bool(over.any())


# ---- edge tables ---------------------------------------------------------------

def edge_problem(kind):
    """tests/test_delta_repeats.py's repeat problem cut to an edge: no mixed
    (single, multi) entry, no multi-multi entry, twelve copies of each
    duplicated bin, or as it is (the overflow and two-subs cases)."""
    state, table, params, obs = _repeat_problem(seed=5, n_dup=11 if kind == "many_copies" else 1)
    if kind in ("no_mixed", "no_multi_multi"):
        dup = np.bincount(np.asarray(table.data_id), minlength=table.n_data_sub) >= 2
        obs = np.array(obs)
        cut = np.outer(~dup, dup) if kind == "no_mixed" else np.outer(dup, dup)
        obs[cut | cut.T] = 0.0
    return _port(state, table, params, obs)


EDGES = {"no_mixed": F_MAX, "no_multi_multi": F_MAX, "overflow": 6, "s_max_2": F_MAX,
         "many_copies": F_MAX}


@pytest.mark.parametrize("kind", list(EDGES))
def test_edge_tables(jax_v2, monkeypatch, kind):
    p = edge_problem(kind)
    rep = np.nonzero(np.asarray(p["state"].rep) == 1)[0]
    pairs = [(int(rep[0]), 5), (int(rep[-1]), int(rep[0])), (3, 19)]
    scorer, over = check_chains_score(p, pairs, jax_v2, f_max=EDGES[kind], msg=kind)
    t = scorer.corr_tables
    assert {"no_mixed": t.capm == 0, "no_multi_multi": t.dd_ob.shape[0] == 0,
            "overflow": bool(over.any()), "s_max_2": t.s_max == 2,
            "many_copies": t.dd_ob.shape[0] > 0 and t.capm > 0}[kind]
    assert t.capd > 0 and t.c_max == (12 if kind == "many_copies" else 2)
    # the card branch through the stand-in on the same table
    states = stack([p["ts"]] * C)
    f_a = torch.tensor([pairs[k][0] for k in range(C)])
    ids = torch.tensor([[pairs[k][1], 7] for k in range(C)])
    args = (states, f_a, ids, *td.extract_rows_each(states, f_a, ids, scorer.f_max), p["tp"],
            states.id_c.amax(-1))
    want = scorer.score(*args)
    spy = StandIn()
    route_to_card(monkeypatch, spy)
    spy.engines[id(t)] = scorer
    got = scorer.score(*args)
    assert trees_equal(got, want) and spy.calls == 1


# ---- the wrapper's checks ------------------------------------------------------

@pytest.fixture(scope="module")
def call(small):
    """One chains-axis scoring call's arguments of F1 / F2 and its engine."""
    s = small
    scorer = tdr.make_repeat_delta_scorer_v2(s["table"], 32, s["sobs"], s["shuf"].rep)
    states = s["starts"]
    f_a = torch.tensor([3, 40, 77])
    ids = torch.tensor([[5, 9, 200], [41, 2, 3], [1, 90, 150]])
    rows, valid, _ = td.extract_rows_each(states, f_a, ids, scorer.f_max)
    p = scorer.plain
    _, vec, ob, pvec = p.inputs(states, f_a, ids, rows, valid, s["params"],
                                states.id_c.amax(-1))
    _, dll1 = p.mini_grid(*p.mini_grid_args(vec, ob, pvec))
    return scorer, [states, f_a, rows, valid, td.geometry_of(vec), vec.accu_sub, pvec, dll1]


def test_check_accepts_a_scoring_call(call):
    scorer, args = call
    assert rc.check_corrections(scorer.corr_tables, *args) == (3, 3, 32, 32)
    corr, cross, dll = scorer.corrections(*args)
    assert corr.shape == (9, 14) and cross.shape == (9, 13) and dll.shape == (9, 13)
    assert corr.dtype == cross.dtype == torch.float64 and dll.dtype == torch.float32


def _bad(name):
    """A mutation of a call's arguments that F1 / F2 must refuse."""
    def state_field(args):
        st = args[0]
        args[0] = st._replace(ori=st.ori.long())

    def geo_field(args):
        args[4] = args[4]._replace(mid=args[4].mid.double())

    return {
        "rows_dtype": lambda a: a.__setitem__(2, a[2].int()),
        "rows_rank": lambda a: a.__setitem__(2, a[2][0]),
        "valid_shape": lambda a: a.__setitem__(3, a[3][:, :2]),
        "f_a_dtype": lambda a: a.__setitem__(1, a[1].int()),
        "f_a_chains": lambda a: a.__setitem__(1, a[1][:2]),
        "state_field": state_field,
        "geo_dtype": geo_field,
        "geo_width": lambda a: a.__setitem__(4, a[4]._replace(idc=a[4].idc[..., :8])),
        "accu_sub_shape": lambda a: a.__setitem__(5, a[5][:, :4]),
        "pvec_width": lambda a: a.__setitem__(6, a[6][:, :9]),
        "dll1_dtype": lambda a: a.__setitem__(7, a[7].double()),
    }[name]


@pytest.mark.parametrize("name", ["rows_dtype", "rows_rank", "valid_shape", "f_a_dtype",
                                  "f_a_chains", "state_field", "geo_dtype", "geo_width",
                                  "accu_sub_shape", "pvec_width", "dll1_dtype"])
def test_check_refuses(call, name):
    scorer, args = call
    args = list(args)
    _bad(name)(args)
    with pytest.raises(ValueError):
        rc.check_corrections(scorer.corr_tables, *args)


@pytest.mark.parametrize("c_max", [0, -1])
def test_check_refuses_copies_out_of_range(call, c_max):
    scorer, args = call
    with pytest.raises(ValueError, match="copy"):
        rc.check_corrections(scorer.corr_tables._replace(c_max=c_max), *args)


@pytest.mark.parametrize("c_max", [9, 40])
def test_check_takes_any_copy_count(call, c_max):
    scorer, args = call
    assert rc.check_corrections(scorer.corr_tables._replace(c_max=c_max), *args) == (3, 3, 32, 32)


@pytest.mark.parametrize("c", [1, 2, 3, 9, 12])
def test_copy_sum_is_a_left_fold(c):
    """``_copy_sum`` adds the copies in the order F1 / F2 fold them (copy
    0, then + copy 1, + copy 2, ...), in f32, on values whose sum depends
    on the order."""
    rng = np.random.default_rng(c)
    x = (rng.standard_normal((5, 7, c)) * 10.0 ** rng.integers(-6, 7, (5, 7, c))) \
        .astype(np.float32)
    want = x[..., 0].copy()
    for k in range(1, c):
        want = (want + x[..., k]).astype(np.float32)
    got = tdr._copy_sum(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_refuses_cpu_tensors(call):
    scorer, args = call
    kernels = rc.RepeatCorrKernels()
    with pytest.raises(ValueError, match="card"):
        kernels.corrections(scorer.corr_tables, *args)
    assert kernels.launches.by_key() == {} and kernels.n_launches == 0


def test_tables_layout(small, call):
    scorer, _ = call
    t = scorer.corr_tables
    for name in rc.CorrTables._fields[:25]:
        x = getattr(t, name)
        assert x.is_contiguous(), name
        assert x.dtype in (torch.int32, torch.float32, torch.bool), name
    assert torch.equal(t.owner.long(), small["table"].owner.long())
    assert torch.equal(t.copy_rows.long(), scorer.ct.copy_rows)
    assert torch.equal(t.so_start.long(), small["sobs"].row_start)
    assert t.inv_nfpb == float(np.float32(1.0) / np.float32(small["table"].n_frags_per_bins))
    assert t.inv_kb == float(np.float32(1.0) / np.float32(1000.0))
    assert (t.s_max, t.c_max) == (scorer.mt.s_max, scorer.ct.c_max)
    assert t.capd == small["sobs"].row_cap and t.capm == scorer.mixed.row_cap
    with pytest.raises(ValueError, match="int32"):
        rc._i32(torch.tensor([2 ** 31]))


def _c_fields(struct):
    """The member names of ``struct`` in csrc/repeat_corr.cu, in order."""
    src = (Path(rc.__file__).resolve().parent.parent / "csrc" / "repeat_corr.cu").read_text()
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, src, re.S).group(1)
    names = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line.endswith(";"):
            continue
        decl = line[:-1]
        for part in decl.split(","):
            names.append(re.sub(r"\[.*\]", "", part.strip().split()[-1]).lstrip("*"))
    return names


@pytest.mark.parametrize("struct, mirror", [("Tables", rc.Tables), ("CorrArgs", rc.CorrArgs)])
def test_ctypes_mirrors_follow_the_c_structs(struct, mirror):
    assert _c_fields(struct) == [name for name, _ in mirror._fields_]
    assert ctypes.sizeof(mirror) % 8 == 0
