"""Kernels G1-G3 of the delta engine's member rows and mini-states
(graal_tpu_torch/ops/rows_cuda.py, csrc/rows.cu) on the CPU, where the
kernels cannot run: what they must compute and what surrounds them.

- The public functions ``extract_rows_each``, ``extract_rows_union``,
  ``extract_rows``, ``extract_rows_max`` and ``gather_mini`` against the
  JAX package's ``extract_rows`` (per neighbour), ``extract_rows_union``
  and ``gather_mini`` on numpy-seeded genomes, one chain and a chains axis:
  rows, valid, overflow and every mini field bit-equal, padding included.
  Cases: a neighbour in fA's own contig (fA itself among them), two slots on
  one contig, contig(fA) and contig(fB) above f_max, a pair that overflows
  although each contig fits, f_max = n, n < (m + 1) x f_max, chains with
  different fA, C = 4 chains of m = 10 slots, contig ids above 2^24, and
  m = 70 slots a chain (more keys than 64, as a repeat table with many
  copies of a bin gives the repeat delta EM step).
- G1 / G2's algorithm, transcribed in numpy (the sorted keys, the chunks'
  counts at each contig's first place and the chunk maxima, each stream's
  total and the chunk's first place in it, the three ordered streams), held to the plain versions at chunk sizes of 1, one that
  splits contigs across chunks and one larger than n.
- The card branch through a stand-in wrapper (its argument blocks, then the
  plain versions): the delta EM step (one chain and chains), the repeat
  delta step (and with 14 copies a bin, m = 70 slots), the delta MTM and MH steps, a delta cycle and
  ``ScaleRunner.run`` give the plain runs' results bit for bit, with one
  extraction (G1 + G2) and one gather (G3) a scoring call and no
  ``torch.topk`` reached outside the stand-in.
- The wrapper's checks (m up to MAX_KEYS - 1, which covers every slot count
  D2 and E1 take), its refusal of CPU tensors, the chunk size, and the
  ctypes mirrors' fields in the order of the C structs.
"""

import ctypes
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graal_tpu.core import delta as jd
from graal_tpu.core.state import GenomeState as JState
from graal_tpu_torch import entry as tentry
from graal_tpu_torch import scale as tscale
from graal_tpu_torch.core import delta as td
from graal_tpu_torch.core import mcmc as tm
from graal_tpu_torch.core import mtm as tmtm
from graal_tpu_torch.core.state import GenomeState
from graal_tpu_torch.ops import build
from graal_tpu_torch.ops import mtm_cuda
from graal_tpu_torch.ops import rows_cuda as rc
from graal_tpu_torch.parallel import tempering as ttemp
from tests.test_torch_state import assert_states_equal  # noqa: F401  (one torch thread)

DELTA = 4
MTM_DELTA = 5


# ---- genomes ------------------------------------------------------------------

def genome(rng, sizes, scatter=True, id_base=3):
    """Numpy fields of one genome whose contigs have ``sizes`` fragments
    (in fragment order, or scattered over the genome; contig k's id is
    id_base + 7 k) and its contig labels; the other fields random."""
    n = int(sum(sizes))
    labels = np.repeat(np.arange(len(sizes)), sizes)
    if scatter:
        labels = rng.permutation(labels)
    fields = {f: rng.integers(-9, 5000, n).astype(np.int32) for f in JState._fields}
    fields["id_c"] = (id_base + 7 * labels).astype(np.int32)
    return fields, labels


def chains_of(genomes):
    """(JAX states, port state (C, n)) of numpy genomes of one length."""
    jax_states = [JState(*[jnp.asarray(g[f]) for f in JState._fields]) for g in genomes]
    port = GenomeState(*[torch.as_tensor(np.stack([g[f] for g in genomes]))
                         for f in JState._fields])
    return jax_states, port


SHAPES = {  # name: (n, C, m, f_max, the first contigs' sizes)
    "random": (400, 3, 5, 64, ()),
    "own_contig": (400, 3, 5, 64, (50, 30)),
    "same_slots": (400, 3, 5, 64, ()),
    "big_contigs": (400, 3, 5, 64, (150, 90, 20)),
    "pair_overflow": (400, 3, 5, 64, (50, 40, 45)),
    "f_max_n": (60, 3, 5, 60, (20, 15)),
    "u_cap_n": (150, 3, 5, 40, (30, 35)),
    "many_slots": (400, 4, 10, 64, (70, 30, 20)),
    "large_ids": (400, 3, 5, 64, (40,)),
    "many_copies": (400, 2, 70, 32, (60, 30, 20)),
}
CASES = list(SHAPES)


def case_inputs(name):
    """(C genomes, f_a (C,), ids (C, m), f_max) of one edge case: chains
    with different fA, the genome of chain 1 in contig order."""
    rng = np.random.default_rng(100 + CASES.index(name))
    n, c, m, f_max, big = SHAPES[name]
    gens, f_a, ids = [], rng.integers(0, n, c), rng.integers(0, n, (c, m))
    for k in range(c):
        sizes = list(big)
        while sum(sizes) < n:
            sizes.append(int(min(rng.integers(1, 40), n - sum(sizes))))
        g, labels = genome(rng, sizes, scatter=k != 1,
                           id_base=2 ** 24 + 1 if name == "large_ids" else 3)
        gens.append(g)
        first, second = np.flatnonzero(labels == 0), np.flatnonzero(labels == 1)
        if name == "own_contig":              # fA itself and its contig among the slots
            f_a[k] = first[k % len(first)]
            ids[k, 0], ids[k, 1] = f_a[k], first[-1]
        elif name == "same_slots":            # two and three slots on one contig
            ids[k, 2] = ids[k, 0]
            ids[k, 3] = np.flatnonzero(labels == labels[ids[k, 0]])[-1]
        elif name in ("big_contigs", "pair_overflow", "many_slots", "u_cap_n", "f_max_n",
                      "many_copies"):
            f_a[k] = first[k % len(first)]    # contig(fA) and contig(fB) large
            ids[k, 0], ids[k, 1] = second[0], first[-1]
    return gens, torch.as_tensor(f_a), torch.as_tensor(ids), f_max


@functools.lru_cache(maxsize=None)
def j_each(f_max):
    return jax.jit(jax.vmap(lambda s, a, b: jd.extract_rows(s, a, b, f_max),
                            in_axes=(None, None, 0)))


@functools.lru_cache(maxsize=None)
def j_union(f_max):
    return jax.jit(lambda s, a, ids: jd.extract_rows_union(s, a, ids, f_max))


j_gather = jax.jit(jax.vmap(jd.gather_mini, in_axes=(None, 0, 0)))


def as_np(x):
    return np.asarray(x)


# ---- the public functions against JAX ---------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_extraction_and_gather_match_jax(name):
    gens, f_a, ids, f_max = case_inputs(name)
    jstates, port = chains_of(gens)
    c, m = ids.shape
    each = td.extract_rows_each(port, f_a, ids, f_max)
    union = td.extract_rows_union(port, f_a, ids, f_max)
    for mode, got, union_mode in (("each", each, False), ("union", union, True)):
        got4 = td.extract_rows_max(port, f_a, ids, f_max, union_mode)
        for a, b in zip(got, got4[:3]):
            assert torch.equal(a, b), (name, mode)
        assert torch.equal(got4[3], port.id_c.amax(-1))
        mini = td.gather_mini(port, got[0], got[1])
        for k in range(c):
            js_ = jstates[k]
            if union_mode:
                want = j_union(f_max)(js_, int(f_a[k]), jnp.asarray(ids[k].numpy(), jnp.int32))
            else:
                want = j_each(f_max)(js_, int(f_a[k]), jnp.asarray(ids[k].numpy(), jnp.int32))
            for g, w, what in zip(got, want, ("rows", "valid", "overflow")):
                np.testing.assert_array_equal(g[k].numpy(), as_np(w),
                                              err_msg=f"{name} {mode} chain {k} {what}")
            wmini = j_gather(js_, want[0], want[1])
            for f in JState._fields:
                np.testing.assert_array_equal(getattr(mini, f)[k].numpy(),
                                              as_np(getattr(wmini, f)),
                                              err_msg=f"{name} {mode} chain {k} mini {f}")
    # one chain: f_a 0-d, ids (m,), fields (n,); extract_rows one neighbour
    one = GenomeState(*[x[0] for x in port])
    got = td.extract_rows_each(one, f_a[0], ids[0], f_max)
    for a, b in zip(got, each):
        assert torch.equal(a, b[0]), name
    got = td.extract_rows_union(one, f_a[0], ids[0], f_max)
    for a, b in zip(got, union):
        assert torch.equal(a, b[0]), name
    for j in range(m):
        got = td.extract_rows(one, int(f_a[0]), int(ids[0, j]), f_max)
        for a, b in zip(got, each):
            assert torch.equal(a, b[0, j]), (name, j)


# ---- G1 / G2 transcribed -------------------------------------------------------

def kernel_transcription(id_c, f_a, ids, f_max, union, chunk):
    """csrc/rows.cu's G1 and G2 in numpy: G1's sorted keys and its per-
    (place, chunk) counts, each contig's at its first place in the sorted
    keys (its other places 0), and chunk maxima; G2's sums of ka's and kb's
    places (in union mode of every place, which gives the union: a place
    whose contig fits f_max), the three streams' totals and first places,
    and each chunk's rows placed in stream order (the kernel's per-tile
    ballot scans are an exclusive scan over the chunk). Returns (rows,
    valid, overflow, max_id)."""
    c_n, n = id_c.shape
    m = ids.shape[1]
    n_chunks = -(-n // chunk)
    rows = np.full((c_n, m, f_max), -1, np.int64)
    valid = np.zeros((c_n, m, f_max), bool)
    overflow = np.zeros((c_n, m), bool)
    max_id = np.zeros(c_n, np.int32)
    for c in range(c_n):
        keys = np.concatenate([[id_c[c, f_a[c]]], id_c[c, ids[c]]])
        skeys = np.sort(keys, kind="stable")
        place = np.searchsorted(skeys, keys)                            # first places
        counts = np.zeros((m + 1, n_chunks), np.int64)
        cmax = np.zeros(n_chunks, np.int64)
        for b in range(n_chunks):                                       # G1
            part = id_c[c, b * chunk:(b + 1) * chunk]
            for r in np.unique(place):
                counts[r, b] = (part == skeys[r]).sum()
            cmax[b] = part.max()
        max_id[c] = cmax.max()
        tot = counts.sum(-1)
        in_u = tot <= f_max                     # a duplicate place adds 0
        ra, rb = place[0], place[1:]                                    # G2, every slot
        same = keys[1:] == keys[0]
        overflow[c] = tot[ra] + np.where(same, 0, tot[rb]) > f_max
        inc_a = not union or tot[ra] <= f_max
        inc_b = ~same & ((tot[rb] <= f_max) if union else True)
        for b in range(n_chunks):
            lo, hi = b * chunk, min((b + 1) * chunk, n)
            bef = counts[:, :b].sum(-1)
            a_tot = inc_a * tot[ra] + inc_b * tot[rb]                   # (m,)
            a_bef = inc_a * bef[ra] + inc_b * bef[rb]
            if union:
                u_tot, u_bef = tot[in_u].sum(), bef[in_u].sum()
            else:
                u_tot, u_bef = a_tot, a_bef
            run = [a_bef, a_tot + (u_bef - a_bef), u_tot + (lo - u_bef)]
            part = id_c[c, lo:hi]
            is_a = ((part == keys[0]) & inc_a)[None, :] \
                | ((part[None, :] == keys[1:, None]) & inc_b[:, None])   # (m, chunk)
            found = np.minimum(np.searchsorted(skeys, part), m)
            is_u = union & (skeys[found] == part) & in_u[found]
            cls = np.where(is_a, 0, np.where(is_u[None, :], 1, 2))
            for st in range(3):
                hit = cls == st
                place_s = np.broadcast_to(run[st], (m,))[:, None] + np.cumsum(hit, 1) - 1
                keep = hit & (place_s < f_max)
                jj, ii = np.nonzero(keep)
                rows[c, jj, place_s[keep]] = lo + ii
                valid[c, jj, place_s[keep]] = st == 0
    return rows, valid, overflow, max_id


@pytest.mark.parametrize("chunk", ["one", "splits", "above_n"])
@pytest.mark.parametrize("name", ["random", "own_contig", "big_contigs", "u_cap_n",
                                  "f_max_n", "many_slots", "many_copies"])
def test_transcribed_algorithm_equals_plain(name, chunk):
    gens, f_a, ids, f_max = case_inputs(name)
    _, port = chains_of(gens)
    n = port.n_frags
    size = {"one": 1, "splits": 7, "above_n": n + 5}[chunk]
    id_c = port.id_c.numpy()
    for union in (False, True):
        got = kernel_transcription(id_c, f_a.numpy(), ids.numpy(), f_max, union, size)
        want = td.extract_rows_max(port, f_a, ids, f_max, union)
        for g, w, what in zip(got, want, ("rows", "valid", "overflow", "max_id")):
            np.testing.assert_array_equal(g, w.numpy(), err_msg=f"{name} {chunk} {union} {what}")
        assert (got[0] >= 0).all()          # every output place written once
        assert all(len(set(r)) == f_max for r in got[0].reshape(-1, f_max))


# ---- the card branch through a stand-in wrapper ------------------------------

class StandIn:
    """The wrapper's contract in plain torch: its argument blocks (the
    checks, outputs and scratch), then the plain versions, returned as the
    kernels return them. Counts the extractions and gathers; ``torch.topk``
    is reachable only from inside it."""

    def __init__(self):
        self.calls = {"extract": 0, "gather": 0}
        self.active = False

    def extract(self, id_c, f_a, ids, f_max, union):
        _, _, out = rc.extract_args(id_c, f_a, ids, f_max, union)
        self.calls["extract"] += 1
        state = GenomeState(*[id_c] * 11)
        self.active = True
        try:
            want = (td.extract_rows_union_plain if union else td.extract_rows_each_plain)(
                state, f_a, ids, f_max)
        finally:
            self.active = False
        for o, w in zip(out, (*want, id_c.amax(-1))):
            assert o.shape == w.shape and o.dtype == w.dtype
            o.copy_(w)
        return out

    def gather(self, state, rows, valid):
        _, _, out = rc.gather_args(state, rows, valid)
        self.calls["gather"] += 1
        want = td.gather_mini_plain(GenomeState(*state), rows, valid)
        out.copy_(torch.stack(list(want)).reshape(out.shape))
        return out


def route_to_card(monkeypatch, spy):
    """Send ``core.delta``'s public functions to their card branches (CPU
    tensors included) and those to ``spy``; ``torch.topk`` raises unless
    the stand-in calls it."""
    topk = torch.topk

    def guarded(*a, **kw):
        assert spy.active, "the card branch reached torch.topk"
        return topk(*a, **kw)

    monkeypatch.setattr(td, "ROWS", spy)
    monkeypatch.setattr(td, "extract_rows_each",
                        lambda *a: td._rows_on_card(*a, False)[:3])
    monkeypatch.setattr(td, "extract_rows_union", lambda *a: td._rows_on_card(*a, True)[:3])
    monkeypatch.setattr(td, "extract_rows_max", td._rows_on_card)
    monkeypatch.setattr(td, "gather_mini", td._gather_on_card)
    monkeypatch.setattr(torch, "topk", guarded)


@pytest.fixture(scope="module")
def plain_problem():
    truth, shuf, table, params, sobs = tentry.scale_problem(240, n_contigs=2, n_pieces=10,
                                                            device="cpu")
    runner = tscale.ScaleRunner(table, sobs, params)
    starts = GenomeState(*[torch.stack(x) for x in zip(shuf, tm.explode_genome(shuf), truth)])
    return dict(truth=truth, shuf=shuf, table=table, params=params, sobs=sobs, runner=runner,
                starts=starts, rep=None, id_d=None)


@pytest.fixture(scope="module")
def repeat_problem():
    truth, shuf, table, params, sobs, id_d = tentry.scale_repeat_problem(240, n_dups=6,
                                                                         device="cpu")
    runner = tscale.ScaleRunner(table, sobs, params, id_d=id_d)
    return dict(truth=truth, shuf=shuf, table=table, params=params, sobs=sobs, runner=runner,
                rep=shuf.rep, id_d=id_d)


@pytest.fixture(scope="module")
def many_copies_problem():
    """The repeat problem with 13 extra copies of each duplicated bin: the
    repeat delta EM step's m = (DELTA + 1) x 14 = 70 neighbour slots."""
    truth, shuf, table, params, sobs, id_d = tentry.scale_repeat_problem(
        240, n_dups=6, copies=13, device="cpu")
    runner = tscale.ScaleRunner(table, sobs, params, id_d=id_d)
    assert (DELTA + 1) * runner.nb.max_copies == 70
    return dict(truth=truth, shuf=shuf, table=table, params=params, sobs=sobs, runner=runner,
                rep=shuf.rep, id_d=id_d)


def trees_equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(trees_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(trees_equal(a[k], b[k]) for k in a)
    return a == b


def em_steps(s, chains, n_steps=6, seed=3):
    """Delta EM steps on shared draws: one chain (the shuffled start) or
    the 3 starts as a chains axis (their own temperatures)."""
    r = s["runner"]
    step = td.make_delta_em_step(s["table"], None, r.nb, DELTA, 48, sobs=s["sobs"],
                                 rep=s["rep"])
    gen = torch.Generator().manual_seed(seed)
    n = s["shuf"].n_frags
    states = s["starts"] if chains else s["shuf"]
    l_t = torch.zeros(3) if chains else torch.zeros(())
    out = []
    for _ in range(n_steps):
        if chains:
            draws = ttemp.draw_chain_inputs(gen, r.nb, DELTA, 3)
            f_a = torch.randint(n, (3,), generator=gen)
            f_t = torch.tensor([1.0, 2.0, 4.0])
        else:
            draws = tm.draw_step_inputs(gen, r.nb, DELTA)
            f_a = torch.randint(n, (), generator=gen)
            f_t = 1.0
        states, l_t, outs = step(states, draws, s["params"], l_t, f_a, f_t)
        out.append((states, l_t, outs))
    return out, n_steps


def move_steps(s, variant, n_steps=4, seed=4):
    """Delta MTM / MH steps (two scoring calls a step)."""
    r = s["runner"]
    jump = r.jump_table(MTM_DELTA, s["shuf"].n_frags)
    make = tmtm.make_delta_mtm_step if variant == "mtm" else tmtm.make_delta_mh_step
    step = make(s["table"], jump, 48, s["sobs"], rep=s["rep"])
    gen = torch.Generator().manual_seed(seed)
    state, l_t = s["shuf"], torch.tensor(-1000.0)
    out = []
    for it in range(n_steps):
        draws = tmtm.draw_move_inputs(gen, jump)
        state, l_t, *rest = step(state, draws, s["params"], l_t, torch.tensor(11 * it + 3), 1.0)
        out.append((state, l_t, rest))
    return out, 2 * n_steps


def cycle_steps(s, n_steps=8, seed=5):
    r = s["runner"]
    cycle = td.make_delta_em_cycle(s["table"], None, r.nb, DELTA, 48, sobs=s["sobs"],
                                   anchor_fn=False, rep=s["rep"])
    gen = torch.Generator().manual_seed(seed)
    order = torch.randperm(s["shuf"].n_frags, generator=gen)[:n_steps]
    return cycle(s["shuf"], gen, s["params"], order, torch.tensor(-1000.0), 1.0), n_steps


def runner_run(s, seed=6):
    runner = tscale.ScaleRunner(s["table"], s["sobs"], s["params"], nb=s["runner"].nb,
                                id_d=s["id_d"])
    final, _, m = runner.run(s["shuf"], n_cycles=1, steps_per_cycle=12, f_max_min=32,
                             order_mode="extremity", seed=seed, progress=False)
    return (final, m["likelihood"], m["n_contigs"]), None


PATHS = {"em_step": ("plain", lambda s: em_steps(s, False)),
         "em_chains": ("plain", lambda s: em_steps(s, True)),
         "repeat_em_step": ("repeat", lambda s: em_steps(s, False)),
         "repeat_em_many_copies": ("many", lambda s: em_steps(s, False)),
         "mtm_step": ("plain", lambda s: move_steps(s, "mtm")),
         "repeat_mh_step": ("repeat", lambda s: move_steps(s, "mh")),
         "em_cycle": ("plain", cycle_steps),
         "runner": ("plain", runner_run)}


@pytest.mark.parametrize("path", list(PATHS))
def test_card_branch_through_stand_in(plain_problem, repeat_problem, many_copies_problem,
                                      monkeypatch, path):
    """Every delta path through the card branch (the wrapper a stand-in)
    gives the plain run's results bit for bit, with one extraction and one
    gather a scoring call and no torch.topk outside the stand-in."""
    kind, run = PATHS[path]
    s = dict(plain=plain_problem, repeat=repeat_problem, many=many_copies_problem)[kind]
    want, _ = run(s)
    spy = StandIn()
    route_to_card(monkeypatch, spy)
    got, calls = run(s)
    assert trees_equal(got, want), path
    if calls is None:
        assert spy.calls["extract"] > 0
        calls = spy.calls["extract"]
    assert spy.calls == {"extract": calls, "gather": calls}, (spy.calls, calls)


# ---- the wrapper's checks ---------------------------------------------------------

def good_extract(c=2, m=3, n=50):
    return (torch.zeros((c, n), dtype=torch.int32), torch.zeros(c, dtype=torch.int64),
            torch.zeros((c, m), dtype=torch.int64), 16)


def test_check_extract_accepts_and_refuses():
    id_c, f_a, ids, f_max = good_extract()
    assert rc.check_extract(id_c, f_a, ids, f_max) == (2, 3, 50)
    assert rc.check_extract(id_c[:, ::2], f_a, ids, 25) == (2, 3, 25)   # strided genome
    for m in (63, 64, 65, 80, rc.MAX_KEYS - 1):
        many = torch.zeros((2, m), dtype=torch.int64)
        assert rc.check_extract(id_c, f_a, many, f_max) == (2, m, 50)
    bad = [(id_c.long(), f_a, ids, f_max, "id_c"), (id_c, f_a.int(), ids, f_max, "f_a"),
           (id_c, f_a, ids.int(), f_max, "ids"), (id_c, f_a[:1], ids, f_max, "f_a"),
           (id_c, f_a, ids[:1], f_max, "ids"), (id_c, f_a, ids, 51, "f_max"),
           (id_c, f_a, ids, 0, "f_max"), (id_c, f_a, ids, 16.0, "f_max"),
           (id_c, f_a, torch.zeros((2, 0), dtype=torch.int64), f_max, "m"),
           (id_c, f_a, torch.zeros((2, rc.MAX_KEYS), dtype=torch.int64), f_max, "m"),
           (id_c, f_a, torch.zeros((2, rc.MAX_GRID_YZ + 1), dtype=torch.int64), f_max, "m"),
           (id_c[0], f_a, ids, f_max, "id_c")]
    for args in bad:
        with pytest.raises(ValueError, match=args[-1]):
            rc.check_extract(*args[:-1])


def test_check_gather_accepts_and_refuses():
    state = GenomeState(*[torch.zeros((2, 50), dtype=torch.int32) for _ in range(11)])
    rows = torch.zeros((2, 3, 8), dtype=torch.int64)
    valid = torch.zeros((2, 3, 8), dtype=torch.bool)
    assert rc.check_gather(state, rows, valid) == (2, 3, 8)
    assert rc.check_gather(state, rows[:, 0], valid[:, 0]) == (2, 1, 8)
    with pytest.raises(ValueError, match="rows"):
        rc.check_gather(state, rows.int(), valid)
    with pytest.raises(ValueError, match="valid"):
        rc.check_gather(state, rows, valid[:, :2])
    with pytest.raises(ValueError, match="field 4"):
        rc.check_gather(state._replace(circ=state.circ.long()), rows, valid)
    with pytest.raises(ValueError, match="fields"):
        rc.check_gather(tuple(state)[:10], rows, valid)


def test_argument_blocks_and_chunks():
    id_c, f_a, ids, _ = good_extract(n=5000)
    a, _, out = rc.extract_args(id_c, f_a, ids, 1024, True)
    assert (a.C, a.m, a.n, a.f_max, a.chunk, a.n_chunks, a.union_mode) == \
        (2, 3, 5000, 1024, rc.CHUNK, 3, 1)
    assert [tuple(x.shape) for x in out] == [(2, 3, 1024), (2, 3, 1024), (2, 3), (2,)]
    assert [x.dtype for x in out] == [torch.int64, torch.bool, torch.bool, torch.int32]
    assert rc.chunk_size(100_000) == rc.CHUNK
    assert rc.chunk_size(500_000) % rc.THREADS == 0
    assert -(-500_000 // rc.chunk_size(500_000)) <= rc.MAX_CHUNKS
    assert "rows" in build.KERNELS


def test_wrapper_refuses_cpu_tensors():
    kernels = rc.RowKernels()
    id_c, f_a, ids, f_max = good_extract()
    with pytest.raises(ValueError, match="card"):
        kernels.extract(id_c, f_a, ids, f_max, True)
    state = GenomeState(*[torch.zeros((2, 50), dtype=torch.int32) for _ in range(11)])
    with pytest.raises(ValueError, match="card"):
        kernels.gather(state, torch.zeros((2, 3, 8), dtype=torch.int64),
                       torch.zeros((2, 3, 8), dtype=torch.bool))
    assert kernels.launches.by_key() == {} and kernels.n_launches == 0


def test_key_limit_takes_every_slot_count_of_d2_and_e1():
    """G1 / G2 take m + 1 <= MAX_KEYS keys, as rows.cu states it: every
    slot count that E1 (mtm_cuda.MAX_M) and D2 (step.cu ``neighbours``:
    4 (n_top + d_eff + 3 m) bytes of its 48 KB, n_top >= 1) take."""
    src = (Path(rc.__file__).resolve().parent.parent / "csrc" / "rows.cu").read_text()
    assert int(re.search(r"constexpr int MAX_KEYS = (\d+);", src).group(1)) == rc.MAX_KEYS
    d2_most = (48 * 1024 // 4 - 1) // 3
    assert rc.MAX_KEYS - 1 >= max(mtm_cuda.MAX_M, d2_most)


def _c_fields(struct):
    """The member names of ``struct`` in csrc/rows.cu, in order."""
    src = (Path(rc.__file__).resolve().parent.parent / "csrc" / "rows.cu").read_text()
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, src, re.S).group(1)
    names = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line.endswith(";"):
            continue
        for part in line[:-1].split(","):
            names.append(re.sub(r"\[.*\]", "", part.strip().split()[-1]).lstrip("*"))
    return names


@pytest.mark.parametrize("struct, mirror", [("RowsArgs", rc.RowsArgs),
                                            ("GatherArgs", rc.GatherArgs)])
def test_ctypes_mirrors_follow_the_c_structs(struct, mirror):
    assert _c_fields(struct) == [name for name, _ in mirror._fields_]
    assert ctypes.sizeof(mirror) % 8 == 0
