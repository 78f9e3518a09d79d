"""The designs of F2 (``csrc/repeat_corr.cu`` ``corr_sums_kernel``) and I1
(``csrc/delta_inputs.cu`` ``delta_slots_kernel``), held on the CPU, where
the kernels cannot run.

Their parts are transcribed in numpy and held to transcriptions of the
earlier designs, to the plain versions and to the JAX package:

- F2's fold: a slot's records laid out as one sequence (mixed, multi-
  multi, part 4, same-bin, each group padded with zeros to a multiple of
  the 128 fold lanes), staged a tile at a time (every place staged once: a
  place a thread, a thread's places taken one or two at a time, the
  multi-multi entries by groups of lanes), fold lane th adding places th,
  th + 128, ... of each tile in f64, then the fixed tree (64, 32, then a
  warp's shuffles); equal bit for bit to the earlier design's order (128
  lanes a genome, lane th adding records th, th + 128, ... of each group
  in turn, skipping terms with e <= 0, then a stride tree), on random
  terms with zeros, negative zeros and magnitudes over twenty decades, at
  group sizes that are empty, below, at and past the fold lanes and the
  tile, at three tiles and the six layouts (512, 256 and 128 threads a
  genome, one or two places a thread);
- the D mass, the cross sum and the delta: lane r (0-255) adding rows r, r
  + 256, ... (the first F2_PRE loaded before w_out is known), then the
  256-wide tree, equal to the earlier design's block tree bit for bit;
- the layouts: a genome a block of a slot's cluster, the base block 0's;
  the 256 cross lanes held once by a block's threads; the layout the
  wrapper picks from the card's fit for the call's slots and rows;
- a multi-multi entry folded by a group of GW lanes (GW the power of two
  that holds c_max copies, at most 32) equal to the plain
  ``_copy_sum(_copy_sum(e))`` and its masses' folds, c_max 1 to 70;
- a mixed record's or a part-4 bin's copies, the first two loaded with
  the place and the rest two at a time, folded once each in copy order
  (the plain ``_copy_sum``); the sizes transcribed here read from the
  kernel's source;
- the whole of F2 on the plain version's own f32 terms (captured from
  ``RepeatDeltaScorer._corrections``) in F1's record order: the new order
  equal to the earlier one bit for bit, and corr / cross within rtol 1e-12
  and dll within one f32 ulp of ``corrections_plain``, on one chain and
  three, c_max 2 and 12, tables with no mixed and with no multi-multi
  entry;
- I1's scan: every row of a warp's run loaded at once, a ballot a pass of
  32 rows, the lowest set bit, the least over the warps (runs past 32 warps'
  rows in turn), read through the wrapper's own argument block at the
  rows' strides; equal every byte to ``core.delta.slot_inputs_plain`` and
  to ``jnp.argmax(rows == f)``: no match, a match only in the padding rows
  past the valid prefix, at row 0 and at the last row, repeated matches,
  f_max not a multiple of 32 or of the threads, f_max 16,384 and past it,
  int32 and int64 ids and maxima, strided rows;
- the wrappers' card branches through stand-in libraries: I1 and I2 handed
  their keys' counters (no torch add beside a launch), F2 handed its
  layout.
"""

import ctypes
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graal_tpu.utils.synthetic import default_params
from graal_tpu_torch import convert
from graal_tpu_torch.core import delta as td
from graal_tpu_torch.core import delta_repeats as tdr
from graal_tpu_torch.core.state import GenomeState
from graal_tpu_torch.ops import delta_inputs_cuda as di
from graal_tpu_torch.ops import repeat_corr_cuda as rcc
from graal_tpu_torch.ops.counts import LaunchCount
from tests.test_torch_delta_inputs import _arr, _read, i1_transcribed
from tests.test_torch_repeat_corr import call, edge_problem, small  # noqa: F401  (fixtures)
from tests.test_torch_state import to_port  # noqa: F401  (one torch thread a worker)

FOLD, CROSS, TILE, PRE, COPIES = 128, 256, 2048, 4, 2   # csrc/repeat_corr.cu F2_*
# threads a genome (TG) and places a thread loads at once
LAYOUTS = {"14x512/2": (512, 2), "14x256/2": (256, 2), "14x128/2": (128, 2),
           "14x512/1": (512, 1), "14x256/1": (256, 1), "14x128/1": (128, 1)}
N_GEN = 14
SLOT_ROWS, MAX_SLOT_THREADS, NO_MATCH = 16, 1024, 0x7FFFFFFF   # csrc/delta_inputs.cu
CORR_RTOL = 1e-12
CSRC = Path(__file__).resolve().parents[1] / "graal_tpu_torch" / "csrc"


# ---- F2's fold -----------------------------------------------------------------

def f64(x):
    return np.asarray(x, np.float32).astype(np.float64)


def stride_tree(red):
    """The earlier design's tree in shared memory: red[t] += red[t + s] for
    t < s, s = n / 2, ..., 1 (f64); the total."""
    red = red.copy()
    s = len(red) // 2
    while s:
        red[:s] = red[:s] + red[s:2 * s]
        s //= 2
    return red[0]


def shfl_down_tree(s):
    """A warp's s += shfl_down(s, o), o = 16, ..., 1 (a lane past the warp
    reads its own value); lane 0's total."""
    s = s.copy()
    for o in (16, 8, 4, 2, 1):
        src = np.arange(32) + o
        s = s + s[np.where(src < 32, src, np.arange(32))]
    return s[0]


def tree128(p):
    """csrc/repeat_corr.cu ``tree128``."""
    lane = np.arange(32)
    return shfl_down_tree((p[lane] + p[lane + 64]) + (p[lane + 32] + p[lane + 96]))


def tree256(p):
    """csrc/repeat_corr.cu ``tree256``."""
    lane = np.arange(32)
    a0 = (p[lane] + p[lane + 128]) + (p[lane + 64] + p[lane + 192])
    a1 = (p[lane + 32] + p[lane + 160]) + (p[lane + 96] + p[lane + 224])
    return shfl_down_tree(a0 + a1)


def earlier_sum(groups):
    """The earlier F2's sum of one genome's terms: lane th (of 128) adds
    records th, th + 128, ... of each group in turn (a term with e <= 0,
    here 0, is skipped), then the stride tree."""
    acc = np.zeros(FOLD)
    for g in groups:
        g = f64(g)
        for q in range(0, len(g), FOLD):
            part = g[q:q + FOLD]
            keep = np.asarray(part != 0.0)
            acc[:len(part)] = np.where(keep, acc[:len(part)] + part, acc[:len(part)])
    return stride_tree(acc)


def pad(n):
    return -(-n // FOLD) * FOLD


def stage_owners(counts, t0, t1, tg, c_max, places):
    """Who stages each place of [t0, t1) of a pass: the place-a-thread loop
    (thread th takes ``places`` places b, b + tg, ... at a time, b = t0 +
    th, + tg x places, ...: their ints, then their rows, then their terms; a
    multi-multi entry's place left to its group) and the entries' groups of
    GW lanes (per warp 32 / GW entries, warps of the genome's tg threads).
    Returns the count of stagings of every place."""
    n_mx, ndd, n4, n_sb = counts
    p_dd = pad(n_mx)
    staged = np.zeros(t1 - t0, int)
    for th in range(tg):
        for b in range(t0 + th, t1, tg * places):
            batch = [b + j * tg for j in range(places)]
            for q in batch:
                if q < t1 and not (p_dd <= q < p_dd + ndd):
                    staged[q - t0] += 1
    gw = 1
    while gw < c_max and gw < 32:
        gw *= 2
    per_warp = 32 // gw
    d0, d1 = max(t0 - p_dd, 0), min(t1 - p_dd, ndd)
    for warp in range(tg // 32):
        for base in range(d0 + warp * per_warp, d1, (tg // 32) * per_warp):
            for grp in range(per_warp):
                if base + grp < d1:
                    staged[p_dd + base + grp - t0] += 1
    return staged


def new_sum(groups, tile=TILE, tg=512, c_max=2, places=1):
    """csrc/repeat_corr.cu's F2 sum of one genome's terms: the groups laid
    out padded to multiples of 128, staged a tile at a time (every place
    staged once), fold lane th adding places th, th + 128, ... of a tile,
    then ``tree128``."""
    counts = [len(g) for g in groups]
    seq = np.concatenate([np.concatenate([np.asarray(g, np.float32),
                                          np.zeros(pad(len(g)) - len(g), np.float32)])
                          for g in groups])
    acc = np.zeros(FOLD)
    for t0 in range(0, len(seq), tile):
        t1 = min(len(seq), t0 + tile)
        assert (stage_owners(counts, t0, t1, tg, c_max, places) == 1).all()
        st = f64(seq[t0:t1])
        for q in range(0, t1 - t0, FOLD):
            acc = acc + st[q:q + FOLD]
    return tree128(acc)


def random_terms(rng, n, zeros=0.2):
    x = (rng.standard_normal(n) * 10.0 ** rng.integers(-10, 10, n)).astype(np.float32)
    x[rng.random(n) < zeros] = 0.0
    x[rng.random(n) < 0.05] = np.float32(-0.0)
    return x


SIZES = [(0, 0, 0, 0), (1, 0, 83, 1), (127, 20, 83, 10), (128, 128, 128, 128),
         (129, 3, 0, 257), (512, 20, 83, 11), (2047, 1, 5, 0), (2049, 130, 166, 3),
         (4444, 20, 83, 82), (0, 300, 0, 0)]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("tile", [TILE, 128, 384])
@pytest.mark.parametrize("sizes", SIZES)
def test_f2_fold_equals_the_earlier_order(sizes, tile, layout):
    rng = np.random.default_rng(sum(sizes) + tile)
    groups = [random_terms(rng, n) for n in sizes]
    want = earlier_sum(groups)
    tg, places = LAYOUTS[layout]
    for c_max in (1, 2, 12, 40):
        got = new_sum(groups, tile, tg, c_max, places)
        assert got.tobytes() == want.tobytes(), (sizes, tile, layout, c_max)


def earlier_lane_sums(values, lanes=CROSS):
    """Lane r adds values r, r + lanes, ... in turn (f64), then the block's
    stride tree: the earlier design's D mass and cross sum."""
    acc = np.zeros(lanes)
    for q in range(0, len(values), lanes):
        part = values[q:q + lanes]
        acc[:len(part)] = acc[:len(part)] + part
    return stride_tree(acc)


def cross_sum(da, os_, w_out):
    """csrc/repeat_corr.cu's cross sum of one candidate: lane r's first PRE
    rows from registers, the rest as loaded, then ``tree256``."""
    r_max = len(da)
    acc = np.zeros(CROSS)
    for q in range(0, r_max, CROSS):
        rows = np.arange(q, min(q + CROSS, r_max))
        acc[rows - q] = acc[rows - q] + f64(da[rows]) * (w_out - f64(os_[rows]))
    return tree256(acc)


def d_mass(a0):
    acc = np.zeros(CROSS)
    for q in range(0, len(a0), CROSS):
        part = f64(a0[q:q + CROSS])
        acc[:len(part)] = acc[:len(part)] + part
    return tree256(acc)


@pytest.mark.parametrize("r", [1, 255, 256, 1024, 1025, 4096, 8192])
def test_d_mass_and_cross_equal_the_earlier_order(r):
    rng = np.random.default_rng(r)
    a = np.where(rng.random((2, r)) < 0.7, rng.random((2, r)) * 10.0 ** rng.integers(-3, 4, (2, r)),
                 0.0).astype(np.float32)
    os_ = (rng.random(r) * 50).astype(np.float32)
    w_all = np.float64(rng.random() * 1e5)
    w_out = w_all - d_mass(a[0])
    assert w_out.tobytes() == (w_all - earlier_lane_sums(f64(a[0]))).tobytes()
    da = a[1] - a[0]
    want = earlier_lane_sums(f64(da) * (w_out - f64(os_)))
    assert cross_sum(da, os_, w_out).tobytes() == want.tobytes()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layouts_follow_the_c_enum(layout):
    """A cluster of 14 blocks a slot, block k genome k (the base block 0's,
    so corr[0] and w_out are summed once a slot); the wrapper's layout k
    launches the kernel of its TG threads and places a thread, whose threads
    hold each of the 256 cross lanes once (th, then th + TG where TG is
    128)."""
    tg, places = LAYOUTS[layout]
    assert tg >= FOLD and tg % 32 == 0 and (tg % CROSS == 0 or CROSS % tg == 0)
    held = [th + lane * tg for th in range(min(tg, CROSS)) for lane in range(max(1, CROSS // tg))]
    assert sorted(held) == list(range(CROSS))
    text = (CSRC / "repeat_corr.cu").read_text()
    name = re.search(r"case (\w+): return \(int\)launch_sums<%d, %d>" % (tg, places),
                     text).group(1)
    enum = [x.split("=")[0].strip()
            for x in re.search(r"enum SumsPlan \{(.*?)\}", text).group(1).split(",")]
    assert enum.index(name) == rcc.SUMS_PLANS.index(layout)
    assert re.search(r"case %s: return sums_fit<%d, %d>\(\)" % (name, tg, places), text)


FIT = (7, 14, 30, 14, 30, 65)      # the H100's, PERF.md


@pytest.mark.parametrize("slots, rows, fit, want", [
    (10, 1024, None, 0), (7, 1024, FIT, 0), (10, 1024, FIT, 1), (14, 512, FIT, 1),
    (15, 1024, FIT, 2), (30, 1024, FIT, 2), (40, 1024, FIT, 5), (60, 1024, FIT, 5),
    (10, 8192, FIT, 3), (30, 4096, FIT, 4), (31, 4096, FIT, 5), (500, 1024, FIT, 5),
    (500, 16384, FIT, 5), (1, 1, (1,) * 6, 0), (1, 1025, (1,) * 6, 3)])
def test_sums_plan_picks_the_most_threads_that_fit(slots, rows, fit, want):
    """F2's layout: the most threads a genome whose clusters the card holds
    all at once for the call's slots, of two places a thread up to 1,024
    rows a slot where one fits, else of one place, else the fewest threads
    of one place; the first off a card."""
    assert rcc.sums_plan(slots, rows, fit) == want


@pytest.mark.parametrize("name, value", [("F2_TILE", TILE), ("F2_FOLD", FOLD),
                                         ("F2_CROSS", CROSS), ("F2_PRE", PRE),
                                         ("F2_COPIES", COPIES)])
def test_f2_constants_follow_the_c_source(name, value):
    """The transcriptions here use the kernel's own sizes."""
    text = (CSRC / "repeat_corr.cu").read_text()
    assert int(re.search(r"constexpr int %s = (\d+);" % name, text).group(1)) == value


def place_copies(c_max):
    """The copies of a mixed record or a part-4 bin in the order F2's
    ``term`` folds them: the first F2_COPIES loaded with the place (those
    past c_max skipped), then COPIES at a time, loaded before they are
    folded."""
    order = [c for c in range(COPIES) if c < c_max]
    for c0 in range(COPIES, c_max, COPIES):
        order += [c0 + j for j in range(COPIES) if c0 + j < c_max]
    return order


@pytest.mark.parametrize("c", [1, 2, 3, 4, 5, 12, 33])
def test_place_copies_fold_in_copy_order(c):
    """A place's copies, loaded COPIES at a time, still fold once each and
    left to right: the plain ``_copy_sum``'s order, so the term is the plain
    version's bit for bit."""
    assert place_copies(c) == list(range(c))
    rng = np.random.default_rng(c)
    e = (rng.standard_normal(c) * 10.0 ** rng.integers(-5, 6, c)).astype(np.float32)
    got = fold([e[q] for q in place_copies(c)])
    want = tdr._copy_sum(torch.from_numpy(e)[None]).numpy()[0]
    assert got.tobytes() == np.float32(want).tobytes()


def fold(xs):
    """The f32 left fold of the plain ``_copy_sum``."""
    out = np.float32(xs[0])
    for x in xs[1:]:
        out = np.float32(out + np.float32(x))
    return out


@pytest.mark.parametrize("c", [1, 2, 3, 12, 33, 70])
def test_multi_multi_by_lane_groups(c):
    """An entry's c x c copy pairs by a group of GW lanes: lane l folds copy
    row cu = l (+ GW, ...) over cv left to right (the v end by shuffles),
    the rows then folded in cu order, the u and v masses each in copy
    order: the plain ``_copy_sum(_copy_sum(e))`` and ``_copy_sum(a)``."""
    rng = np.random.default_rng(c)
    e = (rng.standard_normal((c, c)) * 10.0 ** rng.integers(-5, 6, (c, c))).astype(np.float32)
    au, av = (rng.random((2, c)) * 10.0 ** rng.integers(-3, 3, (2, c))).astype(np.float32)
    gw = 1
    while gw < c and gw < 32:
        gw *= 2
    ee = a_u = a_v = None
    for ub in range(0, c, gw):
        rows = {}
        for sub in range(gw):                 # the lanes of one group
            cu = ub + sub
            if cu >= c:
                continue
            row = None
            for vb in range(0, c, gw):
                for q in range(min(gw, c - vb)):        # lane q's cv by shuffles
                    row = e[cu, vb + q] if row is None else np.float32(row + e[cu, vb + q])
            rows[sub] = row
        if ub == 0:
            for vb in range(0, c, gw):
                for q in range(min(gw, c - vb)):
                    a_v = av[vb + q] if a_v is None else np.float32(a_v + av[vb + q])
        for q in range(min(gw, c - ub)):
            ee = rows[q] if ee is None else np.float32(ee + rows[q])
            a_u = au[ub + q] if a_u is None else np.float32(a_u + au[ub + q])
    want = tdr._copy_sum(tdr._copy_sum(torch.from_numpy(e)[None])).numpy()[0]
    assert np.float32(ee).tobytes() == np.float32(want).tobytes()
    assert np.float32(ee).tobytes() == fold([fold(e[cu]) for cu in range(c)]).tobytes()
    assert np.float32(a_u).tobytes() == fold(au).tobytes()
    assert np.float32(a_v).tobytes() == fold(av).tobytes()


# ---- the whole of F2 on the plain version's terms ------------------------------

def record_masks(scorer, state, rows, valid):
    """One chain's F1 records as the plain version orders them: the mixed
    windows (m, R, capm) and same-bin pairs (m, R, c_max) in use (row-major:
    D row ascending, then entry or copy), and o_same (m, R)."""
    p = scorer.plain
    m, f_max = rows.shape
    n = state.n_frags
    subs, sub_valid = p.sub_rows(rows, valid)
    db = scorer.data_id[subs.clamp(0, scorer.k_subs - 1)]
    db_dup = scorer.dup[db] & sub_valid
    mx = scorer.mixed
    start, end = mx.row_start[db], mx.row_start[db + 1]
    win = start[..., None] + torch.arange(max(mx.row_cap, 0))
    mwin = (win < end[..., None]) & (sub_valid & ~db_dup)[..., None]
    inv_f = torch.full((m, n + 1), -1, dtype=torch.int64)
    inv_f.scatter_(1, torch.where(valid, rows, n), torch.arange(f_max).expand_as(rows))
    inv_f = inv_f[:, :n]
    smat = torch.stack([state.start_bp, state.ori, state.id_c, state.circ, state.l_cont_bp,
                        state.activ], dim=1)
    sb_rows, sb_ok = scorer.copy_rows_of(db)
    sb_in, sb_mini = scorer.route(inv_f, sb_rows, shared=False)
    r = subs.shape[1]
    sb_use = sb_in & sb_ok & db_dup[..., None] & (sb_mini > torch.arange(r)[:, None])
    o_same = tdr._copy_sum(torch.where(sb_ok & ~sb_in, scorer.frozen_a(smat, sb_rows), 0.0))
    return mwin, sb_use, o_same


def plain_terms(scorer, args, k):
    """Chain k's f32 terms as the plain version computes them (each sum's
    argument captured from ``_sum64``): {group: tensor (m, 14, ...)}, 0
    where the plain version skips a term."""
    states, f_a, rows, valid, geo, accu_sub, pvec, _ = args
    m = rows.shape[1]
    sl = slice(k * m, (k + 1) * m)
    got = []
    orig = tdr._sum64

    def spy(x, dims):
        got.append(x.clone())
        return orig(x, dims)

    tdr._sum64 = spy
    try:
        scorer._corrections(GenomeState(*[x[k] for x in states]), f_a[k], rows[k], valid[k],
                            type(geo)(*[x[sl] for x in geo]), accu_sub[sl], pvec[k * m])
    finally:
        tdr._sum64 = orig
    names = [name for name, present in (("mixed", scorer.mixed.vals.numel()),
                                        ("dd", scorer.dd_ob.numel()),
                                        ("p4", scorer.sobs.vals.numel()), ("sb", True))
             if present]
    assert len(names) == len(got)
    return dict(zip(names, got))


def genome_groups(terms, masks, s, g, t):
    """Genome g of slot s: its (mixed, multi-multi, part 4, same-bin) terms
    in F1's record order."""
    mwin, sb_use, _ = masks
    empty = np.zeros(0, np.float32)
    mixed = terms["mixed"][s, g][mwin[s]].numpy() if "mixed" in terms else empty
    dd = terms["dd"][s, g].numpy() if "dd" in terms else empty
    p4 = terms["p4"][s, g].reshape(-1).numpy() if "p4" in terms else empty
    assert len(p4) == t.s_max * t.capd and len(dd) == t.dd_ob.shape[0]
    return [mixed, dd, p4, terms["sb"][s, g][sb_use[s]].numpy()]


def w_all_f1(scorer, state):
    """F1's w_all: lane k of 1,024 adds the active copy rows k, k + 1,024,
    ... in turn, then the block's stride tree."""
    accu = scorer.accu.numpy()
    act = (state.activ[scorer.owner] == 1).numpy()
    return earlier_lane_sums(np.where(act, f64(accu), 0.0), lanes=1024)


def f2_transcribed(scorer, args, order, layout="14x512/2"):
    """F2 on the plain version's terms, in ``order``: "new" (this design,
    one layout) or "earlier". Returns (corr (M, 14), cross (M, 13), dll (M,
    13))."""
    states, f_a, rows, valid, geo, accu_sub, pvec, dll1 = args
    n_ch, m = rows.shape[:2]
    t = scorer.corr_tables
    tg, places = LAYOUTS[layout]
    corr = np.zeros((n_ch * m, N_GEN))
    cross = np.zeros((n_ch * m, N_GEN - 1))
    dll = np.zeros((n_ch * m, N_GEN - 1), np.float32)
    a_g = torch.where(geo.act, accu_sub[:, None, :], 0.0).numpy()
    for k in range(n_ch):
        state = GenomeState(*[x[k] for x in states])
        terms = plain_terms(scorer, args, k)
        masks = record_masks(scorer, state, rows[k], valid[k])
        w_all = w_all_f1(scorer, state)
        for j in range(m):
            s = k * m + j
            vn = (pvec[s, 6] / scorer.nfpb).numpy()      # torch's f32 division on the CPU
            for g in range(N_GEN):
                groups = genome_groups(terms, masks, j, g, t)
                corr[s, g] = new_sum(groups, TILE, tg, t.c_max, places) if order == "new" \
                    else earlier_sum(groups)
            os_ = masks[2][j].numpy()
            if order == "new":
                w_out = w_all - d_mass(a_g[s, 0])
            else:
                w_out = w_all - earlier_lane_sums(f64(a_g[s, 0]))
            for g in range(1, N_GEN):
                da = (a_g[s, g] - a_g[s, 0]).astype(np.float32)
                x = cross_sum(da, os_, w_out) if order == "new" else \
                    earlier_lane_sums(f64(da) * (w_out - f64(os_)))
                cross[s, g - 1] = f64(vn) * x
                dll[s, g - 1] = np.float32((f64(dll1[s, g - 1].numpy()) + (corr[s, g] - corr[s, 0]))
                                           - cross[s, g - 1])
    return corr, cross, dll


def corr_args(p, f_max, pairs, n_chains):
    """A scoring call's arguments of F1 / F2 on the port problem ``p``: chain
    k on the problem's genome, fA and its two neighbours from ``pairs``."""
    scorer = tdr.make_repeat_delta_scorer_v2(p["tt"], f_max, p["tsobs"], p["ts"].rep)
    states = GenomeState(*[torch.stack([x] * n_chains) for x in p["ts"]])
    f_a = torch.tensor([pairs[k % len(pairs)][0] for k in range(n_chains)])
    ids = torch.tensor([[pairs[k % len(pairs)][1], pairs[(k + 1) % len(pairs)][1]]
                        for k in range(n_chains)])
    rows, valid, _ = td.extract_rows_each(states, f_a, ids, scorer.f_max)
    pl = scorer.plain
    _, vec, ob, pvec = pl.inputs(states, f_a, ids, rows, valid, p["tp"], states.id_c.amax(-1))
    _, dll1 = pl.mini_grid(*pl.mini_grid_args(vec, ob, pvec))
    return scorer, [states, f_a, rows, valid, td.geometry_of(vec), vec.accu_sub, pvec, dll1]


def check_f2(scorer, args, layouts=("14x512/2",)):
    want = scorer.corrections_plain(*args)
    earlier = f2_transcribed(scorer, args, "earlier")
    for layout in layouts:
        got = f2_transcribed(scorer, args, "new", layout)
        for g, e in zip(got, earlier):
            assert g.tobytes() == e.tobytes(), layout
    corr, cross, dll = earlier
    np.testing.assert_allclose(corr, want[0].numpy(), rtol=CORR_RTOL, atol=1e-9)
    np.testing.assert_allclose(cross, want[1].numpy(), rtol=CORR_RTOL, atol=1e-9)
    w = want[2].numpy()
    ulp = np.spacing(np.abs(w)).astype(np.float64)
    assert (np.abs(dll.astype(np.float64) - w) <= ulp).all()
    assert np.abs(corr).max() > 0


def test_f2_on_plain_terms_one_and_three_chains(call):
    """c_max 2: the 240-bin repeat problem's chains-axis call (3 chains on
    three genomes, f_max 32), and its first chain alone."""
    scorer, args = call
    check_f2(scorer, args, layouts=tuple(LAYOUTS))
    one = [GenomeState(*[x[:1] for x in args[0]]), args[1][:1], args[2][:1], args[3][:1],
           type(args[4])(*[x[:3] for x in args[4]]), args[5][:3], args[6][:3], args[7][:3]]
    check_f2(scorer, one)


@pytest.mark.parametrize("kind", ["many_copies", "no_mixed", "no_multi_multi"])
def test_f2_on_plain_terms_edge_tables(kind):
    """c_max 12 (twelve copies a duplicated bin), no mixed entry (an empty
    first group), no multi-multi entry; two chains."""
    p = edge_problem(kind)
    rep = np.nonzero(np.asarray(p["state"].rep) == 1)[0]
    pairs = [(int(rep[0]), 5), (int(rep[-1]), int(rep[0])), (3, 19)]
    scorer, args = corr_args(p, 24, pairs, 2)
    t = scorer.corr_tables
    assert {"many_copies": t.c_max == 12, "no_mixed": t.capm == 0,
            "no_multi_multi": t.dd_ob.shape[0] == 0}[kind]
    check_f2(scorer, args)


# ---- I1's scan -----------------------------------------------------------------

def slot_threads(f_max):
    """csrc/delta_inputs.cu ``slot_threads``."""
    warps = -(-f_max // (32 * SLOT_ROWS))
    return 32 * min(max(warps, 1), MAX_SLOT_THREADS // 32)


def ballot_first(row, fa, fb, f_max, threads):
    """One slot's scan as the kernel runs it: warp w's runs (from w x 32 x
    SLOT_ROWS, then + the block's 32 x SLOT_ROWS x warps) until it has both
    first matches, every row of a run loaded first, a ballot a pass and its
    lowest set bit, then the least over the warps; 0 where none."""
    n_warps = threads // 32
    lanes = np.arange(32)
    firsts = []
    for w in range(n_warps):
        ia = ib = NO_MATCH
        run = w * 32 * SLOT_ROWS
        while run < f_max and (ia == NO_MATCH or ib == NO_MATCH):
            idx = run + np.arange(SLOT_ROWS)[:, None] * 32 + lanes          # the run's loads
            inside = idx < f_max
            r = np.where(inside, row[np.minimum(idx, f_max - 1)], 0)
            for q in range(SLOT_ROWS):
                ha = np.flatnonzero(inside[q] & (r[q] == fa))
                hb = np.flatnonzero(inside[q] & (r[q] == fb))
                if ia == NO_MATCH and len(ha):
                    ia = run + q * 32 + ha[0]
                if ib == NO_MATCH and len(hb):
                    ib = run + q * 32 + hb[0]
            run += n_warps * 32 * SLOT_ROWS
        firsts.append((ia, ib))
    ia, ib = (min(x) for x in zip(*firsts))
    return (0 if ia == NO_MATCH else ia), (0 if ib == NO_MATCH else ib)


def i1_scan_transcribed(a: di.SlotArgs):
    """I1 from its argument block: the scalars and parameter rows as
    ``tests.test_torch_delta_inputs.i1_transcribed`` writes them, lf_a /
    lf_b by :func:`ballot_first` over the rows read at their strides."""
    i1_transcribed(a)
    big_m = a.C * a.m
    lf = _arr(a.lf, np.int64, 2 * big_m)
    for s in range(big_m):
        c, j = divmod(s, a.m)
        row = _read(a.rows, np.int64, a.rows_cs * c + a.rows_ms * j
                    + a.rows_is * np.arange(a.f_max))
        fa = _read(a.f_a, np.int64 if a.fa64 else np.int32, np.array([a.fa_s * c]))[0]
        fb = _read(a.ids, np.int64 if a.ids64 else np.int32,
                   np.array([a.ids_cs * c + a.ids_ms * j]))[0]
        lf[s], lf[big_m + s] = ballot_first(row, fa, fb, a.f_max, slot_threads(a.f_max))


def i1_case(name):
    """(rows (C, m, f_max) int64 at the case's strides, f_a, ids, max_id,
    params, log_nfpb) of one case."""
    rng = np.random.default_rng(len(name) * 7 + 1)
    f_max = {"f_max_77": 77, "f_max_513": 513, "f_max_1000": 1000, "f_max_16384": 16384,
             "f_max_20000": 20000}.get(name, 1024)
    c, m = (3, 4) if f_max < 16384 else (2, 2)
    n = 5 * f_max
    rows = torch.as_tensor(rng.integers(0, n, (c, m, f_max)))
    valid_n = rng.integers(1, f_max + 1, (c, m))
    # the valid prefix ascending, the padding past it repeats row 0 as the
    # extraction's does
    for k in range(c):
        for j in range(m):
            v = int(valid_n[k, j])
            rows[k, j, :v] = torch.sort(rows[k, j, :v]).values
            rows[k, j, v:] = rows[k, j, 0]
    f_a = torch.as_tensor(rng.integers(0, n, c))
    ids = torch.as_tensor(rng.integers(0, n, (c, m)))
    if name == "no_match":
        f_a[:] = n + 1
        ids[:] = n + 2
    elif name == "padding_only":
        for k in range(c):
            for j in range(m):
                v = int(valid_n[k, j])
                if v < f_max:
                    rows[k, j, v:] = n + 3 + j
                    ids[k, j] = n + 3 + j
                f_a[k] = n + 3
                rows[k, 0, -1] = n + 3
    elif name == "first_and_last":
        rows[:, :, 0] = n + 8
        f_a[:] = n + 8
        ids[:, 0] = n + 8
        ids[:, 1] = n + 9
        rows[:, 1, -1] = n + 9
        rows[:, 1, :-1] = torch.where(rows[:, 1, :-1] == n + 9, 0, rows[:, 1, :-1])
    elif name == "repeated":
        rows[:, :, 5:40:7] = 17
        f_a[:] = 17
        ids[:, :] = 17
    else:                                  # matches where the draws put them
        for k in range(c):
            f_a[k] = rows[k, rng.integers(m), rng.integers(f_max)]
            for j in range(m):
                ids[k, j] = rows[k, j, rng.integers(f_max)]
    max_id = torch.as_tensor(rng.integers(0, n, c))
    if name == "int32":
        f_a, ids, max_id = f_a.int(), ids.int(), max_id.int()
    if name == "strided":
        wide = torch.zeros((c, m, 2 * f_max), dtype=torch.int64)
        wide[..., ::2] = rows
        rows = wide[..., ::2]
        ids = torch.stack([ids, ids], -1)[..., 0].int()
    if name == "column_major":
        rows = rows.mT.contiguous().mT
    params = convert.params_from_numpy(default_params(fact=4000.0)._asdict())
    params = params._replace(fact=params.fact * torch.linspace(0.9, 1.1, c),
                             d=params.d.expand(c).clone())
    return rows, f_a, ids, max_id, params, torch.tensor(np.log(np.float32(3.0)))


I1_CASES = ("draws", "no_match", "padding_only", "first_and_last", "repeated", "f_max_77",
            "f_max_513", "f_max_1000", "f_max_16384", "f_max_20000", "int32", "strided",
            "column_major")


@pytest.mark.parametrize("name", I1_CASES)
def test_i1_scan_equals_plain_and_jax(name):
    rows, f_a, ids, max_id, params, log_nfpb = i1_case(name)
    want = td.slot_inputs_plain(rows, f_a, ids, max_id, params, log_nfpb)
    a, keep, got = di.slot_args(rows, f_a, ids, max_id, params, log_nfpb)
    i1_scan_transcribed(a)
    for g, w, what in zip(got, want, ("lf_a", "lf_b", "max_id", "pvec")):
        assert g.dtype == w.dtype and torch.equal(g, w), (name, what)
    c, m, f_max = rows.shape
    r = jnp.asarray(rows.reshape(c * m, f_max).numpy())
    ja = jnp.argmax(r == jnp.asarray(f_a.long().repeat_interleave(m).numpy())[:, None], axis=-1)
    jb = jnp.argmax(r == jnp.asarray(ids.long().reshape(-1).numpy())[:, None], axis=-1)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ja))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jb))
    if name == "no_match":
        assert not got[0].any() and not got[1].any()
    if name == "first_and_last":
        assert (got[0] == 0).all() and bool((got[1].reshape(c, m)[:, 1] == f_max - 1).all())
    del keep


@pytest.mark.parametrize("f_max", [1, 31, 32, 512, 513, 1024, 16384, 16385, 100_000])
def test_i1_threads_cover_the_rows(f_max):
    """I1's block: 1 to 32 warps, as many as hold f_max rows at SLOT_ROWS a
    thread; past 32 warps' rows each warp takes further runs, so every row
    lies in exactly one warp's runs."""
    threads = slot_threads(f_max)
    assert 32 <= threads <= MAX_SLOT_THREADS and threads % 32 == 0
    n_warps = threads // 32
    owner = np.full(f_max, -1)
    for w in range(n_warps):
        for run in range(w * 32 * SLOT_ROWS, f_max, n_warps * 32 * SLOT_ROWS):
            span = np.arange(run, min(run + 32 * SLOT_ROWS, f_max))
            assert (owner[span] == -1).all()
            owner[span] = w
    assert (owner >= 0).all()
    assert threads == MAX_SLOT_THREADS or threads * SLOT_ROWS >= f_max


# ---- the wrappers' card branches through stand-in libraries -----------------------

def no_torch_add(monkeypatch):
    def refuse(self, device, key=None):
        raise AssertionError(f"a torch add counted {key} beside a self-counting kernel")

    monkeypatch.setattr(LaunchCount, "add", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=None))


def bump(ptr):
    ctypes.c_int64.from_address(ptr).value += 1


def test_inputs_card_branch_counts_in_the_kernels(monkeypatch):
    """I1 / I2's wrapper hands each kernel its key's counter, which the
    kernel bumps (the stand-in library: the transcriptions); no torch add
    beside a launch; a block with no counter is refused by the library."""
    from tests.test_torch_delta_inputs import i2_transcribed

    wrapper = di.DeltaInputKernels()
    dev = torch.device("cpu")
    seen = []

    def slots(block, stream):
        a = block._obj
        assert a.counter == wrapper.launches.counter(dev, "delta_slots").data_ptr()
        i1_scan_transcribed(a)
        bump(a.counter)
        seen.append("slots")
        return 0

    def vectors(block, stream):
        a = block._obj
        assert a.counter == wrapper.launches.counter(dev, "delta_vectors").data_ptr()
        i2_transcribed(a, reciprocal=False)
        bump(a.counter)
        seen.append("vectors")
        return 0

    no_torch_add(monkeypatch)
    monkeypatch.setattr(di, "load_library",
                        lambda: types.SimpleNamespace(delta_slots=slots, delta_vectors=vectors))
    monkeypatch.setattr(di.DeltaInputKernels, "_card", staticmethod(lambda dev: None))
    rows, f_a, ids, max_id, params, log_nfpb = i1_case("draws")
    for _ in range(3):
        got = wrapper.slots(rows, f_a, ids, max_id, params, log_nfpb)
        want = td.slot_inputs_plain(rows, f_a, ids, max_id, params, log_nfpb)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert seen == ["slots"] * 3
    assert wrapper.launches.by_key() == {"delta_slots": 3}
    a, keep, _ = di.slot_args(rows, f_a, ids, max_id, params, log_nfpb)
    assert a.counter is None
    del keep


def test_sums_block_carries_its_layout(call, monkeypatch):
    """F2's argument block names the layout :func:`sums_plan` picks from the
    card's fit for the call's slots (csrc/repeat_corr.cu SumsPlan), 648
    bytes with it; off a card the first."""
    scorer, args = call
    slots = args[2].shape[0] * args[2].shape[1]
    a, keep, _ = rcc.call_args(scorer.corr_tables, *args)
    assert a.sums_plan == 0 and ctypes.sizeof(a) == 648
    del keep
    for k in range(len(rcc.SUMS_PLANS)):
        fit = tuple(slots if j >= k else slots - 1 for j in range(len(rcc.SUMS_PLANS)))
        monkeypatch.setattr(rcc, "sums_fit", lambda dev, fit=fit: fit)
        a, keep, _ = rcc.call_args(scorer.corr_tables, *args)
        assert a.sums_plan == k
        del keep
