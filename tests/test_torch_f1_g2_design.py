"""The designs of F1 (``csrc/repeat_corr.cu`` ``corr_frozen_kernel``), G1
(``csrc/rows.cu`` ``rows_counts_kernel``) and G2 (``rows_write_kernel``),
held on the CPU, where the kernels cannot run.

Their parts are transcribed in numpy and held to the plain versions and
the JAX package on inputs made from numpy seeds:

- F1's routers: the staged valid prefix (its length the count of the valid
  rows, a route a binary search of it) and the membership bitmap of the
  genome's fragments with each 32-bit word's rank (a block scan of the
  words' counts, a contiguous run of words a thread), each equal to the
  plain version's (n + 1) scatter ``inv_f`` and its mini rows;
- F1's records: the D rows split into K runs (a cluster's blocks) and a
  contiguous run a thread, each thread's counts scanned, the same-bin pairs
  copied to their places and the mixed records written flat (record i by
  thread i mod the block's threads, its row found by a binary search of
  the rows' offsets), equal to the plain version's windows and pairs in
  its order (D row ascending, then entry, same-bin pairs in copy order),
  with the same mini rows, frozen masses and o_same;
- F1's multi-multi fold, a lane a copy row of the u end (in blocks of 32
  lanes) then the rows in order, equal to the plain ``_copy_sum`` of
  ``_copy_sum`` bit for bit;
- G2's chunk ranked in one scan: the sums (every place's, or ka's and
  kb's) giving each stream's run, a chunk that cannot write skipped, each
  thread's RPT contiguous rows of a pass classed into the three streams and
  counted, an exclusive scan over the threads, the pass's rows staged in
  output order and written by consecutive threads at the stream's run plus
  their place in the stage, cut at f_max; equal to
  ``extract_rows_each_plain`` / ``extract_rows_union_plain`` and to JAX's
  ``extract_rows`` / ``extract_rows_union``, with chunk edges (a last
  partial pass), the f_max cut inside each of the three streams, kb == ka,
  a contig larger than f_max in union mode and m + 1 = 4,096 keys;
- G1's chunk loaded before its keys and counted in registers: the keys
  padded to their sorting width and sorted by the warp's shuffle network
  (up to 32) or the block's shared-memory network (up to 4,096; its
  barriers where a stage crosses a warp's values), each step of a warp's
  32 consecutive rows placed by a lower bound, the warp's equal places
  counted by one shared atomic, the chunk maxima from the same rows; equal
  to a direct count at m = 1 to 4,095, repeated and equal keys, fA among
  its own slots, chunks of 7 rows, of CHUNK, above CHUNK and above n with
  a shorter last chunk, with as many shared atomics as the earlier design;
  and
  ``core.delta``'s card branch through the wrapper and a stand-in library
  running the G1 and G2 transcriptions (G2 reading G1's scratch), equal to
  the plain extractions and JAX's;
- the wrappers' card branches through stand-in libraries: the argument
  blocks' sizes, the counters handed to the kernels (no torch add beside a
  launch), F1's plan in its block, and the dynamic shared memory F1 and
  G2 ask, held to what the device allows.
"""

import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graal_tpu_torch.core import delta as td
from graal_tpu_torch.core import delta_repeats as tdr
from graal_tpu_torch.core.state import GenomeState
from graal_tpu_torch.ops import build
from graal_tpu_torch.ops import repeat_corr_cuda as rcc
from graal_tpu_torch.ops import rows_cuda as rwc
from graal_tpu_torch.ops.counts import LaunchCount
from tests.test_torch_repeat_corr import call, small  # noqa: F401  (fixtures)
from tests.test_torch_rows import chains_of, genome, j_each, j_union
from tests.test_torch_state import to_port  # noqa: F401  (one torch thread a worker)


# ---- F1's routers ----------------------------------------------------------------

def route_staged(rows, valid, g):
    """The staged router's slot of fragments ``g``: the valid prefix's
    length from the count of valid rows, a lower-bound binary search."""
    nvalid = int(np.sum(valid))
    prefix = rows[:nvalid]
    lo = np.searchsorted(prefix, g, side="left")
    hit = (lo < nvalid) & (prefix[np.minimum(lo, max(nvalid - 1, 0))] == g) if nvalid else \
        np.zeros(len(g), bool)
    return np.where(hit, lo, -1)


def bitmap_ranks(rows, valid, n, threads):
    """The bitmap router's words and ranks: each valid row's bit set, then
    an exclusive scan of the words' counts, a contiguous run of words a
    thread (``threads`` threads)."""
    nw = -(-n // 32)
    bits = np.zeros(nw, np.uint64)
    for r, v in zip(rows, valid):
        if v:
            bits[r >> 5] |= np.uint64(1) << np.uint64(r & 31)
    per = -(-nw // threads)
    counts = [sum(bin(int(bits[w])).count("1") for w in range(min(t * per, nw),
                                                               min(t * per + per, nw)))
              for t in range(threads)]
    run = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.zeros(nw, np.int64)
    for t in range(threads):
        acc = run[t]
        for w in range(min(t * per, nw), min(t * per + per, nw)):
            rank[w] = acc
            acc += bin(int(bits[w])).count("1")
    return bits, rank


def route_bitmap(bits, rank, g):
    w, b = g >> 5, (g & 31).astype(np.uint64)
    word = bits[w]
    member = (word >> b) & np.uint64(1)
    below = np.array([bin(int(x & ((np.uint64(1) << y) - np.uint64(1)))).count("1")
                      for x, y in zip(word, b)], np.int64)
    return np.where(member == 1, rank[w] + below, -1)


def mini_rows(slot, krows, t, r_max):
    """Copy rows' mini rows from their slots (csrc/repeat_corr.cu Router)."""
    sub_start = t.sub_start.numpy().astype(np.int64)
    owner = t.owner.numpy().astype(np.int64)
    return np.clip(np.maximum(slot, 0) * t.s_max + (krows - sub_start[owner[krows]]), 0,
                   r_max - 1)


@pytest.mark.parametrize("threads", [1, 7, 1024])
@pytest.mark.parametrize("f_max", [4, 16, 64])
@pytest.mark.parametrize("genome_kind", ["shuffled", "truth"])
def test_routers_equal_inv_f(small, f_max, genome_kind, threads):
    s = small
    state = s["shuf"] if genome_kind == "shuffled" else s["truth"]
    n = state.n_frags
    gen = torch.Generator().manual_seed(f_max + threads)
    f_a = torch.randint(n, (), generator=gen)
    ids = torch.randint(n, (5,), generator=gen)
    rows, valid, _ = td.extract_rows_each(state, f_a, ids, f_max)
    scorer = tdr.make_repeat_delta_scorer_v2(s["table"], f_max, s["sobs"], state.rep)
    t = scorer.corr_tables
    owner = t.owner.numpy().astype(np.int64)
    krows = np.arange(len(owner))
    for i in range(len(ids)):
        inv_f = torch.full((n + 1,), -1, dtype=torch.int64)
        inv_f.scatter_(0, torch.where(valid[i], rows[i], n), torch.arange(rows.shape[1]))
        want = inv_f[:n].numpy()[owner]
        r_np, v_np = rows[i].numpy(), valid[i].numpy()
        bits, rank = bitmap_ranks(r_np, v_np, n, threads)
        for got in (route_staged(r_np, v_np, owner), route_bitmap(bits, rank, owner)):
            np.testing.assert_array_equal(got, want, err_msg=f"{genome_kind} {f_max} {i}")
        in_d, mrow = scorer.route(inv_f[None, :n], torch.as_tensor(krows), shared=True)
        np.testing.assert_array_equal(mini_rows(want, krows, t, scorer.r_max), mrow[0].numpy())
        assert np.array_equal(want >= 0, in_d[0].numpy())


# ---- F1's records ----------------------------------------------------------------

def fold(xs):
    """The f32 left fold of the plain ``_copy_sum``."""
    out = np.float32(xs[0])
    for x in xs[1:]:
        out = np.float32(out + np.float32(x))
    return out


def f1_records(t, activ, rows, valid, r_max, k, threads, router):
    """csrc/repeat_corr.cu's D-row clusters on one slot, transcribed: rows
    split into K runs of ceil(R / K), a contiguous run a thread; each row's
    walk (same-bin pairs staged, o_same, its mixed range); the threads'
    counts scanned, the blocks' totals summed in rank order (through
    DSMEM on the card); the pairs copied to their places; the mixed
    records written flat (record i by thread i mod ``threads``, its row
    the last whose place is at most i). Returns (records (r, ent), their
    mini rows, their frozen masses, pairs (r, mini row), o_same)."""
    T = {f: getattr(t, f).numpy() for f in ("owner", "data_id", "accu", "sub_start", "sub_count",
                                            "copy_start", "copy_rows", "dup", "mx_start",
                                            "mx_cols")}
    n_k, c_max, s_max, capm = len(T["owner"]), t.c_max, t.s_max, t.capm
    if router == "staged":
        def route(krow):
            return route_staged(rows, valid, T["owner"][[krow]])[0]
    else:
        bits, rank = bitmap_ranks(rows, valid, len(T["sub_start"]), threads)

        def route(krow):
            return route_bitmap(bits, rank, T["owner"][[krow]])[0]

    def mrow(slot, krow):
        g = T["owner"][krow]
        return int(np.clip(max(slot, 0) * s_max + (krow - T["sub_start"][g]), 0, r_max - 1))

    def frozen_a(krow):
        return np.float32(T["accu"][krow]) if activ[T["owner"][krow]] == 1 else np.float32(0)

    def walk(r):
        j, si = divmod(r, s_max)
        frag = rows[j]
        sv = bool(valid[j]) and si < T["sub_count"][frag]
        db = T["data_id"][np.clip(T["sub_start"][frag] + si, 0, n_k - 1)]
        db_dup = bool(T["dup"][db]) and sv
        c0, cnt = T["copy_start"][db], T["copy_start"][db + 1] - T["copy_start"][db]
        w0 = nm = 0
        if capm > 0 and sv and not db_dup:
            w0 = T["mx_start"][db]
            nm = min(T["mx_start"][db + 1], w0 + capm) - w0
        stage, outs = [], []
        for c in range(c_max):
            krow = T["copy_rows"][np.clip(c0 + c, 0, n_k - 1)]
            slot = route(krow)
            q_in, q_row = slot >= 0, mrow(slot, krow)
            if q_in and c < cnt and db_dup and q_row > r:
                stage.append(q_row)
            outs.append(frozen_a(krow) if (c < cnt and not q_in) else np.float32(0))
        return w0, nm, stage, fold(outs)

    def mixed(r, ent):
        tb = T["mx_cols"][ent]
        v0, vc = T["copy_start"][tb], T["copy_start"][tb + 1] - T["copy_start"][tb]
        minis, outs = [], []
        for c in range(c_max):
            krow = T["copy_rows"][np.clip(v0 + c, 0, n_k - 1)]
            slot = route(krow)
            minis.append(mrow(slot, krow) if (c < vc and slot >= 0) else -1)
            outs.append(frozen_a(krow) if (c < vc and slot < 0) else np.float32(0))
        return minis, fold(outs)

    recs, rec_minis, rec_aout, pairs = [], [], [], []
    o_same = np.zeros(r_max, np.float32)
    rb = -(-r_max // k)
    for rank_k in range(k):
        rb0 = min(rank_k * rb, r_max)
        n_rows = min(rb0 + rb, r_max) - rb0
        per = -(-n_rows // threads)
        w0s, nms, stages = np.zeros(n_rows, int), np.zeros(n_rows, int), [None] * n_rows
        n_mx, n_sb = np.zeros(threads, int), np.zeros(threads, int)
        for th in range(threads):
            for lr in range(min(th * per, n_rows), min(th * per + per, n_rows)):
                w0s[lr], nms[lr], stages[lr], o_same[rb0 + lr] = walk(rb0 + lr)
                n_mx[th] += nms[lr]
                n_sb[th] += len(stages[lr])
        ex_mx = np.concatenate([[0], np.cumsum(n_mx)[:-1]])
        ex_sb = np.concatenate([[0], np.cumsum(n_sb)[:-1]])
        off = np.zeros(n_rows, int)
        block_pairs = [None] * int(n_sb.sum())
        for th in range(threads):
            run_mx, run_sb = ex_mx[th], ex_sb[th]
            for lr in range(min(th * per, n_rows), min(th * per + per, n_rows)):
                for m_row in stages[lr]:
                    block_pairs[run_sb] = (rb0 + lr, m_row)
                    run_sb += 1
                off[lr] = run_mx
                run_mx += nms[lr]
        pairs += block_pairs
        block = [None] * int(n_mx.sum())
        for th in range(threads):
            for i in range(th, len(block), threads):
                lr = int(np.searchsorted(off, i, side="right")) - 1
                ent = w0s[lr] + (i - off[lr])
                block[i] = (rb0 + lr, ent, *mixed(rb0 + lr, ent))
        recs += [(r, e) for r, e, _, _ in block]
        rec_minis += [mm for _, _, mm, _ in block]
        rec_aout += [a for _, _, _, a in block]
    return (np.array(recs, int).reshape(-1, 2), np.array(rec_minis, int).reshape(-1, c_max),
            np.array(rec_aout, np.float32), np.array(pairs, int).reshape(-1, 2), o_same)


def plain_records(scorer, state, rows, valid):
    """The plain version's mixed windows and same-bin pairs of one chain's
    slots, in its order (``RepeatDeltaScorer._corrections``'s tensors):
    per slot (records (r, ent), mini rows, frozen masses, pairs, o_same)."""
    p = scorer.plain
    m, f_max = rows.shape
    n = state.n_frags
    subs, sub_valid = p.sub_rows(rows, valid)
    db = scorer.data_id[subs.clamp(0, scorer.k_subs - 1)]
    db_dup = scorer.dup[db] & sub_valid
    inv_f = torch.full((m, n + 1), -1, dtype=torch.int64)
    inv_f.scatter_(1, torch.where(valid, rows, n), torch.arange(f_max).expand_as(rows))
    inv_f = inv_f[:, :n]
    smat = torch.stack([state.start_bp, state.ori, state.id_c, state.circ, state.l_cont_bp,
                        state.activ], dim=1)
    mx = scorer.mixed
    start, end = mx.row_start[db], mx.row_start[db + 1]
    win = start[..., None] + torch.arange(mx.row_cap)
    mwin = (win < end[..., None]) & (sub_valid & ~db_dup)[..., None]
    t_bin = torch.where(mwin, mx.cols[win.clamp_max(mx.vals.shape[0] - 1)].long(), 0)
    v_rows, v_ok = scorer.copy_rows_of(t_bin)
    v_in, v_mini = scorer.route(inv_f, v_rows, shared=False)
    v_ok = v_ok & mwin[..., None]
    a_out = tdr._copy_sum(torch.where(v_ok & ~v_in, scorer.frozen_a(smat, v_rows), 0.0))
    minis = torch.where(v_ok & v_in, v_mini, -1)
    sb_rows, sb_ok = scorer.copy_rows_of(db)
    sb_in, sb_mini = scorer.route(inv_f, sb_rows, shared=False)
    r = subs.shape[1]
    sb_use = sb_in & sb_ok & db_dup[..., None] & (sb_mini > torch.arange(r)[:, None])
    o_same = tdr._copy_sum(torch.where(sb_ok & ~sb_in, scorer.frozen_a(smat, sb_rows), 0.0))
    out = []
    for i in range(m):
        rr, ww = torch.nonzero(mwin[i], as_tuple=True)
        pr, pc = torch.nonzero(sb_use[i], as_tuple=True)
        out.append((torch.stack([rr, win[i][rr, ww]], 1).numpy(), minis[i][rr, ww].numpy(),
                    a_out[i][rr, ww].numpy(), torch.stack([pr, sb_mini[i][pr, pc]], 1).numpy(),
                    o_same[i].numpy()))
    return out


@pytest.mark.parametrize("k, threads", [(1, 1024), (1, 3), (2, 5), (3, 4), (8, 2)])
@pytest.mark.parametrize("router", rcc.ROUTERS)
def test_f1_records_in_the_plain_order(small, k, threads, router):
    s = small
    state = s["shuf"]
    n = state.n_frags
    scorer = tdr.make_repeat_delta_scorer_v2(s["table"], 64, s["sobs"], state.rep)
    t = scorer.corr_tables
    # fA an original of duplicated data and its copies among the neighbours
    # (same-bin pairs: both copies in D), then a random fragment
    id_d = torch.as_tensor(s["id_d"]).long()
    copies = torch.nonzero(id_d != torch.arange(n)).reshape(-1)
    gen = torch.Generator().manual_seed(k * 10 + threads)
    ids = torch.cat([copies[:6], torch.randint(n, (1,), generator=gen)])
    for q in range(len(copies)):      # the first such fA whose slots hold a same-bin pair
        f_a = id_d[copies[(k + q) % len(copies)]]
        rows, valid, _ = td.extract_rows_each(state, f_a, ids, scorer.f_max)
        want = plain_records(scorer, state, rows, valid)
        if sum(len(w[3]) for w in want):
            break
    assert sum(len(w[0]) for w in want) > 0 and sum(len(w[3]) for w in want) > 0
    activ = state.activ.numpy()
    for i in range(len(ids)):
        got = f1_records(t, activ, rows[i].numpy(), valid[i].numpy(), scorer.r_max, k, threads,
                         router)
        for g, w, what in zip(got, want[i], ("records", "mini rows", "frozen masses", "pairs",
                                            "o_same")):
            np.testing.assert_array_equal(g, w, err_msg=f"slot {i} {what}")


@pytest.mark.parametrize("c", [1, 2, 12, 33, 70])
def test_multi_multi_fold_by_lanes(c):
    """A warp's fold of an entry's c x c copy pairs: lane l folds copy row
    cu = l (+ 32, ...) over cv left to right, the rows then folded in cu
    order through shuffles: the plain ``_copy_sum(_copy_sum(e))``."""
    rng = np.random.default_rng(c)
    e = (rng.standard_normal((c, c)) * 10.0 ** rng.integers(-5, 6, (c, c))).astype(np.float32)
    ee = None
    for ub in range(0, c, 32):
        rows = [fold(e[cu]) for cu in range(ub, min(ub + 32, c))]   # one a lane
        for v in rows:
            ee = v if ee is None else np.float32(ee + v)
    want = tdr._copy_sum(tdr._copy_sum(torch.from_numpy(e)))
    assert np.float32(want.item()) == ee


# ---- G2: a chunk ranked in one scan ------------------------------------------------

def g2_transcription(id_c, f_a, ids, f_max, union, chunk, threads, rpt, scratch=None):
    """csrc/rows.cu's G2 over G1's scratch, transcribed: a block a (chunk,
    slot, chain); each place's sums (ka's and kb's: the same numbers), the
    streams' runs, a chunk none of whose streams can land below f_max
    skipped; each pass of threads x rpt rows, each thread's rpt contiguous
    rows classed and counted, an exclusive scan over the threads, the rows
    staged stream by stream in output order, then written by consecutive
    threads at the stream's run plus their place in the stage, where below
    f_max. ``scratch``: G1's (sorted keys (C, m + 1), counts (C, m + 1,
    n_chunks)) to read, else counted here. Returns (rows, valid,
    overflow)."""
    c_n, n = id_c.shape
    m = ids.shape[1]
    n_chunks = -(-n // chunk)
    rows = np.full((c_n, m, f_max), -1, np.int64)
    valid = np.zeros((c_n, m, f_max), bool)
    overflow = np.zeros((c_n, m), bool)
    pass_rows = threads * rpt
    for c in range(c_n):
        keys = np.concatenate([[id_c[c, f_a[c]]], id_c[c, ids[c]]])
        skeys = np.sort(keys, kind="stable")
        counts = np.zeros((m + 1, n_chunks), np.int64)            # G1: at first places
        for b in range(n_chunks):
            part = id_c[c, b * chunk:(b + 1) * chunk]
            for r in np.unique(np.searchsorted(skeys, keys)):
                counts[r, b] = (part == skeys[r]).sum()
        if scratch is not None:
            assert np.array_equal(scratch[0][c], skeys)
            counts = scratch[1][c]
        tot = counts.sum(-1)
        fits = tot <= f_max
        for b in range(n_chunks):
            lo, hi = b * chunk, min((b + 1) * chunk, n)
            bef, here = counts[:, :b].sum(-1), counts[:, b]
            for j in range(m):
                ka, kb = keys[0], keys[1 + j]
                same = kb == ka
                pa, pb = np.searchsorted(skeys, ka), np.searchsorted(skeys, kb)
                inc_a = not union or tot[pa] <= f_max
                inc_b = not same and (not union or tot[pb] <= f_max)
                a_tot = inc_a * tot[pa] + inc_b * tot[pb]
                a_bef = inc_a * bef[pa] + inc_b * bef[pb]
                a_in = inc_a * here[pa] + inc_b * here[pb]
                ut, ub, ui = (tot[fits].sum(), bef[fits].sum(), here[fits].sum()) if union \
                    else (a_tot, a_bef, a_in)
                if b == 0:
                    overflow[c, j] = tot[pa] + (0 if same else tot[pb]) > f_max
                run = [a_bef, a_tot + (ub - a_bef), ut + (lo - ub)]
                if not ((a_in > 0 and run[0] < f_max) or (ui > a_in and run[1] < f_max)
                        or (hi - lo > ui and run[2] < f_max)):
                    continue
                for base in range(lo, hi, pass_rows):
                    # thread th's rows base + th rpt + k, k < rpt
                    i = base + np.arange(pass_rows).reshape(threads, rpt)
                    x = id_c[c, np.minimum(i, n - 1)]
                    place = np.minimum(np.searchsorted(skeys, x), m)
                    in_u = union & (skeys[place] == x) & fits[place]
                    cls = np.where((x == ka) & inc_a | (x == kb) & inc_b, 0,
                                   np.where(in_u, 1, 2))
                    cls = np.where(i < hi, cls, 3)
                    cnt = np.stack([(cls == st).sum(1) for st in range(3)], 1)  # (threads, 3)
                    ex = np.cumsum(cnt, 0) - cnt                # the scan over threads
                    tot_p = cnt.sum(0)
                    off = np.concatenate([[0], np.cumsum(tot_p)[:-1]])
                    stage = np.zeros(tot_p.sum(), np.int64)
                    for th in range(threads):
                        e = off + ex[th]
                        for k in range(rpt):
                            st = cls[th, k]
                            if st != 3:
                                stage[e[st]] = i[th, k]
                                e[st] += 1
                    for q in range(len(stage)):             # consecutive threads
                        st = 0 if q < off[1] else 1 if q < off[2] else 2
                        p = run[st] + q - off[st]
                        if p < f_max:
                            rows[c, j, p] = stage[q]
                            valid[c, j, p] = st == 0
                    run = [run[st] + int(tot_p[st]) for st in range(3)]
    return rows, valid, overflow


def g2_case(name):
    """(C genomes, f_a, ids, f_max) of one G2 edge case, made from a numpy
    seed: the f_max cut inside stream A, B or C, kb == ka, a contig larger
    than f_max in union mode, m + 1 = 4,096 keys."""
    rng = np.random.default_rng({"cut_a": 1, "cut_b": 2, "cut_c": 3, "same_contig": 4,
                                 "big_union": 5, "keys_4096": 6}[name])
    n, c, m, f_max, sizes = {
        "cut_a": (300, 2, 3, 64, [50, 40]),            # ka + kb = 90 > f_max: cut in A
        "cut_b": (300, 2, 5, 64, [30] * 6),            # A = 60, the union's others past f_max
        "cut_c": (300, 2, 1, 64, [10, 10]),            # A + B = 20: cut in C
        "same_contig": (300, 2, 4, 48, [30, 20]),      # kb == ka in some slots
        "big_union": (300, 2, 4, 48, [120, 30, 25]),   # contig(fA) above f_max
        "keys_4096": (260, 1, 4095, 16, [12, 9]),
    }[name]
    gens, f_as, idss = [], [], []
    for k in range(c):
        sz = list(sizes)
        while sum(sz) < n:
            sz.append(int(min(rng.integers(1, 9), n - sum(sz))))
        g, labels = genome(rng, sz, scatter=k == 0)
        gens.append(g)
        contig = [np.flatnonzero(labels == q) for q in range(len(sizes))]
        f_as.append(contig[0][k % len(contig[0])])
        ids = rng.integers(0, n, m)
        for q in range(1, min(len(sizes), m + 1)):
            ids[q - 1] = contig[q][0]
        if name == "same_contig":
            ids[0], ids[2] = f_as[-1], contig[0][-1]
        idss.append(ids)
    return gens, torch.as_tensor(np.array(f_as)), torch.as_tensor(np.stack(idss)), f_max


G2_PLANS = {"one_pass": (256, 256, 8), "edges": (48, 4, 8), "rows_of_one": (7, 2, 1),
            "passes": (100, 4, 4)}


@pytest.mark.parametrize("plan", list(G2_PLANS))
@pytest.mark.parametrize("name", ["cut_a", "cut_b", "cut_c", "same_contig", "big_union"])
def test_g2_scan_equals_plain_and_jax(name, plan):
    gens, f_a, ids, f_max = g2_case(name)
    jstates, port = chains_of(gens)
    chunk, threads, rpt = G2_PLANS[plan]
    id_c = port.id_c.numpy()
    for union in (False, True):
        got = g2_transcription(id_c, f_a.numpy(), ids.numpy(), f_max, union, chunk, threads, rpt)
        plain = (td.extract_rows_union_plain if union else td.extract_rows_each_plain)(
            port, f_a, ids, f_max)
        for g, w, what in zip(got, plain, ("rows", "valid", "overflow")):
            np.testing.assert_array_equal(g, w.numpy(), err_msg=f"{name} {plan} {union} {what}")
        for k, js in enumerate(jstates):
            fn = j_union(f_max) if union else j_each(f_max)
            want = fn(js, int(f_a[k]), jnp.asarray(ids[k].numpy(), jnp.int32))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[k], np.asarray(w), err_msg=f"{name} {k} jax")
    # the cut falls where the case says
    valid_each = td.extract_rows_each_plain(port, f_a, ids, f_max)
    if name == "cut_a":
        assert bool(valid_each[1][:, 0].all()) and bool(valid_each[2][:, 0].all())
    if name == "cut_b":
        u = td.extract_rows_union_plain(port, f_a, ids, f_max)
        assert not bool(u[1][:, 0].all()) and bool(u[1][:, 0].any())


def test_g2_scan_at_4096_keys():
    gens, f_a, ids, f_max = g2_case("keys_4096")
    _, port = chains_of(gens)
    assert ids.shape[1] + 1 == rwc.MAX_KEYS
    id_c = port.id_c.numpy()
    for union in (False, True):
        for chunk, threads, rpt in ((100, 4, 8), (260, 32, 8)):
            got = g2_transcription(id_c, f_a.numpy(), ids.numpy(), f_max, union, chunk, threads,
                                   rpt)
            plain = (td.extract_rows_union_plain if union else td.extract_rows_each_plain)(
                port, f_a, ids, f_max)
            for g, w in zip(got, plain):
                np.testing.assert_array_equal(g, w.numpy())
    assert rwc.write_smem(4095, True, 1) > 48 * 1024 >= rwc.write_smem(4095, False, 3)


# ---- G1: the chunk's loads issued at once, the keys sorted by a network ------------

INT_MIN, INT_MAX = -2 ** 31, 2 ** 31 - 1


def sort_width(n_keys):
    """rows.cu's ``sort_width``: 32, or the power of two at or above n_keys."""
    p = 32
    while p < n_keys:
        p <<= 1
    return p


def warp_sort(v):
    """rows.cu's ``warp_sort``: the bitonic network over a warp's 32 lanes,
    lane l taking the min or the max of its value and lane l ^ j's."""
    v, lane = np.asarray(v, np.int64), np.arange(32)
    k = 2
    while k <= 32:
        j = k >> 1
        while j:
            o = v[lane ^ j]
            v = np.where(((lane & j) == 0) == ((lane & k) == 0), np.minimum(v, o),
                         np.maximum(v, o))
            j >>= 1
        k <<= 1
    return v


def block_sort(s):
    """rows.cu's ``block_sort``: the bitonic network over p values in shared
    memory, compare-exchange i of a stage on (lo, lo + j) with lo the i-th
    index whose bit j is 0, swapped where its order is not the stage's."""
    s, p = np.array(s, np.int64), len(s)
    k = 2
    while k <= p:
        j = k >> 1
        while j:
            i = np.arange(p // 2)
            lo = ((i & ~(j - 1)) << 1) | (i & (j - 1))
            x, y = s[lo], s[lo + j]
            swap = (x > y) == ((lo & k) == 0)
            s[lo], s[lo + j] = np.where(swap, y, x), np.where(swap, x, y)
            j >>= 1
        k <<= 1
    return s


def rank_sort(keys, n_keys):
    """rows.cu's rank sort (33 to THREADS keys): key t at the count of the
    keys below it and of its equals before it."""
    v = np.asarray(keys[:n_keys], np.int64)
    t = np.arange(n_keys)
    below = v[None, :] < v[:, None]
    r = (below | ((v[None, :] == v[:, None]) & (t[None, :] < t[:, None]))).sum(1)
    out = np.empty(n_keys, np.int64)
    out[r] = v
    return out


def g1_transcription(id_c, f_a, ids, chunk, threads=256, rpt=8):
    """csrc/rows.cu's G1, transcribed: a block a (chunk, chain); the keys
    (fA's, then each slot's) padded with INT_MAX to their sorting width and
    sorted by the warp's network (up to 32 keys), a rank a thread (up to
    ``threads``) or the block's network; each pass of threads x rpt
    rows, loaded before the keys, thread t's k-th row k threads + t (a
    warp's 32 consecutive rows a step); each row's first place in the
    sorted keys by a lower bound, the warp's (warp, k) rows of one place
    counted by one shared atomic; the chunk's largest id over the same
    rows. Returns (sorted keys (C, m + 1), counts (C, m + 1, n_chunks),
    chunk maxima (C, n_chunks), the shared atomics, and those of the
    earlier design: a warp's 32 consecutive rows of a pass, one atomic a
    place among them)."""
    c_n, n = id_c.shape
    m = ids.shape[1]
    n_keys, n_chunks = m + 1, -(-n // chunk)
    p = sort_width(n_keys)
    skeys = np.zeros((c_n, n_keys), np.int64)
    counts = np.zeros((c_n, n_keys, n_chunks), np.int64)
    cmax = np.zeros((c_n, n_chunks), np.int64)
    atomics = earlier = 0
    warp_k = (np.arange(threads)[:, None] // 32) * rpt + np.arange(rpt)[None, :]
    for c in range(c_n):
        keys = np.full(p, INT_MAX, np.int64)
        keys[:n_keys] = id_c[c, np.concatenate([[f_a[c]], ids[c]])]
        sk = (warp_sort(keys) if p == 32 else rank_sort(keys, n_keys) if n_keys <= threads
              else block_sort(keys))[:n_keys]
        skeys[c] = sk

        def places(x, live):
            pos = np.searchsorted(sk, x)
            hit = live & (pos < n_keys) & (sk[np.minimum(pos, n_keys - 1)] == x)
            return np.where(hit, pos, -1)

        for b in range(n_chunks):
            lo, hi = b * chunk, min((b + 1) * chunk, n)
            mx = INT_MIN
            for base in range(lo, hi, threads * rpt):
                r = base + np.arange(rpt)[None, :] * threads + np.arange(threads)[:, None]
                live = r < hi
                x = id_c[c, np.minimum(r, n - 1)]
                place = places(x, live)
                sel = place >= 0
                np.add.at(counts[c, :, b], place[sel], 1)
                atomics += len(np.unique(warp_k[sel] * n_keys + place[sel]))
                mx = max(mx, int(x[live].max()))
            cmax[c, b] = mx
            for base in range(lo, hi, 32):
                part = id_c[c, base:min(base + 32, hi)]
                got = places(part, np.ones(len(part), bool))
                earlier += len(np.unique(got[got >= 0]))
    return skeys, counts, cmax, atomics, earlier


def direct_counts(id_c, f_a, ids, chunk):
    """What G1 writes, counted directly: each chain's keys sorted, each
    contig's rows in a chunk at its first place in them (0 elsewhere), each
    chunk's largest id."""
    c_n, n = id_c.shape
    n_chunks = -(-n // chunk)
    skeys = np.sort(id_c[np.arange(c_n)[:, None], np.concatenate([f_a[:, None], ids], 1)], 1)
    counts = np.zeros(skeys.shape + (n_chunks,), np.int64)
    cmax = np.zeros((c_n, n_chunks), np.int64)
    for c in range(c_n):
        first = np.unique(np.searchsorted(skeys[c], skeys[c]))
        for b in range(n_chunks):
            part = id_c[c, b * chunk:(b + 1) * chunk]
            counts[c, first, b] = (part[None, :] == skeys[c, first][:, None]).sum(1)
            cmax[c, b] = part.max()
    return skeys, counts, cmax


def g1_case(m, n, seed, ordered):
    """Two chains of n rows whose contigs (12-400 rows) lie in order
    (``ordered``) or scattered, m slots drawn from a few contigs (repeated
    and equal keys), fA among its own slots in chain 0."""
    rng = np.random.default_rng(seed)
    gens, f_as, idss = [], [], []
    for k in range(2):
        sizes = []
        while sum(sizes) < n:
            sizes.append(int(min(rng.integers(12, 400), n - sum(sizes))))
        g, labels = genome(rng, sizes, scatter=not ordered)
        gens.append(g)
        pool = rng.choice(n, size=min(n, 9), replace=False)
        ids = rng.choice(pool, size=m) if m > 1 else pool[:1]
        f_as.append(int(pool[0]))
        if k == 0:
            ids[0] = f_as[-1]
        idss.append(ids)
    id_c = np.stack([g["id_c"] for g in gens]).astype(np.int64)
    return gens, id_c, np.array(f_as), np.stack(idss)


@pytest.mark.parametrize("m", [1, 5, 31, 32, 33, 80, 255, 256, 320, 1000, 4095])
def test_g1_transcription_equals_a_direct_count(m):
    """G1's design at every sorting path (m + 1 up to 32 on a warp's
    shuffles, up to 256 by ranks, above on the block's network, up to
    MAX_KEYS), at chunks of
    7 rows, of CHUNK, above CHUNK (several passes a chunk) and above n, each
    with a last chunk shorter than the rest, on genomes in contig order and
    scattered: the sorted keys, each contig's count at its first place and
    the chunk maxima equal a direct count, with as many shared atomics as
    the earlier design (a warp's 32 consecutive rows a pass)."""
    n = 6000
    for ordered in (True, False):
        _, id_c, f_a, ids = g1_case(m, n, seed=m + ordered, ordered=ordered)
        for chunk in (7, rwc.CHUNK, rwc.CHUNK + 2 * rwc.THREADS, n + 5):
            skeys, counts, cmax, atomics, earlier = g1_transcription(id_c, f_a, ids, chunk)
            want = direct_counts(id_c, f_a, ids, chunk)
            for g, w, what in zip((skeys, counts, cmax), want, ("skeys", "counts", "cmax")):
                np.testing.assert_array_equal(g, w, err_msg=f"m {m} chunk {chunk} {what}")
            assert atomics == earlier, (m, chunk, atomics, earlier)


def test_g1_sorting_networks_sort():
    """The warp's and the block's networks sort every width they take,
    duplicates and INT_MAX / INT_MIN among the values."""
    rng = np.random.default_rng(9)
    for p in (32, 64, 128, 512, 4096):
        for v in (rng.integers(-5, 5, p), rng.integers(INT_MIN, INT_MAX, p, endpoint=True),
                  np.arange(p)[::-1]):
            want = np.sort(v)
            assert np.array_equal(block_sort(v), want)
            if p == 32:
                assert np.array_equal(warp_sort(v), want)
    assert [sort_width(k) for k in (1, 32, 33, 64, 65, 4096)] == [32, 32, 64, 64, 128, 4096]
    for n in (33, 81, 256):
        v = rng.integers(-3, 3, n)
        assert np.array_equal(rank_sort(v, n), np.sort(v))


def test_g1_block_sort_barriers_cover_every_crossing():
    """``block_sort``'s barriers: a stage of distance j <= 32 keeps warp w's
    pairs (32 consecutive pair indices a warp, i = t + 256 r) inside 64
    values of its own, so a warp's barrier orders it; wherever one of two
    consecutive stages moves values across those ranges (j >= 64), the
    block's barrier stands between them, as rows.cu's rule (j >= 64 or the
    next stage's distance >= 64) places it."""
    threads = 256
    for p in (64, 128, 512, 4096):
        stages = []
        k = 2
        while k <= p:
            j = k >> 1
            while j:
                stages.append((k, j))
                j >>= 1
            k <<= 1
        i = np.arange(p // 2)
        warp = (i % threads) // 32 + 8 * (i // threads)
        for s, (k, j) in enumerate(stages):
            lo = ((i & ~(j - 1)) << 1) | (i & (j - 1))
            local = np.array_equal(lo // 64, warp) and np.array_equal((lo + j) // 64, warp)
            assert local == (j <= 32), (p, k, j)
            nxt = j >> 1 if j > 1 else (k if k < p else 0)
            block = j >= 64 or nxt >= 64
            if s + 1 < len(stages):
                assert block == (not local or stages[s + 1][1] >= 64), (p, k, j)


# ---- the wrappers' card branches through stand-in libraries -----------------------

def no_torch_add(monkeypatch):
    """A counting add beside a launch fails the test; the stream is none."""
    def refuse(self, device, key=None):
        raise AssertionError(f"a torch add counted {key} beside a self-counting kernel")

    monkeypatch.setattr(LaunchCount, "add", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=None))


def copy_into(ptr, x):
    x = x.contiguous()
    ctypes.memmove(ptr, x.data_ptr(), x.numel() * x.element_size())


def bump(ptr):
    ctypes.c_int64.from_address(ptr).value += 1


def test_argument_blocks_follow_the_c_structs():
    """The ctypes mirrors' sizes as the C structs lay them out (pointers
    and int64s 8 bytes, int32s and floats 4)."""
    assert ctypes.sizeof(rcc.Tables) == 25 * 8 + 2 * 4 + 8 * 4
    assert ctypes.sizeof(rcc.CorrArgs) == 640
    assert ctypes.sizeof(rwc.RowsArgs) == 12 * 8 + 3 * 8 + 8 * 4
    assert ctypes.sizeof(rwc.GatherArgs) == 11 * 8 * 3 + 4 * 8 + 4 * 4


@pytest.mark.parametrize("limit", ["fits", "too_small"])
def test_corr_card_branch_counts_in_the_kernels(call, monkeypatch, limit):
    """F1 / F2's wrapper hands each kernel its key's counter, F1 its plan
    (K, router) and asks the library the shared memory F1 needs, held to
    what the device allows (opted in once); no torch add counts beside
    the launches."""
    scorer, args = call
    wrapper = rcc.RepeatCorrKernels()
    dev = torch.device("cpu")
    calls = []
    r, f_max, n = args[4].mid.shape[2], args[2].shape[2], scorer.corr_tables.sub_start.shape[0]
    need = rcc.frozen_smem(r, f_max, n, *rcc.plan(r, f_max, n))
    inits = []

    def frozen(block, stream):
        a = block._obj
        assert ctypes.sizeof(a) == 640
        assert a.frozen_counter == wrapper.launches.counter(dev, "frozen").data_ptr()
        assert (a.cluster, rcc.ROUTERS[a.router]) == rcc.plan(a.R, a.f_max, a.t.n)
        calls.append("frozen")
        bump(a.frozen_counter)
        return 0

    def sums(block, stream):
        a = block._obj
        assert a.sums_counter == wrapper.launches.counter(dev, "sums").data_ptr()
        calls.append("sums")
        bump(a.sums_counter)
        for ptr, x in zip((a.corr, a.cross, a.dll), scorer.corrections_plain(*args)):
            copy_into(ptr, x)
        return 0

    def frozen_smem(block):
        a = block._obj
        return rcc.frozen_smem(a.R, a.f_max, a.t.n, a.cluster, rcc.ROUTERS[a.router])

    def init():
        inits.append(1)
        return need if limit == "fits" else need - 4

    no_torch_add(monkeypatch)
    monkeypatch.setattr(build, "_OPTED_IN", {})
    monkeypatch.setattr(rcc, "load_library", lambda: types.SimpleNamespace(
        repeat_corr_frozen=frozen, repeat_corr_sums=sums, repeat_corr_frozen_smem=frozen_smem,
        repeat_corr_init=init))
    monkeypatch.setattr(rcc.RepeatCorrKernels, "_card", staticmethod(lambda dev: None))
    if limit == "too_small":
        with pytest.raises(RuntimeError, match="shared memory"):
            wrapper.corrections(scorer.corr_tables, *args)
        assert calls == []
        return
    for _ in range(3):
        got = wrapper.corrections(scorer.corr_tables, *args)
        want = scorer.corrections_plain(*args)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert calls == ["frozen", "sums"] * 3 and inits == [1]
    assert wrapper.launches.by_key() == {"frozen": 3, "sums": 3}


@pytest.mark.parametrize("r, f_max, n, k", [(1024, 1024, 20_200, 1), (4096, 4096, 20_200, 2),
                                            (8192, 8192, 20_200, 4), (16384, 16384, 100_000, 8),
                                            (32768, 16384, 500_000, 8)])
def test_f1_plan_fits_its_shared_memory(r, f_max, n, k):
    """F1's plan: at most two D rows a thread where a cluster of at most 8
    blocks holds them, the dynamic shared memory within SMEM_MOST at every
    bucket up to 16,384 (no route searches global memory)."""
    got_k, router = rcc.plan(r, f_max, n)
    assert got_k == k and router in rcc.ROUTERS
    assert rcc.frozen_smem(r, f_max, n, got_k, router) <= rcc.SMEM_MOST
    assert rcc.frozen_smem(r, f_max, n, got_k, "staged") == 4 * (f_max + 3 * -(-r // got_k))
    assert rcc.frozen_smem(r, f_max, n, got_k, "bitmap") == 4 * (2 * -(-n // 32)
                                                                 + 3 * -(-r // got_k))


def test_rows_card_branch_counts_in_the_kernels(monkeypatch):
    """G1-G3's wrapper hands each kernel its key's counter and asks the
    library G2's shared memory, held to what the device allows; no torch
    add counts beside the launches."""
    gens, f_a, ids, f_max = g2_case("cut_b")
    _, port = chains_of(gens)
    wrapper = rwc.RowKernels()
    dev = torch.device("cpu")
    calls = []

    def counts(block, stream):
        a = block._obj
        assert a.counts_counter == wrapper.launches.counter(dev, "counts").data_ptr()
        calls.append("counts")
        bump(a.counts_counter)
        return 0

    def write(block, stream):
        a = block._obj
        assert a.write_counter == wrapper.launches.counter(dev, "write").data_ptr()
        calls.append("write")
        bump(a.write_counter)
        want = (td.extract_rows_union_plain if a.union_mode else td.extract_rows_each_plain)(
            port, f_a, ids, f_max)
        for ptr, x in zip((a.rows, a.valid, a.overflow), want):
            copy_into(ptr, x)
        copy_into(a.max_id, port.id_c.amax(-1))
        return 0

    def gather(block, stream):
        g = block._obj
        assert g.counter == wrapper.launches.counter(dev, "gather").data_ptr()
        calls.append("gather")
        bump(g.counter)
        return 0

    def write_smem(block):
        a = block._obj
        return rwc.write_smem(a.m, bool(a.union_mode), a.n_chunks)

    no_torch_add(monkeypatch)
    monkeypatch.setattr(build, "_OPTED_IN", {})
    monkeypatch.setattr(rwc, "load_library", lambda: types.SimpleNamespace(
        rows_counts=counts, rows_write=write, rows_gather=gather, rows_write_smem=write_smem,
        rows_init=lambda: 48 * 1024))
    monkeypatch.setattr(rwc.RowKernels, "_card", staticmethod(lambda dev: None))
    for union in (False, True):
        got = wrapper.extract(port.id_c, f_a, ids, f_max, union)
        want = (td.extract_rows_union_plain if union else td.extract_rows_each_plain)(
            port, f_a, ids, f_max)
        assert all(torch.equal(x, y) for x, y in zip(got[:3], want))
        assert torch.equal(got[3], port.id_c.amax(-1))
    wrapper.gather(GenomeState(*port), got[0], got[1])
    assert calls == ["counts", "write"] * 2 + ["gather"]
    assert wrapper.launches.by_key() == {"counts": 2, "write": 2, "gather": 1}


def _read(ptr, ctype, count):
    return np.ctypeslib.as_array((ctype * count).from_address(ptr)).astype(np.int64)


def _write(ptr, x, ctype):
    buf = np.ascontiguousarray(x).astype(np.dtype(ctype))
    ctypes.memmove(ptr, buf.ctypes.data, buf.nbytes)


def g1_g2_library(calls):
    """A stand-in rows library: ``rows_counts`` runs :func:`g1_transcription`
    on its argument block's inputs (read at their addresses and strides)
    into the block's scratch, ``rows_write`` :func:`g2_transcription` over
    that scratch into the outputs and each chain's max_id from the chunk
    maxima, each adding one to the counter handed to it."""
    def inputs(a):
        flat = _read(a.id_c, ctypes.c_int32, (a.C - 1) * a.id_cs + (a.n - 1) * a.id_is + 1)
        id_c = flat[np.arange(a.C)[:, None] * a.id_cs + np.arange(a.n)[None, :] * a.id_is]
        f_a = _read(a.f_a, ctypes.c_int64, (a.C - 1) * a.fa_s + 1)[np.arange(a.C) * a.fa_s]
        return id_c, f_a, _read(a.ids, ctypes.c_int64, a.C * a.m).reshape(a.C, a.m)

    def counts(block, stream):
        a = block._obj
        calls.append("counts")
        bump(a.counts_counter)
        skeys, cnt, cmax, _, _ = g1_transcription(*inputs(a), a.chunk)
        assert cnt.shape[-1] == a.n_chunks
        for ptr, x in ((a.skeys, skeys), (a.counts, cnt), (a.cmax, cmax)):
            _write(ptr, x, np.int32)
        return 0

    def write(block, stream):
        a = block._obj
        calls.append("write")
        bump(a.write_counter)
        id_c, f_a, ids = inputs(a)
        n_keys = a.m + 1
        skeys = _read(a.skeys, ctypes.c_int32, a.C * n_keys).reshape(a.C, n_keys)
        cnt = _read(a.counts, ctypes.c_int32, a.C * n_keys * a.n_chunks).reshape(
            a.C, n_keys, a.n_chunks)
        cmax = _read(a.cmax, ctypes.c_int32, a.C * a.n_chunks).reshape(a.C, a.n_chunks)
        rows, valid, over = g2_transcription(id_c, f_a, ids, a.f_max, bool(a.union_mode),
                                             a.chunk, 32, 8, scratch=(skeys, cnt))
        _write(a.rows, rows, np.int64)
        _write(a.valid, valid, np.uint8)
        _write(a.overflow, over, np.uint8)
        _write(a.max_id, cmax.max(1), np.int32)
        return 0

    def write_smem(block):
        a = block._obj
        return rwc.write_smem(a.m, bool(a.union_mode), a.n_chunks)

    return types.SimpleNamespace(rows_counts=counts, rows_write=write, rows_write_smem=write_smem,
                                 rows_init=lambda: 48 * 1024)


@pytest.mark.parametrize("chunk", ["wrapper's", "7 rows"])
def test_g1_g2_card_branch_equals_plain_and_jax(chunk, monkeypatch):
    """``core.delta``'s card branch of the extraction, through the wrapper
    and a stand-in library running the G1 and G2 transcriptions (G2 reading
    G1's scratch): rows, valid, overflow and max_id equal
    ``extract_rows_union_plain`` / ``extract_rows_each_plain`` (with
    ``id_c.amax``) and JAX's ``extract_rows`` / ``extract_rows_union`` at
    the G2 edge cases, and the plain versions at f_max = n, with one G1 and
    one G2 launch an extraction counted in the kernels."""
    calls = []
    wrapper = rwc.RowKernels()
    no_torch_add(monkeypatch)
    monkeypatch.setattr(build, "_OPTED_IN", {})
    monkeypatch.setattr(rwc, "load_library", lambda: g1_g2_library(calls))
    monkeypatch.setattr(rwc.RowKernels, "_card", staticmethod(lambda dev: None))
    monkeypatch.setattr(td, "ROWS", wrapper)
    if chunk == "7 rows":
        monkeypatch.setattr(rwc, "chunk_size", lambda n: 7)
    n_calls = 0
    for name in ("cut_a", "cut_b", "same_contig", "big_union", "f_max_n"):
        gens, f_a, ids, f_max = g2_case("cut_c" if name == "f_max_n" else name)
        jstates, port = chains_of(gens)
        if name == "f_max_n":
            f_max = port.n_frags
        for union in (False, True):
            got = td._rows_on_card(port, f_a, ids, f_max, union)
            n_calls += 1
            plain = (td.extract_rows_union_plain if union else td.extract_rows_each_plain)(
                port, f_a, ids, f_max)
            for g, w, what in zip(got, (*plain, port.id_c.amax(-1)),
                                  ("rows", "valid", "overflow", "max_id")):
                assert g.dtype == w.dtype and torch.equal(g, w), (name, union, what)
            if name == "f_max_n":
                continue
            for k, js in enumerate(jstates):
                fn = j_union(f_max) if union else j_each(f_max)
                want = fn(js, int(f_a[k]), jnp.asarray(ids[k].numpy(), jnp.int32))
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g[k].numpy(), np.asarray(w),
                                                  err_msg=f"{name} {k} jax")
    assert calls == ["counts", "write"] * n_calls
    assert wrapper.launches.by_key() == {"counts": n_calls, "write": n_calls}
