"""Mini-grid candidate scorer of the delta engine: a hand-written CUDA
kernel for Hopper.

The port of the Pallas kernel ``make_mini_grid_scorer`` / ``_mini_kernel``
(graal_tpu/ops/likelihood_pallas.py): M neighbour slots, each with C
genomes (the base mini-state and its 13 candidates) on its own R x R
sub-row grid,

    score[m, c] = sum_{u<v} ob[m,u,v] * log_e - exp(log_e)
    log_e = (same contig ? log_cis : log v_inter) + la_u + la_v - log nfpb

and the deltas dll[m, c-1] = score[m, c] - score[m, 0] taken in f64. The
kernel source is ``graal_tpu_torch/csrc/ll_mini.cu``; its header says what
bounds it on the card and how the design answers that.

The kernel's persistent grid is sized once per process
(:mod:`graal_tpu_torch.ops.persistent`); each launch plans its candidate
chunk from the shapes alone, so a launch never waits for the device.

The kernel scores each (half tile, candidate) by one of three classes
(empty, band-free, band); :func:`tile_classes_plain` decides them by the
kernel's rule in plain torch, for the tests and the bounds of the chip
smoke. Inputs must keep the kernel's contract: ob is zero on every row
and column where candidate 0 has la = -1e9 (``DEAD_LA``).

Dispatch is by device: on CUDA tensors :class:`MiniGridScorer` launches the
kernel (or raises); on CPU tensors it runs :func:`mini_grid_plain`, the
same per-cell math in plain torch (the circular-aware formula on every
row, which equals the linear one on a linear row).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from graal_tpu_torch.ops import build, persistent
from graal_tpu_torch.ops.counts import Counted, LaunchCount
from graal_tpu_torch.ops.likelihood_cuda import N_PARAMS

# Working-set bound of the plain versions: the mini-grid scorer takes its
# genomes, and the banded mass of core/delta.py its genomes and band
# offsets, in chunks of about this many cells.
MAX_CELLS = 1 << 24
DEAD_LA = -1e9       # la of a dead row (padding, or inactive)
ROWS = persistent.TILE // persistent.HALVES   # rows of a half tile
EMPTY, FREE, BAND = 0, 1, 2                   # the kernel's classes of (half tile, candidate)


@functools.cache
def load_library():
    """The kernel library (built at first use), its C functions typed."""
    lib = build.load("ll_mini")
    ptr = ctypes.c_void_p
    for fn, args in ((lib.ll_mini_n_tiles, [ctypes.c_int]),
                     (lib.ll_mini_n_extents, [ctypes.c_int]), (lib.ll_mini_slots, []),
                     (lib.ll_mini_max_candidates, []), (lib.ll_mini_max_chunk, []),
                     (lib.ll_mini_configure, [ctypes.POINTER(ctypes.c_int)])):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.ll_mini_score.argtypes = [ptr] * 13 + [ctypes.c_int] * 5 + [ptr]
    lib.ll_mini_score.restype = ctypes.c_int
    if lib.ll_mini_slots() != persistent.SLOTS:
        raise RuntimeError("ll_mini.cu and ops/persistent.py disagree on SLOTS")
    return lib


@functools.cache
def resident_blocks(device) -> int:
    """Persistent blocks of the kernel on ``device``, asked once per process."""
    return persistent.resident_blocks(load_library().ll_mini_configure, device)


def log_cis_plain(s, circ_row, stot, pvec):
    """The kernel's per-cell log expectation of a same-contig pair (before
    the accumulation term): circular formula on circular rows, clamped
    below by log v_inter, log v_inter outside (0, d_max). ``pvec`` is one
    (10,) vector, or (..., 10) whose leading shape broadcasts against the
    cells'."""
    (log_c1fact, slope, d, d_max, lmk, log_v, _v_inter, log_norm_circ,
     log_k3fact, _log_nfpb) = pvec.unbind(-1)
    safe_s = torch.clamp_min(s, 1e-9)
    n_lin = safe_s * lmk
    log_lin = log_c1fact + slope * torch.log(safe_s) + (d - 2.0) / (n_lin * n_lin + d)
    in_range = (s > 0.0) & (s < d_max)
    n_circ = lmk * safe_s * torch.clamp_min(stot - s, 1e-9) / torch.clamp_min(stot, 1e-9)
    log_val_circ = log_k3fact + slope * torch.log(n_circ) + (d - 2.0) / (n_circ * n_circ + d)
    log_norm_lin = torch.where(in_range, torch.maximum(log_lin, log_v), log_v)
    log_cis = torch.where(circ_row, log_val_circ + log_norm_lin - log_norm_circ, log_lin)
    log_cis = torch.where(in_range, log_cis, -math.inf)
    return torch.maximum(log_cis, log_v)


def pvec_rows(pvec, nbr, cell_dims=1):
    """Rows ``nbr`` of an (M, 10) parameter matrix, shaped (G, 1, ..., 10)
    to broadcast over their genomes' cells (``cell_dims`` axes a genome)."""
    return pvec[nbr].reshape((nbr.shape[0],) + (1,) * cell_dims + (pvec.shape[-1],))


def mini_grid_plain(mid, idc, circ, stot, la, ob, pvec):
    """Plain torch version of the kernel on (M, C, R) vectors and (M, R, R)
    grids: the same per-cell math over the pairs u < v, each genome's sum
    taken in f64, genomes in chunks of about ``MAX_CELLS`` pairs. ``pvec``
    is one (10,) vector, read as its broadcast (M, 10), or one row per
    neighbour slot. Returns (scores (M, C) f32, dll (M, C - 1) f32)."""
    m, c, r = mid.shape
    pvec = pvec.expand(m, N_PARAMS)
    iu, ju = torch.triu_indices(r, r, 1, device=mid.device)
    ob_pairs = ob[:, iu, ju]                                     # (M, P)
    flat = [x.reshape(m * c, r) for x in (mid, idc, circ, stot, la)]
    nbr = torch.arange(m, device=mid.device).repeat_interleave(c)
    chunk = max(1, MAX_CELLS // max(iu.shape[0], 1))
    sums = []
    for g0 in range(0, m * c, chunk):
        g_mid, g_idc, g_circ, g_stot, g_la = [x[g0:g0 + chunk] for x in flat]
        pv = pvec_rows(pvec, nbr[g0:g0 + chunk])
        log_v, log_nfpb = pv[..., 5], pv[..., 9]
        s = torch.abs(g_mid[:, iu] - g_mid[:, ju])
        log_cis = log_cis_plain(s, g_circ[:, iu] == 1, g_stot[:, iu], pv)
        log_e = torch.where(g_idc[:, iu] == g_idc[:, ju], log_cis, log_v) \
            + ((g_la[:, iu] + g_la[:, ju]) - log_nfpb)
        contrib = ob_pairs[nbr[g0:g0 + chunk]] * log_e - torch.exp(log_e)
        sums.append(contrib.sum(dim=1, dtype=torch.float64))
    tot = torch.cat(sums).reshape(m, c)
    return tot.float(), (tot[:, 1:] - tot[:, :1]).float()


def tri_tiles(n_rb: int, device=None):
    """(bi, bj) of the upper-triangle tiles of an n_rb x n_rb tile grid in
    the kernel's partial order (``tri_slot``: by column block, so the tiles
    inside the first L row blocks come first)."""
    bj = torch.repeat_interleave(torch.arange(n_rb, device=device),
                                 torch.arange(1, n_rb + 1, device=device))
    return torch.arange(bj.shape[0], device=device) - bj * (bj + 1) // 2, bj


def _id_pair(live, ids):
    """The kernel's ``id_pair`` over the last axis: the first live id, the
    first other one (the first where there is none), whether each exists,
    and whether a third is live."""
    has_a = live.any(-1)
    a = ids.gather(-1, live.int().argmax(-1, keepdim=True))[..., 0]
    other = live & (ids != a[..., None])
    has_b = other.any(-1)
    b = torch.where(has_b, ids.gather(-1, other.int().argmax(-1, keepdim=True))[..., 0], a)
    over = (other & (ids != b[..., None])).any(-1)
    return (a, has_a), (b, has_b), over


def _id_span(live, ids, mid, x):
    """[min, max] of the live midpoints of contig id ``x`` (per leading index)."""
    sel = live & (ids == x[..., None])
    return (torch.where(sel, mid, math.inf).amin(-1), torch.where(sel, mid, -math.inf).amax(-1))


def tile_classes_plain(mid, idc, la, ob, pvec):
    """The kernel's class of every (half tile, candidate), by its rule, in
    plain torch: (M, C, n_tri, 2) int8 of EMPTY, FREE (band-free) or BAND,
    tiles in the kernel's partial order (:func:`tri_tiles`), on (M, C, R)
    vectors, (M, R, R) grids and a (10,) or (M, 10) ``pvec``.

    A (half tile, candidate) is empty when all its rows, or all its
    columns, are past R or dead (la <= DEAD_LA) in the candidate and in
    candidate 0; else band on a diagonal tile; else band-free when no row
    or column dead in the candidate has a count in the tile, at most two
    contig ids are live among its rows and two among its columns, and
    every id live on both sides has its rows' and its columns' midpoints
    d_max or more apart (f32, as the kernel tests it); else band."""
    m_, c_, r = mid.shape
    dev = mid.device
    t = persistent.TILE
    n_rb = -(-r // t)
    rp, h_ = n_rb * t, 2 * n_rb
    pvec = pvec.expand(m_, N_PARAMS)
    bi, bj = tri_tiles(n_rb, dev)
    out = torch.empty((m_, c_, bi.shape[0], 2), dtype=torch.int8, device=dev)
    pad = rp - r
    j_blk = torch.arange(n_rb, device=dev)
    h_blk = torch.arange(h_, device=dev) // 2
    for m in range(m_):
        # rows past R behave as dead rows without counts
        la_m = torch.nn.functional.pad(la[m], (0, pad), value=DEAD_LA)
        mid_m = torch.nn.functional.pad(mid[m], (0, pad))
        idc_m = torch.nn.functional.pad(idc[m], (0, pad))
        nz = torch.nn.functional.pad(ob[m], (0, pad, 0, pad)) != 0
        live = la_m > DEAD_LA
        dead = ~live
        gone = dead & dead[:1]
        empty = gone.reshape(c_, h_, ROWS).all(-1)[:, :, None] \
            | gone.reshape(c_, n_rb, t).all(-1)[:, None, :]
        row_nz = nz.reshape(rp, n_rb, t).any(-1).float()                 # (Rp, n_rb)
        col_nz = nz.reshape(h_, ROWS, rp).any(1).float()                 # (H, Rp)
        del nz
        dead_f = dead.float()
        bad = torch.einsum("chu,huj->chj", dead_f.reshape(c_, h_, ROWS),
                           row_nz.reshape(h_, ROWS, n_rb)) > 0
        bad |= torch.einsum("cjv,hjv->chj", dead_f.reshape(c_, n_rb, t),
                            col_nz.reshape(h_, n_rb, t)) > 0
        rows = [x.reshape(c_, h_, ROWS) for x in (live, idc_m, mid_m)]
        cols = [x.reshape(c_, n_rb, t) for x in (live, idc_m, mid_m)]
        r_ids, c_ids = _id_pair(*rows[:2]), _id_pair(*cols[:2])
        ok = ~bad & ~r_ids[2][:, :, None] & ~c_ids[2][:, None, :]
        d_max = pvec[m, 3]
        for xr, has_r in r_ids[:2]:
            r_lo, r_hi = _id_span(*rows, xr)
            for yc, has_c in c_ids[:2]:
                c_lo, c_hi = _id_span(*cols, yc)
                shared = has_r[:, :, None] & has_c[:, None, :] \
                    & (xr[:, :, None] == yc[:, None, :])
                apart = (c_lo[:, None, :] - r_hi[:, :, None] >= d_max) \
                    | (r_lo[:, :, None] - c_hi[:, None, :] >= d_max)
                ok &= ~shared | apart
        ok &= j_blk[None, None, :] > h_blk[None, :, None]
        cls = torch.where(empty, EMPTY, torch.where(ok, FREE, BAND)).to(torch.int8)
        out[m] = torch.stack([cls[:, 2 * bi + half, bj] for half in range(2)], -1)
    return out


class MiniGridScorer(Counted):
    """``score(mid, idc, circ, stot, la, ob, pvec) -> (scores (M, C),
    dll (M, C - 1))``: ``mid``, ``circ``, ``stot``, ``la`` (M, C, R) f32,
    ``idc`` (M, C, R) int32, ``ob`` (M, R, R) f32, ``pvec`` the (10,) f32
    parameter vector of :func:`graal_tpu_torch.ops.likelihood_cuda.params_vector`
    shared by every slot (launched as its broadcast), or (M, 10), one row
    per neighbour slot (chains with their own parameters in one launch).

    ``n_launches`` counts the kernel's launches, on the card (``ops.counts``).
    """

    def __init__(self):
        self.launches = LaunchCount()
        self.tickets = persistent.Tickets()

    def launch(self, mid, idc, circ, stot, la, ob, pvec, class_counts=None):
        """Launch the kernel; (scores, dll) on the inputs' card.
        ``class_counts``, a (3,) int32 tensor on the card, gets the
        kernel's (half tile, candidate) pairs of each class added to it
        (EMPTY, FREE, BAND; the tiles past a neighbour's live extent are
        drawn by no item, so not counted)."""
        dev = mid.device
        if dev.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, not {dev}")
        if mid.dim() != 3:
            raise ValueError(f"mid: need (M, C, R), got {tuple(mid.shape)}")
        m, c, r = mid.shape
        pvec = pvec.expand(m, N_PARAMS).contiguous()
        for name, x, dt, shape in (("mid", mid, torch.float32, (m, c, r)),
                                   ("idc", idc, torch.int32, (m, c, r)),
                                   ("circ", circ, torch.float32, (m, c, r)),
                                   ("stot", stot, torch.float32, (m, c, r)),
                                   ("la", la, torch.float32, (m, c, r)),
                                   ("ob", ob, torch.float32, (m, r, r)),
                                   ("pvec", pvec, torch.float32, (m, N_PARAMS))):
            if x.device != dev or x.dtype != dt or not x.is_contiguous():
                raise ValueError(f"{name}: need contiguous {dt} on {dev}, "
                                 f"got {x.dtype} on {x.device}")
            if tuple(x.shape) != shape:
                raise ValueError(f"{name}: need shape {shape}, got {tuple(x.shape)}")
        if class_counts is not None and (class_counts.device != dev
                                         or class_counts.dtype != torch.int32
                                         or tuple(class_counts.shape) != (3,)):
            raise ValueError(f"class_counts: need (3,) int32 on {dev}")
        lib = load_library()
        if c > lib.ll_mini_max_candidates():
            raise ValueError(f"{c} candidates per neighbour > "
                             f"{lib.ll_mini_max_candidates()}")
        n_tri = lib.ll_mini_n_tiles(r)
        cs, grid, _ = persistent.plan(n_tri, c, m, resident_blocks(dev),
                                      lib.ll_mini_max_chunk())
        stream = torch.cuda.current_stream(dev).cuda_stream
        partial = torch.empty((m, c, n_tri * persistent.SLOTS), dtype=torch.float32,
                              device=dev)
        ext = torch.empty((m, lib.ll_mini_n_extents(r)), dtype=torch.int32, device=dev)
        scores = torch.empty((m, c), dtype=torch.float32, device=dev)
        dll = torch.empty((m, c - 1), dtype=torch.float32, device=dev)
        rc = lib.ll_mini_score(
            mid.data_ptr(), idc.data_ptr(), circ.data_ptr(), stot.data_ptr(),
            la.data_ptr(), ob.data_ptr(), pvec.data_ptr(), partial.data_ptr(), ext.data_ptr(),
            scores.data_ptr(), dll.data_ptr(), self.tickets.get(dev, stream).data_ptr(),
            None if class_counts is None else class_counts.data_ptr(), m, c, r, cs, grid,
            stream)
        if rc != 0:
            raise RuntimeError(f"ll_mini_score launch failed: cudaError {rc}")
        self.launches.add(dev)
        return scores, dll

    def plain(self, mid, idc, circ, stot, la, ob, pvec):
        return mini_grid_plain(mid, idc, circ, stot, la, ob, pvec)

    def __call__(self, mid, idc, circ, stot, la, ob, pvec):
        if mid.device.type == "cuda":
            return self.launch(mid, idc, circ, stot, la, ob, pvec)
        return self.plain(mid, idc, circ, stot, la, ob, pvec)
