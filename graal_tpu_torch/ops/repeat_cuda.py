"""Copy-summing dense scorer of repeat tables: a hand-written CUDA kernel
for Hopper.

The port of the Pallas kernel ``make_repeat_pallas_scorer`` /
``_repeat_kernel`` (graal_tpu/ops/likelihood_pallas.py): score a batch of
candidate genomes of a copy-expanded (repeat) table on the data grid. The
expected count of a data pair sums, in linear space, over every active
copy pair of its two data subs; the whole Poisson pmf is then taken with a
precomputed log(ob!) plane, so a pair whose copies are all inactive
contributes exactly 0. The kernel source is
``graal_tpu_torch/csrc/ll_repeat.cu``; its header says what bounds it on
the card and how the design answers that.

Build: at first use, ``nvcc`` compiles the source for ``sm_90a`` and it is
loaded with ``ctypes`` (:mod:`graal_tpu_torch.ops.build`). A missing
``nvcc`` or a failed build raises. The kernel's persistent grid is sized
at a scorer's first launch (:mod:`graal_tpu_torch.ops.persistent`); each
launch plans its candidate chunk from the shapes alone, at most as many
candidates as the card's shared memory holds for the table's densest
block of copy rows.

Dispatch: ``make_dense_scorer`` returns a :class:`RepeatScorer` for a
repeat table. On CUDA tensors it launches the kernel (or raises); on CPU
tensors it runs :func:`score_repeat_plain`, the same math in plain torch.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from graal_tpu_torch.core.state import GenomeState
from graal_tpu_torch.core.subfrags import SubFragTable, copy_csr
from graal_tpu_torch.ops import build, persistent
from graal_tpu_torch.ops.likelihood_cuda import CopyRowScorer, host_obs

TILE = 64          # the kernel's tile edge (data subs)
MAX_CELLS = 1 << 24   # working-set bound of the plain version (cells per chunk)


def log_factorial_np(ob) -> np.ndarray:
    """log(ob!) per cell with the reference's branches (exact below 10,
    Stirling 10..14, Stirling expansion from 15), 0 where ob = 0: the f32
    operation order of the JAX package's ``_log_factorial_np``."""
    ob = np.asarray(ob, np.float32)
    n = np.floor(ob)
    exact = np.zeros_like(ob)
    for k in range(2, 10):
        exact = exact + np.where(n >= k, np.float32(np.log(k)), np.float32(0.0))
    stirling = n * np.log(np.maximum(n, 1.0)) - n \
        + 0.5 * np.log(2.0 * np.pi * np.maximum(n, 1.0))
    big = ob * np.log(np.maximum(ob, 1.0)) - ob \
        + np.log(np.sqrt(np.maximum(ob, 1.0) * 2.0 * np.pi))
    out = np.where(ob >= 15.0, big, np.where(n >= 10, stirling, exact))
    return np.where(ob > 0.0, out, 0.0).astype(np.float32)


@functools.cache
def load_library():
    """The kernel library (built at first use), its C functions typed."""
    lib = build.load("ll_repeat")
    ptr = ctypes.c_void_p
    for fn, args in ((lib.ll_repeat_n_tiles, [ctypes.c_int]), (lib.ll_repeat_slots, []),
                     (lib.ll_repeat_max_chunk, []),
                     (lib.ll_repeat_smem_bytes, [ctypes.c_int] * 3),
                     (lib.ll_repeat_smem_limit, [ctypes.c_int]),
                     (lib.ll_repeat_configure, [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.ll_repeat_score.argtypes = [ptr] * 9 + [ctypes.c_float, ptr, ptr, ptr] \
        + [ctypes.c_int] * 7 + [ptr]
    lib.ll_repeat_score.restype = ctypes.c_int
    if lib.ll_repeat_slots() != persistent.SLOTS:
        raise RuntimeError("ll_repeat.cu and ops/persistent.py disagree on SLOTS")
    return lib


def block_max(start: np.ndarray, s_dim: int, width: int) -> int:
    """The largest copy count of the aligned blocks of ``width`` data subs
    (``start`` the (S + 1,) copy ranges)."""
    edges = start[np.minimum(np.arange(0, s_dim + width, width), s_dim)]
    return int(np.diff(edges).max())


def score_repeat_plain(mid, idc, circ, stot, a, slots, slot_ok, obs, lf, pvec,
                       nfpb: float, max_cells: int = MAX_CELLS):
    """Plain torch version of the kernel. The (B, K) copy vectors are read
    through the (S, mc) copy-slot table ``slots`` (``slot_ok`` marks real
    copies); E is summed over the mc x mc slot pairs of each data cell in
    slot order, the pmf taken over s < t, each candidate's sum in f64.
    Candidates are processed in chunks of about ``max_cells`` data cells.
    Returns (B,) f32."""
    B = mid.shape[0]
    S, mc = slots.shape
    (log_c1fact, slope, d, d_max, lmk, log_v, v_inter, log_norm_circ,
     log_k3fact, _) = pvec.unbind()
    mask = torch.ones((S, S), dtype=torch.bool, device=mid.device).triu(1)
    chunk = max(1, max_cells // (S * S))
    # per slot: (B, S) vectors of the slot's copy row, a = 0 on empty slots
    per_slot = []
    for q in range(mc):
        rows = slots[:, q]
        per_slot.append((mid[:, rows], idc[:, rows], circ[:, rows], stot[:, rows],
                         torch.where(slot_ok[:, q], a[:, rows], 0.0)))
    out = []
    for b0 in range(0, B, chunk):
        sl = slice(b0, b0 + chunk)
        e_tot = torch.zeros((mid[sl].shape[0], S, S), dtype=torch.float32,
                            device=mid.device)
        for mu, iu, cu, su, au in per_slot:
            st = su[sl, :, None]
            for mv, iv, _, _, av in per_slot:
                s = torch.abs(mu[sl, :, None] - mv[sl, None, :])
                safe_s = torch.clamp_min(s, 1e-9)
                n_lin = safe_s * lmk
                log_lin = log_c1fact + slope * torch.log(safe_s) \
                    + (d - 2.0) / (n_lin * n_lin + d)
                in_range = (s > 0.0) & (s < d_max)
                n_circ = lmk * safe_s * torch.clamp_min(st - s, 1e-9) \
                    / torch.clamp_min(st, 1e-9)
                log_val_circ = log_k3fact + slope * torch.log(n_circ) \
                    + (d - 2.0) / (n_circ * n_circ + d)
                log_norm_lin = torch.where(in_range, torch.maximum(log_lin, log_v), log_v)
                log_cis = torch.where(cu[sl, :, None] == 1.0,
                                      log_val_circ + log_norm_lin - log_norm_circ, log_lin)
                cis = torch.maximum(torch.where(in_range, torch.exp(log_cis), 0.0), v_inter)
                e0 = torch.where(iu[sl, :, None] == iv[sl, None, :], cis, v_inter)
                e_tot = e_tot + e0 * ((au[sl, :, None] * av[sl, None, :]) / nfpb)
        log_e = torch.log(torch.where(e_tot > 0.0, e_tot, 1.0))
        pmf = torch.where(obs > 0.0, obs * log_e - e_tot - lf, -e_tot)
        pmf = torch.where((e_tot > 0.0) & mask, pmf, 0.0)
        out.append(pmf.sum(dim=(1, 2), dtype=torch.float64))
    return torch.cat(out).float()


class RepeatScorer(CopyRowScorer):
    """``score(states (B, n), params) -> (B,) f32`` log-likelihoods of a
    repeat (copy-expanded) table on the data grid, the counterpart of
    ``make_repeat_pallas_scorer``; equal to ``core.likelihood.log_likelihood``
    up to summation order. Its vectors are the copy rows in copy order
    (the copies of data sub s at ``[copy_start[s], copy_start[s + 1])``),
    plus ``a``, accu on active copies and 0 otherwise.
    """

    VECTORS = CopyRowScorer.VECTORS + ("a",)

    def __init__(self, table: SubFragTable, obs, device):
        obs = host_obs(obs)
        s_dim, k = table.n_data_sub, table.n_subs
        if obs.shape != (s_dim, s_dim):
            raise ValueError(f"obs is {obs.shape}, the data grid is {(s_dim, s_dim)}")
        data_id = table.data_id.cpu().numpy()
        start, order, mc = copy_csr(data_id, s_dim)
        if np.diff(start).min() < 1:
            raise ValueError("every data sub needs at least one copy row")
        super().__init__(table, obs, device, rows=order)
        device = self.device
        self.s = s_dim
        self.lf = torch.as_tensor(log_factorial_np(obs), device=device).contiguous()
        self.copy_start = torch.as_tensor(start.astype(np.int32), device=device)
        # the copies of each block of data subs are one contiguous run; the
        # kernel's shared memory is sized for the largest item rows (32 subs)
        # and columns (64 subs)
        self.max_blk = block_max(start, s_dim, TILE)
        self.max_hblk = block_max(start, s_dim, TILE // persistent.HALVES)
        # asked of the card at the first launch: the most candidates an item
        # may stage in shared memory, and the persistent blocks at that size
        self.chunk_max = self.resident = None
        self.tickets = persistent.Tickets()
        pos_in = np.arange(k) - start[data_id[order]]
        slots = np.zeros((s_dim, mc), np.int64)
        slot_ok = np.zeros((s_dim, mc), bool)
        slots[data_id[order], pos_in] = np.arange(k)   # copy-order positions
        slot_ok[data_id[order], pos_in] = True
        self.slots = torch.as_tensor(slots, device=device)
        self.slot_ok = torch.as_tensor(slot_ok, device=device)
        self.accu = table.accu.to(device)[torch.as_tensor(order, device=device)]
        self.accu_rows = self.accu
        self.nfpb = float(np.float32(table.n_frags_per_bins))

    def vectors_plain(self, states: GenomeState):
        """Per-candidate copy-row vectors in copy order (mid, idc, circ,
        stot, a), shape (B, K): the plain version of H1's."""
        a = torch.where(states.activ[:, self.owner] == 1, self.accu, 0.0)
        return self.geometry(states) + (a,)

    def launch(self, mid, idc, circ, stot, a, pvec) -> torch.Tensor:
        """Launch the kernel on the copy vectors of B candidates; (B,) f32."""
        B = self.check_launch((mid, idc, circ, stot, a), pvec)
        lib = load_library()
        if self.resident is None:
            def smem(cs):
                return lib.ll_repeat_smem_bytes(cs, self.max_hblk, self.max_blk)
            self.chunk_max = persistent.fit_chunk(
                smem, lib.ll_repeat_smem_limit(self.device.index), lib.ll_repeat_max_chunk())
            self.resident = persistent.resident_blocks(
                lambda per_sm: lib.ll_repeat_configure(smem(self.chunk_max), per_sm),
                self.device)
        n_tri = lib.ll_repeat_n_tiles(self.s)
        cs, grid, _ = persistent.plan(n_tri, B, 1, self.resident, self.chunk_max)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        partial = torch.empty((B, n_tri * persistent.SLOTS), dtype=torch.float32,
                              device=self.device)
        out = torch.empty(B, dtype=torch.float32, device=self.device)
        rc = lib.ll_repeat_score(
            mid.data_ptr(), idc.data_ptr(), circ.data_ptr(), stot.data_ptr(),
            a.data_ptr(), self.copy_start.data_ptr(), self.obs.data_ptr(),
            self.lf.data_ptr(), pvec.data_ptr(), self.nfpb, partial.data_ptr(),
            out.data_ptr(), self.tickets.get(self.device, stream).data_ptr(), B, self.s,
            self.k, self.max_hblk, self.max_blk, cs, grid, stream)
        if rc != 0:
            raise RuntimeError(f"ll_repeat_score launch failed: cudaError {rc}")
        self.launches.add(self.device, (B, self.k))
        return out

    def plain(self, mid, idc, circ, stot, a, pvec, max_cells: int = MAX_CELLS) -> torch.Tensor:
        """The plain torch version on the same vectors; (B,) f32."""
        return score_repeat_plain(mid, idc, circ, stot, a, self.slots, self.slot_ok,
                                  self.obs, self.lf, pvec, self.nfpb, max_cells)
