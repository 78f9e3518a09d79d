"""Window observed-count grid: a hand-written CUDA kernel for Hopper.

The port of the Pallas kernel ``make_window_obs_grid`` / ``_obsgrid_kernel``
(graal_tpu/ops/obsgrid_pallas.py): the CSR window of each of the R mini
sub rows of M neighbour slots made dense over the same R rows,

    ob[m, r, j] = sum_{e in window(keys[m, r])} vals[e] * (cols[e] == keys[m, j]),

where the window of key k is the CSR row ``[row_start[k], row_start[k+1])``
of the observed map and a key of -1 has no window and matches no column;
returned as its strict upper triangle (j > r), the part the mini-grid
scorer reads, with a zero lower part. The JAX kernel takes the windows
gathered beforehand; this one reads the CSR map in place. The kernel
source is ``graal_tpu_torch/csrc/obsgrid.cu``; its header says what bounds
it on the card and how the design answers that.

Dispatch is by device: on CUDA tensors :class:`WindowObsGrid` launches the
kernel (or raises); on CPU tensors it runs :func:`obs_grid_plain`, a
scatter-add whose tests hold it to the one-hot contraction of the JAX
package's ``window_obs_grid_reference`` on the windows the JAX delta engine
gathers.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from graal_tpu_torch.ops import build
from graal_tpu_torch.ops.counts import Counted, LaunchCount

HASH_MUL = 0x9E3779B1    # the kernel's multiplicative hash
MIN_LOG2CAP = 5


@functools.cache
def load_library():
    """The kernel library (built at first use), its C functions typed."""
    lib = build.load("obsgrid")
    ptr = ctypes.c_void_p
    for fn, args in ((lib.obsgrid_smem_bytes, [ctypes.c_int] * 3), (lib.obsgrid_warps, []),
                     (lib.obsgrid_configure, [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]),
                     (lib.obsgrid_occupancy, [ctypes.c_int, ctypes.c_int,
                                              ctypes.POINTER(ctypes.c_int)])):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.obsgrid.argtypes = [ptr] * 5 + [ctypes.c_int] * 5 + [ptr]
    lib.obsgrid.restype = ctypes.c_int
    return lib


@functools.cache
def smem_limit(device) -> int:
    """Once per process and card: let the kernel use all the dynamic
    shared memory a block may have; returns that limit (bytes)."""
    limit = ctypes.c_int(0)
    rc = load_library().obsgrid_configure(torch.device(device).index, ctypes.byref(limit))
    if rc != 0:
        raise RuntimeError(f"obsgrid_configure failed: cudaError {rc}")
    return limit.value


def log2_capacity(r: int) -> int:
    """Entries (log2) of a neighbour's key table: at least 2R."""
    return max(MIN_LOG2CAP, (2 * r - 1).bit_length())


def bucket(key, log2cap: int):
    """The table entry where the kernel starts looking for ``key`` (>= 0,
    below 2^31): a Python int, or a numpy int64 array of keys."""
    return ((key * HASH_MUL) & 0xFFFFFFFF) >> (32 - log2cap)


def plan(r: int, m: int, smem_max: int, smem_bytes, warps: int, resident):
    """(rows_per_block, width, log2cap): the launch of M neighbours' R
    rows. A block holds its neighbour's keys and table and, for each of its
    ``warps`` warps, a row buffer of ``width`` columns: the widest multiple
    of 4 that fits in ``smem_max`` bytes (``smem_bytes(r, width, log2cap)``
    the need), cut down to equal ranges of the row. ``resident(smem,
    n_ranges)`` is the number of such blocks the card holds at once (the
    kernel of one range a row and that of several differ in registers).
    Each warp takes at least two rows, and the blocks fill the card once.
    Raises ValueError when not even a buffer of 4 columns a warp fits."""
    log2cap = log2_capacity(r)
    fits = (smem_max - smem_bytes(r, 0, log2cap)) // (4 * warps) // 4 * 4
    if fits < 4:
        raise ValueError(f"R = {r} needs more shared memory than a block has "
                         f"({smem_bytes(r, 4, log2cap)} > {smem_max} bytes)")
    n_ranges = -(-r // fits)
    per_range = -(-r // n_ranges)
    width = -(-per_range // 4) * 4
    per_nbr = max(1, resident(smem_bytes(r, width, log2cap), n_ranges) // m)   # blocks a neighbour
    rows = max(2 * warps, -(-r // per_nbr))
    return -(-rows // warps) * warps, width, log2cap


def obs_grid_plain(row_start, cols, vals, keys):
    """Plain torch version: every window entry of every slot with a key
    scattered into the slot of the key equal to its column (a sorted search
    over the neighbour's keys; a repeated key takes the entries at its
    first slot), strict upper triangle. ``row_start`` (n + 1,) int64,
    ``cols`` (nnz,) int32, ``vals`` (nnz,) f32, ``keys`` (M, R) int32 ->
    (M, R, R) f32."""
    m, r = keys.shape
    dev = keys.device
    n = row_start.shape[0] - 1
    k = keys.long().reshape(-1)
    ok = k >= 0
    start = torch.where(ok, row_start[k.clamp_min(0)], 0)
    length = torch.where(ok, row_start[(k + 1).clamp_min(0)] - start, 0)
    total = int(length.sum())
    row_of = torch.repeat_interleave(torch.arange(m * r, device=dev), length)     # (E,)
    first = torch.repeat_interleave(length.cumsum(0) - length, length)
    entry = start[row_of] + torch.arange(total, device=dev) - first
    nbr = row_of // r
    # the slot of a column among its neighbour's keys: search (neighbour,
    # key) pairs sorted stably, so a repeated key resolves to its first slot
    pair = torch.where(ok, torch.arange(m, device=dev).repeat_interleave(r) * (n + 1) + k, -1)
    spair, order = torch.sort(pair, stable=True)
    want = nbr * (n + 1) + cols[entry].long()
    at = torch.searchsorted(spair, want).clamp_max(m * r - 1)
    hit = spair[at] == want
    # a column that matches no key lands in the dropped cell m * r * r
    tgt = torch.where(hit, row_of * r + order[at] % r, m * r * r)
    ob = torch.zeros(m * r * r + 1, dtype=torch.float32, device=dev)
    ob.index_add_(0, tgt, vals[entry])
    upper = torch.ones((r, r), dtype=torch.bool, device=dev).triu(1)
    return torch.where(upper, ob[:-1].reshape(m, r, r), 0.0)


class WindowObsGrid(Counted):
    """``grid(row_start (n + 1,) int64, cols (nnz,) int32, vals (nnz,) f32,
    keys (M, R) int32) -> (M, R, R) f32``, the strict upper triangle of the
    densified CSR windows of the keys. Contract: keys are CSR rows in
    [0, n) or -1; a key may repeat, but no window column equals a repeated
    key (then every entry has one slot to go to). Were one to, its entries
    would go to the key's first slot, in the kernel as in the plain
    version.

    ``n_launches`` counts the kernel's launches, on the card (``ops.counts``).
    """

    def __init__(self):
        self.launches = LaunchCount()
        self.plans = {}       # (device, R, M) -> (rows_per_block, width, log2cap)

    def plan_for(self, device, r: int, m: int):
        """The launch plan of (R, M) on ``device``, made once (the card's
        shared-memory limit and occupancy are asked once)."""
        key = (device, r, m)
        if key not in self.plans:
            lib = load_library()
            n_sm = torch.cuda.get_device_properties(device).multi_processor_count

            def resident(smem, n_ranges):
                per_sm = ctypes.c_int(0)
                rc = lib.obsgrid_occupancy(smem, n_ranges, ctypes.byref(per_sm))
                if rc != 0:
                    raise RuntimeError(f"obsgrid occupancy query failed: cudaError {rc}")
                return per_sm.value * n_sm

            self.plans[key] = plan(r, m, smem_limit(device), lib.obsgrid_smem_bytes,
                                   lib.obsgrid_warps(), resident)
        return self.plans[key]

    def launch(self, row_start, cols, vals, keys) -> torch.Tensor:
        """Launch the kernel; (M, R, R) f32 on the inputs' card."""
        dev = keys.device
        if dev.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, not {dev}")
        if keys.dim() != 2:
            raise ValueError(f"keys: need (M, R), got {tuple(keys.shape)}")
        m, r = keys.shape
        nnz = cols.shape[0]
        for name, x, dt, shape in (("row_start", row_start, torch.int64, (row_start.shape[0],)),
                                   ("cols", cols, torch.int32, (nnz,)),
                                   ("vals", vals, torch.float32, (nnz,)),
                                   ("keys", keys, torch.int32, (m, r))):
            if x.device != dev or x.dtype != dt or not x.is_contiguous():
                raise ValueError(f"{name}: need contiguous {dt} on {dev}, "
                                 f"got {x.dtype} on {x.device}")
            if tuple(x.shape) != shape:
                raise ValueError(f"{name}: need shape {shape}, got {tuple(x.shape)}")
        lib = load_library()
        rows_per_block, width, log2cap = self.plan_for(dev, r, m)
        out = torch.empty((m, r, r), dtype=torch.float32, device=dev)
        rc = lib.obsgrid(row_start.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                         keys.data_ptr(), out.data_ptr(), m, r, rows_per_block, width,
                         log2cap, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"obsgrid launch failed: cudaError {rc}")
        self.launches.add(dev)
        return out

    def plain(self, row_start, cols, vals, keys) -> torch.Tensor:
        return obs_grid_plain(row_start, cols, vals, keys)

    def __call__(self, row_start, cols, vals, keys) -> torch.Tensor:
        if keys.device.type == "cuda":
            return self.launch(row_start, cols, vals, keys)
        return self.plain(row_start, cols, vals, keys)
