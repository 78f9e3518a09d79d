"""Window observed-count grid: a hand-written CUDA kernel for Hopper.

The port of the Pallas kernel ``make_window_obs_grid`` / ``_obsgrid_kernel``
(graal_tpu/ops/obsgrid_pallas.py): each mini row's CSR window made dense
over the D sub rows of the delta engine,

    ob[m, r, j] = sum_w vals[m, r, w] * (cols[m, r, w] == keys[m, j]),

returned as its strict upper triangle (j > r), the part the mini-grid
scorer reads. The kernel source is ``graal_tpu_torch/csrc/obsgrid.cu``; its
header says what bounds it on the card and how the design answers that.

Dispatch is by device: on CUDA tensors :class:`WindowObsGrid` launches the
kernel (or raises); on CPU tensors it runs :func:`obs_grid_plain`, a
scatter-add whose tests hold it to the one-hot contraction of the JAX
package's ``window_obs_grid_reference``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from graal_tpu_torch.ops import build

SMEM_LIMIT = 232_448   # bytes of shared memory a block may use on Hopper


@functools.cache
def load_library():
    """The kernel library (built at first use), its C functions typed."""
    lib = build.load("obsgrid")
    ptr = ctypes.c_void_p
    lib.obsgrid_smem_bytes.argtypes = [ctypes.c_int]
    lib.obsgrid_smem_bytes.restype = ctypes.c_int
    lib.obsgrid.argtypes = [ptr] * 5 + [ctypes.c_int] * 3 + [ptr]
    lib.obsgrid.restype = ctypes.c_int
    return lib


def obs_grid_plain(cols, vals, keys):
    """Plain torch version: a scatter-add of each window entry into the
    slot of the key equal to its column (found by a sorted search), strict
    upper triangle. ``cols`` (M, R, cap) int32, ``vals`` (M, R, cap) f32,
    ``keys`` (M, R) int32 -> (M, R, R) f32."""
    m, r, cap = cols.shape
    skeys, slots = torch.sort(keys, dim=-1)
    flat_cols = cols.reshape(m, r * cap)
    at = torch.searchsorted(skeys, flat_cols).clamp_max(r - 1)
    hit = (skeys.gather(1, at) == flat_cols) & (flat_cols >= 0)
    # a column that matches no key lands in the extra column r, dropped below
    tgt = torch.where(hit, slots.gather(1, at), r).reshape(m, r, cap)
    ob = torch.zeros((m, r, r + 1), dtype=torch.float32, device=cols.device)
    ob.scatter_add_(2, tgt, vals)
    upper = torch.ones((r, r), dtype=torch.bool, device=cols.device).triu(1)
    return torch.where(upper, ob[..., :r], 0.0)


class WindowObsGrid:
    """``grid(cols (M, R, cap) int32, vals (M, R, cap) f32, keys (M, R)
    int32) -> (M, R, R) f32``, the strict upper triangle of the window
    densification. Contract (the JAX kernel's): valid keys distinct and
    >= 0, invalid key slots -1; columns >= 0, or -2 where the window holds
    no entry; ``vals`` zero on unused window slots.

    ``n_launches`` counts the calls that launched the CUDA kernel.
    """

    def __init__(self):
        self.n_launches = 0

    def launch(self, cols, vals, keys) -> torch.Tensor:
        """Launch the kernel; (M, R, R) f32 on the inputs' card."""
        if cols.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, not {cols.device}")
        if cols.dim() != 3:
            raise ValueError(f"cols: need (M, R, cap), got {tuple(cols.shape)}")
        m, r, cap = cols.shape
        for name, x, dt, shape in (("cols", cols, torch.int32, (m, r, cap)),
                                   ("vals", vals, torch.float32, (m, r, cap)),
                                   ("keys", keys, torch.int32, (m, r))):
            if x.device != cols.device or x.dtype != dt or not x.is_contiguous():
                raise ValueError(f"{name}: need contiguous {dt} on {cols.device}, "
                                 f"got {x.dtype} on {x.device}")
            if tuple(x.shape) != shape:
                raise ValueError(f"{name}: need shape {shape}, got {tuple(x.shape)}")
        lib = load_library()
        if lib.obsgrid_smem_bytes(r) > SMEM_LIMIT:
            raise ValueError(f"R = {r} needs more shared memory than a block has")
        skeys, slots = torch.sort(keys, dim=-1)
        slots = slots.int()
        out = torch.empty((m, r, r), dtype=torch.float32, device=cols.device)
        rc = lib.obsgrid(cols.data_ptr(), vals.data_ptr(), skeys.data_ptr(),
                         slots.data_ptr(), out.data_ptr(), m, r, cap,
                         torch.cuda.current_stream(cols.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"obsgrid launch failed: cudaError {rc}")
        self.n_launches += 1
        return out

    def plain(self, cols, vals, keys) -> torch.Tensor:
        return obs_grid_plain(cols, vals, keys)

    def __call__(self, cols, vals, keys) -> torch.Tensor:
        if cols.device.type == "cuda":
            return self.launch(cols, vals, keys)
        return self.plain(cols, vals, keys)
