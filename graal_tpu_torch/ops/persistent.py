"""The persistent schedule of the candidate scorers, dense (B1),
mini-grid (B2) and copy-summing (B3), on the host.

The kernels (``csrc/ll_dense.cu``, ``csrc/ll_mini.cu``,
``csrc/ll_repeat.cu``; the device side and the one decode of an item are
in ``csrc/schedule.cuh``) cut their work into items: one half (32 rows x 64
columns) of an upper-triangle 64 x 64 tile of the pair grid, for one chunk
of candidates (and, in B2, one neighbour). A grid of ``G`` resident
blocks takes them in increasing order from a ticket counter, a device int
the wrapper keeps (:class:`Tickets`)
and the kernel's reduction resets to 0: an item of same-contig cells costs
about ten of trans cells, so a block that drew cheap items draws more.
Each of a block's 8 warps sums its fixed cells of the item per candidate,
and the 8 sums are added in warp order into the candidate's f32 partial of
the item. So a candidate owns ``SLOTS`` partials per tile whatever the
chunk size, the grid, the batch or the block that drew the item, and its
score, their sum in a fixed order, is the same in any batch. B2 draws the
tiles inside each neighbour's live extent only, which its kernel finds
on the card (``decode_mini_item``); the plan still counts every tile.

:func:`plan` picks the chunk size and the grid from the shapes alone (no
device read, so it is safe inside a step that must not synchronise): the
fewest rounds of items per block, weighed by the candidates an item holds.
:func:`fit_chunk` caps the chunk where an item's shared memory grows with
its inputs (B3's copy rows). :func:`resident_blocks` asks the card once per
process how many blocks stay resident.
"""

from __future__ import annotations

import ctypes

import torch

TILE = 64         # tile edge of the pair grid
HALVES = 2        # items per tile (32-row halves)
SLOTS = HALVES    # partials per (candidate, tile): one per item
# staging an item (obs rows, copy ranges) costs about as much as scoring
# this many candidates on it
ITEM_COST = 2


def n_tiles(n: int) -> int:
    """Upper-triangle 64 x 64 tiles of an n x n pair grid."""
    n_rb = -(-n // TILE)
    return n_rb * (n_rb + 1) // 2


def plan(n_tri: int, n_cand: int, n_groups: int, resident: int, chunk_max: int):
    """(chunk, grid, n_items): candidates per item and persistent blocks for
    ``n_groups`` independent grids (B2's neighbours; 1 for B3) of
    ``n_tri`` tiles and ``n_cand`` candidates each, when ``resident``
    blocks fit on the card at once. The chunk minimises the rounds of
    items per block times (chunk + ITEM_COST), the larger chunk on a tie."""
    if min(n_tri, n_cand, n_groups, resident, chunk_max) < 1:
        raise ValueError("plan needs positive sizes")
    best = None
    for cs in range(1, min(chunk_max, n_cand) + 1):
        items = n_groups * -(-n_cand // cs) * n_tri * HALVES
        cost = -(-items // resident) * (cs + ITEM_COST)
        if best is None or cost <= best[0]:
            best = (cost, cs, items)
    _, cs, items = best
    return cs, min(items, resident), items


def fit_chunk(smem_bytes, limit: int, chunk_max: int) -> int:
    """The largest chunk, at most ``chunk_max``, whose item fits in
    ``limit`` bytes of shared memory (``smem_bytes(chunk)`` its need; a
    negative ``limit`` is the cudaError_t of a failed query). Raises when
    even one candidate does not fit."""
    if limit < 0:
        raise RuntimeError(f"shared-memory limit query failed: cudaError {-limit}")
    for cs in range(chunk_max, 0, -1):
        if smem_bytes(cs) <= limit:
            return cs
    raise RuntimeError(f"an item of one candidate needs {smem_bytes(1)} bytes of shared "
                       f"memory; a block may have {limit}")


class Tickets:
    """A kernel's ticket counters, one device int per (device, stream).
    The kernel's reduction resets a counter to 0 for the next launch, so
    the launches that share one must run in order, as on one stream."""

    def __init__(self):
        self.counters = {}

    def get(self, device, stream: int) -> torch.Tensor:
        """The counter of launches on ``stream`` (a ``cuda_stream`` handle)."""
        key = (device, stream)
        if key not in self.counters:
            self.counters[key] = torch.zeros(1, dtype=torch.int32, device=device)
        return self.counters[key]


def resident_blocks(configure, device) -> int:
    """Blocks of a kernel resident on the whole card: ``configure(byref
    int)`` (the library's occupancy query, a cudaError_t) per SM, times the
    SM count."""
    per_sm = ctypes.c_int(0)
    rc = configure(ctypes.byref(per_sm))
    if rc != 0 or per_sm.value < 1:
        raise RuntimeError(f"occupancy query failed: cudaError {rc}, "
                           f"{per_sm.value} blocks per SM")
    return per_sm.value * torch.cuda.get_device_properties(device).multi_processor_count
