"""The persistent schedule of kernels B1, B2 and B3 (graal_tpu_torch.ops.persistent),
on the host: the items the blocks draw from the ticket counter (0, 1, ...,
n_items - 1) score every (candidate, tile, half) exactly once, whatever the
batch, the chunk and the grid; a candidate's partials lie at the same
places and are summed in the same order in any batch; the plan fills the
resident blocks at the shapes the main paths give the kernels; and B3's
chunk fits the shared memory of a copy-dense table.

Items are decoded by the kernels' own ``decode_item`` (csrc/schedule.cuh,
plain C++), compiled here with the host's C++ compiler.
"""

import ctypes
import shutil
import subprocess
from collections import Counter
from pathlib import Path

import pytest

from graal_tpu_torch.ops import persistent

RESIDENT = 5 * 132      # blocks of 8 warps at 48 registers on an H100
CSRC = Path(persistent.__file__).resolve().parent.parent / "csrc"
SHIM = """
#include "schedule.cuh"
extern "C" int schedule_slots() { return persistent::SLOTS; }
extern "C" void schedule_decode(int item, int n_groups, int n_chunks, int cs, int* out) {
  const persistent::Item it = persistent::decode_item(item, n_groups, n_chunks, cs);
  out[0] = it.group; out[1] = it.first; out[2] = it.tile; out[3] = it.half;
}
"""


@pytest.fixture(scope="module")
def decode(tmp_path_factory):
    """decode(item, n_groups, n_chunks, cs) -> (group, first candidate,
    tile, half), as the kernels decode an item."""
    cxx = shutil.which("c++") or shutil.which("g++")
    assert cxx, "a C++ compiler is needed to build the schedule's decode"
    d = tmp_path_factory.mktemp("schedule")
    (d / "shim.cpp").write_text(SHIM)
    so = d / "libschedule.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{CSRC}",
                    str(d / "shim.cpp"), "-o", str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    assert lib.schedule_slots() == persistent.SLOTS
    out = (ctypes.c_int * 4)()

    def fn(item, n_groups, n_chunks, cs):
        lib.schedule_decode(item, n_groups, n_chunks, cs, out)
        return tuple(out)
    return fn


def covered(decode, n_tri, n_cand, n_groups, resident, chunk_max):
    """(group, candidate, tile, half) -> times scored by the items the
    tickets hand out, and the plan."""
    cs, grid, n_items = persistent.plan(n_tri, n_cand, n_groups, resident, chunk_max)
    n_chunks = -(-n_cand // cs)
    assert n_items == n_groups * n_chunks * n_tri * persistent.HALVES
    seen = Counter()
    for item in range(n_items):
        g, c0, t, half = decode(item, n_groups, n_chunks, cs)
        assert 0 <= t < n_tri and 0 <= c0 < n_cand and 0 <= g < n_groups
        for c in range(c0, min(c0 + cs, n_cand)):
            seen[g, c, t, half] += 1
    return seen, (cs, grid, n_items)


@pytest.mark.parametrize("n_tri,n_cand,n_groups,resident,chunk_max", [
    (171, 130, 1, RESIDENT, 13),      # B3: a dense repeat step's candidates, S = 1,152
    (171, 65, 1, RESIDENT, 13),       # B1: a dense step's candidates, K = 1,152
    (171, 1, 1, RESIDENT, 13),        # B3: the nuisance call
    (4465, 13, 1, RESIDENT, 13),      # B3: S = 6,000
    (171, 131, 1, 7, 13),             # a ragged last chunk on a small grid
    (10, 14, 5, RESIDENT, 14),        # B2: R = 256
    (136, 14, 10, RESIDENT, 14),      # B2: R = 1,024, 10 neighbour slots
    (3, 29, 2, 4, 14),
    (6, 13, 1, 132, 7),               # B3 on a copy-dense table: chunk capped at 7
])
def test_every_cell_block_scored_once(decode, n_tri, n_cand, n_groups, resident, chunk_max):
    seen, (cs, grid, n_items) = covered(decode, n_tri, n_cand, n_groups, resident, chunk_max)
    want = {(g, c, t, h) for g in range(n_groups) for c in range(n_cand)
            for t in range(n_tri) for h in range(persistent.HALVES)}
    assert set(seen) == want and set(seen.values()) == {1}
    assert 1 <= cs <= chunk_max and 1 <= grid <= min(resident, n_items)


@pytest.mark.parametrize("n_tri,n_cand,n_groups,chunk_max", [
    (171, 65, 1, 13),    # B1: a dense step's candidates, K = 1,152
    (171, 1, 1, 13),     # B1: the nuisance call
    (4465, 13, 1, 13),   # B1 / B3: K = 6,000
    (21, 29, 1, 4),      # ragged last chunk
    (136, 14, 5, 14),    # B2: R = 1,024, 5 neighbour slots
])
def test_tile_major_items_score_every_cell_block_once(decode, n_tri, n_cand, n_groups,
                                                      chunk_max):
    """The items are tile-major: every (group, candidate, tile, half) once,
    and the tiles (heaviest first in the kernels' band order) in increasing
    order across the chunks and groups."""
    seen, (cs, _, n_items) = covered(decode, n_tri, n_cand, n_groups, RESIDENT, chunk_max)
    want = {(g, c, t, h) for g in range(n_groups) for c in range(n_cand)
            for t in range(n_tri) for h in range(persistent.HALVES)}
    assert set(seen) == want and set(seen.values()) == {1}
    n_chunks = -(-n_cand // cs)
    tiles = [decode(i, n_groups, n_chunks, cs)[2] for i in range(0, n_items, 7)]
    assert tiles == sorted(tiles)


@pytest.mark.parametrize("n_cand", [1, 13, 65, 130, 520])
def test_a_candidate_has_the_same_partials_in_any_batch(decode, n_cand):
    """A candidate's partials are one per (tile, half) whatever the batch
    and the chunk the plan picks for it, so its f64 sum over them (in the
    order tile * SLOTS + half) runs the same in any batch."""
    n_tri = 171
    seen, (cs, _, _) = covered(decode, n_tri, n_cand, 1, RESIDENT, 13)
    for c in {0, n_cand - 1}:
        mine = sorted(t * persistent.SLOTS + h for (_, cc, t, h) in seen if cc == c)
        assert mine == list(range(n_tri * persistent.SLOTS))


def test_plan_fills_the_card_at_the_path_shapes():
    # the B = 1 nuisance call splits its 171 tiles into 342 half tiles: every SM
    cs, grid, n_items = persistent.plan(171, 1, 1, RESIDENT, 13)
    assert (cs, grid, n_items) == (1, 342, 342)
    # B2 at R = 256: 10 tiles x 5 neighbours reach the card through small chunks
    cs, grid, n_items = persistent.plan(persistent.n_tiles(256), 14, 5, RESIDENT, 14)
    assert n_items <= RESIDENT and grid >= 132 * 3 and cs < 14
    # B2 at R = 4,096: whole chunks, many rounds
    cs, grid, _ = persistent.plan(persistent.n_tiles(4096), 14, 5, RESIDENT, 14)
    assert (cs, grid) == (14, RESIDENT)
    with pytest.raises(ValueError):
        persistent.plan(0, 14, 5, RESIDENT, 14)


@pytest.mark.parametrize("k,b", [(1152, 65), (1152, 1), (6000, 13)])
def test_plan_fills_the_card_at_b1_shapes(k, b):
    """B1's calls (a dense step's 65 candidates, the nuisance B = 1, the
    largest dense table's 13) reach every SM, and a call with more items
    than resident blocks keeps every resident block busy."""
    n_tri = persistent.n_tiles(k)
    cs, grid, n_items = persistent.plan(n_tri, b, 1, RESIDENT, 13)
    assert n_items == -(-b // cs) * n_tri * persistent.HALVES
    assert grid == min(n_items, RESIDENT) and grid >= 2 * 132
    if b == 65:
        assert cs == 13                 # the EM step's chunks of 13 stay whole
    # the rounds of items per block: at most one more than the even share
    assert -(-n_items // grid) <= n_items / RESIDENT + 1


def b3_smem(cs, max_hblk, max_blk):
    """B3's shared memory of an item (ll_repeat.cu smem_bytes): obs and lf
    rows and copy ranges, then 16 bytes a copy column and 20 a copy row per
    candidate."""
    return 16_784 + cs * (16 * max_blk + 20 * max_hblk)


@pytest.mark.parametrize("max_hblk,max_blk,want", [
    (34, 66, 13),        # the flagship repeat table: whole EM chunks
    (630, 1_050, 7),     # ~1,000 copy rows in a 64-sub block
    (5_000, 5_200, 1),   # one candidate at a time
])
def test_fit_chunk_caps_b3_by_shared_memory(max_hblk, max_blk, want):
    limit = 227 * 1024 - 420     # an H100's opt-in block limit less B3's static arrays
    cs = persistent.fit_chunk(lambda c: b3_smem(c, max_hblk, max_blk), limit, 13)
    assert cs == want
    assert b3_smem(cs, max_hblk, max_blk) <= limit
    assert cs == 13 or b3_smem(cs + 1, max_hblk, max_blk) > limit


def test_fit_chunk_refuses_what_cannot_fit():
    with pytest.raises(RuntimeError, match="one candidate"):
        persistent.fit_chunk(lambda c: b3_smem(c, 6_000, 6_200), 227 * 1024, 13)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        persistent.fit_chunk(lambda c: 0, -1, 13)


def test_tickets_one_counter_per_stream():
    tickets = persistent.Tickets()
    a, b = tickets.get("cpu", 1), tickets.get("cpu", 2)
    assert a is tickets.get("cpu", 1) and a is not b
    assert a.tolist() == [0] and str(a.dtype) == "torch.int32"


def test_n_tiles():
    assert [persistent.n_tiles(n) for n in (1, 64, 65, 1152, 6000)] == [1, 1, 3, 171, 4465]


MINI_SHIM = """
#include "schedule.cuh"
extern "C" int mini_diag_items(int d, const int* live, int n_groups, int n_chunks) {
  return persistent::diag_items(d, live, n_groups, n_chunks);
}
extern "C" void mini_decode(int item, const int* diag_start, int n_diag, const int* live,
                            int n_chunks, int cs, int* out) {
  const persistent::MiniItem it =
      persistent::decode_mini_item(item, diag_start, n_diag, live, n_chunks, cs);
  out[0] = it.group; out[1] = it.first; out[2] = it.bi; out[3] = it.bj; out[4] = it.half;
  out[5] = persistent::tri_slot(it.bi, it.bj);
}
"""


@pytest.fixture(scope="module")
def mini_items(tmp_path_factory):
    """items(live, n_chunks, cs) -> [(group, first candidate, bi, bj, half,
    partial slot of the tile)] for item 0, 1, ..., as B2 (csrc/ll_mini.cu)
    builds its ticket table from the live row blocks of each group and
    decodes a ticket."""
    cxx = shutil.which("c++") or shutil.which("g++")
    assert cxx, "a C++ compiler is needed to build the schedule's decode"
    d = tmp_path_factory.mktemp("mini_schedule")
    (d / "shim.cpp").write_text(MINI_SHIM)
    so = d / "libmini_schedule.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{CSRC}",
                    str(d / "shim.cpp"), "-o", str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    out = (ctypes.c_int * 6)()

    def fn(live, n_chunks, cs):
        n_diag = max(live)
        c_live = (ctypes.c_int * len(live))(*live)
        start = [0]
        for diag in range(n_diag):
            start.append(start[-1] + lib.mini_diag_items(diag, c_live, len(live), n_chunks))
        c_start = (ctypes.c_int * len(start))(*start)
        items = []
        for item in range(start[-1]):
            lib.mini_decode(item, c_start, n_diag, c_live, n_chunks, cs, out)
            items.append(tuple(out))
        return items
    return fn


@pytest.mark.parametrize("live,n_cand,cs", [
    ([4] * 5, 14, 7),                 # R = 256, every row live: every tile, small chunks
    ([16] * 5, 14, 14),               # R = 1,024
    ([3, 16, 0, 9, 16], 14, 5),       # neighbours of other extents, one with no live row
    ([157, 40, 79, 10], 14, 14),      # R = 16,384 of 4 chains: 10,000, 2,560, 5,000 rows
])
def test_b2_items_score_every_live_cell_block_once(mini_items, live, n_cand, cs):
    """B2's items cover every (neighbour, candidate, live tile, half) once
    and nothing past a neighbour's live row blocks, by diagonal offset
    (heaviest first); a neighbour's live tiles take the first L (L + 1) / 2
    partial slots, so its f64 sum over that prefix holds every partial."""
    n_chunks = -(-n_cand // cs)
    items = mini_items(live, n_chunks, cs)
    seen = Counter()
    for g, c0, bi, bj, half, slot in items:
        assert 0 <= bi <= bj < live[g] and c0 % cs == 0 and c0 < n_cand
        assert slot == bj * (bj + 1) // 2 + bi < live[g] * (live[g] + 1) // 2
        for c in range(c0, min(c0 + cs, n_cand)):
            seen[g, c, bi, bj, half] += 1
    want = {(g, c, bi, bj, h) for g, n in enumerate(live) for c in range(n_cand)
            for bj in range(n) for bi in range(bj + 1) for h in range(persistent.HALVES)}
    assert set(seen) == want and set(seen.values()) == {1}
    diags = [bj - bi for _, _, bi, bj, _, _ in items]
    assert diags == sorted(diags)
