// The persistent schedule of the candidate scorers (ll_dense.cu,
// ll_mini.cu, ll_repeat.cu; planned on the host by
// graal_tpu_torch/ops/persistent.py). Plain C++ with no CUDA header, so the
// host can compile the same item decode the kernels run.
//
// A work item is one half (32 rows x 64 columns) of an upper-triangle 64 x
// 64 tile for one chunk of candidates (and, in ll_mini.cu, one neighbour:
// the item's group); decode_item below is the one place that says which
// for ll_dense.cu and ll_repeat.cu, decode_mini_item for ll_mini.cu, whose
// items cover only each neighbour's live tiles.
// The G resident blocks take the items in increasing order from a ticket
// counter (atomicAdd on a device int the wrapper keeps and the reduction
// resets): items differ in cost by an order of magnitude (same-contig cells
// inside (0, d_max) against trans cells), so a block that drew cheap items
// draws more. The order is tile-major and the tiles go by diagonal offset
// (band_coords in scorer_common.cuh): the same-contig pairs gather near the
// diagonal, so the costly items are drawn first and the cheap ones fill
// the tail. Warp w of the 8 covers rows w + 8q, q < 4, of its item, lane
// l the columns l and l + 32, so a row's values (read by the whole warp at
// once) serve two cells a lane; the warp reduces its cells per candidate
// into shared memory; after the barrier that opens the block's next item,
// one thread per candidate sums the 8 warp sums in warp order into the
// item's f32 partial (in ll_dense.cu a pure-trans item's partial is its
// affine form instead, in ll_mini.cu an empty or band-free one's is 0 or
// its closed form). So a candidate has SLOTS = 2 partials per tile, each
// over the same cells in the same order whatever the item's chunk or
// block, and a score is the same in any batch.
#pragma once

#if defined(__CUDACC__)
#define SCHEDULE_FN __host__ __device__ __forceinline__
#else
#define SCHEDULE_FN inline
#endif

namespace persistent {
constexpr int TILE = 64;                    // tile edge
constexpr int ROWS = 32;                    // rows of an item (half a tile)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = ROWS / WARPS;  // 4: warp w's rows are w + 8q
constexpr int COLS_PER_LANE = TILE / 32;     // 2: lane l's columns are l and l + 32
constexpr int SLOTS = TILE / ROWS;          // items, so partials, per (candidate, tile)
constexpr int REDUCE_WARPS = 16;            // candidates reduced at once by a block

struct Item {
  int group;   // ll_mini.cu's neighbour; 0 in ll_dense.cu and ll_repeat.cu
  int first;   // the chunk's first candidate
  int tile;    // upper-triangle tile, in band_coords' order
  int half;    // which 32 rows of the tile; the partial's slot in the tile
};

// Item i of n_groups groups of n_chunks chunks of cs candidates: the
// halves of a tile are adjacent, then the chunks of a group, then the
// groups, then the tiles. Its partial of candidate c lies at tile * SLOTS +
// half in c's row of its group.
SCHEDULE_FN Item decode_item(int item, int n_groups, int n_chunks, int cs) {
  const int rest = item / SLOTS;
  const int chunk_group = rest % (n_chunks * n_groups);
  return Item{chunk_group / n_chunks, chunk_group % n_chunks * cs, rest / (n_chunks * n_groups),
              item % SLOTS};
}

// ll_mini.cu's items. Group g has live[g] live row blocks: its rows from
// TILE * live[g] on are dead in every candidate, so its live tiles are the
// (bi, bj) with bi <= bj < live[g], and no item covers the others. Items
// go by diagonal offset d = bj - bi (heaviest first), then group, then bi,
// then chunk, then half: diag_items(d) of them on diagonal d, and
// diag_start[d] the first of them (diag_start[0] = 0; n_diag + 1 entries,
// the last the item count).
struct MiniItem {
  int group;   // neighbour
  int first;   // the chunk's first candidate
  int bi, bj;  // tile
  int half;    // which 32 rows of the tile; the partial's slot in the tile
};

SCHEDULE_FN int diag_items(int d, const int* live, int n_groups, int n_chunks) {
  int tiles = 0;
  for (int g = 0; g < n_groups; ++g) tiles += live[g] > d ? live[g] - d : 0;
  return tiles * n_chunks * SLOTS;
}

SCHEDULE_FN MiniItem decode_mini_item(int item, const int* diag_start, int n_diag,
                                      const int* live, int n_chunks, int cs) {
  int d = 0;
  for (int hi = n_diag; hi - d > 1;) {   // diag_start[d] <= item < diag_start[hi]
    const int mid = (d + hi) / 2;
    if (diag_start[mid] <= item) d = mid; else hi = mid;
  }
  const int per_tile = n_chunks * SLOTS;
  int rest = item - diag_start[d];
  int g = 0;
  for (;; ++g) {
    const int span = (live[g] > d ? live[g] - d : 0) * per_tile;
    if (rest < span) break;
    rest -= span;
  }
  const int bi = rest / per_tile;
  rest -= bi * per_tile;
  return MiniItem{g, rest / SLOTS * cs, bi, bi + d, rest % SLOTS};
}

// Where ll_mini.cu keeps the partials of tile (bi, bj), bj >= bi: tiles by
// column block, so a group's live tiles take its first
// live * (live + 1) / 2 slots.
SCHEDULE_FN int tri_slot(int bi, int bj) { return bj * (bj + 1) / 2 + bi; }
}  // namespace persistent
