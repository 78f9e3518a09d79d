// The persistent schedule of the candidate scorers (ll_dense.cu,
// ll_mini.cu, ll_repeat.cu; planned on the host by
// graal_tpu_torch/ops/persistent.py). Plain C++ with no CUDA header, so the
// host can compile the same item decode the kernels run.
//
// A work item is one half (32 rows x 64 columns) of an upper-triangle 64 x
// 64 tile for one chunk of candidates (and, in ll_mini.cu, one neighbour:
// the item's group); decode_item below is the one place that says which.
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
// affine form instead). So a candidate has SLOTS = 2 partials per tile, each
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
}  // namespace persistent
