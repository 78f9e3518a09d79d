// Mini-grid candidate scorer of the delta engine, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_mini_kernel` of
// graal_tpu/ops/likelihood_pallas.py (built there by `make_mini_grid_scorer`).
// For each of M neighbour slots, a block of C genomes (the base mini-state
// and its 13 candidates) is scored on the neighbour's R x R sub-row grid:
//
//     score[m, c] = sum_{u<v<R} ob[m,u,v] * log_e - exp(log_e)
//     log_e = (same contig ? log_cis : log v_inter) + la_u + la_v - log nfpb
//
// with the per-cell math of the dense scorer (scorer_common.cuh). ob is the
// neighbour's observed grid (zero on inactive rows and columns), la the log
// accumulation weight (-1e9 on padding and inactive rows, so exp gives 0).
// The delta of candidate c is dll[m, c-1] = score[m, c] - score[m, 0],
// taken in f64 from the f64 tile sums and then rounded once: base and
// candidates differ in few cells, and an f32 difference of two f32 sums
// would lose those cells to cancellation. The Rippe parameters are one row
// per neighbour slot (a tempered chain carries its own); an item reads its
// slot's row once.
//
// What bounds it on the card. No design avoids the same-contig power law:
// a logf, a divide and an expf per same-contig pair inside (0, d_max)
// (accurate libm sequences: no --use_fast_math). A mini grid holds the two
// contigs a move touches, so a large share of its cells are same-contig.
// Every other cell is a few FP32 operations, and the observed grids (21 MB
// at R = 1,024, M = 5) are read once. There is no product of matrices, so
// the tensor cores have nothing to do.
//
// What the design does about it.
//  - Only the same-contig pairs inside (0, d_max) pay the logf, the
//    divide and the expf (circular rows take the circular formula); every
//    other cell has e0 = v_inter and pays no transcendental: with A =
//    exp(la) computed once per row and candidate when the item is staged,
//    E = (v_inter A_u / nfpb) A_v is a product of a row factor and a column
//    factor and log E a sum. Padding and inactive rows (la = -1e9) give
//    A = 0, so E = 0, and ob = 0 there.
//  - A persistent grid (schedule.cuh) over the items
//    (neighbour, candidate chunk, half tile): the wrapper sizes it once per
//    process from cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM
//    count and plans the chunk from the shapes on the host, so that the
//    low tiers (R = 256, 512: 20-72 half tiles a neighbour) fill the card
//    and R = 1,024 loses its tail wave. Blocks draw items from a ticket
//    counter, since an item of same-contig cells costs about ten of trans
//    cells, and heaviest first (tiles by diagonal offset, tile-major).
//  - No barrier per candidate: a block stages the obs rows of its item
//    once and the row and column values of all the chunk's candidates
//    (with their factors) in shared memory at once, as one record per row
//    and per column, so a warp reaches every field of its rows at a
//    constant offset from one address per candidate. Shared-memory loads,
//    not arithmetic, set the pace of a trans cell, so each warp takes the
//    candidates in turn, keeps its lanes' two columns in registers for
//    its 4 rows, and reads each row's values (one broadcast load a field)
//    for two cells a lane: a cell costs one load of ob and half a row.
//    Looping cells outside and candidates inside would read ob once but
//    the column values once per cell and candidate, and hold 14
//    accumulators. Each warp reduces its cells per candidate into shared
//    memory; the barrier that opens the next item also orders the one sum
//    per candidate of the 8 warp sums. The staging is not double-buffered:
//    a second buffer would cost a resident block, and the other resident
//    blocks' work covers one block's loads. 48 registers, no spills: 5
//    blocks an SM.
//  - Index widths. An item, a tile and a partial's slot are ints: at
//    M = 20, R = 16,384 (the top tier of 4 tempered chains) there are
//    1,315,840 items, and the launch refuses a shape whose items and
//    tickets would pass INT_MAX. Every offset into the (M, R, R) grid,
//    the (M, C, R) vectors and the partials is a size_t product (the grid
//    holds 5.4e9 cells at that shape).
//  - Nothing is accumulated across blocks: one f32 partial per (neighbour,
//    candidate, tile, half), and a second kernel, one warp per candidate,
//    sums them in f64 in a fixed order. A candidate's score depends only on
//    its own inputs, in any batch, whichever block computed it; a cell
//    where base and candidate agree gives the same value in both, so it
//    cancels exactly in the delta.

#include <climits>

#include <cuda_runtime.h>

#include "scorer_common.cuh"

namespace {

using namespace persistent;

constexpr int CAND_MAX = 14;        // candidates per item (base + 13)
constexpr int MAX_C = 64;           // candidates per neighbour (EM: 14)
constexpr int MIN_BLOCKS = 5;       // resident blocks per SM the registers must allow
constexpr int Q_UNROLL = 2;         // rows of a warp in flight together

// A candidate's values of one row of an item and of one column, as the
// block stages them: one base address per candidate, each field and each
// row of a warp at a constant offset from it.
struct RowVals {
  float mid, cst, la, rt;   // cst: contig length on a circular row, else -1
  int idc;                  // rt: v_inter exp(la) / nfpb
};
struct __align__(16) ColVals {
  float mid, la, a;         // a: exp(la)
  int idc;
};

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ll_mini_items(const float* __restrict__ mid,    // (M, C, R) sub-row midpoints (kb)
              const int* __restrict__ idc,      // (M, C, R) contig id
              const float* __restrict__ circ,   // (M, C, R) 1.0 on circular contigs
              const float* __restrict__ stot,   // (M, C, R) contig length (kb)
              const float* __restrict__ la,     // (M, C, R) log accu, -1e9 if inactive
              const float* __restrict__ ob,     // (M, R, R) observed grid
              const float* __restrict__ pvec,   // (M, N_PARAMS), one row a mini genome
              float* __restrict__ partial,      // (M, C, n_tri * SLOTS)
              int* __restrict__ next_item,      // ticket counter, 0 at launch
              int M, int C, int R, int n_rb, int n_tri, int cs, int n_chunks, int n_items) {
  __shared__ float s_ob[ROWS * TILE];
  __shared__ RowVals s_row[CAND_MAX][ROWS];
  __shared__ ColVals s_col[CAND_MAX][TILE];
  __shared__ float s_warp[CAND_MAX][WARPS];  // warp sums of the last item
  __shared__ int s_item;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* ob_lane = s_ob + warp * TILE + lane;   // this lane's cells of row q: + 8q TILE + 32j
  // the item whose warp sums wait in s_warp: where its first candidate's
  // partial goes, its candidate count
  size_t last_part = 0;
  int last_nc = 0;

  for (;;) {
    if (tid == 0) s_item = atomicAdd(next_item, 1);
    __syncthreads();   // the previous item's readers are done with shared memory
    const int item = s_item;
    if (tid < last_nc)
      flush_partial(s_warp[tid], partial + last_part + (size_t)tid * n_tri * SLOTS);
    if (item >= n_items) break;
    const Item it = decode_item(item, M, n_chunks, cs);
    const int half = it.half;
    const int t = it.tile;
    const int c0 = it.first;
    const int nbr = it.group;
    const int nc = min(cs, C - c0);
    const RippeCell p(pvec + (size_t)nbr * N_PARAMS);   // this neighbour's parameters
    int bi, bj;
    band_coords(t, n_rb, &bi, &bj);
    const int i0 = bi * TILE + half * ROWS;         // first row of the item
    const int j0 = bj * TILE;
    const float* obn = ob + (size_t)nbr * R * R;
    for (int e = tid; e < ROWS * TILE; e += THREADS) {
      const int rg = i0 + e / TILE;
      const int cg = j0 + e % TILE;
      s_ob[e] = (rg < R && cg < R) ? obn[(size_t)rg * R + cg] : 0.0f;
    }
    for (int e = tid; e < nc * ROWS; e += THREADS) {
      const int k = e / ROWS;
      const int u = e - k * ROWS;
      const int rg = i0 + u;
      if (rg < R) {
        const size_t o = ((size_t)nbr * C + c0 + k) * R + rg;
        const float lau = la[o];
        s_row[k][u] = RowVals{mid[o], circ[o] == 1.0f ? stot[o] : -1.0f, lau,
                              p.v_inter * expf(lau - p.log_nfpb), idc[o]};
      }
    }
    for (int e = tid; e < nc * TILE; e += THREADS) {
      const int k = e / TILE;
      const int v = e - k * TILE;
      const int cg = j0 + v;
      if (cg < R) {
        const size_t o = ((size_t)nbr * C + c0 + k) * R + cg;
        const float lav = la[o];
        s_col[k][v] = ColVals{mid[o], lav, expf(lav), idc[o]};
      }
    }
    __syncthreads();

    for (int k = 0; k < nc; ++k) {
      ColVals cv[COLS_PER_LANE];
#pragma unroll
      for (int j = 0; j < COLS_PER_LANE; ++j)
        cv[j] = j0 + lane + 32 * j < R ? s_col[k][lane + 32 * j] : ColVals{0.0f, 0.0f, 0.0f, 0};
      const RowVals* rows = &s_row[k][warp];
      float acc = 0.0f;
#pragma unroll Q_UNROLL
      for (int q = 0; q < ROWS_PER_WARP; ++q) {
        const int row_g = i0 + warp + WARPS * q;
        const RowVals* u = rows + WARPS * q;
#pragma unroll
        for (int j = 0; j < COLS_PER_LANE; ++j) {
          const int col_g = j0 + lane + 32 * j;
          if (!(col_g < R && col_g > row_g)) continue;
          const float la_pair = (u->la + cv[j].la) - p.log_nfpb;
          const float s = fabsf(u->mid - cv[j].mid);
          float log_e, e;
          if (u->idc == cv[j].idc && s > 0.0f && s < p.d_max) {
            log_e = p.log_cis(s, u->cst >= 0.0f, u->cst) + la_pair;
            e = expf(log_e);
          } else {   // trans, or same contig outside (0, d_max): e0 = v_inter
            log_e = p.log_v + la_pair;
            e = u->rt * cv[j].a;
          }
          acc += ob_lane[WARPS * TILE * q + 32 * j] * log_e - e;
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) s_warp[k][warp] = acc;
    }
    last_part = ((size_t)nbr * C + c0) * n_tri * SLOTS + t * SLOTS + half;
    last_nc = nc;
  }
}

// One block per neighbour, one warp per candidate: each candidate's
// partials summed in f64 in a fixed order, then scores and deltas against
// candidate 0 (the base).
__global__ void __launch_bounds__(REDUCE_WARPS * 32)
ll_mini_reduce(const float* __restrict__ partial, int C, int n_part,
               float* __restrict__ scores,      // (M, C)
               float* __restrict__ dll,         // (M, C - 1)
               int* __restrict__ next_item) {   // reset for the next launch
  __shared__ double s_tot[MAX_C];
  const int nbr = blockIdx.x;
  const int tid = threadIdx.x;
  if (nbr == 0 && tid == 0) *next_item = 0;
  for (int c = tid >> 5; c < C; c += REDUCE_WARPS) {
    const double tot = warp_sum_f64(partial + ((size_t)nbr * C + c) * n_part, n_part);
    if ((tid & 31) == 0) s_tot[c] = tot;
  }
  __syncthreads();
  if (tid < C) {
    scores[(size_t)nbr * C + tid] = (float)s_tot[tid];
    if (tid > 0) dll[(size_t)nbr * (C - 1) + tid - 1] = (float)(s_tot[tid] - s_tot[0]);
  }
}

int row_blocks(int R) { return (R + TILE - 1) / TILE; }

}  // namespace

extern "C" {

// Upper-triangle tiles of an R x R grid.
int ll_mini_n_tiles(int R) {
  const int n_rb = row_blocks(R);
  return n_rb * (n_rb + 1) / 2;
}

int ll_mini_slots() { return SLOTS; }

int ll_mini_max_candidates() { return MAX_C; }

int ll_mini_max_chunk() { return CAND_MAX; }

// Once per process: prefer shared memory over L1 and write the blocks of
// ll_mini_items that stay resident on one SM.
int ll_mini_configure(int* blocks_per_sm) {
  const cudaError_t err = prefer_shared(ll_mini_items);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, ll_mini_items,
                                                            THREADS, 0);
}

// Score M x C mini-grid genomes: partial is (M, C, ll_mini_n_tiles(R) *
// ll_mini_slots()) f32 scratch, scores (M, C) and dll (M, C - 1) f32 outputs,
// next_item a device int that is 0 before the launch (and is 0 again after
// it: launches that share it must be ordered on one stream). `cs`
// candidates per item and `grid` persistent blocks come from the caller's
// plan (ops/persistent.py). Mini genome m reads its N_PARAMS parameters at
// pvec + m * N_PARAMS (a shared vector comes broadcast to M rows). Launches
// on `stream`, does not synchronise, returns the cudaError_t of the
// launches.
int ll_mini_score(const float* mid, const int* idc, const float* circ,
                  const float* stot, const float* la, const float* ob,
                  const float* pvec, float* partial, float* scores, float* dll,
                  int* next_item, int M, int C, int R, int cs, int grid, void* stream) {
  if (M <= 0 || C < 1 || C > MAX_C || R <= 0 || cs < 1 || cs > CAND_MAX || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_rb = row_blocks(R);
  const int n_tri = n_rb * (n_rb + 1) / 2;
  const int n_chunks = (C + cs - 1) / cs;
  // items are ints, and the blocks draw tickets up to n_items + grid
  const long long items = (long long)M * n_chunks * n_tri * SLOTS;
  if (items > (long long)INT_MAX - grid) return (int)cudaErrorInvalidValue;
  const int n_items = (int)items;
  ll_mini_items<<<grid, THREADS, 0, s>>>(mid, idc, circ, stot, la, ob, pvec, partial,
                                         next_item, M, C, R, n_rb, n_tri, cs, n_chunks, n_items);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ll_mini_reduce<<<M, REDUCE_WARPS * 32, 0, s>>>(partial, C, n_tri * SLOTS, scores, dll,
                                                 next_item);
  return (int)cudaGetLastError();
}

}  // extern "C"
