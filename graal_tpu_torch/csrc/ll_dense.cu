// Dense candidate scorer for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_ll_kernel` / `_tile_body` of
// graal_tpu/ops/likelihood_pallas.py (built there by `make_pallas_scorer`).
// For each of B candidate genomes it computes
//
//     sum_{s<t<K} ob[s,t] * log E[s,t] - E[s,t]
//
// where log E is the log-space Rippe model of a same-contig pair (with the
// circular-contig variant on circular rows) clamped below by log v_inter,
// or log v_inter for a trans pair, plus the accumulation term
// la[s] + la[t] - log nfpb. The genome-independent -sum log(ob!) term is a
// host constant added in the second stage.
//
// What bounds it on the card. There is no matrix product. A same-contig
// pair inside (0, d_max) costs a logf, a divide and an expf (the accurate
// libm sequences: no --use_fast_math); every other cell a few FP32
// operations, and a half tile with no same-contig pair nothing per cell
// at all (below). At the flagship size (K = 1,152, B = 65) that is 43 M
// cells a call against 2.7 MB of observed upper triangle, so the kernel is
// bound by operations, not by memory, as long as obs is read about once.
//
// What the design does about it.
//  - The pure-trans shortcut of the TPU kernel (likelihood_pallas.py:
//    103-129). Observed counts and accumulation weights do not depend on
//    the genome, so a block of cells with no same-contig pair contributes
//    log_v tc0 + tc1 - v_inter tc2, where tc = (sum ob, sum ob la_pair,
//    sum accu_u accu_v / nfpb) over its cells is summed in f64 on the host
//    once per scorer (ops/likelihood_cuda.py trans_constants). The test is
//    exact and per (candidate, item): each warp takes candidates of the
//    chunk in turn, each lane compares its two column contig ids with the
//    item's 32 row ids, and __any_sync decides. A pure-trans (candidate,
//    item) costs one compare per cell and three f64 operations, and when
//    every candidate of an item is pure-trans the block reads no obs. On
//    the exploded start nearly every off-diagonal item is pure-trans; on
//    an assembled genome most items more than a tile off the diagonal.
//    The decision depends on the candidate's own ids only, so a score is
//    bit-identical alone and in any batch.
//  - Elsewhere only same-contig pairs inside (0, d_max) pay the logf, the
//    divide and the expf (circular rows take the circular formula). Every
//    other cell has e0 = v_inter, so E = (v_inter A_u / nfpb) A_v with
//    A = exp(la) is a product of a row factor and a column factor and
//    log E a sum: ob (log_v + la_pair) - rt_u a_v, the trans cell of
//    ll_mini.cu. la, A / nfpb and A do not depend on the genome: they are
//    (K,) vectors computed once per scorer and staged once per item.
//  - The persistent schedule of ll_mini.cu and ll_repeat.cu
//    (schedule.cuh): G resident blocks, sized once per process from
//    cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count, draw
//    items (candidate chunk, half tile) from a ticket counter, the chunk
//    planned on the host from the shapes (ops/persistent.py). No tail
//    wave (one block per (tile, chunk) would be 855 blocks on 660 slots
//    at B = 65), and the B = 1 nuisance call spreads its 342 half tiles
//    over the card. Items are drawn heaviest first, as in the other two:
//    tiles by diagonal offset (band_coords; the same-contig pairs, and so
//    the items scored cell by cell, gather near the diagonal), tile-major
//    over the chunks.
//    An item of 13 candidates scored cell by cell takes a block ~7.5 us
//    on an H100 and a pure-trans one a fraction of that, so in row-major
//    order the last cell items would set the call's time.
//  - No barrier per candidate: a block stages the row and column records
//    of all the chunk's candidates at once (one record per row and per
//    column, every field at a constant offset from one address) with the
//    half tile's three sums, tests them, and only then, if some candidate
//    needs cells, stages the obs half tile. Three barriers an item, none
//    per candidate.
//  - Nothing is accumulated across blocks: one f32 partial per (candidate,
//    tile, half), the cell sum in a fixed order or the affine form, and a
//    second kernel, one warp per candidate, sums them in f64 in a fixed
//    order. No float atomics.

#include <cuda_runtime.h>

#include "scorer_common.cuh"

namespace {

using namespace persistent;

constexpr int CAND_MAX = 13;        // candidates per item (EM batches are 13 m)
constexpr int MIN_BLOCKS = 4;       // resident blocks per SM the registers must allow
constexpr int Q_UNROLL = 2;         // rows of a warp in flight together
constexpr int TC_TERMS = 3;         // (sum ob, sum ob la_pair, sum accu_u accu_v / nfpb)

// A candidate's values of one row of an item and of one column, as the
// block stages them.
struct __align__(16) RowVals {
  float mid, cst;   // cst: contig length on a circular row, else -1
  int idc;
};
struct __align__(8) ColVals {
  float mid;
  int idc;
};

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ll_dense_items(const float* __restrict__ mid,    // (B, K) sub-frag midpoints (kb)
               const int* __restrict__ idc,      // (B, K) contig id
               const float* __restrict__ circ,   // (B, K) 1.0 on circular contigs
               const float* __restrict__ stot,   // (B, K) contig length (kb)
               const float* __restrict__ la,     // (K,) log accu
               const float* __restrict__ ra,     // (K,) accu / nfpb
               const float* __restrict__ acc,    // (K,) accu
               const double* __restrict__ tc,    // (n_tri * SLOTS, TC_TERMS) per half tile
               const float* __restrict__ obs,    // (K, K) observed counts
               const float* __restrict__ pvec,   // (N_PARAMS,)
               float* __restrict__ partial,      // (B, n_tri * SLOTS)
               int* __restrict__ next_item,      // ticket counter, 0 at launch
               int B, int K, int n_rb, int n_tri, int cs, int n_chunks, int n_items) {
  __shared__ float s_ob[ROWS * TILE];
  __shared__ RowVals s_row[CAND_MAX][ROWS];
  __shared__ ColVals s_col[CAND_MAX][TILE];
  __shared__ float2 s_rfac[ROWS];            // (la, v_inter accu / nfpb) of the item's rows
  __shared__ float2 s_cfac[TILE];            // (la, accu) of its columns
  __shared__ double s_tc[TC_TERMS];          // its half tile's pure-trans sums
  __shared__ float s_warp[CAND_MAX][WARPS];  // warp sums of the last item
  __shared__ float s_affine[CAND_MAX];       // its pure-trans partials
  __shared__ int s_cells[CAND_MAX];          // 1: the candidate's item went cell by cell
  __shared__ int s_item;

  const RippeCell p(pvec);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_part = n_tri * SLOTS;
  const float* ob_lane = s_ob + warp * TILE + lane;   // this lane's cells of row q: + 8q TILE + 32j
  // the item whose partials wait in shared memory: its first candidate,
  // its candidate count and its partial slot
  int last_b0 = 0, last_nb = 0, last_slot = 0;

  for (;;) {
    if (tid == 0) s_item = atomicAdd(next_item, 1);
    __syncthreads();   // the previous item's readers are done with shared memory
    const int item = s_item;
    if (tid < last_nb) {
      float* out = partial + (size_t)(last_b0 + tid) * n_part + last_slot;
      if (s_cells[tid]) flush_partial(s_warp[tid], out);
      else *out = s_affine[tid];
    }
    if (item >= n_items) break;
    const Item it = decode_item(item, 1, n_chunks, cs);
    const int half = it.half;
    const int t = it.tile;
    const int b0 = it.first;
    const int nb = min(cs, B - b0);
    int bi, bj;
    band_coords(t, n_rb, &bi, &bj);
    const int i0 = bi * TILE + half * ROWS;         // first row of the item
    const int j0 = bj * TILE;
    const int slot = t * SLOTS + half;

    if (tid < ROWS) {
      const int rg = i0 + tid;
      s_rfac[tid] = rg < K ? make_float2(la[rg], p.v_inter * ra[rg]) : make_float2(0.0f, 0.0f);
    } else if (tid < ROWS + TILE) {
      const int cg = j0 + tid - ROWS;
      s_cfac[tid - ROWS] = cg < K ? make_float2(la[cg], acc[cg]) : make_float2(0.0f, 0.0f);
    } else if (tid < ROWS + TILE + TC_TERMS) {
      s_tc[tid - ROWS - TILE] = tc[(size_t)slot * TC_TERMS + tid - ROWS - TILE];
    }
    for (int e = tid; e < nb * ROWS; e += THREADS) {
      const int k = e / ROWS;
      const int u = e - k * ROWS;
      const int rg = i0 + u;
      if (rg < K) {
        const size_t o = (size_t)(b0 + k) * K + rg;
        s_row[k][u] = RowVals{mid[o], circ[o] == 1.0f ? stot[o] : -1.0f, idc[o]};
      }
    }
    for (int e = tid; e < nb * TILE; e += THREADS) {
      const int k = e / TILE;
      const int v = e - k * TILE;
      const int cg = j0 + v;
      if (cg < K) {
        const size_t o = (size_t)(b0 + k) * K + cg;
        s_col[k][v] = ColVals{mid[o], idc[o]};
      }
    }
    __syncthreads();

    // the pure-trans test: does any row of the item share a contig with
    // any column? (rows and columns beyond K excluded)
    const int n_r = min(ROWS, K - i0);
    bool col_ok[COLS_PER_LANE];
#pragma unroll
    for (int j = 0; j < COLS_PER_LANE; ++j) col_ok[j] = j0 + lane + 32 * j < K;
    int need = 0;
    for (int k = warp; k < nb; k += WARPS) {
      int cid[COLS_PER_LANE];
#pragma unroll
      for (int j = 0; j < COLS_PER_LANE; ++j) cid[j] = s_col[k][lane + 32 * j].idc;
      bool hit = false;
#pragma unroll 4
      for (int u = 0; u < n_r; ++u) {
        const int rid = s_row[k][u].idc;
#pragma unroll
        for (int j = 0; j < COLS_PER_LANE; ++j) hit |= col_ok[j] && rid == cid[j];
      }
      const int same = __any_sync(0xffffffffu, hit);
      if (lane == 0) {
        s_cells[k] = same;
        if (!same)
          s_affine[k] = (float)((double)p.log_v * s_tc[0] + s_tc[1] - (double)p.v_inter * s_tc[2]);
      }
      need |= same;
    }
    if (__syncthreads_or(need)) {   // else every candidate is pure-trans: no cell, no obs read
      for (int e = tid; e < ROWS * TILE; e += THREADS) {
        const int rg = i0 + e / TILE;
        const int cg = j0 + e % TILE;
        s_ob[e] = (rg < K && cg < K) ? obs[(size_t)rg * K + cg] : 0.0f;
      }
      __syncthreads();

      float2 cf[COLS_PER_LANE];
#pragma unroll
      for (int j = 0; j < COLS_PER_LANE; ++j) cf[j] = s_cfac[lane + 32 * j];
      for (int k = 0; k < nb; ++k) {
        if (!s_cells[k]) continue;   // block-uniform
        ColVals cv[COLS_PER_LANE];
#pragma unroll
        for (int j = 0; j < COLS_PER_LANE; ++j) cv[j] = s_col[k][lane + 32 * j];
        const RowVals* rows = &s_row[k][warp];
        const float2* rfac = s_rfac + warp;
        float sum = 0.0f;
#pragma unroll Q_UNROLL
        for (int q = 0; q < ROWS_PER_WARP; ++q) {
          const int row_g = i0 + warp + WARPS * q;
          const RowVals u = rows[WARPS * q];
          const float2 rf = rfac[WARPS * q];
#pragma unroll
          for (int j = 0; j < COLS_PER_LANE; ++j) {
            const int col_g = j0 + lane + 32 * j;
            if (!(col_ok[j] && col_g > row_g)) continue;
            const float la_pair = (rf.x + cf[j].x) - p.log_nfpb;
            const float s = fabsf(u.mid - cv[j].mid);
            float log_e, e;
            if (u.idc == cv[j].idc && s > 0.0f && s < p.d_max) {
              log_e = p.log_cis(s, u.cst >= 0.0f, u.cst) + la_pair;
              e = expf(log_e);
            } else {   // trans, or same contig outside (0, d_max): e0 = v_inter
              log_e = p.log_v + la_pair;
              e = rf.y * cf[j].y;
            }
            sum += ob_lane[WARPS * TILE * q + 32 * j] * log_e - e;
          }
        }
        sum = warp_sum(sum);
        if (lane == 0) s_warp[k][warp] = sum;
      }
    }
    last_b0 = b0;
    last_nb = nb;
    last_slot = slot;
  }
}

// One warp per candidate: its partials summed in f64 in a fixed order,
// plus the observation constant.
__global__ void __launch_bounds__(REDUCE_WARPS * 32)
ll_dense_reduce(const float* __restrict__ partial, int B, int n_part, double obs_const,
                float* __restrict__ out, int* __restrict__ next_item) {   // reset for the next launch
  const int b = blockIdx.x * REDUCE_WARPS + (threadIdx.x >> 5);
  if (blockIdx.x == 0 && threadIdx.x == 0) *next_item = 0;
  if (b >= B) return;
  const double tot = warp_sum_f64(partial + (size_t)b * n_part, n_part);
  if ((threadIdx.x & 31) == 0) out[b] = (float)(tot + obs_const);
}

int row_blocks(int K) { return (K + TILE - 1) / TILE; }

}  // namespace

extern "C" {

// Upper-triangle tiles of a K x K grid.
int ll_dense_n_tiles(int K) {
  const int n_rb = row_blocks(K);
  return n_rb * (n_rb + 1) / 2;
}

int ll_dense_slots() { return SLOTS; }

int ll_dense_max_chunk() { return CAND_MAX; }

// Once per process: prefer shared memory over L1 and write the blocks of
// ll_dense_items that stay resident on one SM.
int ll_dense_configure(int* blocks_per_sm) {
  const cudaError_t err = prefer_shared(ll_dense_items);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, ll_dense_items,
                                                            THREADS, 0);
}

// Score B candidates: la, ra (accu / nfpb) and acc (accu) are (K,) f32, tc
// the (ll_dense_n_tiles(K) * ll_dense_slots(), 3) f64 pure-trans sums of
// each half tile, partial (B, ll_dense_n_tiles(K) * ll_dense_slots()) f32
// scratch, out (B,) f32, next_item a device int that is 0 before the launch
// (and is 0 again after it: launches that share it must be ordered on one
// stream). `cs` candidates per item and `grid` persistent blocks come from
// the caller's plan (ops/persistent.py). Launches on `stream`, does not
// synchronise, returns the cudaError_t of the launches (0 on success).
int ll_dense_score(const float* mid, const int* idc, const float* circ, const float* stot,
                   const float* la, const float* ra, const float* acc, const double* tc,
                   const float* obs, const float* pvec, float* partial, float* out,
                   int* next_item, int B, int K, double obs_const, int cs, int grid,
                   void* stream) {
  if (B <= 0 || K <= 0 || cs < 1 || cs > CAND_MAX || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_rb = row_blocks(K);
  const int n_tri = n_rb * (n_rb + 1) / 2;
  const int n_chunks = (B + cs - 1) / cs;
  const int n_items = n_chunks * n_tri * SLOTS;
  ll_dense_items<<<grid, THREADS, 0, s>>>(mid, idc, circ, stot, la, ra, acc, tc, obs, pvec,
                                          partial, next_item, B, K, n_rb, n_tri, cs, n_chunks,
                                          n_items);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ll_dense_reduce<<<(B + REDUCE_WARPS - 1) / REDUCE_WARPS, REDUCE_WARPS * 32, 0, s>>>(
      partial, B, n_tri * SLOTS, obs_const, out, next_item);
  return (int)cudaGetLastError();
}

}  // extern "C"
