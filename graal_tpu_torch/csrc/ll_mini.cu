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
// would lose those cells to cancellation.
//
// What bounds it on the card. As in ll_dense.cu, the per-cell
// transcendental sequences (a logf, a divide and an expf on a same-contig
// cell, an expf on a trans cell; built without --use_fast_math), not
// memory: at the flagship bucket (R = 1,024, M = 5, C = 14) a call covers
// 36.7 M upper-triangle cells against 21 MB of observed grids.
//
// What the design does about it.
//  - One block per (upper-triangle 64 x 64 tile, neighbour). The block
//    loads the neighbour's obs tile into shared memory once and reuses it
//    for all C candidates, so each grid is read from device memory once per
//    call.
//  - Loops are bounded by R and mask the ragged edge: no padding.
//  - Trans cells skip the log / divide path, circular rows take the
//    circular formula: both branch per cell (the TPU kernel specialised
//    whole tiles instead).
//  - Blocks run in any order, so nothing is accumulated across blocks: each
//    block writes one f32 partial per (neighbour, candidate, tile) after a
//    fixed-shape reduction, and a second kernel sums each candidate's
//    partials in f64 in a fixed order. A candidate's score depends only on
//    its own inputs, in any batch.

#include <cuda_runtime.h>

#include "scorer_common.cuh"

namespace {

constexpr int TILE = 64;            // tile edge (cells)
constexpr int THREADS = 256;        // threads per block
constexpr int ROW_GROUPS = THREADS / TILE;            // 4
constexpr int ROWS_PER_THREAD = TILE / ROW_GROUPS;    // 16
constexpr int REDUCE_THREADS = 256;
constexpr int MAX_C = 64;           // candidates per neighbour (EM: 14)

__global__ void __launch_bounds__(THREADS)
ll_mini_tiles(const float* __restrict__ mid,    // (M, C, R) sub-row midpoints (kb)
              const int* __restrict__ idc,      // (M, C, R) contig id
              const float* __restrict__ circ,   // (M, C, R) 1.0 on circular contigs
              const float* __restrict__ stot,   // (M, C, R) contig length (kb)
              const float* __restrict__ la,     // (M, C, R) log accu, -1e9 if inactive
              const float* __restrict__ ob,     // (M, R, R) observed grid
              const float* __restrict__ pvec,   // (N_PARAMS,)
              float* __restrict__ partial,      // (M, C, n_tri)
              int C, int R, int n_rb, int n_tri) {
  __shared__ float s_ob[TILE][TILE];
  __shared__ float s_mid[TILE];
  __shared__ int s_idc[TILE];
  __shared__ float s_circ[TILE];
  __shared__ float s_stot[TILE];
  __shared__ float s_la[TILE];
  __shared__ float s_red[THREADS / 32];

  const int t = blockIdx.x;
  const int nbr = blockIdx.y;
  int bi, bj;
  tile_coords(t, n_rb, &bi, &bj);
  const int i0 = bi * TILE;
  const int j0 = bj * TILE;
  const int tid = threadIdx.x;
  const int col = tid % TILE;
  const int rg = tid / TILE;
  const int col_g = j0 + col;
  const bool col_ok = col_g < R;

  const RippeCell p(pvec);

  // the neighbour's obs tile, once per block
  const float* obn = ob + (size_t)nbr * R * R;
  for (int e = tid; e < TILE * TILE; e += THREADS) {
    const int r = e / TILE;
    const int c = e % TILE;
    const int rgl = i0 + r;
    const int cgl = j0 + c;
    s_ob[r][c] = (rgl < R && cgl < R) ? obn[(size_t)rgl * R + cgl] : 0.0f;
  }

  for (int c = 0; c < C; ++c) {
    const size_t base = ((size_t)nbr * C + c) * R;
    __syncthreads();  // previous candidate's readers are done with s_*
    if (tid < TILE) {
      const int rgl = i0 + tid;
      const bool ok = rgl < R;
      s_mid[tid] = ok ? mid[base + rgl] : 0.0f;
      s_idc[tid] = ok ? idc[base + rgl] : 0;
      s_circ[tid] = ok ? circ[base + rgl] : 0.0f;
      s_stot[tid] = ok ? stot[base + rgl] : 1.0f;
      s_la[tid] = ok ? la[base + rgl] : -1e9f;
    }
    const float mc = col_ok ? mid[base + col_g] : 0.0f;
    const int idc_c = col_ok ? idc[base + col_g] : 0;
    const float la_c = col_ok ? la[base + col_g] : -1e9f;
    __syncthreads();

    float acc = 0.0f;
#pragma unroll 4
    for (int k = 0; k < ROWS_PER_THREAD; ++k) {
      const int r = rg + ROW_GROUPS * k;
      const int row_g = i0 + r;
      if (!(col_g > row_g && row_g < R && col_ok)) continue;
      const float la_pair = (s_la[r] + la_c) - p.log_nfpb;
      const float log_e0 = (s_idc[r] == idc_c)
          ? p.log_cis(fabsf(s_mid[r] - mc), s_circ[r] == 1.0f, s_stot[r])
          : p.log_v;
      const float log_e = log_e0 + la_pair;
      acc += s_ob[r][col] * log_e - expf(log_e);
    }

    // fixed-shape block reduction: warp butterfly, then warp sums in order
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if ((tid & 31) == 0) s_red[tid >> 5] = acc;
    __syncthreads();
    if (tid == 0) {
      float tot = 0.0f;
      for (int w = 0; w < THREADS / 32; ++w) tot += s_red[w];
      partial[((size_t)nbr * C + c) * n_tri + t] = tot;
    }
  }
}

// One block per neighbour: each candidate's partials summed in f64 in a
// fixed tree, then scores and deltas against candidate 0 (the base).
__global__ void __launch_bounds__(REDUCE_THREADS)
ll_mini_reduce(const float* __restrict__ partial, int C, int n_tri,
               float* __restrict__ scores,      // (M, C)
               float* __restrict__ dll) {       // (M, C - 1)
  __shared__ double s_acc[REDUCE_THREADS];
  __shared__ double s_tot[MAX_C];
  const int nbr = blockIdx.x;
  const int tid = threadIdx.x;
  for (int c = 0; c < C; ++c) {
    const float* pc = partial + ((size_t)nbr * C + c) * n_tri;
    double acc = 0.0;
    for (int t = tid; t < n_tri; t += REDUCE_THREADS) acc += (double)pc[t];
    s_acc[tid] = acc;
    __syncthreads();
    for (int w = REDUCE_THREADS / 2; w > 0; w >>= 1) {
      if (tid < w) s_acc[tid] += s_acc[tid + w];
      __syncthreads();
    }
    if (tid == 0) s_tot[c] = s_acc[0];
    __syncthreads();
  }
  if (tid < C) {
    scores[(size_t)nbr * C + tid] = (float)s_tot[tid];
    if (tid > 0) dll[(size_t)nbr * (C - 1) + tid - 1] = (float)(s_tot[tid] - s_tot[0]);
  }
}

int row_blocks(int R) { return (R + TILE - 1) / TILE; }

}  // namespace

extern "C" {

// Number of f32 partials per (neighbour, candidate) for grid size R.
int ll_mini_n_tiles(int R) {
  const int n_rb = row_blocks(R);
  return n_rb * (n_rb + 1) / 2;
}

int ll_mini_max_candidates() { return MAX_C; }

// Score M x C mini-grid genomes: partial is (M, C, ll_mini_n_tiles(R)) f32
// scratch, scores (M, C) and dll (M, C - 1) f32 outputs. Launches on
// `stream`, does not synchronise, returns the cudaError_t of the launches.
int ll_mini_score(const float* mid, const int* idc, const float* circ,
                  const float* stot, const float* la, const float* ob,
                  const float* pvec, float* partial, float* scores, float* dll,
                  int M, int C, int R, void* stream) {
  if (M <= 0 || C < 1 || C > MAX_C || R <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_rb = row_blocks(R);
  const int n_tri = n_rb * (n_rb + 1) / 2;
  ll_mini_tiles<<<dim3(n_tri, M), THREADS, 0, s>>>(mid, idc, circ, stot, la, ob,
                                                   pvec, partial, C, R, n_rb, n_tri);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ll_mini_reduce<<<M, REDUCE_THREADS, 0, s>>>(partial, C, n_tri, scores, dll);
  return (int)cudaGetLastError();
}

}  // extern "C"
