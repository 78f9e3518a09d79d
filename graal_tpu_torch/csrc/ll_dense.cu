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
// What bounds it on the card. There is no matrix product: every cell of
// the pair grid costs a logf, a divide and an expf on a same-contig pair
// (about 3 SFU-class operations, each expanded by the accurate libm
// sequence since the file is built without --use_fast_math), and an expf
// on a trans pair, for ~20 FP32 operations in all. At the flagship size
// (K = 1,152, B = 65) that is 43 M cells per call against 5.3 MB of obs,
// so the kernel is bound by the arithmetic of the transcendental
// sequences, not by memory, provided obs is read from device memory about
// once per call.
//
// What the design does about it.
//  - The grid is (upper-triangle tile, candidate chunk). A block loads its
//    64 x 64 obs tile into shared memory once and reuses it for all
//    candidates of its chunk, so obs is read from device memory (or L2,
//    which holds all of it at K = 1,152) once per chunk instead of once
//    per candidate.
//  - Only tiles of the upper triangle are launched; the diagonal tiles
//    mask s < t and the ragged edge is masked against K (no padding).
//  - Trans cells skip the log / divide path (branch per cell; warps are
//    row-uniform, so a warp diverges only where a contig boundary crosses
//    its 32 columns).
//  - Blocks run in any order and in parallel, so nothing is accumulated
//    across blocks: each block writes one f32 partial per (candidate,
//    tile) after a fixed-shape reduction, and a second kernel sums each
//    candidate's partials in a fixed order in f64. No float atomics, so a
//    candidate's score does not depend on B, on the chunking or on its
//    position in the batch.

#include <cuda_runtime.h>

#include "scorer_common.cuh"

namespace {

constexpr int TILE = 64;            // tile edge (cells)
constexpr int THREADS = 256;        // threads per block
constexpr int ROW_GROUPS = THREADS / TILE;            // 4
constexpr int ROWS_PER_THREAD = TILE / ROW_GROUPS;    // 16
constexpr int CAND_CHUNK = 13;      // candidates per block (EM batches are 13 m)
constexpr int REDUCE_THREADS = 256;

__global__ void __launch_bounds__(THREADS)
ll_dense_tiles(const float* __restrict__ mid,    // (B, K) sub-frag midpoints (kb)
               const int* __restrict__ idc,      // (B, K) contig id
               const float* __restrict__ circ,   // (B, K) 1.0 on circular contigs
               const float* __restrict__ stot,   // (B, K) contig length (kb)
               const float* __restrict__ la,     // (K,) log accu
               const float* __restrict__ obs,    // (K, K) observed counts
               const float* __restrict__ pvec,   // (N_PARAMS,)
               float* __restrict__ partial,      // (B, n_tri)
               int B, int K, int n_rb, int n_tri) {
  __shared__ float s_obs[TILE][TILE];
  __shared__ float s_la[TILE];
  __shared__ float s_mid[TILE];
  __shared__ int s_idc[TILE];
  __shared__ float s_circ[TILE];
  __shared__ float s_stot[TILE];
  __shared__ float s_red[THREADS / 32];

  const int t = blockIdx.x;
  int bi, bj;
  tile_coords(t, n_rb, &bi, &bj);
  const int i0 = bi * TILE;
  const int j0 = bj * TILE;
  const int tid = threadIdx.x;
  const int col = tid % TILE;
  const int rg = tid / TILE;
  const int col_g = j0 + col;
  const bool col_ok = col_g < K;

  const RippeCell p(pvec);

  // the obs tile and the (genome-independent) log accu rows, once per block
  for (int e = tid; e < TILE * TILE; e += THREADS) {
    const int r = e / TILE;
    const int c = e % TILE;
    const int rgl = i0 + r;
    const int cgl = j0 + c;
    s_obs[r][c] = (rgl < K && cgl < K) ? obs[(size_t)rgl * K + cgl] : 0.0f;
  }
  if (tid < TILE) s_la[tid] = (i0 + tid < K) ? la[i0 + tid] : 0.0f;
  const float la_c = col_ok ? la[col_g] : 0.0f;

  const int b_end = min(B, (int)(blockIdx.y + 1) * CAND_CHUNK);
  for (int b = blockIdx.y * CAND_CHUNK; b < b_end; ++b) {
    __syncthreads();  // previous candidate's readers are done with s_*
    if (tid < TILE) {
      const int rgl = i0 + tid;
      const bool ok = rgl < K;
      const size_t o = (size_t)b * K + rgl;
      s_mid[tid] = ok ? mid[o] : 0.0f;
      s_idc[tid] = ok ? idc[o] : 0;
      s_circ[tid] = ok ? circ[o] : 0.0f;
      s_stot[tid] = ok ? stot[o] : 1.0f;
    }
    const size_t oc = (size_t)b * K + col_g;
    const float mc = col_ok ? mid[oc] : 0.0f;
    const int idc_c = col_ok ? idc[oc] : 0;
    __syncthreads();

    float acc = 0.0f;
#pragma unroll 4
    for (int k = 0; k < ROWS_PER_THREAD; ++k) {
      const int r = rg + ROW_GROUPS * k;
      const int row_g = i0 + r;
      if (!(col_g > row_g && row_g < K && col_ok)) continue;
      const float la_pair = (s_la[r] + la_c) - p.log_nfpb;
      const float log_e0 = (s_idc[r] == idc_c)
          ? p.log_cis(fabsf(s_mid[r] - mc), s_circ[r] == 1.0f, s_stot[r])
          : p.log_v;
      const float log_e = log_e0 + la_pair;
      acc += s_obs[r][col] * log_e - expf(log_e);
    }

    // fixed-shape block reduction: warp butterfly, then warp sums in order
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if ((tid & 31) == 0) s_red[tid >> 5] = acc;
    __syncthreads();
    if (tid == 0) {
      float tot = 0.0f;
      for (int w = 0; w < THREADS / 32; ++w) tot += s_red[w];
      partial[(size_t)b * n_tri + t] = tot;
    }
  }
}

__global__ void __launch_bounds__(REDUCE_THREADS)
ll_dense_reduce(const float* __restrict__ partial, int n_tri, double obs_const,
                float* __restrict__ out) {
  __shared__ double s_acc[REDUCE_THREADS];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  double acc = 0.0;
  for (int t = tid; t < n_tri; t += REDUCE_THREADS)
    acc += (double)partial[(size_t)b * n_tri + t];
  s_acc[tid] = acc;
  __syncthreads();
  for (int w = REDUCE_THREADS / 2; w > 0; w >>= 1) {
    if (tid < w) s_acc[tid] += s_acc[tid + w];
    __syncthreads();
  }
  if (tid == 0) out[b] = (float)(s_acc[0] + obs_const);
}

int row_blocks(int K) { return (K + TILE - 1) / TILE; }

}  // namespace

extern "C" {

// Number of f32 partials per candidate the caller allocates for size K.
int ll_dense_n_tiles(int K) {
  const int n_rb = row_blocks(K);
  return n_rb * (n_rb + 1) / 2;
}

// Score B candidates: partial is (B, ll_dense_n_tiles(K)) f32 scratch,
// out is (B,) f32. Launches on `stream`, does not synchronise, returns the
// cudaError_t of the launches (0 on success).
int ll_dense_score(const float* mid, const int* idc, const float* circ,
                   const float* stot, const float* la, const float* obs,
                   const float* pvec, float* partial, float* out, int B, int K,
                   double obs_const, void* stream) {
  if (B <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_rb = row_blocks(K);
  const int n_tri = n_rb * (n_rb + 1) / 2;
  const dim3 grid(n_tri, (B + CAND_CHUNK - 1) / CAND_CHUNK);
  ll_dense_tiles<<<grid, THREADS, 0, s>>>(mid, idc, circ, stot, la, obs, pvec,
                                          partial, B, K, n_rb, n_tri);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ll_dense_reduce<<<B, REDUCE_THREADS, 0, s>>>(partial, n_tri, obs_const, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
