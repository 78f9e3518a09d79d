// Copy-summing dense scorer for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_repeat_kernel` of
// graal_tpu/ops/likelihood_pallas.py (built there by
// `make_repeat_pallas_scorer`): the candidate scorer of copy-expanded
// (repeat) tables. For each of B candidate genomes it computes, over the
// data pairs s < t < S,
//
//     E[s,t] = sum_{u in copies(s), v in copies(t)} e0(u,v) * (a_u * a_v / nfpb)
//     pmf    = ob * log E - E - lf[s,t]   (ob > 0),   -E   (ob = 0),
//              0 when E = 0
//
// where a_u is the copy row's accu when its fragment is active and 0
// otherwise, e0 is max(exp(log_cis), v_inter) for a same-contig pair inside
// (0, d_max) (circular variant on circular rows) and v_inter otherwise, and
// lf is the precomputed log(ob!) plane. The whole pmf is evaluated: a cell
// whose copies are all inactive has E = 0 and contributes exactly nothing,
// so no observation constant can be folded out.
//
// What bounds it on the card. Like the repeat-free scorer (ll_dense.cu),
// arithmetic, not memory: per data cell a logf for the pmf, and per copy
// pair a logf, a divide and an expf when the pair is on one contig (an add
// when it is not), all as the accurate libm sequences (no --use_fast_math).
// At the flagship repeat table (S = 1,152 data subs, K = 1,188 copy rows,
// B = 130 candidates) that is 86 M data cells per call at ~1.06 copy pairs
// per cell, against 5.3 MB each of obs and lf.
//
// What the design does about it.
//  - The TPU kernel pads every data sub to mc copy slots and evaluates all
//    mc x mc slot pairs of every cell (4x the pair work at mc = 2 for 3%
//    duplicated subs). Here the wrapper hands over the copy-row vectors in
//    copy order (rows sorted by data sub), so the copies of data sub s are
//    the contiguous range [copy_start[s], copy_start[s+1]) and the copies of
//    a 64-sub block are one contiguous run. Each cell loops over its real
//    copy pairs only, usually 1 x 1.
//  - The grid is (upper-triangle 64 x 64 data tile, candidate chunk). A
//    block loads the obs and lf tiles and the copy ranges of its rows and
//    columns once, and per candidate only the copy vectors of its two
//    blocks of 64 subs (into dynamic shared memory sized by the wrapper for
//    the largest block).
//  - As in ll_dense.cu, nothing is accumulated across blocks: one f32
//    partial per (candidate, tile) after a fixed-shape reduction, and a
//    second kernel sums each candidate's partials in f64 in a fixed order.
//    No float atomics, so a candidate's score is bit-identical alone and in
//    any batch.

#include <cuda_runtime.h>

#include "scorer_common.cuh"

namespace {

constexpr int TILE = 64;            // tile edge (data subs)
constexpr int THREADS = 256;        // threads per block
constexpr int ROW_GROUPS = THREADS / TILE;            // 4
constexpr int ROWS_PER_THREAD = TILE / ROW_GROUPS;    // 16
constexpr int CAND_CHUNK = 13;      // candidates per block (EM batches are 13 m)
constexpr int REDUCE_THREADS = 256;
constexpr int FIELDS = 5;           // mid, stot, circ, a (f32), idc (int32)

// Copy vectors of one block of subs in shared memory, structure of arrays.
struct CopyBlock {
  float* mid;
  float* stot;
  float* circ;
  float* a;
  int* idc;

  __device__ __forceinline__ CopyBlock(float* base, int cap)
      : mid(base), stot(base + cap), circ(base + 2 * cap), a(base + 3 * cap),
        idc(reinterpret_cast<int*>(base + 4 * cap)) {}

  __device__ __forceinline__ void load(int e, size_t o, const float* __restrict__ g_mid,
                                       const float* __restrict__ g_stot,
                                       const float* __restrict__ g_circ,
                                       const float* __restrict__ g_a,
                                       const int* __restrict__ g_idc) {
    mid[e] = g_mid[o];
    stot[e] = g_stot[o];
    circ[e] = g_circ[o];
    a[e] = g_a[o];
    idc[e] = g_idc[o];
  }
};

__global__ void __launch_bounds__(THREADS)
ll_repeat_tiles(const float* __restrict__ mid,   // (B, K) copy-row midpoints (kb), copy order
                const int* __restrict__ idc,     // (B, K) contig id
                const float* __restrict__ circ,  // (B, K) 1.0 on circular contigs
                const float* __restrict__ stot,  // (B, K) contig length (kb)
                const float* __restrict__ a,     // (B, K) accu if active, else 0
                const int* __restrict__ copy_start,  // (S + 1,) copy ranges
                const float* __restrict__ obs,   // (S, S) observed counts
                const float* __restrict__ lf,    // (S, S) log(ob!)
                const float* __restrict__ pvec,  // (N_PARAMS,)
                float nfpb, float* __restrict__ partial,  // (B, n_tri)
                int B, int S, int K, int n_rb, int n_tri, int max_blk) {
  __shared__ float s_obs[TILE][TILE];
  __shared__ float s_lf[TILE][TILE];
  __shared__ int s_rs[TILE + 1];   // local copy range of each tile row
  __shared__ int s_cs[TILE + 1];   // ... and column
  __shared__ float s_red[THREADS / 32];
  extern __shared__ float s_copies[];  // row block, then column block

  const int t = blockIdx.x;
  int bi, bj;
  tile_coords(t, n_rb, &bi, &bj);
  const int i0 = bi * TILE;
  const int j0 = bj * TILE;
  const int tid = threadIdx.x;
  const int col = tid % TILE;
  const int rg = tid / TILE;
  const int col_g = j0 + col;
  const bool col_ok = col_g < S;

  const RippeCell p(pvec);
  CopyBlock rows(s_copies, max_blk);
  CopyBlock cols(s_copies + FIELDS * max_blk, max_blk);

  // candidate-independent: obs / lf tiles and the copy ranges
  for (int e = tid; e < TILE * TILE; e += THREADS) {
    const int r = e / TILE;
    const int c = e % TILE;
    const int rgl = i0 + r;
    const int cgl = j0 + c;
    const bool ok = rgl < S && cgl < S;
    const size_t o = (size_t)rgl * S + cgl;
    s_obs[r][c] = ok ? obs[o] : 0.0f;
    s_lf[r][c] = ok ? lf[o] : 0.0f;
  }
  const int r_base = copy_start[i0];
  const int c_base = copy_start[j0];
  if (tid <= TILE) {
    s_rs[tid] = copy_start[min(i0 + tid, S)] - r_base;
    s_cs[tid] = copy_start[min(j0 + tid, S)] - c_base;
  }
  __syncthreads();
  const int n_r = s_rs[TILE];
  const int n_c = s_cs[TILE];
  const int v0 = col_ok ? s_cs[col] : 0;
  const int v1 = col_ok ? s_cs[col + 1] : 0;

  const int b_end = min(B, (int)(blockIdx.y + 1) * CAND_CHUNK);
  for (int b = blockIdx.y * CAND_CHUNK; b < b_end; ++b) {
    __syncthreads();  // previous candidate's readers are done with the copies
    const size_t ob = (size_t)b * K;
    for (int e = tid; e < n_r; e += THREADS)
      rows.load(e, ob + r_base + e, mid, stot, circ, a, idc);
    for (int e = tid; e < n_c; e += THREADS)
      cols.load(e, ob + c_base + e, mid, stot, circ, a, idc);
    __syncthreads();

    float acc = 0.0f;
#pragma unroll 2
    for (int k = 0; k < ROWS_PER_THREAD; ++k) {
      const int r = rg + ROW_GROUPS * k;
      const int row_g = i0 + r;
      if (!(col_g > row_g && row_g < S && col_ok)) continue;
      float e_tot = 0.0f;
      for (int u = s_rs[r]; u < s_rs[r + 1]; ++u) {
        const float mu = rows.mid[u];
        const float su = rows.stot[u];
        const bool cu = rows.circ[u] == 1.0f;
        const float au = rows.a[u];
        const int iu = rows.idc[u];
        for (int v = v0; v < v1; ++v) {
          const float e0 = (iu == cols.idc[v]) ? p.cis(fabsf(mu - cols.mid[v]), cu, su)
                                               : p.v_inter;
          e_tot += e0 * ((au * cols.a[v]) / nfpb);
        }
      }
      if (e_tot > 0.0f) {
        const float ob_rc = s_obs[r][col];
        acc += (ob_rc > 0.0f) ? ob_rc * logf(e_tot) - e_tot - s_lf[r][col] : -e_tot;
      }
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
ll_repeat_reduce(const float* __restrict__ partial, int n_tri, float* __restrict__ out) {
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
  if (tid == 0) out[b] = (float)s_acc[0];
}

int row_blocks(int S) { return (S + TILE - 1) / TILE; }

}  // namespace

extern "C" {

// Number of f32 partials per candidate the caller allocates for S data subs.
int ll_repeat_n_tiles(int S) {
  const int n_rb = row_blocks(S);
  return n_rb * (n_rb + 1) / 2;
}

// Dynamic shared memory of a launch whose largest 64-sub block holds
// max_blk copy rows (bytes).
int ll_repeat_smem_bytes(int max_blk) { return 2 * FIELDS * max_blk * (int)sizeof(float); }

// Score B candidates: the (B, K) copy vectors are in copy order (the
// copies of data sub s at [copy_start[s], copy_start[s+1])), partial is
// (B, ll_repeat_n_tiles(S)) f32 scratch, out is (B,) f32. max_blk is the
// largest copy count of any block of 64 data subs. Launches on `stream`,
// does not synchronise, returns the cudaError_t of the launches.
int ll_repeat_score(const float* mid, const int* idc, const float* circ,
                    const float* stot, const float* a, const int* copy_start,
                    const float* obs, const float* lf, const float* pvec,
                    float nfpb, float* partial, float* out, int B, int S, int K,
                    int max_blk, void* stream) {
  if (B <= 0 || S <= 0 || K < S || max_blk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = ll_repeat_smem_bytes(max_blk);
  cudaError_t err = cudaFuncSetAttribute(
      ll_repeat_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_rb = row_blocks(S);
  const int n_tri = n_rb * (n_rb + 1) / 2;
  const dim3 grid(n_tri, (B + CAND_CHUNK - 1) / CAND_CHUNK);
  ll_repeat_tiles<<<grid, THREADS, smem, s>>>(mid, idc, circ, stot, a, copy_start, obs,
                                              lf, pvec, nfpb, partial, B, S, K, n_rb,
                                              n_tri, max_blk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ll_repeat_reduce<<<B, REDUCE_THREADS, 0, s>>>(partial, n_tri, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
