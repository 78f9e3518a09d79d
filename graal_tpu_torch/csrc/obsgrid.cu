// Window observed-count grid of the delta engine, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_obsgrid_kernel` of
// graal_tpu/ops/obsgrid_pallas.py (built there by `make_window_obs_grid`).
// For each of M neighbour slots it densifies the CSR windows of the R mini
// sub rows into the R x R observed grid,
//
//     ob[m, r, j] = sum_w vals[m, r, w] * (cols[m, r, w] == keys[m, j])
//
// and writes its strict upper triangle (j > r; zeros elsewhere), the only
// part the scorer reads. Valid keys are distinct sub rows >= 0, invalid
// slots are -1, and window columns are >= 0 or -2 (no entry), so an entry
// matches at most one key and a negative column matches none.
//
// What bounds it on the card. The TPU kernel compares every window entry
// with every key: R * cap * R compare-adds (190 M per neighbour at R =
// 1,024, cap = 180). The useful work is R * cap entries, each matching at
// most one key. What is left is moving bytes: reading the windows
// (R * cap * 8 bytes) and writing the dense grid (R * R * 4 bytes, 4 MB per
// neighbour at R = 1,024), which bounds the kernel.
//
// What the design does about it.
//  - The wrapper hands over each neighbour's keys sorted, with their slots
//    (torch.sort as glue). A block of ROWS_PER_BLOCK rows of one neighbour
//    loads them into shared memory once; each window entry binary-searches
//    its column there (log2 R steps) instead of comparing with all R keys.
//  - A row is accumulated in a shared buffer of R floats with shared-memory
//    atomics, then written out coalesced (one float per thread and step).
//  - Observed counts are integers held in f32, far below 2^24, so the sum
//    is exact in any order: atomics and duplicate columns cannot change a
//    bit, and the result equals the one-hot contraction exactly.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = 8;

__global__ void __launch_bounds__(THREADS)
obsgrid_rows(const int* __restrict__ cols,    // (M, R, cap) window column ids
             const float* __restrict__ vals,  // (M, R, cap) window counts (0 if unused)
             const int* __restrict__ skeys,   // (M, R) keys sorted ascending
             const int* __restrict__ slots,   // (M, R) slot of each sorted key
             float* __restrict__ out,         // (M, R, R)
             int R, int cap) {
  extern __shared__ int smem[];
  int* s_keys = smem;                                       // R
  int* s_slot = smem + R;                                   // R
  float* s_row = reinterpret_cast<float*>(smem + 2 * R);    // R

  const int nbr = blockIdx.y;
  const int r0 = blockIdx.x * ROWS_PER_BLOCK;
  const int tid = threadIdx.x;
  for (int j = tid; j < R; j += THREADS) {
    s_keys[j] = skeys[(size_t)nbr * R + j];
    s_slot[j] = slots[(size_t)nbr * R + j];
  }

  const int r_end = min(R, r0 + ROWS_PER_BLOCK);
  for (int r = r0; r < r_end; ++r) {
    for (int j = tid; j < R; j += THREADS) s_row[j] = 0.0f;
    __syncthreads();  // keys loaded, row buffer cleared
    const size_t wb = ((size_t)nbr * R + r) * cap;
    for (int w = tid; w < cap; w += THREADS) {
      const int col = cols[wb + w];
      if (col < 0) continue;
      int lo = 0;
      int hi = R;
      while (lo < hi) {  // first key >= col
        const int mid = (lo + hi) >> 1;
        if (s_keys[mid] < col) lo = mid + 1; else hi = mid;
      }
      if (lo < R && s_keys[lo] == col) atomicAdd(&s_row[s_slot[lo]], vals[wb + w]);
    }
    __syncthreads();
    float* orow = out + ((size_t)nbr * R + r) * R;
    for (int j = tid; j < R; j += THREADS) orow[j] = j > r ? s_row[j] : 0.0f;
    __syncthreads();  // row written before the next row clears the buffer
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for grid size R (bytes).
int obsgrid_smem_bytes(int R) { return 3 * R * (int)sizeof(int); }

// Densify M neighbours' windows into out (M, R, R) f32. Launches on
// `stream`, does not synchronise, returns the cudaError_t of the launch.
int obsgrid(const int* cols, const float* vals, const int* skeys,
            const int* slots, float* out, int M, int R, int cap, void* stream) {
  if (M <= 0 || R <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  const int smem = obsgrid_smem_bytes(R);
  cudaError_t err = cudaFuncSetAttribute(
      obsgrid_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, M);
  obsgrid_rows<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      cols, vals, skeys, slots, out, R, cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
