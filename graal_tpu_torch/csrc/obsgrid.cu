// Window observed-count grid of the delta engine, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_obsgrid_kernel` of
// graal_tpu/ops/obsgrid_pallas.py (built there by `make_window_obs_grid`).
// For each of M neighbour slots it densifies the CSR windows of the R mini
// sub rows into the R x R observed grid,
//
//     ob[m, r, j] = sum_{e in window(keys[m, r])} vals[e] * (cols[e] == keys[m, j])
//
// where the window of key k is the CSR row [row_start[k], row_start[k+1])
// of the observed map and a key of -1 has no window and matches no column.
// It writes the strict upper triangle (j > r) and zeros elsewhere: the
// mini-grid scorer reads the upper triangle (and the diagonal tiles' lower
// cells before it masks them), so the lower part is written too. The
// caller folds activity into the keys (an inactive sub row gets -1), so
// the grid comes out masked.
//
// What bounds it on the card. The TPU kernel compares every window entry
// with every key: R * cap * R compare-adds (190 M per neighbour at R =
// 1,024, cap = 180). The useful work is one lookup per entry of the R
// windows. What is left is moving bytes: reading those CSR entries (8
// bytes each) and writing the dense grid (R * R * 4 bytes, 4 MB per
// neighbour at R = 1,024), which bounds the kernel.
//
// What the design does about it.
//  - The CSR map is read in place: a row's window is a contiguous run of
//    (cols, vals), read coalesced by its warp. No (M, R, cap) window
//    tensors are gathered beforehand and no keys are sorted.
//  - Each block owns one neighbour and a range of rows, and first builds
//    a key -> slot map of its neighbour in shared memory: an open-
//    addressing table of 16-bit slots (at least 2R entries, multiplicative
//    hashing, linear probing) filled with atomicCAS, the key of a slot read
//    from the staged keys. Keys may repeat (under the repeat engine's
//    data_keys two copies of a bin share one); a repeated key keeps one
//    entry, which ends up holding its smallest slot whatever the order of
//    the inserts, so the table never overflows or loops and a lookup is
//    deterministic: an entry whose column equals a repeated key goes to the
//    key's first slot, as in the plain version. The callers never send one
//    (the observed map of the single-copy rows holds no entry of a
//    multi-copy bin), so an entry still matches every slot of its key. The wrapper sizes the blocks' runs of
//    rows from the shapes so that the blocks fill the card once, each warp
//    taking at least two rows, and the map is built once per block.
//  - One warp per row, no block barrier per row: warp w takes rows w,
//    w + 8, ... of its block, clears its own row buffer in shared memory,
//    adds its window's entries into it with shared atomics and writes the
//    row out with 16-byte stores, ordered by its own __syncwarp()s.
//    Observed counts are integers held in f32, far below 2^24, so the sums
//    are exact in any order: atomics cannot change a bit, and the result
//    equals the one-hot contraction exactly.
//  - Every warp works at every R. Until this design a warp's buffer held
//    a whole row, so at R = 16,384 (64 KB of keys, a 64 KB table and a
//    64 KB row) one warp of eight had one and the others only built the
//    table. Now the wrapper gives all 8 warps a buffer of the widest range
//    of columns that fits beside the keys and the table: the whole row up
//    to R = 4,096 (as before), 2 ranges a row at 8,192 and 6 at 16,384.
//    A warp with a row in ranges looks up the slots of its window's
//    entries once (8 a lane, held in registers: a window of up to 256
//    entries, ~130 on the chr1-class map, costs one round of loads and not
//    one a range), keeps only those above the diagonal, and then, range
//    by range, clears its buffer, adds the entries of the range and writes
//    it out; a range on or below the diagonal, or a row without a window,
//    is written as zeros without a buffer. The two row loops are two
//    instances of one kernel (ranges or not), picked by the plan.
//  - Index widths: a slot is 16 bits (R < 65,535), a neighbour is
//    blockIdx.y (M <= 65,535), and every offset into the (M, R, R) grid
//    is a size_t product (5.4e9 cells at M = 20, R = 16,384); CSR offsets
//    are 64-bit.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned short EMPTY = 0xffff;     // a free table entry
constexpr unsigned HASH_MUL = 0x9E3779B1u;   // Fibonacci hashing

constexpr int HELD = 8;   // window entries a lane holds across a row's ranges
constexpr int MIN_BLOCKS = 5;   // resident blocks an SM the registers of a whole row must allow

__device__ __forceinline__ unsigned bucket(int key, int shift) {
  return ((unsigned)key * HASH_MUL) >> shift;
}

// The slot whose key is column c, or -1.
__device__ __forceinline__ int slot_of(int c, const unsigned short* s_tab, const int* s_keys,
                                       int shift, unsigned mask) {
  for (unsigned h = bucket(c, shift);; h = (h + 1) & mask) {
    const unsigned short s = s_tab[h];
    if (s == EMPTY) return -1;                            // no slot holds this column
    if (s_keys[s] == c) return s;
  }
}

// Zeros into x[0, n), 16 bytes a store when `vec` (x 16-byte aligned, n a
// multiple of 4), by the 32 lanes of a warp.
__device__ __forceinline__ void zero_range(float* x, int n, bool vec, int lane) {
  if (vec) {
    float4* x4 = reinterpret_cast<float4*>(x);
    for (int i = lane; i < n / 4; i += 32) x4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    for (int i = lane; i < n; i += 32) x[i] = 0.0f;
  }
}

// held: 0 when a warp's buffer holds a whole row; else the window entries
// a lane looks up once and holds in registers for all the ranges of a row.
// A whole row leaves room for several blocks an SM (their shared memory
// allows 5 at R = 1,024), a row in ranges for one.
template <int held>
__global__ void __launch_bounds__(THREADS, held > 0 ? 1 : MIN_BLOCKS)
obsgrid_rows(const long long* __restrict__ row_start,   // (n + 1,) CSR row offsets
             const int* __restrict__ cols,               // (nnz,) column ids
             const float* __restrict__ vals,             // (nnz,) counts
             const int* __restrict__ keys,               // (M, R) CSR row of each slot, or -1
             float* __restrict__ out,                    // (M, R, R)
             int R, int rows_per_block, int width, int log2cap) {
  extern __shared__ float4 smem4[];
  float* s_bufs = reinterpret_cast<float*>(smem4);                  // (WARPS, width)
  int* s_keys = reinterpret_cast<int*>(s_bufs + WARPS * width);     // (R,)
  unsigned short* s_tab = reinterpret_cast<unsigned short*>(s_keys + R);   // (1 << log2cap,)
  const unsigned mask = (1u << log2cap) - 1u;
  const int shift = 32 - log2cap;

  const int nbr = blockIdx.y;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(R, r0 + rows_per_block);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // the neighbour's key -> slot map
  const int* keys_n = keys + (size_t)nbr * R;
  for (int j = tid; j < R; j += THREADS) s_keys[j] = keys_n[j];
  for (int h = tid; h <= (int)mask; h += THREADS) s_tab[h] = EMPTY;
  __syncthreads();
  for (int j = tid; j < R; j += THREADS) {
    const int k = s_keys[j];
    if (k < 0) continue;
    for (unsigned h = bucket(k, shift);; h = (h + 1) & mask) {
      unsigned short prev = atomicCAS(&s_tab[h], EMPTY, (unsigned short)j);
      if (prev == EMPTY) break;                   // placed
      if (s_keys[prev] != k) continue;            // another key's entry: probe on
      // a repeated key (rare): an entry keeps its key, so it only ever
      // goes down to a smaller slot of the same key
      while (prev > j) {
        const unsigned short seen = atomicCAS(&s_tab[h], prev, (unsigned short)j);
        if (seen == prev) break;
        prev = seen;
      }
      break;
    }
  }
  __syncthreads();

  float* buf = s_bufs + warp * width;
  float4* buf4 = reinterpret_cast<float4*>(buf);
  const bool vec = (R & 3) == 0;   // then width and every range start are multiples of 4
  if constexpr (held == 0) {   // a whole row a buffer
    for (int r = r0 + warp; r < r1; r += WARPS) {
      zero_range(buf, width, vec, lane);
      __syncwarp();
      const int key = s_keys[r];
      if (key >= 0) {
        const long long e1 = row_start[key + 1];
        for (long long e = row_start[key] + lane; e < e1; e += 32) {
          const int s = slot_of(cols[e], s_tab, s_keys, shift, mask);
          if (s >= 0) atomicAdd(&buf[s], vals[e]);
        }
      }
      __syncwarp();
      float* orow = out + ((size_t)nbr * R + r) * R;
      if (vec) {
        float4* o4 = reinterpret_cast<float4*>(orow);
        for (int i = lane; i < R / 4; i += 32) {
          float4 x = buf4[i];
          const int j = 4 * i;
          x.x = j > r ? x.x : 0.0f;
          x.y = j + 1 > r ? x.y : 0.0f;
          x.z = j + 2 > r ? x.z : 0.0f;
          x.w = j + 3 > r ? x.w : 0.0f;
          o4[i] = x;
        }
      } else {
        for (int j = lane; j < R; j += 32) orow[j] = j > r ? buf[j] : 0.0f;
      }
      __syncwarp();   // the row is read out before the next row clears the buffer
    }
  } else {   // a row in ranges
    for (int r = r0 + warp; r < r1; r += WARPS) {
      float* orow = out + ((size_t)nbr * R + r) * R;
      const int key = s_keys[r];
      if (key < 0) {   // no window: a row of zeros
        zero_range(orow, R, vec, lane);
        continue;
      }
      // the slots (above the diagonal) and counts of the window's first
      // 32 * held entries, looked up once and held in registers
      const long long e0 = row_start[key], e1 = row_start[key + 1];
      int slot[held];
      float val[held];
#pragma unroll
      for (int i = 0; i < held; ++i) {
        const long long e = e0 + lane + 32 * i;
        slot[i] = -1;
        if (e < e1) {
          const int s = slot_of(cols[e], s_tab, s_keys, shift, mask);
          if (s > r) {
            slot[i] = s;
            val[i] = vals[e];
          }
        }
      }
      for (int lo = 0; lo < R; lo += width) {
        const int n = min(width, R - lo);
        if (lo + n <= r + 1) {   // every column j <= r
          zero_range(orow + lo, n, vec, lane);
          continue;
        }
        zero_range(buf, n, vec, lane);
        __syncwarp();
#pragma unroll
        for (int i = 0; i < held; ++i)
          if (slot[i] >= lo && slot[i] < lo + n) atomicAdd(&buf[slot[i] - lo], val[i]);
        for (long long e = e0 + 32 * held + lane; e < e1; e += 32) {   // the rest of the window
          const int s = slot_of(cols[e], s_tab, s_keys, shift, mask);
          if (s > r && s >= lo && s < lo + n) atomicAdd(&buf[s - lo], vals[e]);
        }
        __syncwarp();
        if (vec) {
          float4* o4 = reinterpret_cast<float4*>(orow + lo);
          for (int i = lane; i < n / 4; i += 32) o4[i] = buf4[i];
        } else {
          for (int i = lane; i < n; i += 32) orow[lo + i] = buf[i];
        }
        __syncwarp();   // the range is read out before the next one clears the buffer
      }
    }
  }
}

// The kernel instance of rows cut into n_ranges ranges.
auto rows_kernel(int n_ranges) { return n_ranges > 1 ? obsgrid_rows<HELD> : obsgrid_rows<0>; }

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) of a block whose warps each have a row
// buffer of `width` floats, on a grid of size R with a table of
// 1 << log2cap entries.
int obsgrid_smem_bytes(int R, int width, int log2cap) {
  return WARPS * width * (int)sizeof(float) + R * (int)sizeof(int) +
         (1 << log2cap) * (int)sizeof(unsigned short);
}

int obsgrid_warps() { return WARPS; }

// Once per process: allow both instances of obsgrid_rows all the dynamic
// shared memory a block of `device` may have, prefer shared memory over L1,
// and write that limit (bytes) to *smem_max.
int obsgrid_configure(int device, int* smem_max) {
  int optin = 0, limit = INT_MAX;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  for (int n_ranges = 1; n_ranges <= 2 && err == cudaSuccess; ++n_ranges) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, rows_kernel(n_ranges));
    const int left = optin - (int)attr.sharedSizeBytes;
    if (err == cudaSuccess && left < limit) limit = left;
  }
  for (int n_ranges = 1; n_ranges <= 2 && err == cudaSuccess; ++n_ranges) {
    err = cudaFuncSetAttribute(rows_kernel(n_ranges), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               limit);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(rows_kernel(n_ranges),
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return (int)err;
  *smem_max = limit;
  return 0;
}

// The blocks of obsgrid_rows (the instance of rows cut into n_ranges
// ranges) resident on one SM with `smem` bytes of dynamic shared memory
// each.
int obsgrid_occupancy(int smem, int n_ranges, int* blocks_per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, rows_kernel(n_ranges),
                                                            THREADS, smem);
}

// Densify the windows of M neighbours' R keys into out (M, R, R) f32: a
// grid of ceil(R / rows_per_block) x M blocks, each warp with a row buffer
// of `width` columns (a multiple of 4 when R is; a row is cut into
// ceil(R / width) ranges) and a table of 1 << log2cap entries (more than
// R), after obsgrid_configure. Launches on `stream`, does not synchronise,
// returns the cudaError_t of the launch.
int obsgrid(const long long* row_start, const int* cols, const float* vals, const int* keys,
            float* out, int M, int R, int rows_per_block, int width, int log2cap,
            void* stream) {
  if (M <= 0 || M > 65535 || R <= 0 || R >= EMPTY || rows_per_block < 1 || width < 1 ||
      width > R + 3 || ((R & 3) == 0 && (width & 3) != 0) || log2cap < 1 || log2cap > 16 ||
      (1 << log2cap) <= R)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((R + rows_per_block - 1) / rows_per_block, M);
  const auto kernel = rows_kernel((R + width - 1) / width);
  kernel<<<grid, THREADS, obsgrid_smem_bytes(R, width, log2cap),
           static_cast<cudaStream_t>(stream)>>>(row_start, cols, vals, keys, out, R,
                                                rows_per_block, width, log2cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
