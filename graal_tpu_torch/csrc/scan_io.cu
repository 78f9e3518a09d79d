// A captured cycle's per-step inputs, outputs and carry, for NVIDIA Hopper
// (sm_90a): H2 (load) and H3 (store), one launch each a step of every
// core.graphs.Scan (every sampler cycle and the runners' cycle end).
//
// Replaces no Pallas kernel: in the JAX package `lax.scan`
// (graal_tpu/core/mcmc.py:468 and every other cycle) slices the per-step
// inputs, stacks the per-step outputs and aliases the carry inside one XLA
// program. The plain torch versions (graal_tpu_torch/ops/scan_cuda.py
// `scan_load_plain`, `scan_store_plain`: the scan's step as it was) take one
// index_select a per-step input, one index_copy_ an output and one copy_ a
// new carry leaf: some forty kernels a dense EM step (6 inputs, 11 metrics,
// 20 carry leaves).
//
// The function. Every copy is an entry of a table of (source, destination,
// bytes) that the wrapper builds from the tensors' addresses: once at a
// capture (the graph's pool keeps its addresses), again each step when the
// body runs eagerly. An entry's source is `src + step * src_step`, read as
// `outer` runs of `inner` bytes `outer_stride` apart (a leaf at any strides
// that coalesce to at most two levels); its destination `dst + step *
// dst_step`, written contiguously. `step` is the scan's device step index:
//   H2: row `idx` of every per-step input buffer -> its fixed per-step slot,
//       and idx -> the step-local cell `step`;
//   H3: every output leaf -> row `step` of its (capacity, ...) buffer; every
//       new carry leaf that is not its buffer -> its buffer; idx = step + 1.
// Every block reads the step it copies at from a cell that no block of the
// same launch writes (H2 reads idx and writes the step cell; H3 reads the
// step cell and writes idx), so no block can see an advanced index.
//
// What bounds it on the card: bytes, and at these sizes latency. A dense EM
// step moves a few kilobytes (the state's 11 x n int32 fields and the
// metrics' rows); a 4-chain delta step a few megabytes at most.
//
// What the design does about it.
//  - One launch for all of a step's loads and one for all of its stores:
//    the table is passed by value (at most MAX_ENTRIES entries within the
//    4 KB kernel-parameter limit, read in place as a __grid_constant__), a
//    block a chunk of CHUNK_WORDS words of one entry, each entry's first
//    block in the table; a thread copies 16, 8, 4, 2 or 1 bytes at a time,
//    the widest that the entry's addresses, strides and sizes allow.
//  - Order. The plain version copies in order, so where one entry reads or
//    writes what another writes (a new carry leaf that is a view of another
//    carry buffer, an output that is a view of a carry buffer), the result
//    depends on that order. The wrapper cuts the table there into launches
//    that run one after the other, so each launch's entries touch disjoint
//    bytes and the sequence equals the plain version's; an entry whose
//    source overlaps its own destination is refused. No path so far
//    aliases, so every step is one H2 and one H3 launch.
//
// Launch keys (ops/counts.py): "load", "store".

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK_WORDS = 4 * THREADS;   // words a block copies, at most
constexpr int MAX_ENTRIES = 60;

struct Entry {
  const char* src;
  char* dst;
  long long src_step;        // bytes added to src a step index (H2's inputs)
  long long dst_step;        // bytes added to dst a step index (H3's outputs)
  long long outer;           // runs of the source
  long long outer_stride;    // bytes between them
  long long inner;           // bytes a run; the destination is contiguous
  int first_block;           // the entry's first block
  int log_w;                 // log2 of the word a thread copies
};

struct Table {
  const long long* step_in;  // the step the copies are at
  long long* step_out;       // written with *step_in + step_add, or nullptr
  long long step_add;
  int n;                     // entries
  int n_blocks;
  Entry e[MAX_ENTRIES];
};

template <typename W>
__device__ __forceinline__ void copy_words(const Entry& e, const char* src, char* dst,
                                           long long q0, long long q1) {
  const long long per_run = e.inner / static_cast<long long>(sizeof(W));
  for (long long q = q0 + threadIdx.x; q < q1; q += THREADS) {
    const char* s;
    if (e.outer == 1) {
      s = src + q * static_cast<long long>(sizeof(W));
    } else {
      const long long r = q / per_run;
      s = src + r * e.outer_stride + (q - r * per_run) * static_cast<long long>(sizeof(W));
    }
    *reinterpret_cast<W*>(dst + q * static_cast<long long>(sizeof(W))) =
        *reinterpret_cast<const W*>(s);
  }
}

__device__ __forceinline__ void copy_table(const Table& t) {
  const long long step = *t.step_in;
  if (t.step_out != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    *t.step_out = step + t.step_add;
  int j = 0;
  while (j + 1 < t.n && t.e[j + 1].first_block <= static_cast<int>(blockIdx.x)) ++j;
  if (j >= t.n) return;
  const Entry& e = t.e[j];
  const long long words = (e.outer * e.inner) >> e.log_w;
  const long long q0 = static_cast<long long>(blockIdx.x - e.first_block) * CHUNK_WORDS;
  const long long q1 = min(q0 + CHUNK_WORDS, words);
  const char* src = e.src + step * e.src_step;
  char* dst = e.dst + step * e.dst_step;
  switch (e.log_w) {
    case 4: copy_words<uint4>(e, src, dst, q0, q1); break;
    case 3: copy_words<unsigned long long>(e, src, dst, q0, q1); break;
    case 2: copy_words<unsigned int>(e, src, dst, q0, q1); break;
    case 1: copy_words<unsigned short>(e, src, dst, q0, q1); break;
    default: copy_words<unsigned char>(e, src, dst, q0, q1); break;
  }
}

__global__ void __launch_bounds__(THREADS) scan_load_kernel(const __grid_constant__ Table t) {
  copy_table(t);
}

__global__ void __launch_bounds__(THREADS) scan_store_kernel(const __grid_constant__ Table t) {
  copy_table(t);
}

int check_table(const Table* t) {
  if (t->n < 0 || t->n > MAX_ENTRIES || t->n_blocks < 1) return (int)cudaErrorInvalidValue;
  for (int j = 0; j < t->n; ++j) {
    const Entry& e = t->e[j];
    if (e.log_w < 0 || e.log_w > 4) return (int)cudaErrorInvalidValue;
    const long long w = 1LL << e.log_w;
    const int next = j + 1 < t->n ? t->e[j + 1].first_block : t->n_blocks;
    const long long words = (e.outer * e.inner) / w;
    if (e.outer < 1 || e.inner < w || e.inner % w != 0
        || (j == 0 && e.first_block != 0)
        || static_cast<long long>(next - e.first_block) * CHUNK_WORDS < words
        || static_cast<long long>(next - e.first_block - 1) * CHUNK_WORDS >= words)
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

extern "C" {

// sizeof the table and the kernels' constants, for the wrapper's checks of
// its ctypes mirror
int scan_table_size() { return (int)sizeof(Table); }
int scan_max_entries() { return MAX_ENTRIES; }
int scan_chunk_words() { return CHUNK_WORDS; }

// Each entry point launches its kernel on `stream` from the table the
// wrapper filled, does not synchronise, and returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a table it refuses).
int scan_load(const void* table, void* stream) {
  const Table* t = static_cast<const Table*>(table);
  if (int rc = check_table(t)) return rc;
  scan_load_kernel<<<t->n_blocks, THREADS, 0, (cudaStream_t)stream>>>(*t);
  return (int)cudaGetLastError();
}

int scan_store(const void* table, void* stream) {
  const Table* t = static_cast<const Table*>(table);
  if (int rc = check_table(t)) return rc;
  scan_store_kernel<<<t->n_blocks, THREADS, 0, (cudaStream_t)stream>>>(*t);
  return (int)cudaGetLastError();
}

}  // extern "C"
