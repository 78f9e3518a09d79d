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
// metrics' rows); a 4-chain delta step a few megabytes at most. Most
// entries are small: 20 of the dense EM store's 31 are 4-8 byte scalars.
//
// What the design does about it.
//  - One launch for all of a step's loads and one for all of its stores:
//    the table is passed by value (at most MAX_ENTRIES entries within the
//    4 KB kernel-parameter limit, read in place as a __grid_constant__).
//  - A warp a unit: an entry is cut into units of UNIT_WORDS words (32
//    lanes x LANE_WORDS), and a block's WARPS warps take WARPS consecutive
//    units, so an entry small enough for one warp takes a warp, not a
//    block, and the dense store's scalars share blocks. The wrapper lays
//    the units out on the host (`first`: each entry's first unit).
//  - A short lookup: a warp finds its entry by a binary search of the
//    compact `first` column at the head of the table (at most 6 loads for
//    64 entries, each one address for the whole warp, a broadcast from the
//    constant bank), in place of a walk through the entries one dependent
//    load at a time. Measured on the card against two ballots over the
//    column (lane l reading entries l and l + 32, so 32 addresses a load):
//    the search was 0.0001-0.0004 ms faster on every table, from 1 entry to
//    60 (PERF.md §6). The step index is loaded before the lookup, so
//    the two wait together.
//  - A lane loads its up to LANE_WORDS words before it stores any, 16, 8,
//    4, 2 or 1 bytes each, the widest that the entry's addresses, strides
//    and sizes allow.
//  - Order. The plain version copies in order, so where one entry reads or
//    writes what another writes (a new carry leaf that is a view of another
//    carry buffer, an output that is a view of a carry buffer), the result
//    depends on that order. The wrapper cuts the table there into launches
//    that run one after the other, so each launch's entries touch disjoint
//    bytes and the sequence equals the plain version's; an entry whose
//    source overlaps its own destination is refused. No path so far
//    aliases, so every step is one H2 and one H3 launch.
//  - Block 0's thread 0 adds one to the launch key's int64 counter
//    (ops/counts.py `LaunchCount.counter`), so no counting kernel runs
//    beside H2 or H3; every launch of a cut counts itself.
//
// Launch keys (ops/counts.py): "load", "store".

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LANE_WORDS = 4;                  // words a lane copies, at most
constexpr int UNIT_WORDS = 32 * LANE_WORDS;    // words a warp copies, at most
constexpr int MAX_ENTRIES = 64;

struct Entry {
  const char* src;
  char* dst;
  long long src_step;        // bytes added to src a step index (H2's inputs)
  long long dst_step;        // bytes added to dst a step index (H3's outputs)
  long long outer_stride;    // bytes between the source's runs
  long long inner;           // bytes a run; the destination is contiguous
  int outer;                 // runs of the source
  int log_w;                 // log2 of the word a lane copies
};

struct Table {
  const long long* step_in;  // the step the copies are at
  long long* step_out;       // written with *step_in + step_add, or nullptr
  long long step_add;
  unsigned long long* counter;   // the launch key's int64 counter
  int n;                     // entries
  int n_units;               // warp units of all entries
  int first[MAX_ENTRIES];    // each entry's first unit, ascending; INT_MAX past n
  Entry e[MAX_ENTRIES];
};

template <typename W>
__device__ __forceinline__ void copy_words(const Entry& e, const char* src, char* dst,
                                           long long q0, long long q1) {
  constexpr long long w = sizeof(W);
  const long long per_run = e.inner / w;
  W v[LANE_WORDS];
#pragma unroll
  for (int i = 0; i < LANE_WORDS; ++i) {
    const long long q = q0 + i * 32;
    if (q < q1) {
      const char* s;
      if (e.outer == 1) {
        s = src + q * w;
      } else {
        const long long r = q / per_run;
        s = src + r * e.outer_stride + (q - r * per_run) * w;
      }
      v[i] = *reinterpret_cast<const W*>(s);
    }
  }
#pragma unroll
  for (int i = 0; i < LANE_WORDS; ++i) {
    const long long q = q0 + i * 32;
    if (q < q1) *reinterpret_cast<W*>(dst + q * w) = v[i];
  }
}

__device__ __forceinline__ void copy_table(const Table& t) {
  const long long step = *t.step_in;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(t.counter, 1ULL);
    if (t.step_out != nullptr) *t.step_out = step + t.step_add;
  }
  const int unit = blockIdx.x * WARPS + static_cast<int>(threadIdx.x / 32);
  if (unit >= t.n_units) return;   // the same for the whole warp
  const int lane = threadIdx.x % 32;
  // the warp's entry, the last whose first unit is at or before its unit:
  // a binary search, each load one address for the whole warp
  int j = 0;
  for (int hi = t.n - 1; j < hi;) {
    const int mid = (j + hi + 1) / 2;
    if (t.first[mid] <= unit) j = mid; else hi = mid - 1;
  }
  const Entry& e = t.e[j];
  const long long words = (static_cast<long long>(e.outer) * e.inner) >> e.log_w;
  const long long q0 = static_cast<long long>(unit - t.first[j]) * UNIT_WORDS;
  const long long q1 = min(q0 + UNIT_WORDS, words);
  const char* src = e.src + step * e.src_step;
  char* dst = e.dst + step * e.dst_step;
  switch (e.log_w) {
    case 4: copy_words<uint4>(e, src, dst, q0 + lane, q1); break;
    case 3: copy_words<unsigned long long>(e, src, dst, q0 + lane, q1); break;
    case 2: copy_words<unsigned int>(e, src, dst, q0 + lane, q1); break;
    case 1: copy_words<unsigned short>(e, src, dst, q0 + lane, q1); break;
    default: copy_words<unsigned char>(e, src, dst, q0 + lane, q1); break;
  }
}

__global__ void __launch_bounds__(THREADS) scan_load_kernel(const __grid_constant__ Table t) {
  copy_table(t);
}

__global__ void __launch_bounds__(THREADS) scan_store_kernel(const __grid_constant__ Table t) {
  copy_table(t);
}

int check_table(const Table* t) {
  if (t->n < 0 || t->n > MAX_ENTRIES || t->n_units < 0 || t->counter == nullptr
      || (t->n == 0) != (t->n_units == 0))
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < MAX_ENTRIES; ++j) {
    if (j >= t->n) {
      if (t->first[j] != INT_MAX) return (int)cudaErrorInvalidValue;
      continue;
    }
    const Entry& e = t->e[j];
    if (e.log_w < 0 || e.log_w > 4) return (int)cudaErrorInvalidValue;
    const long long w = 1LL << e.log_w;
    const int next = j + 1 < t->n ? t->first[j + 1] : t->n_units;
    const long long words = (static_cast<long long>(e.outer) * e.inner) / w;
    if (e.outer < 1 || e.inner < w || e.inner % w != 0
        || (j == 0 && t->first[0] != 0)
        || static_cast<long long>(next - t->first[j]) != (words + UNIT_WORDS - 1) / UNIT_WORDS)
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

int blocks(const Table* t) { return t->n_units > 0 ? (t->n_units + WARPS - 1) / WARPS : 1; }

}  // namespace

extern "C" {

// sizeof the table and the kernels' constants, for the wrapper's checks of
// its ctypes mirror
int scan_table_size() { return (int)sizeof(Table); }
int scan_max_entries() { return MAX_ENTRIES; }
int scan_unit_words() { return UNIT_WORDS; }
int scan_warps() { return WARPS; }

// Each entry point launches its kernel on `stream` from the table the
// wrapper filled, does not synchronise, and returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a table it refuses).
int scan_load(const void* table, void* stream) {
  const Table* t = static_cast<const Table*>(table);
  if (int rc = check_table(t)) return rc;
  scan_load_kernel<<<blocks(t), THREADS, 0, (cudaStream_t)stream>>>(*t);
  return (int)cudaGetLastError();
}

int scan_store(const void* table, void* stream) {
  const Table* t = static_cast<const Table*>(table);
  if (int rc = check_table(t)) return rc;
  scan_store_kernel<<<blocks(t), THREADS, 0, (cudaStream_t)stream>>>(*t);
  return (int)cudaGetLastError();
}

}  // extern "C"
