// A captured cycle's per-step inputs, outputs and carry, for NVIDIA Hopper
// (sm_90a): H2 (the load of a call's first step) and H3 (a step's store
// and the next step's load, in one launch), for every core.graphs.Scan
// (every sampler cycle and the runners' cycle end).
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
// dst_step`, written contiguously. `step` is the scan's device step index
// idx, read by every block at its start:
//   H2 (once a call, before its first step): row idx (0) of every per-step
//       input buffer -> its fixed per-step slot;
//   H3 (once a step, after the body): every output leaf -> row idx of its
//       (capacity, ...) buffer; every new carry leaf that is not its buffer
//       -> its buffer; then row idx + 1 of every per-step input -> its slot
//       (the load entries, from `first_load` on, copy only while idx + 1 is
//       below the buffers' capacity: `load_last`); then idx = idx + 1.
// The plain sequence is the store, then the next step's load: an output or
// new carry leaf that lies in a slot (the dense EM body returns its f_a slot
// as a metric) is read by the wrapper from the slot's input buffer at row
// idx, which no entry writes, so the load may overwrite the slot in the
// same launch.
//
// The step index. H3 reads idx in every block and leaves idx + 1 for the
// next step, written once every block has read idx. A launch of one block
// writes it after a barrier. In a launch of more blocks each block, once
// all its threads have read idx (a barrier), takes a ticket
// (`__threadfence`, then an atomicAdd on the scan's int32 ticket cell); the
// one that draws the last ticket resets the cell to 0 and writes idx + 1.
// Only a table with `step_out` does this (H3's last launch of a step); H2
// writes no index.
//
// What bounds it on the card: bytes, and at these sizes latency. A dense EM
// step moves a few kilobytes (the state's 11 x n int32 fields and the
// metrics' rows); a 4-chain delta step a few megabytes at most. Most
// entries are small: 20 of the dense EM store's 31 are 4-8 byte scalars. At
// these sizes a launch costs about as much as its copies, so the step's
// load rides in its store's launch: one launch a step of a graph, not two.
//
// What the design does about it.
//  - One launch for all of a step's stores and the next step's loads: the
//    table is passed by value (at most MAX_ENTRIES entries within the 4 KB
//    kernel-parameter limit, read in place as a __grid_constant__).
//  - A warp a unit: an entry is cut into units of UNIT_WORDS words (32
//    lanes x LANE_WORDS), and a block's warps take consecutive units, so an
//    entry small enough for one warp takes a warp, not a block, and the
//    dense store's scalars share blocks. The wrapper lays the units out on
//    the host (`first`: each entry's first unit). A launch takes as few
//    blocks as hold its units at MAX_WARPS warps a block, the units spread
//    evenly over them (`launch_blocks`, `launch_warps`): a table of up to
//    32 units (every delta step's, the cycle end's) is one block, whose
//    index needs no ticket; the dense EM step's 37 are two blocks of 19
//    warps. Measured against blocks of 8 warps with a ticket in every
//    launch (PERF.md §6).
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
//    source overlaps its own destination is refused. No sampler's step
//    aliases once slot sources are read from their rows, so every step is
//    one H3 launch.
//  - Block 0's thread 0 adds one to the launch key's int64 counter
//    (ops/counts.py `LaunchCount.counter`), so no counting kernel runs
//    beside H2 or H3; every launch of a cut counts itself.
//
// Launch keys (ops/counts.py): "load" (H2), "store" (H3).

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int MAX_WARPS = 32;                  // warps (units) a block, at most
constexpr int LANE_WORDS = 4;                  // words a lane copies, at most
constexpr int UNIT_WORDS = 32 * LANE_WORDS;    // words a warp copies, at most
constexpr int MAX_ENTRIES = 64;

struct Entry {
  const char* src;
  char* dst;
  long long src_step;        // bytes added to src a step index (inputs, slot sources)
  long long dst_step;        // bytes added to dst a step index (outputs)
  long long outer_stride;    // bytes between the source's runs
  long long inner;           // bytes a run; the destination is contiguous
  int outer;                 // runs of the source
  int log_w;                 // log2 of the word a lane copies
};

struct Table {
  const long long* step_in;  // the step the copies are at (the scan's idx)
  long long* step_out;       // written with *step_in + 1 by the last block, or nullptr
  unsigned int* ticket;      // with step_out: the blocks done (0 between launches)
  long long load_last;       // entries from first_load on copy only at a step <= load_last
  unsigned long long* counter;   // the launch key's int64 counter
  int n;                     // entries
  int n_units;               // warp units of all entries
  int first_load;            // the first load entry (n: none)
  int pad;
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
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(t.counter, 1ULL);
  const int warps = static_cast<int>(blockDim.x / 32);
  const int unit = blockIdx.x * warps + static_cast<int>(threadIdx.x / 32);
  if (unit < t.n_units) {   // the same for the whole warp
    const int lane = threadIdx.x % 32;
    // the warp's entry, the last whose first unit is at or before its unit:
    // a binary search, each load one address for the whole warp
    int j = 0;
    for (int hi = t.n - 1; j < hi;) {
      const int mid = (j + hi + 1) / 2;
      if (t.first[mid] <= unit) j = mid; else hi = mid - 1;
    }
    const Entry& e = t.e[j];
    if (j < t.first_load || step <= t.load_last) {
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
  }
  if (t.step_out != nullptr) {
    // idx + 1 once every block has read idx (every thread of a block read it
    // before the barrier): at once in a launch of one block, else by the
    // block that finishes last
    __syncthreads();
    if (threadIdx.x == 0) {
      if (gridDim.x == 1) {
        *t.step_out = step + 1;
      } else {
        __threadfence();
        if (atomicAdd(t.ticket, 1u) == gridDim.x - 1) {
          *t.ticket = 0;
          *t.step_out = step + 1;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(MAX_WARPS * 32)
scan_load_kernel(const __grid_constant__ Table t) {
  copy_table(t);
}

__global__ void __launch_bounds__(MAX_WARPS * 32)
scan_store_kernel(const __grid_constant__ Table t) {
  copy_table(t);
}

int check_table(const Table* t) {
  if (t->n < 0 || t->n > MAX_ENTRIES || t->n_units < 0 || t->counter == nullptr
      || (t->n == 0) != (t->n_units == 0) || t->first_load < 0 || t->first_load > t->n
      || (t->step_out != nullptr && t->ticket == nullptr))
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

// A launch's blocks: as few as hold the units at MAX_WARPS a block; and its
// warps a block: the units spread evenly over them (one for none)
int launch_blocks(const Table* t) {
  return t->n_units > 0 ? (t->n_units + MAX_WARPS - 1) / MAX_WARPS : 1;
}
int launch_warps(const Table* t) {
  const int b = launch_blocks(t);
  return t->n_units > 0 ? (t->n_units + b - 1) / b : 1;
}

}  // namespace

extern "C" {

// sizeof the table and the kernels' constants, for the wrapper's checks of
// its ctypes mirror
int scan_table_size() { return (int)sizeof(Table); }
int scan_max_entries() { return MAX_ENTRIES; }
int scan_unit_words() { return UNIT_WORDS; }
int scan_max_warps() { return MAX_WARPS; }

// Each entry point launches its kernel on `stream` from the table the
// wrapper filled, does not synchronise, and returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a table it refuses).
int scan_load(const void* table, void* stream) {
  const Table* t = static_cast<const Table*>(table);
  if (int rc = check_table(t)) return rc;
  scan_load_kernel<<<launch_blocks(t), 32 * launch_warps(t), 0, (cudaStream_t)stream>>>(*t);
  return (int)cudaGetLastError();
}

int scan_store(const void* table, void* stream) {
  const Table* t = static_cast<const Table*>(table);
  if (int rc = check_table(t)) return rc;
  scan_store_kernel<<<launch_blocks(t), 32 * launch_warps(t), 0, (cudaStream_t)stream>>>(*t);
  return (int)cudaGetLastError();
}

}  // extern "C"
