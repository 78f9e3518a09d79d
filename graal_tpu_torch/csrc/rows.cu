// The delta engine's member rows and mini-states, for NVIDIA Hopper
// (sm_90a): the counts (G1), the ordered write of each neighbour slot's
// rows (G2) and the mini-state gather (G3) of one scoring call, every chain
// and neighbour slot at once.
//
// Replaces no Pallas kernel: the JAX package writes these as jnp code inside
// its jitted step (graal_tpu/core/delta.py `extract_rows` :100, whose
// `top_k` :116 XLA lowers to a full sort on a TPU; `extract_rows_union`
// :121 with its two `top_k`s :156, :168; `gather_mini` :179; and the step's
// `max_id`). The plain torch versions (graal_tpu_torch/core/delta.py
// `extract_rows_each_plain`, `extract_rows_union_plain`,
// `gather_mini_plain`, and the step's `id_c.amax(-1)`) take a (C, m, n)
// membership compare, torch.topk over the genome, and a (C, n, 11) stack of
// the genome every scoring call: some thirty to sixty kernels a step.
//
// The function, in both modes, for a chain c with contigs ka = id_c[f_a]
// and kb = id_c[ids[j]] of slot j, is an ordered stream compaction of the
// genome's n rows into three streams, written one after the other and cut
// at f_max:
//   A  the pair's members (id_c in {ka, kb}), ascending;
//   B  (union mode) the union's other members, ascending;
//   C  the other rows, ascending.
// valid is true on A. In union mode a contig with more than f_max members
// is out of the union (its pairs overflow anyway), so A holds only the
// pair's contigs that fit, and the union is that of ka and every slot's kb
// that fit; the plain version's union top-k of capacity min(n, (m + 1) x
// f_max) never truncates the union and never reaches past its f_max-th
// output, so its padding is the stream C above. In each mode B is empty.
// overflow is the counted membership of the pair (ka's count, plus kb's
// when kb != ka) above f_max in both modes. Contig ids of a genome are not
// -1 (they are made from non-negative ids by max_id + 1; negative ids mark
// the mini-states' padding), which the union's plain version relies on.
//
// What bounds it on the card: bytes, and at these sizes latency. A call
// reads each chain's id_c (0.4 MB at n = 100,000) and writes C x m x f_max
// rows (9 bytes each), then G3 reads 11 fields at those rows and writes
// them: about a megabyte a chain, a fraction of a microsecond at 3.35 TB/s.
// A block that walks a genome alone is latency-bound (one block a slot
// walking 100,000 rows takes tens of microseconds), so the genome is split
// into chunks across blocks.
//
// What the design does about it.
//  - G1 (`rows_counts_kernel`): one block a (chunk, chain). It counts,
//    over its chunk, the rows of each of the chain's m + 1 contig keys (ka,
//    then each slot's kb) at the contig's first place in the sorted keys
//    (its other places stay 0), and the chunk's largest id, and writes them
//    to scratch: the sorted keys (C, m + 1), counts (C, m + 1, n_chunks)
//    and the chunk maxima (C, n_chunks). A chunk's walk used to wait for
//    the keys' two dependent loads and their sort, and each of its passes
//    for the one before. Now every thread first issues all RPT loads of
//    its rows of the chunk's first pass (a warp's 32 consecutive ids a
//    load, so each coalesces), and they stay in flight while the keys load
//    and sort; the keys sort by a bitonic network over one warp's shuffles
//    up to 32 keys, by a rank a thread (m + 1 compares) up to THREADS keys,
//    and by a bitonic network in shared memory (sized from m + 1) above, so
//    no thread does (m + 1)^2 compares; then each step of a warp's 32 rows
//    finds the rows' places (a binary search a row) and merges the warp's
//    equal places by a match, one shared atomic a place, as many as
//    before. The chunk's maximum comes from the same registers. Chunks over
//    THREADS x RPT rows take more passes. RPT contiguous rows a thread
//    (16-byte loads, runs of one place folded, a reduce over each match's
//    lanes) and the shared-memory network at m + 1 = 81 were measured
//    slower (PERF.md §6).
//  - G2 (`rows_write_kernel`): one block a (chunk, slot, chain). Its
//    prologue issues every load that waits for nothing at once: the
//    slot's keys ka and kb, the chain's sorted keys into shared memory in
//    one coalesced read and, in union mode or where they are few
//    (every_place), every place's counts, summed over every chunk and over
//    the chunks before the block's own by a group of lanes a place; that
//    gives the union (the contigs that fit f_max) and its sums. One
//    barrier (a second one where only ka's and kb's places are summed, by
//    two warps, once the keys are in shared memory). Each stream's total
//    and the place of the chunk's first row in it follow; a chunk none of
//    whose streams can still land below f_max exits. A live block loads
//    its chunk (L2-resident: G1 has just read it) a pass of THREADS x RPT
//    rows at a time, RPT contiguous rows a thread (two 16-byte loads where
//    id_c is contiguous and aligned), all before any ranking; each thread
//    classes its rows into the three streams (by comparison with ka and
//    kb; union membership by a binary search of the shared keys) and counts
//    each class; one block scan of the three counts (warp shuffles, then
//    the warp totals: one barrier) gives each thread its first place in
//    each stream. The pass's rows go to shared memory in output order and,
//    after a barrier, consecutive threads write consecutive places (where
//    below f_max), so the stores coalesce. Every output place gets exactly
//    one row (the streams hold all n >= f_max rows). Block (0, slot,
//    chain) writes the slot's overflow, and block (0, 0, chain) the
//    chain's max_id from G1's chunk maxima. One block walking its chunk
//    for all m slots (a barrier a slot) was slower at every shape
//    measured, by 2-40x (PERF.md), and is not kept.
//  - Shared memory follows m + 1 (8 bytes a key in G1, its sorting width
//    padded to a power of two; 4 in G2, 12 more
//    for the place sums and 1 more in union mode), so any slot count up to
//    MAX_KEYS - 1 runs: every count D2 and E1 take (G2 opted in above 48
//    KB once a device, `rows_init`).
//  - G3 (`rows_gather_kernel`): one thread an output row: the 11 fields of
//    its genome row, read at their strides (no (C, n, 11) stack), the
//    padding's fills where the row is not valid (id_c -(slot + 2)), written
//    to one (11, C, m, f_max) int32 tensor.
//  - Three launches a scoring call however many chains, each counting
//    itself (block 0's thread 0 adds one to the launch key's int64 on the
//    card, ops/counts.py), on the current stream, with no host read, into
//    fresh outputs and scratch whose sizes follow (C, m, f_max, n) alone,
//    so a captured step (core.graphs.Scan) captures them. Integers only:
//    the output is the plain version's bit for bit, padding included.
//
// Launch keys (ops/counts.py): "counts" (G1), "write" (G2), "gather" (G3).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int N_WARPS = THREADS / 32;
constexpr int RPT = 8;             // G1 / G2: contiguous rows a thread a pass
constexpr int PASS = THREADS * RPT;  // G1 / G2: rows a block a pass (the wrapper's CHUNK)
// m + 1 contig keys a chain (fA's and one a neighbour slot), at most: D2
// (step.cu `neighbours`) takes at most 4,095 slots, E1 (mtm.cu) 64
constexpr int MAX_KEYS = 4096;
constexpr int N_FIELDS = 11;       // GenomeState's fields, in their order
constexpr int IDC = 1;             // id_c's place among them
constexpr unsigned FULL = 0xffffffffu;

// One extraction: C chains of m neighbour slots.
struct RowsArgs {
  const int* id_c;            // (C, n) at strides (id_cs, id_is)
  const long long* f_a;       // (C,) at stride fa_s
  const long long* ids;       // (C, m) contiguous
  int* counts;                // scratch (C, m + 1, n_chunks)
  int* cmax;                  // scratch (C, n_chunks)
  int* skeys;                 // scratch (C, m + 1): each chain's keys, ascending
  long long* rows;            // (C, m, f_max)
  unsigned char* valid;       // (C, m, f_max)
  unsigned char* overflow;    // (C, m)
  int* max_id;                // (C,)
  unsigned long long* counts_counter;  // the launch keys' int64s (ops/counts.py)
  unsigned long long* write_counter;
  long long id_cs, id_is, fa_s;
  int C, m, n, f_max, chunk, n_chunks, union_mode, pad;
};

// One mini-state gather: the 11 fields at C x m x f_max rows.
struct GatherArgs {
  const int* st[N_FIELDS];    // (C, n) each, at strides (st_cs, st_is)
  long long st_cs[N_FIELDS];
  long long st_is[N_FIELDS];
  const long long* rows;      // (C, m, f_max)
  const unsigned char* valid; // (C, m, f_max)
  int* out;                   // (11, C, m, f_max)
  unsigned long long* counter;  // the launch key's int64
  int C, m, f_max, pad;
};

// The padding's fill of each field (core/delta.py _PAD_FIELDS; id_c is
// -(slot + 2), and len_bp and id_d keep the gathered value: KEEP).
constexpr int KEEP = INT_MIN;
__constant__ int PAD_FILL[N_FIELDS] = {0, KEEP, 0, KEEP, 0, 1, 1, 1, 0, 0, KEEP};

__device__ __forceinline__ int key_of(const RowsArgs& a, int c, int k) {
  const long long f = k == 0 ? a.f_a[c * a.fa_s] : a.ids[(long long)c * a.m + (k - 1)];
  return a.id_c[c * a.id_cs + f * a.id_is];
}

// The first place in sorted keys s[0, n) not below v.
__device__ __forceinline__ int lower_bound(const int* s, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// One warp's sums of a place's counts (C's row of (n_keys, n_chunks)): over
// every chunk, over the chunks before chunk b, and chunk b's; in every lane.
__device__ __forceinline__ void place_sums(const RowsArgs& a, const int* cnt, int r, int b,
                                           int lane, int& tot, int& bef, int& in) {
  const int* row = cnt + (long long)r * a.n_chunks;
  tot = bef = 0;
  for (int q = lane; q < a.n_chunks; q += 32) {
    const int v = row[q];
    tot += v;
    if (q < b) bef += v;
  }
  for (int off = 16; off > 0; off >>= 1) {
    tot += __shfl_xor_sync(FULL, tot, off);
    bef += __shfl_xor_sync(FULL, bef, off);
  }
  in = row[b];
}

// A thread's RPT contiguous rows of a pass from r0 (ids of rows at or past
// hi are not read): two 16-byte loads where id_c is contiguous and aligned.
__device__ __forceinline__ void load_pass(const RowsArgs& a, const int* idc, int r0, int hi,
                                          int (&id)[RPT]) {
  const int* p = idc + r0;
  if (a.id_is == 1 && r0 + RPT <= hi && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const int4 x = reinterpret_cast<const int4*>(p)[0], y = reinterpret_cast<const int4*>(p)[1];
    id[0] = x.x; id[1] = x.y; id[2] = x.z; id[3] = x.w;
    id[4] = y.x; id[5] = y.y; id[6] = y.z; id[7] = y.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) id[k] = r0 + k < hi ? idc[(long long)(r0 + k) * a.id_is] : 0;
}

// G1's rows of a pass from r0 = the pass's first row + t: thread t's k-th
// row r0 + k THREADS (a warp's loads, 32 consecutive ids, coalesce), all
// issued at once (ids of rows at or past hi are not read)
__device__ __forceinline__ void load_rows(const RowsArgs& a, const int* idc, int r0, int hi,
                                          int (&id)[RPT]) {
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int r = r0 + k * THREADS;
    id[k] = r < hi ? idc[(long long)r * a.id_is] : 0;
  }
}

// G1's keys sorted ascending where they fit a warp: a bitonic network over
// the 32 lanes' values, by shuffles
__device__ __forceinline__ int warp_sort(int v, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int o = __shfl_xor_sync(FULL, v, j);
      v = ((lane & j) == 0) == ((lane & k) == 0) ? min(v, o) : max(v, o);
    }
  }
  return v;
}

// ... and above THREADS keys: a bitonic network over the p (a power of
// two) values of s in shared memory, the block's threads a
// compare-exchange each (pair i = t + THREADS r). A stage of distance j <=
// 32 keeps each warp's 32 consecutive pairs inside 64 values of its own,
// so it needs only the warp's barrier; the block's barrier stands around
// stages of distance 64 and more (at m + 1 = 321, width 512: 9 of 45
// stages; at 4,096: 27 of 78)
__device__ __forceinline__ void block_sort(int* s, int p, int t) {
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = t; i < p / 2; i += THREADS) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1)), hi = lo + j;
        const int x = s[lo], y = s[hi];
        if ((x > y) == ((lo & k) == 0)) {
          s[lo] = y;
          s[hi] = x;
        }
      }
      const int next = j > 1 ? j >> 1 : (k < p ? k : 0);   // the next stage's distance
      if (j >= 64 || next >= 64) __syncthreads();
      else __syncwarp();
    }
  }
}

// The keys' sorting width: a warp's 32, or the power of two at or above them
__host__ __device__ __forceinline__ int sort_width(int n_keys) {
  int p = 32;
  while (p < n_keys) p <<= 1;
  return p;
}

__global__ void __launch_bounds__(THREADS) rows_counts_kernel(RowsArgs a) {
  extern __shared__ int smem[];     // sized from m + 1 (counts_smem)
  const int n_keys = a.m + 1;
  const int p = sort_width(n_keys);
  int* s_sorted = smem;             // the chain's keys, ascending (INT_MAX past n_keys)
  int* s_cnt = smem + p;            // each place's count in the chunk
  __shared__ int s_max[N_WARPS];
  const int b = blockIdx.x, c = blockIdx.y, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  if (b == 0 && c == 0 && t == 0) atomicAdd(a.counts_counter, 1ULL);
  const int lo = b * a.chunk, hi = min(lo + a.chunk, a.n);
  const int* idc = a.id_c + c * a.id_cs;
  // the chunk's first pass of rows, in flight while the keys load and sort
  int id[RPT];
  load_rows(a, idc, lo + t, hi, id);
  if (p == 32) {
    if (t < n_keys) s_cnt[t] = 0;
    if (warp == 0) s_sorted[lane] = warp_sort(lane < n_keys ? key_of(a, c, lane) : INT_MAX, lane);
  } else if (n_keys <= THREADS) {
    // a rank a thread, n_keys compares: key t goes after the smaller keys
    // and its equals before it (the keys staged where the counts go)
    if (t < n_keys) s_cnt[t] = key_of(a, c, t);
    __syncthreads();
    int v = 0, r = 0;
    if (t < n_keys) {
      v = s_cnt[t];
      for (int k = 0; k < n_keys; ++k) {
        const int w = s_cnt[k];
        r += w < v || (w == v && k < t);
      }
    }
    __syncthreads();
    if (t < n_keys) {
      s_sorted[r] = v;
      s_cnt[t] = 0;
    }
  } else {
    for (int k = t; k < n_keys; k += THREADS) s_cnt[k] = 0;
    for (int k = t; k < p; k += THREADS) s_sorted[k] = k < n_keys ? key_of(a, c, k) : INT_MAX;
    __syncthreads();
    block_sort(s_sorted, p, t);
  }
  __syncthreads();
  if (b == 0)
    for (int k = t; k < n_keys; k += THREADS) a.skeys[(long long)c * n_keys + k] = s_sorted[k];
  int mx = INT_MIN;
  for (int base = lo; base < hi; base += PASS) {
    if (base > lo) load_rows(a, idc, base + t, hi, id);
    // a warp's 32 consecutive rows a step: each row's first place in the
    // sorted keys (-1: not a key), the warp's equal places merged by a
    // match, one shared atomic a place (a step with no key row skipped)
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      int place = -1;
      if (base + k * THREADS + t < hi) {
        mx = max(mx, id[k]);
        const int r = lower_bound(s_sorted, n_keys, id[k]);
        if (r < n_keys && s_sorted[r] == id[k]) place = r;
      }
      if (__any_sync(FULL, place >= 0)) {
        const unsigned peers = __match_any_sync(FULL, place);
        if (place >= 0 && lane == __ffs(peers) - 1) atomicAdd(&s_cnt[place], __popc(peers));
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) mx = max(mx, __shfl_xor_sync(FULL, mx, off));
  if (lane == 0) s_max[warp] = mx;
  __syncthreads();
  for (int k = t; k < n_keys; k += THREADS)
    a.counts[((long long)c * n_keys + k) * a.n_chunks + b] = s_cnt[k];
  if (t == 0) {
    int m = s_max[0];
    for (int w = 1; w < N_WARPS; ++w) m = max(m, s_max[w]);
    a.cmax[(long long)c * a.n_chunks + b] = m;
  }
}

// In the union: each row's contig found in the shared sorted keys with its
// place in the union (union mode; false otherwise)
__device__ __forceinline__ void union_flags(const RowsArgs& a, const int (&id)[RPT],
                                            const int* s_sorted, const unsigned char* s_inc,
                                            bool (&in_u)[RPT]) {
  const int n_keys = a.m + 1;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    in_u[k] = false;
    if (a.union_mode) {
      const int r = lower_bound(s_sorted, n_keys, id[k]);
      in_u[k] = r < n_keys && s_sorted[r] == id[k] && s_inc[r];
    }
  }
}

// G2 sums every place's counts (else only ka's and kb's, once the keys are
// in shared memory): in union mode, or where that is at most SUMS_ALL
// counts a block
constexpr int SUMS_ALL = 2048;
__host__ __device__ __forceinline__ bool every_place(const RowsArgs& a) {
  return a.union_mode || (long long)(a.m + 1) * a.n_chunks <= SUMS_ALL;
}

// Inclusive scans over the warp of three counts
__device__ __forceinline__ void warp_scan3(int& x, int& y, int& z, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ux = __shfl_up_sync(FULL, x, off), uy = __shfl_up_sync(FULL, y, off),
              uz = __shfl_up_sync(FULL, z, off);
    if (lane >= off) {
      x += ux;
      y += uy;
      z += uz;
    }
  }
}

__global__ void __launch_bounds__(THREADS) rows_write_kernel(RowsArgs a) {
  extern __shared__ int smem[];     // sized from m + 1 (write_smem)
  const int n_keys = a.m + 1;
  const bool all_sums = every_place(a);
  int* s_sorted = smem;             // the chain's keys, ascending
  int* s_sum = smem + n_keys;       // all_sums: each place's (total, before the chunk, in it)
  unsigned char* s_inc = reinterpret_cast<unsigned char*>(s_sum + (all_sums ? 3 * n_keys : 0));
  __shared__ int s_key[2];          // ka, kb
  __shared__ int s_pair[2][3];      // otherwise: ka's and kb's sums
  __shared__ int s_u[N_WARPS][3];   // the union's sums, each warp's part
  __shared__ int s_w[N_WARPS][3];   // the class counts, each warp's
  __shared__ int s_out[PASS];       // a pass's rows, stream by stream, in output order
  const int b = blockIdx.x, j = blockIdx.y, c = blockIdx.z, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  if (b == 0 && j == 0 && c == 0 && t == 0) atomicAdd(a.write_counter, 1ULL);

  // ---- the loads that wait for nothing: keys, sorted keys, sums ----------
  if (t < 2) s_key[t] = key_of(a, c, t == 0 ? 0 : j + 1);
  const int* keys = a.skeys + (long long)c * n_keys;
  for (int k = t; k < n_keys; k += THREADS) s_sorted[k] = keys[k];
  const int* cnt = a.counts + (long long)c * n_keys * a.n_chunks;
  if (all_sums) {
    // every place's sums, `span` lanes a place (lanes over the chunks): as
    // few lanes as give each of the block's places a group of lanes. A
    // place's counts stand at its contig's first place (its other places
    // hold 0), so the union's sums need no deduplication.
    int span = 32;
    while (span > 1 && THREADS / span < n_keys) span >>= 1;
    const int sl = lane & (span - 1);
    int ut = 0, ub = 0, ui = 0;
    for (int base = 0; base < n_keys; base += THREADS / span) {
      const int r = base + t / span;
      const int* row = cnt + (long long)min(r, n_keys - 1) * a.n_chunks;
      int tot = 0, bef = 0, in = 0;
      if (r < n_keys) {
        if (sl == 0) in = row[b];
        for (int q = sl; q < a.n_chunks; q += span) {
          const int v = row[q];
          tot += v;
          bef += q < b ? v : 0;
        }
      }
      for (int off = span / 2; off > 0; off >>= 1) {
        tot += __shfl_xor_sync(FULL, tot, off);
        bef += __shfl_xor_sync(FULL, bef, off);
      }
      if (r < n_keys && sl == 0) {
        s_sum[3 * r] = tot;
        s_sum[3 * r + 1] = bef;
        s_sum[3 * r + 2] = in;
        if (a.union_mode) {
          s_inc[r] = tot <= a.f_max;
          if (tot <= a.f_max) {
            ut += tot;
            ub += bef;
            ui += in;
          }
        }
      }
    }
    if (a.union_mode) {
      ut = __reduce_add_sync(FULL, ut);
      ub = __reduce_add_sync(FULL, ub);
      ui = __reduce_add_sync(FULL, ui);
      if (lane == 0) {
        s_u[warp][0] = ut;
        s_u[warp][1] = ub;
        s_u[warp][2] = ui;
      }
    }
  }
  if (b == 0 && j == 0 && warp == N_WARPS - 1) {
    int mx = INT_MIN;
    for (int q = lane; q < a.n_chunks; q += 32) mx = max(mx, a.cmax[(long long)c * a.n_chunks + q]);
    for (int off = 16; off > 0; off >>= 1) mx = max(mx, __shfl_xor_sync(FULL, mx, off));
    if (lane == 0) a.max_id[c] = mx;
  }
  __syncthreads();

  const int ka = s_key[0], kb = s_key[1];
  const bool same = kb == ka;
  int tot_a, bef_a, in_a, tot_b, bef_b, in_b;
  if (all_sums) {
    const int* sa = s_sum + 3 * lower_bound(s_sorted, n_keys, ka);
    const int* sb = s_sum + 3 * lower_bound(s_sorted, n_keys, kb);
    tot_a = sa[0], bef_a = sa[1], in_a = sa[2];
    tot_b = sb[0], bef_b = sb[1], in_b = sb[2];
  } else {                          // many places: two warps sum ka's and kb's
    if (warp < 2) {
      int tot, bef, in;
      place_sums(a, cnt, lower_bound(s_sorted, n_keys, warp == 0 ? ka : kb), b, lane, tot, bef,
                 in);
      if (lane == 0) {
        s_pair[warp][0] = tot;
        s_pair[warp][1] = bef;
        s_pair[warp][2] = in;
      }
    }
    __syncthreads();
    tot_a = s_pair[0][0], bef_a = s_pair[0][1], in_a = s_pair[0][2];
    tot_b = s_pair[1][0], bef_b = s_pair[1][1], in_b = s_pair[1][2];
  }
  // the three streams' totals and this chunk's counts and first places
  const bool inc_a = !a.union_mode || tot_a <= a.f_max;
  const bool inc_b = !same && (!a.union_mode || tot_b <= a.f_max);
  const int a_tot = (inc_a ? tot_a : 0) + (inc_b ? tot_b : 0);
  const int a_bef = (inc_a ? bef_a : 0) + (inc_b ? bef_b : 0);
  const int a_in = (inc_a ? in_a : 0) + (inc_b ? in_b : 0);
  int u_tot = a_tot, u_bef = a_bef, u_in = a_in;   // the union (each mode: A)
  if (a.union_mode) {
    u_tot = u_bef = u_in = 0;
    for (int w = 0; w < N_WARPS; ++w) {
      u_tot += s_u[w][0];
      u_bef += s_u[w][1];
      u_in += s_u[w][2];
    }
  }
  const int lo = b * a.chunk, hi = min(lo + a.chunk, a.n);
  if (b == 0 && t == 0) a.overflow[(long long)c * a.m + j] = tot_a + (same ? 0 : tot_b) > a.f_max;
  // each stream's next output place
  int run0 = a_bef, run1 = a_tot + (u_bef - a_bef), run2 = u_tot + (lo - u_bef);
  // a chunk none of whose streams can still land below f_max writes nothing
  if (!((a_in > 0 && run0 < a.f_max) || (u_in > a_in && run1 < a.f_max)
        || (hi - lo > u_in && run2 < a.f_max)))
    return;

  const long long out0 = ((long long)c * a.m + j) * a.f_max;
  const int* idc = a.id_c + c * a.id_cs;
  for (int base = lo; base < hi; base += PASS) {
    const int r0 = base + t * RPT;
    int id[RPT];
    bool in_u[RPT];
    load_pass(a, idc, r0, hi, id);
    union_flags(a, id, s_sorted, s_inc, in_u);
    unsigned char cls[RPT];         // 0: A, 1: B, 2: C, 3: past the chunk
    int n0 = 0, n1 = 0, n2 = 0;
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      cls[k] = 3;
      if (r0 + k < hi) {
        cls[k] = ((id[k] == ka && inc_a) || (id[k] == kb && inc_b)) ? 0 : in_u[k] ? 1 : 2;
        n0 += cls[k] == 0;
        n1 += cls[k] == 1;
        n2 += cls[k] == 2;
      }
    }
    // one block scan of the three counts: this thread's first place in
    // each stream of the pass
    int i0 = n0, i1 = n1, i2 = n2;
    warp_scan3(i0, i1, i2, lane);
    if (lane == 31) {
      s_w[warp][0] = i0;
      s_w[warp][1] = i1;
      s_w[warp][2] = i2;
    }
    __syncthreads();
    int w0 = lane < N_WARPS ? s_w[lane][0] : 0;
    int w1 = lane < N_WARPS ? s_w[lane][1] : 0;
    int w2 = lane < N_WARPS ? s_w[lane][2] : 0;
    warp_scan3(w0, w1, w2, lane);
    const int src = (warp + 31) & 31;
    const int t0 = __shfl_sync(FULL, w0, N_WARPS - 1), t1 = __shfl_sync(FULL, w1, N_WARPS - 1),
              t2 = __shfl_sync(FULL, w2, N_WARPS - 1);
    // the pass's rows to shared memory, stream 0, then 1, then 2, each in
    // output order; then written out by consecutive threads
    int e0 = (warp > 0 ? __shfl_sync(FULL, w0, src) : 0) + i0 - n0;
    int e1 = t0 + (warp > 0 ? __shfl_sync(FULL, w1, src) : 0) + i1 - n1;
    int e2 = t0 + t1 + (warp > 0 ? __shfl_sync(FULL, w2, src) : 0) + i2 - n2;
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      if (cls[k] == 3) continue;
      s_out[cls[k] == 0 ? e0++ : cls[k] == 1 ? e1++ : e2++] = r0 + k;
    }
    __syncthreads();
    for (int q = t; q < t0 + t1 + t2; q += THREADS) {
      const int p = q < t0 ? run0 + q : q < t0 + t1 ? run1 + (q - t0) : run2 + (q - t0 - t1);
      if (p < a.f_max) {
        a.rows[out0 + p] = s_out[q];
        a.valid[out0 + p] = q < t0;
      }
    }
    run0 += t0;
    run1 += t1;
    run2 += t2;
    if (base + PASS < hi) __syncthreads();   // s_w and s_out are the next pass's
  }
}

__global__ void __launch_bounds__(THREADS) rows_gather_kernel(GatherArgs g) {
  const long long total = (long long)g.C * g.m * g.f_max;
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e == 0) atomicAdd(g.counter, 1ULL);
  if (e >= total) return;
  const int pos = (int)(e % g.f_max);
  const int c = (int)(e / ((long long)g.m * g.f_max));
  const long long r = g.rows[e];
  const bool ok = g.valid[e];
#pragma unroll
  for (int f = 0; f < N_FIELDS; ++f) {
    int x = g.st[f][c * g.st_cs[f] + r * g.st_is[f]];
    if (!ok) {
      if (f == IDC) x = -(pos + 2);
      else if (PAD_FILL[f] != KEEP) x = PAD_FILL[f];
    }
    g.out[f * total + e] = x;
  }
}

int launched() { return (int)cudaGetLastError(); }

// Dynamic shared memory of G1 (the keys at their sorting width and a count
// a place) and G2
// (the sorted keys; in union mode or where they are few each place's three
// sums; in union mode a byte a place).
int counts_smem(int n_keys) { return 4 * (sort_width(n_keys) + n_keys); }
inline long long write_smem(const RowsArgs& a) {
  const long long n_keys = a.m + 1;
  return 4 * (n_keys + (every_place(a) ? 3 * n_keys : 0)) + (a.union_mode ? n_keys : 0);
}
static_assert(8 * MAX_KEYS <= 48 * 1024 && (MAX_KEYS & (MAX_KEYS - 1)) == 0,
              "G1's sorting width and counts must fit in 48 KB of shared memory");

int check_rows(const RowsArgs* a) {
  if (a->C < 1 || a->m < 1 || a->m + 1 > MAX_KEYS || a->f_max < 1 || a->f_max > a->n
      || a->chunk < 1 || a->n_chunks != (a->n + a->chunk - 1) / a->chunk
      || a->C > 65535 || a->m > 65535 || a->counts_counter == nullptr
      || a->write_counter == nullptr)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

// sizeof each argument block, for the wrapper's check of its ctypes mirrors
int rows_args_size() { return (int)sizeof(RowsArgs); }

int rows_gather_args_size() { return (int)sizeof(GatherArgs); }

// G2's dynamic shared memory (bytes) for the block's shapes
long long rows_write_smem(const void* args) {
  return write_smem(*static_cast<const RowsArgs*>(args));
}

// Opt G2 in to the current device's largest dynamic shared memory: once a
// device, outside any capture. Returns the bytes a launch may now ask (the
// opt-in limit less G2's static shared memory), or -cudaError_t.
long long rows_init() {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, rows_write_kernel);
  const int dyn = optin - static_cast<int>(fa.sharedSizeBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(rows_write_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  return e == cudaSuccess ? dyn : -static_cast<long long>(e);
}

// Each entry point launches its kernel on `stream` from the argument block
// the wrapper filled, does not synchronise, and returns the cudaError_t of
// the launch (cudaErrorInvalidValue for a block it refuses). G2 reads what
// G1 wrote: launch them in that order on one stream.
int rows_counts(const void* args, void* stream) {
  const RowsArgs* a = static_cast<const RowsArgs*>(args);
  if (int rc = check_rows(a)) return rc;
  rows_counts_kernel<<<dim3(a->n_chunks, a->C), THREADS, counts_smem(a->m + 1),
                       (cudaStream_t)stream>>>(*a);
  return launched();
}

int rows_write(const void* args, void* stream) {
  const RowsArgs* a = static_cast<const RowsArgs*>(args);
  if (int rc = check_rows(a)) return rc;
  rows_write_kernel<<<dim3(a->n_chunks, a->m, a->C), THREADS, (size_t)write_smem(*a),
                      (cudaStream_t)stream>>>(*a);
  return launched();
}

int rows_gather(const void* args, void* stream) {
  const GatherArgs* g = static_cast<const GatherArgs*>(args);
  const long long total = (long long)g->C * g->m * g->f_max;
  if (total < 1 || g->counter == nullptr) return (int)cudaErrorInvalidValue;
  const long long blocks = (total + THREADS - 1) / THREADS;
  rows_gather_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(*g);
  return launched();
}

}  // extern "C"
