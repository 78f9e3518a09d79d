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
//  - G1 (`rows_counts_kernel`): one block a (chunk, chain). The block
//    sorts the chain's m + 1 contig keys (ka, then each slot's kb) in
//    shared memory sized from m + 1 (a rank sort), and counts, over its
//    chunk, the rows of each contig (a binary search a row, the warp's
//    equal places merged by a match, one shared atomic a place) at the
//    contig's first place in the sorted keys (its other places stay 0), and
//    the chunk's largest id. It writes them to scratch: the sorted keys
//    (C, m + 1), counts (C, m + 1, n_chunks) and the chunk maxima (C,
//    n_chunks).
//  - G2 (`rows_write_kernel`): one block a (chunk, slot, chain). Two warps
//    sum ka's and kb's counts over every chunk and over the chunks before
//    the block's own (lanes over the chunks); in union mode the warps do so
//    for every place of the sorted keys, which gives the union (the
//    contigs that fit f_max) and its sums. That gives each stream's total
//    and the place of the chunk's first row in each stream. A block none
//    of whose streams can still land below f_max exits. The others walk
//    their chunk in tiles of THREADS rows: each row's stream by comparison
//    with ka and kb (in union mode, then a binary search of the sorted
//    keys), its rank in the tile by three warp ballots and the warps'
//    totals, and its output place, written where below f_max. Every output
//    place gets exactly one row (the streams hold all n >= f_max rows).
//    Block (0, slot, chain) writes the slot's overflow, and block (0, 0,
//    chain) the chain's max_id from G1's chunk maxima.
//  - Shared memory follows m + 1 (8 bytes a key in G1, 5 in G2's union
//    mode), so any slot count up to MAX_KEYS - 1 runs: every count D2 and
//    E1 take.
//  - G3 (`rows_gather_kernel`): one thread an output row: the 11 fields of
//    its genome row, read at their strides (no (C, n, 11) stack), the
//    padding's fills where the row is not valid (id_c -(slot + 2)), written
//    to one (11, C, m, f_max) int32 tensor.
//  - Three launches a scoring call however many chains, on the current
//    stream, with no host read, into fresh outputs and scratch whose sizes
//    follow (C, m, f_max, n) alone, so a captured step (core.graphs.Scan)
//    captures them. Integers only: the output is the plain version's bit
//    for bit, padding included.
//
// Launch keys (ops/counts.py): "counts" (G1), "write" (G2), "gather" (G3).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int N_WARPS = THREADS / 32;
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

__global__ void __launch_bounds__(THREADS) rows_counts_kernel(RowsArgs a) {
  extern __shared__ int smem[];     // sized from m + 1 (counts_smem)
  const int n_keys = a.m + 1;
  int* s_sorted = smem;             // the chain's keys, ascending
  int* s_cnt = smem + n_keys;       // the keys as given, then each place's count
  __shared__ int s_max[N_WARPS];
  const int b = blockIdx.x, c = blockIdx.y, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  for (int k = t; k < n_keys; k += THREADS) s_cnt[k] = key_of(a, c, k);
  __syncthreads();
  // rank sort: key k goes after the smaller keys and its equals before it
  for (int k = t; k < n_keys; k += THREADS) {
    const int v = s_cnt[k];
    int r = 0;
    for (int k2 = 0; k2 < n_keys; ++k2) {
      const int w = s_cnt[k2];
      r += w < v || (w == v && k2 < k);
    }
    s_sorted[r] = v;
  }
  __syncthreads();
  for (int k = t; k < n_keys; k += THREADS) {
    s_cnt[k] = 0;
    if (b == 0) a.skeys[(long long)c * n_keys + k] = s_sorted[k];
  }
  __syncthreads();
  const int lo = b * a.chunk, hi = min(lo + a.chunk, a.n);
  const int* idc = a.id_c + c * a.id_cs;
  int mx = INT_MIN;
  for (int base = lo; base < hi; base += THREADS) {
    const int i = base + t;
    int place = -1;                       // the first place of the row's key
    if (i < hi) {
      const int id = idc[i * a.id_is];
      mx = max(mx, id);
      const int r = lower_bound(s_sorted, n_keys, id);
      if (r < n_keys && s_sorted[r] == id) place = r;
    }
    const unsigned peers = __match_any_sync(FULL, place);
    if (place >= 0 && lane == __ffs(peers) - 1) atomicAdd(&s_cnt[place], __popc(peers));
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

__global__ void __launch_bounds__(THREADS) rows_write_kernel(RowsArgs a) {
  extern __shared__ int smem[];     // sized from m + 1 (write_smem)
  const int n_keys = a.m + 1;
  int* s_sorted = smem;             // union mode: the chain's keys, ascending
  unsigned char* s_inc = reinterpret_cast<unsigned char*>(smem + n_keys);   // ... in the union
  __shared__ int s_pair[2][3];      // ka's and kb's rows: in all, before the chunk, in it
  __shared__ int s_u[N_WARPS][3];   // the union's, each warp's part
  __shared__ int s_w[N_WARPS][3];
  const int b = blockIdx.x, j = blockIdx.y, c = blockIdx.z, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int ka = key_of(a, c, 0), kb = key_of(a, c, j + 1);
  const int* keys = a.skeys + (long long)c * n_keys;
  const int* cnt = a.counts + (long long)c * n_keys * a.n_chunks;
  if (warp < 2) {
    int tot, bef, in;
    place_sums(a, cnt, lower_bound(keys, n_keys, warp == 0 ? ka : kb), b, lane, tot, bef, in);
    if (lane == 0) {
      s_pair[warp][0] = tot;
      s_pair[warp][1] = bef;
      s_pair[warp][2] = in;
    }
  }
  if (b == 0 && j == 0 && warp == N_WARPS - 1) {
    int mx = INT_MIN;
    for (int q = lane; q < a.n_chunks; q += 32) mx = max(mx, a.cmax[(long long)c * a.n_chunks + q]);
    for (int off = 16; off > 0; off >>= 1) mx = max(mx, __shfl_xor_sync(FULL, mx, off));
    if (lane == 0) a.max_id[c] = mx;
  }
  if (a.union_mode) {
    // a contig's counts stand at its first place (its other places hold 0),
    // so the union's sums need no deduplication
    for (int k = t; k < n_keys; k += THREADS) s_sorted[k] = keys[k];
    int ut = 0, ub = 0, ui = 0;
    for (int r = warp; r < n_keys; r += N_WARPS) {
      int tot, bef, in;
      place_sums(a, cnt, r, b, lane, tot, bef, in);
      const bool inc = tot <= a.f_max;
      if (lane == 0) {
        s_inc[r] = inc;
        if (inc) {
          ut += tot;
          ub += bef;
          ui += in;
        }
      }
    }
    if (lane == 0) {
      s_u[warp][0] = ut;
      s_u[warp][1] = ub;
      s_u[warp][2] = ui;
    }
  }
  __syncthreads();

  // the three streams' totals and this chunk's counts and first places
  const bool same = kb == ka;
  const int tot_a = s_pair[0][0], tot_b = s_pair[1][0];
  const bool inc_a = !a.union_mode || tot_a <= a.f_max;
  const bool inc_b = !same && (!a.union_mode || tot_b <= a.f_max);
  const int a_tot = (inc_a ? tot_a : 0) + (inc_b ? tot_b : 0);
  const int a_bef = (inc_a ? s_pair[0][1] : 0) + (inc_b ? s_pair[1][1] : 0);
  const int a_in = (inc_a ? s_pair[0][2] : 0) + (inc_b ? s_pair[1][2] : 0);
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
  const bool live = (a_in > 0 && run0 < a.f_max) || (u_in > a_in && run1 < a.f_max)
      || ((hi - lo) > u_in && run2 < a.f_max);
  if (!live) return;

  const long long out0 = ((long long)c * a.m + j) * a.f_max;
  const int* idc = a.id_c + c * a.id_cs;
  const unsigned below = (1u << lane) - 1u;
  for (int base = lo; base < hi; base += THREADS) {
    const int i = base + t;
    int cls = -1;                         // 0: A, 1: B, 2: C
    if (i < hi) {
      const int id = idc[i * a.id_is];
      if ((id == ka && inc_a) || (id == kb && inc_b)) {
        cls = 0;
      } else {
        cls = 2;
        if (a.union_mode) {
          const int r = lower_bound(s_sorted, n_keys, id);
          if (r < n_keys && s_sorted[r] == id && s_inc[r]) cls = 1;
        }
      }
    }
    const unsigned v0 = __ballot_sync(FULL, cls == 0), v1 = __ballot_sync(FULL, cls == 1),
                   v2 = __ballot_sync(FULL, cls == 2);
    if (lane == 0) {
      s_w[warp][0] = __popc(v0);
      s_w[warp][1] = __popc(v1);
      s_w[warp][2] = __popc(v2);
    }
    __syncthreads();
    int before0 = 0, before1 = 0, before2 = 0, tile0 = 0, tile1 = 0, tile2 = 0;
    for (int w = 0; w < N_WARPS; ++w) {
      tile0 += s_w[w][0];
      tile1 += s_w[w][1];
      tile2 += s_w[w][2];
      if (w < warp) {
        before0 += s_w[w][0];
        before1 += s_w[w][1];
        before2 += s_w[w][2];
      }
    }
    if (cls >= 0) {
      const int p = cls == 0 ? run0 + before0 + __popc(v0 & below)
                  : cls == 1 ? run1 + before1 + __popc(v1 & below)
                             : run2 + before2 + __popc(v2 & below);
      if (p < a.f_max) {
        a.rows[out0 + p] = i;
        a.valid[out0 + p] = cls == 0;
      }
    }
    run0 += tile0;
    run1 += tile1;
    run2 += tile2;
    __syncthreads();                      // s_w is the next tile's
    if (run0 >= a.f_max && run1 >= a.f_max && run2 >= a.f_max) break;
  }
}

__global__ void __launch_bounds__(THREADS) rows_gather_kernel(GatherArgs g) {
  const long long total = (long long)g.C * g.m * g.f_max;
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
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

// Dynamic shared memory of G1 (the sorted keys and a count a place) and G2
// (union mode: the sorted keys and a byte a place), within the default 48 KB.
int counts_smem(int n_keys) { return 8 * n_keys; }
int write_smem(const RowsArgs* a) { return a->union_mode ? 5 * (a->m + 1) : 0; }
static_assert(8 * MAX_KEYS <= 48 * 1024, "G1's keys must fit in 48 KB of shared memory");

int check_rows(const RowsArgs* a) {
  if (a->C < 1 || a->m < 1 || a->m + 1 > MAX_KEYS || a->f_max < 1 || a->f_max > a->n
      || a->chunk < 1 || a->n_chunks != (a->n + a->chunk - 1) / a->chunk
      || a->C > 65535 || a->m > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

// sizeof each argument block, for the wrapper's check of its ctypes mirrors
int rows_args_size() { return (int)sizeof(RowsArgs); }

int rows_gather_args_size() { return (int)sizeof(GatherArgs); }

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
  rows_write_kernel<<<dim3(a->n_chunks, a->m, a->C), THREADS, write_smem(a),
                      (cudaStream_t)stream>>>(*a);
  return launched();
}

int rows_gather(const void* args, void* stream) {
  const GatherArgs* g = static_cast<const GatherArgs*>(args);
  const long long total = (long long)g->C * g->m * g->f_max;
  if (total < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (total + THREADS - 1) / THREADS;
  rows_gather_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(*g);
  return launched();
}

}  // extern "C"
