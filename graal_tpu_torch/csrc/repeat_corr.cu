// The repeat delta engine's copy corrections, for NVIDIA Hopper (sm_90a):
// the routing and frozen terms (F1) and the per-genome sums and the delta
// (F2) of every chain and neighbour slot of one scoring call.
//
// Replaces no Pallas kernel: the JAX package writes the corrections as jnp
// code inside its jitted, vmapped step and XLA fuses them
// (graal_tpu/core/delta_repeats.py `dscore_spec` :590, its
// candidate-independent routing :604-747, `corr_terms` :748-806 and the
// cross term and delta :807-818). The plain torch version
// (graal_tpu_torch/core/delta_repeats.py `RepeatDeltaScorer._corrections`,
// taken chain by chain by `corrections_plain`) runs it as about fifty small
// torch kernels a chain and a scoring call.
//
// With repeated bins an observed count's expectation sums over copy pairs.
// The single-copy majority goes through B4 + B2 (dll1, one f32 delta per
// candidate); these kernels add, for each of the 14 genomes (base + 13
// candidates) of a neighbour slot, four correction sums, each a sum of f32
// terms in f64, and the activity cross term, and write
//
//     dll = dll1 + (corr[1:] - corr[0]) - cross          (f64, then f32)
//
//  - mixed: each single-copy D row's (single, multi) observed windows: the
//    in-D copies of the multi end take the genome's geometry, its frozen
//    copies (contigs outside D) add a trans term of their frozen accu mass;
//  - multi-multi: the short static list of (multi, multi) entries, every
//    copy pair enumerated, frozen x frozen pairs at the base geometry;
//  - part 4: fA's multi-copy bins against frozen single-copy partners;
//  - same-bin: copy pairs of one data bin, out of B2's expected mass;
//  - cross: swap_activity's trans mass against the frozen genome.
//
// What bounds it on the card: neither bytes nor operations. At the repeat
// configuration's width (R = 1,024 sub rows, 10 neighbour slots, 14 genomes,
// two copies a bin) a call evaluates some tens of thousands of copy pairs
// (at most about a million: every window of every row) and reads a few MB
// (the mixed windows, the data-grid rows of fA's bins, the slots'
// geometry): a microsecond of the card's bound. The plain version's ~1.4 ms
// a call was launches.
//
// What the design does about it: it is latency-bound, so it shortens each
// block's chain of dependent loads and barriers, spreads the work over
// enough blocks and packs what F2 walks.
//  - Two launches a scoring call, however many chains, each counting
//    itself: block 0's thread 0 adds one to the launch key's int64 on the
//    card (ops/counts.py), so no counting kernel runs beside them. The
//    wrapper (ops/repeat_corr_cuda.py) passes fresh outputs and scratch and
//    reads nothing back, so a captured step (core.graphs.Scan) captures
//    both.
//  - F1 (`corr_frozen_kernel`): a grid of thread block clusters of K
//    blocks of 1,024 threads (K from 1 to 8, `plan` in the wrapper), two a
//    (chain, neighbour) slot and one a chain. Work that does not wait for
//    another runs beside it: a slot's D-row cluster writes the records and
//    o_same, its entry cluster the multi-multi entries' frozen pair sums
//    and masses and part 4's frozen sums and coefficients, and the chain's
//    cluster its active accu mass w_all (block 0 alone: a fixed-order f64
//    sum over the K copy rows).
//  - Routing, in shared memory at every f_max. The member rows of a slot
//    are an ascending valid prefix (core/delta.py extract_rows_each: top-k
//    of a key that puts members first, in index order), so a copy row's
//    mini slot is its owner's place in that prefix. The plain version
//    scatters an (m, n + 1) map; each block builds one of two routers
//    instead (the wrapper's plan picks one): the prefix staged (the valid
//    count from one round of loads and a warp-sum, a route a binary
//    search of it), or a membership bitmap of the genome's n fragments
//    with the rank of each 32-bit word (a block scan of the words' counts;
//    a route two shared loads and a popcount). Dynamic shared memory is
//    sized from f_max (or n) and the rows a block takes, opted in above
//    48 KB once a device (`repeat_corr_init`).
//  - One pass over the D rows. A D-row cluster splits the slot's R rows
//    into K runs, a block's run into one contiguous run a thread. Each
//    thread walks its rows once: a row's data bin, its copies' routes (the
//    same-bin pairs' mini rows kept in scratch by row, o_same written), its
//    mixed-entry range kept in shared memory. A warp-shuffle scan of the
//    two counts (warp inclusive scans, then one scan of the warp totals)
//    and, when K > 1, the lower blocks' totals read through distributed
//    shared memory place every run. Then each thread copies its rows'
//    same-bin pairs to their places, and the block's mixed records are
//    written flat, record i by thread i mod 1,024 (its row found by a
//    binary search of the rows' offsets), so a row with many entries does
//    not hold one thread. Records stay in the order F2 sums them: D row
//    ascending, then entry ascending, same-bin pairs in copy order.
//  - A multi-multi entry is a warp's: lane l takes copy row cu = l (and l +
//    32, ...) of its u end and folds that row over cv left to right, the
//    v end's frozen geometry passed by shuffles; the rows fold into the
//    entry's sum in cu order. So every f32 term is still the plain
//    version's left fold.
//  - F2 (`corr_sums_kernel<TG, PLACES>`): a thread block cluster a slot,
//    14 blocks of TG threads, a genome a block. Every genome is summed
//    once: the base genome by block 0, which also sums its D mass and w_out
//    once a slot and hands corr[0] and w_out to the candidates through
//    distributed shared memory.
//  - Terms computed wide, folded in a fixed order. The slot's records are
//    laid out as one sequence: the mixed records, the multi-multi entries,
//    part 4's (s_max x capd) places and the same-bin pairs, each group
//    padded with zeros to a multiple of 128. A pass stages F2_TILE places
//    of it in shared memory as f32 terms (0 where the parent skips a term
//    or a place is padding): place q by thread q mod TG, PLACES places of
//    a thread at a time in three steps (all their ints: the records' rows,
//    entries and first F2_COPIES copies; then all those rows' geometry and
//    the entries' ob and log(ob!); then the terms, a place's further
//    copies loaded F2_COPIES at a time); and the multi-multi entries a
//    group of GW lanes an entry (GW the power of two that holds a bin's
//    copies, at most 32: lane l takes copy row cu = l (+ GW, ...) of the u
//    end, folds it over cv left to right, the v end passed by shuffles,
//    and the rows fold in cu order). After a barrier fold lane th (0-127)
//    adds places th, th + 128, ... of the pass in f64. As every group
//    starts at a multiple of 128, lane th adds the records th, th + 128,
//    ... of each group in turn, and an added zero leaves an f64 sum's bits
//    unchanged; so with the fixed tree over the 128 partials (64, 32 in
//    shared memory, then a warp's shuffles) every corr is bit for bit the
//    sum of the earlier design (a block of 256 a (slot, candidate), 128
//    threads a genome walking its records). The D mass and the cross sum
//    keep that design's order too: lane r (0-255) adds rows r, r + 256,
//    ..., then a 256-wide tree. So corr, cross and dll are that design's to
//    the bit; the order is not torch's, so they agree with the plain
//    version to f64 rounding (rtol 1e-12 in chip_smoke.py 3f) and dll to
//    one f32 ulp.
//  - Layouts (`SumsPlan`, picked a call by the wrapper's `sums_plan`): TG
//    512, 256 or 128, and PLACES 2 or 1. Two places a thread have two
//    records' chains of loads in flight at once, but need up to 128
//    registers a thread (512 threads a multiprocessor); one place fits 64
//    (1,024 threads). So two places win where a call leaves the card
//    mostly idle (few slots, R up to 1,024 rows) and lose where it fills
//    the card, whose resident warps then hide the latency (PERF.md). The
//    wrapper takes the most threads whose clusters the card holds all at
//    once for the call's slots (`repeat_corr_sums_fit`), of two places
//    where R <= 1,024 and one fits, else of one place, so a call of many
//    slots runs in one wave of smaller blocks rather than in waves of
//    large ones (at 128 a thread holds two of the 256 cross lanes).
//  - Latency: the base genome loads its D mass beside its terms; a
//    candidate loads its first cross rows (its activity, the base's,
//    o_same) after its terms, while the sums fold and block 0 finds w_out
//    (loaded before the terms, they held 8-16 registers the places need).
//  - Rounding. Each f32 term follows the plain version op for op: explicit
//    round-to-nearest intrinsics in the plain order (never contracted into
//    an FMA), expf and logf as torch's CUDA kernels call them (no fast-math),
//    a division by the Python divisors nfpb and 1,000 as a product with
//    their f32 reciprocals, as torch divides by a CPU scalar on the card,
//    and each f32 sum over a bin's copies (or a pair's c x c copy pairs) as
//    the left fold the plain version writes out (`_copy_sum`: copy 0, then
//    + copy 1, + copy 2, ...; a pair's rows over v first, then over u). So
//    every f32 term is the plain version's bit for bit, and only the f64
//    sums' order differs.
//  - The copies of a data bin are a runtime count (the table's c_max, any
//    number): every copy loop runs to c_max, the padding copies adding
//    exact zeros, as the plain version's padded (..., c_max) tensors do.
//
// Launch keys (ops/counts.py): "frozen" (F1), "sums" (F2).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "scorer_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int F1_THREADS = 1024;
constexpr int F1_WARPS = F1_THREADS / 32;
constexpr int F2_TILE = 2048;         // F2: the places of the record sequence staged a pass
constexpr int F2_FOLD = 128;          // F2: the fold lanes of a genome (each group padded to it)
constexpr int F2_CROSS = 256;         // F2: the lanes of the D mass and the cross sum
constexpr int F2_PRE = 4;             // F2: cross rows a lane loads before w_out is known
constexpr int F2_COPIES = 2;          // F2: a place's copies loaded with it (then as many a time)
constexpr int N_GEN = 14;             // base + 13 candidates a neighbour slot
constexpr int N_OPS = 13;
constexpr int N_STATE = 6;
constexpr int MAX_CLUSTER = 8;        // the portable cluster size
constexpr unsigned FULL = 0xffffffffu;

enum StateField { START = 0, ORI, IDC, CIRC, LCONT, ACTIV };
enum RouterKind { STAGED = 0, BITMAP = 1 };   // F1's routers (CorrArgs.router)
// F2's layouts (CorrArgs.sums_plan): the threads of a genome's block and
// the places a thread loads at once (two: W, one: D)
enum SumsPlan { W512 = 0, W256, W128, D512, D256, D128 };

// F2's threads a multiprocessor holds at PLACES places a thread at once:
// one place fits 64 registers (1,024 threads); two take up to 128 (512)
__host__ __device__ constexpr int sums_sm_threads(int places) { return places == 1 ? 1024 : 512; }

// The engine's constant tables, on the card once per engine.
struct Tables {
  const int* owner;           // (K,) copy row -> fragment
  const int* data_id;         // (K,) copy row -> data bin
  const float* accu;          // (K,)
  const float* pre;           // (K,) prefix_kb
  const float* suf;           // (K,) suffix_kb
  const float* half;          // (K,) len_kb * 0.5
  const int* sub_start;       // (n,) first copy row of a fragment
  const int* sub_count;       // (n,)
  const int* copy_start;      // (S + 1,) data bin -> copy rows CSR
  const int* copy_rows;       // (K,)
  const unsigned char* dup;   // (S,) multi-copy bins
  const int* mx_start;        // (S + 1,) the mixed (single, multi) CSR
  const int* mx_cols;
  const float* mx_vals;
  const float* mx_lf;         // log(ob!)
  const int* so_start;        // (S + 1,) the data-grid CSR
  const int* so_cols;
  const float* so_vals;
  const float* so_lf;
  const float* dd_ob;         // (ndd,) multi-multi entries
  const float* dd_lf;
  const int* ddu_rows;        // (ndd, c_max) copy rows of each end
  const int* ddv_rows;
  const unsigned char* ddu_ok;
  const unsigned char* ddv_ok;
  float inv_nfpb;             // f32 reciprocals of the Python divisors
  float inv_kb;
  int K, S, n, s_max, c_max, capm, capd, ndd;
};

// One scoring call: M = C x m neighbour slots.
struct CorrArgs {
  Tables t;
  const long long* rows;      // (M, f_max) member rows, ascending valid prefix
  const unsigned char* valid; // (M, f_max)
  const int* st[N_STATE];     // each chain's genome, (C, n) at any strides
  long long st_cs[N_STATE];
  long long st_is[N_STATE];
  const long long* fa;        // (C,)
  long long fa_s;
  const float* mid;           // (M, 14, R) the genomes' geometry
  const int* idc;
  const unsigned char* act;
  const int* circ;
  const float* stot;
  const float* accu_sub;      // (M, R)
  const float* pvec;          // (M, 10)
  const float* dll1;          // (M, 13)
  int* n_rec;                 // scratch, F1 -> F2: (M, 2) mixed records, same-bin pairs
  int* mx_rec;                // (M, R x capm, 2 + c_max): D row, entry, c_max mini rows
  float* mx_aout;             // (M, R x capm) frozen trans mass of a record
  int* sb_pair;               // (M, R x c_max, 2): D row, mini row of its same-bin copy
  float* o_same;              // (M, R)
  float* dd_f;                // (M, ndd, 3)
  int* dd_mini;               // (M, ndd, 2, c_max)
  float* p4_f;                // (M, s_max, capd, 2)
  int* p4_ent;                // (M, s_max, capd)
  int* ca_mini;               // (M, s_max, c_max)
  double* w_all;              // (C,)
  int* sb_stage;              // F1 alone: (M, R, c_max) a D row's same-bin mini rows
  double* corr;               // out: (M, 14)
  double* cross;              // (M, 13)
  float* dll;                 // (M, 13)
  unsigned long long* frozen_counter;  // the launch keys' int64s (ops/counts.py)
  unsigned long long* sums_counter;
  int C, m, f_max, R;
  int cluster, router;        // F1's plan: K blocks a cluster, its router
  int sums_plan, pad;         // F2's layout (SumsPlan)
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

// The f32 sum of a run of copies as the plain version's `_copy_sum` takes
// it: a left fold from the first value, v0 + v1 + v2 + ...
struct Fold {
  float v = 0.0f;
  bool any = false;
  __device__ __forceinline__ void add(float x) {
    v = any ? __fadd_rn(v, x) : x;
    any = true;
  }
};

// A copy row's geometry: (mid, idc, circ, stot, a) of the plain version's
// dicts.
struct Geo {
  float mid, stot, a;
  int idc;
  bool circ;
};

// The linear expected contacts of a copy pair (delta_repeats._pair_e): the
// circular variant follows u.
__device__ __forceinline__ float pair_e(const Geo& u, const Geo& v, const RippeCell& p,
                                        float inv_nfpb) {
  const float s = fabsf(__fsub_rn(u.mid, v.mid));
  const float x = u.idc == v.idc ? expf(p.log_cis_rn(s, u.circ, u.stot)) : p.v_inter;
  return __fmul_rn(__fmul_rn(__fmul_rn(x, u.a), v.a), inv_nfpb);
}

// lane's Geo, in every lane of the warp
__device__ __forceinline__ Geo shfl_geo(const Geo& g, int lane) {
  Geo out;
  out.mid = __shfl_sync(FULL, g.mid, lane);
  out.stot = __shfl_sync(FULL, g.stot, lane);
  out.a = __shfl_sync(FULL, g.a, lane);
  out.idc = __shfl_sync(FULL, g.idc, lane);
  out.circ = __shfl_sync(FULL, (int)g.circ, lane) != 0;
  return out;
}

__device__ __forceinline__ int state_at(const CorrArgs& a, int field, int chain, int f) {
  return a.st[field][chain * a.st_cs[field] + f * a.st_is[field]];
}

// frozen_a: the accu of a copy row in the chain's base genome (0 inactive)
__device__ __forceinline__ float frozen_a(const CorrArgs& a, int chain, int krow) {
  return state_at(a, ACTIV, chain, a.t.owner[krow]) == 1 ? a.t.accu[krow] : 0.0f;
}

// frozen: a copy row's base-genome geometry
__device__ __forceinline__ Geo frozen(const CorrArgs& a, int chain, int krow) {
  const Tables& t = a.t;
  const int f = t.owner[krow];
  Geo g;
  g.mid = __fadd_rn(__fadd_rn(__fmul_rn((float)state_at(a, START, chain, f), t.inv_kb),
                              state_at(a, ORI, chain, f) == 1 ? t.pre[krow] : t.suf[krow]),
                    t.half[krow]);
  g.idc = state_at(a, IDC, chain, f);
  g.circ = state_at(a, CIRC, chain, f) == 1;
  g.stot = __fmul_rn((float)state_at(a, LCONT, chain, f), t.inv_kb);
  g.a = state_at(a, ACTIV, chain, f) == 1 ? t.accu[krow] : 0.0f;
  return g;
}

// A slot's 14 genomes at a mini row (the plain version's `pick`).
struct Mini {
  const float* mid;
  const int* idc;
  const unsigned char* act;
  const int* circ;
  const float* stot;
  const float* accu;
  int R;

  // accu is loaded beside act, not after it
  __device__ __forceinline__ float a(int k, int r) const {
    const float ac = accu[r];
    return act[k * R + r] ? ac : 0.0f;
  }
  __device__ __forceinline__ Geo at(int k, int r) const {
    const int i = k * R + r;
    Geo g;
    g.mid = mid[i];
    g.idc = idc[i];
    g.circ = circ[i] == 1;
    g.stot = stot[i];
    const float ac = accu[r];
    g.a = act[i] ? ac : 0.0f;
    return g;
  }
};

// A copy row's place in the slot's mini-state: in D, and its mini row.
struct Route {
  bool in;
  int mrow;
};

// The plain version's inv_f[owner] and mini row of a copy row, from a
// router in shared memory: the staged valid prefix (`rows`, `nvalid`: a
// binary search) or the bitmap of members (`bits`, `rank`: the members
// below each 32-bit word, so a member's place is its word's rank plus the
// set bits below it).
template <int KIND>
struct Router {
  const int* rows;
  const unsigned* bits;
  const int* rank;
  int nvalid;
  const int* owner;
  const int* sub_start;
  int s_max, R;

  __device__ __forceinline__ Route operator()(int krow) const {
    const int g = owner[krow];
    int slot;
    if (KIND == STAGED) {
      int lo = 0, hi = nvalid;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (rows[mid] < g) lo = mid + 1;
        else hi = mid;
      }
      slot = (lo < nvalid && rows[lo] == g) ? lo : -1;
    } else {
      const unsigned w = bits[g >> 5];
      const unsigned bit = 1u << (g & 31);
      slot = (w & bit) ? rank[g >> 5] + __popc(w & (bit - 1u)) : -1;
    }
    return Route{slot >= 0, clampi(max(slot, 0) * s_max + (krow - sub_start[g]), 0, R - 1)};
  }
};

// 32-bit words of the bitmap router of an n-fragment genome
__host__ __device__ __forceinline__ int bitmap_words(int n) { return (n + 31) / 32; }

// The sum of the block's per-thread values in a fixed order (a tree over
// the threads in shared memory ``red`` of blockDim.x); every thread gets
// it.
__device__ double block_sum(double x, double* red) {
  const int tid = threadIdx.x;
  red[tid] = x;
  __syncthreads();
  for (int stride = blockDim.x / 2; stride > 0; stride >>= 1) {
    if (tid < stride) red[tid] = __dadd_rn(red[tid], red[tid + stride]);
    __syncthreads();
  }
  const double out = red[0];
  __syncthreads();
  return out;
}

// Exclusive scans of two ints a thread over F1's block: warp inclusive
// scans by shuffles, one barrier, then one scan of the warp totals
// (``wsum``: 2 x F1_WARPS ints, free again after the caller's next
// barrier). Returns the exclusive prefixes in *x / *y and the block's sums
// in *tx / *ty.
__device__ __forceinline__ void block_scan2(int* x, int* y, int* wsum, int* tx, int* ty) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int ix = *x, iy = *y;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ux = __shfl_up_sync(FULL, ix, off), uy = __shfl_up_sync(FULL, iy, off);
    if (lane >= off) {
      ix += ux;
      iy += uy;
    }
  }
  if (lane == 31) {
    wsum[warp] = ix;
    wsum[F1_WARPS + warp] = iy;
  }
  __syncthreads();
  int wx = lane < F1_WARPS ? wsum[lane] : 0, wy = lane < F1_WARPS ? wsum[F1_WARPS + lane] : 0;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ux = __shfl_up_sync(FULL, wx, off), uy = __shfl_up_sync(FULL, wy, off);
    if (lane >= off) {
      wx += ux;
      wy += uy;
    }
  }
  *tx = __shfl_sync(FULL, wx, F1_WARPS - 1);
  *ty = __shfl_sync(FULL, wy, F1_WARPS - 1);
  const int bx = __shfl_sync(FULL, wx, (warp + 31) & 31);
  const int by = __shfl_sync(FULL, wy, (warp + 31) & 31);
  *x = (warp > 0 ? bx : 0) + ix - *x;
  *y = (warp > 0 ? by : 0) + iy - *y;
}

// Build the slot's router in shared memory ``smem`` (STAGED: f_max ints;
// BITMAP: 2 x bitmap_words(n) ints); every thread gets it.
template <int KIND>
__device__ Router<KIND> build_router(const CorrArgs& a, int slot, int* smem, int* wsum) {
  const Tables& t = a.t;
  const long long* rows = a.rows + (long long)slot * a.f_max;
  const unsigned char* valid = a.valid + (long long)slot * a.f_max;
  const int tid = threadIdx.x;
  Router<KIND> r{};
  r.owner = t.owner;
  r.sub_start = t.sub_start;
  r.s_max = t.s_max;
  r.R = a.R;
  if (KIND == STAGED) {
    // the valid rows are a prefix: its length is their count
    int cnt = 0;
    for (int i = tid; i < a.f_max; i += F1_THREADS) {
      const bool v = valid[i];
      smem[i] = (int)rows[i];
      cnt += v;
    }
    cnt = __reduce_add_sync(FULL, cnt);
    if ((tid & 31) == 0) wsum[tid >> 5] = cnt;
    __syncthreads();
    r.nvalid = __reduce_add_sync(FULL, (tid & 31) < F1_WARPS ? wsum[tid & 31] : 0);
    r.rows = smem;
    __syncthreads();            // wsum free again
  } else {
    const int nw = bitmap_words(t.n);
    unsigned* bits = reinterpret_cast<unsigned*>(smem);
    int* rank = smem + nw;
    for (int w = tid; w < nw; w += F1_THREADS) bits[w] = 0u;
    __syncthreads();
    for (int i = tid; i < a.f_max; i += F1_THREADS)
      if (valid[i]) {
        const int g = (int)rows[i];
        atomicOr(&bits[g >> 5], 1u << (g & 31));
      }
    __syncthreads();
    // the ranks: an exclusive scan of the words' counts, a contiguous run
    // of words a thread
    const int per = (nw + F1_THREADS - 1) / F1_THREADS;
    const int w0 = min(tid * per, nw), w1 = min(w0 + per, nw);
    int run = 0, none = 0, total, unused;
    for (int w = w0; w < w1; ++w) run += __popc(bits[w]);
    block_scan2(&run, &none, wsum, &total, &unused);
    for (int w = w0; w < w1; ++w) {
      rank[w] = run;
      run += __popc(bits[w]);
    }
    r.bits = bits;
    r.rank = rank;
    r.nvalid = total;
    __syncthreads();            // the ranks written, wsum free again
  }
  return r;
}

// One D row's walk (F1): its same-bin copies' routes (the pairs' mini rows
// kept in sb_stage by row), o_same, and its mixed-entry range [*w0, *w0 +
// *n_mx). Returns the row's same-bin pairs.
template <int KIND>
__device__ int walk_row(const CorrArgs& a, const Router<KIND>& route, int slot, int chain, int r,
                        int* w0, int* n_mx) {
  const Tables& t = a.t;
  const int R = a.R, s_max = t.s_max, C = t.c_max;
  const long long* rows = a.rows + (long long)slot * a.f_max;
  const int j = r / s_max, si = r - j * s_max;
  const int frag = (int)rows[j];
  const bool sv = a.valid[(long long)slot * a.f_max + j] && si < t.sub_count[frag];
  const int db = t.data_id[clampi(t.sub_start[frag] + si, 0, t.K - 1)];
  const bool db_dup = t.dup[db] && sv;
  const int c0 = t.copy_start[db], cnt = t.copy_start[db + 1] - c0;
  *w0 = 0;
  *n_mx = 0;
  if (t.capm > 0 && sv && !db_dup) {
    *w0 = t.mx_start[db];
    *n_mx = min(t.mx_start[db + 1], *w0 + t.capm) - *w0;
  }
  int* stage = a.sb_stage + ((long long)slot * R + r) * C;
  int n_sb = 0;
  Fold out_a;
  for (int c = 0; c < C; ++c) {
    const int krow = t.copy_rows[clampi(c0 + c, 0, t.K - 1)];
    const bool ok = c < cnt;
    const Route q = route(krow);
    if (q.in && ok && db_dup && q.mrow > r) stage[n_sb++] = q.mrow;
    out_a.add((ok && !q.in) ? frozen_a(a, chain, krow) : 0.0f);
  }
  a.o_same[(long long)slot * R + r] = out_a.v;
  return n_sb;
}

// One mixed record (F1): D row r's window entry ent at place ``at`` of the
// slot's records, with its in-D mini rows and frozen trans mass.
template <int KIND>
__device__ void write_mixed(const CorrArgs& a, const Router<KIND>& route, int chain, int r,
                            int ent, long long at) {
  const Tables& t = a.t;
  const int C = t.c_max;
  int* rec = a.mx_rec + at * (2 + C);
  rec[0] = r;
  rec[1] = ent;
  const int tb = t.mx_cols[ent];
  const int v0 = t.copy_start[tb], vc = t.copy_start[tb + 1] - v0;
  Fold out_t;
  for (int c = 0; c < C; ++c) {
    const int krow = t.copy_rows[clampi(v0 + c, 0, t.K - 1)];
    const bool ok = c < vc;
    const Route q = route(krow);
    rec[2 + c] = (ok && q.in) ? q.mrow : -1;
    out_t.add((ok && !q.in) ? frozen_a(a, chain, krow) : 0.0f);
  }
  a.mx_aout[at] = out_t.v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// A slot's D rows, block `rank` of its cluster of K: rows [rb0, rb0 +
// n_rows), a contiguous run a thread. ``row_smem`` holds three ints a row
// of the block's run: its mixed range's start, its mixed count (then its
// records' place in the block), its same-bin pairs.
template <int KIND>
__device__ void d_rows(const CorrArgs& a, const Router<KIND>& route, int slot, int rank,
                       int* row_smem, int* wsum, int* s_block) {
  const Tables& t = a.t;
  const int R = a.R, K = a.cluster, C = t.c_max, tid = threadIdx.x;
  const int chain = slot / a.m;
  const int rb = (R + K - 1) / K;
  const int rb0 = min(rank * rb, R), n_rows = min(rb0 + rb, R) - rb0;
  int* s_w0 = row_smem;
  int* s_off = row_smem + rb;
  int* s_nsb = row_smem + 2 * rb;
  const int per = (n_rows + F1_THREADS - 1) / F1_THREADS;
  const int l0 = min(tid * per, n_rows), l1 = min(l0 + per, n_rows);
  int ex_mx = 0, ex_sb = 0;
  for (int l = l0; l < l1; ++l) {
    int w0, nm;
    const int ns = walk_row(a, route, slot, chain, rb0 + l, &w0, &nm);
    s_w0[l] = w0;
    s_off[l] = nm;
    s_nsb[l] = ns;
    ex_mx += nm;
    ex_sb += ns;
  }
  // each thread's place in the block, then (K > 1) the block's in the slot
  int tot_mx, tot_sb;
  block_scan2(&ex_mx, &ex_sb, wsum, &tot_mx, &tot_sb);
  int base_mx = 0, base_sb = 0;
  if (K > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (tid == 0) {
      s_block[0] = tot_mx;
      s_block[1] = tot_sb;
    }
    cluster.sync();
    for (int q = 0; q < rank; ++q) {
      base_mx += *cluster.map_shared_rank(&s_block[0], q);
      base_sb += *cluster.map_shared_rank(&s_block[1], q);
    }
    cluster_arrive();            // done reading the peers' shared memory
  }
  if (rank == K - 1 && tid == 0) {
    a.n_rec[slot * 2] = base_mx + tot_mx;
    a.n_rec[slot * 2 + 1] = base_sb + tot_sb;
  }
  // this thread's rows: the same-bin pairs to their places, the mixed
  // counts to their records' places in the block
  int run_sb = base_sb + ex_sb, run_mx = ex_mx;
  for (int l = l0; l < l1; ++l) {
    const int r = rb0 + l;
    const int* stage = a.sb_stage + ((long long)slot * R + r) * C;
    for (int k = 0; k < s_nsb[l]; ++k, ++run_sb) {
      int* pair = a.sb_pair + ((long long)slot * R * C + run_sb) * 2;
      pair[0] = r;
      pair[1] = stage[k];
    }
    const int nm = s_off[l];
    s_off[l] = run_mx;
    run_mx += nm;
  }
  __syncthreads();
  // the block's mixed records, flat: record i by thread i mod 1,024, its
  // row the last whose place is at most i
  const long long at0 = (long long)slot * R * t.capm + base_mx;
  for (int i = tid; i < tot_mx; i += F1_THREADS) {
    int lo = 0, hi = n_rows;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_off[mid] <= i) lo = mid + 1;
      else hi = mid;
    }
    const int l = lo - 1;
    write_mixed(a, route, chain, rb0 + l, s_w0[l] + (i - s_off[l]), at0 + i);
  }
  if (K > 1) cluster_wait();     // no block leaves while a peer may read it
}

// A slot's work that does not wait for its D rows, split over the K
// blocks of its cluster: the multi-multi entries (a warp an entry), part 4
// and fA's copies' mini rows.
template <int KIND>
__device__ void entries(const CorrArgs& a, const Router<KIND>& route, int slot, int rank) {
  const Tables& t = a.t;
  const int C = t.c_max, K = a.cluster, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int chain = slot / a.m;
  const RippeCell p(a.pvec + (long long)slot * N_PARAMS);
  const float inv_nfpb = t.inv_nfpb;
  const float vn = __fmul_rn(p.v_inter, inv_nfpb);

  // ---- multi-multi entries: frozen x frozen pairs, frozen masses ---------
  // lane l takes copy row cu = l (l + 32, ...) of the u end; every sum is
  // folded in copy order through shuffles, so it is the plain left fold
  for (int d = rank * F1_WARPS + warp; d < t.ndd; d += K * F1_WARPS) {
    const long long at = (long long)slot * t.ndd + d;
    const int* ur = t.ddu_rows + d * C;
    const int* vr = t.ddv_rows + d * C;
    const unsigned char* uok = t.ddu_ok + d * C;
    const unsigned char* vok = t.ddv_ok + d * C;
    Fold ee, au, av;
    for (int ub = 0; ub < C; ub += 32) {
      const int cu = ub + lane, nu = min(32, C - ub);
      Geo gu{};
      bool u_out = false;
      float fau = 0.0f, fav = 0.0f;
      if (cu < C) {
        const Route qu = route(ur[cu]), qv = route(vr[cu]);
        u_out = uok[cu] && !qu.in;
        gu = frozen(a, chain, ur[cu]);
        a.dd_mini[(at * 2) * C + cu] = (uok[cu] && qu.in) ? qu.mrow : -1;
        a.dd_mini[(at * 2 + 1) * C + cu] = (vok[cu] && qv.in) ? qv.mrow : -1;
        if (u_out) fau = frozen_a(a, chain, ur[cu]);
        if (vok[cu] && !qv.in) fav = frozen_a(a, chain, vr[cu]);
      }
      for (int k = 0; k < nu; ++k) {
        au.add(__shfl_sync(FULL, fau, k));
        av.add(__shfl_sync(FULL, fav, k));
      }
      // copy row cu folded over cv, the v end's geometry passed by shuffles
      Fold row;
      for (int vb = 0; vb < C; vb += 32) {
        const int cv = vb + lane;
        Geo gv{};
        bool v_out = false;
        if (cv < C) {
          v_out = vok[cv] && !route(vr[cv]).in;
          gv = frozen(a, chain, vr[cv]);
        }
        for (int k = 0; k < min(32, C - vb); ++k) {
          const Geo g = shfl_geo(gv, k);
          const bool out = __shfl_sync(FULL, (int)v_out, k) != 0;
          row.add((u_out && out) ? pair_e(gu, g, p, inv_nfpb) : 0.0f);
        }
      }
      for (int k = 0; k < nu; ++k) ee.add(__shfl_sync(FULL, row.v, k));
    }
    if (lane == 0) {
      a.dd_f[at * 3] = ee.v;
      a.dd_f[at * 3 + 1] = au.v;
      a.dd_f[at * 3 + 2] = av.v;
    }
  }

  // ---- part 4: fA's multi-copy bins x frozen single-copy partners --------
  if (t.capd == 0) return;
  const int fa = (int)a.fa[chain * a.fa_s];
  const int fs = t.sub_start[fa], fc = t.sub_count[fa];
  const int n4 = t.s_max * t.capd;
  for (int i = rank * F1_THREADS + tid; i < n4; i += K * F1_THREADS) {
    const int si = i / t.capd, w = i - si * t.capd;
    const int dba = t.data_id[clampi(fs + si, 0, t.K - 1)];
    const long long at = (long long)slot * n4 + i;
    const int ent = t.so_start[dba] + w;
    int keep = -1;
    if (t.dup[dba] && si < fc && ent < t.so_start[dba + 1]) {
      const int t4 = t.so_cols[ent];
      const int t4_row = t.copy_rows[min(t.copy_start[t4], t.K - 1)];
      if (!t.dup[t4] && !route(t4_row).in) {
        const Geo gt = frozen(a, chain, t4_row);
        const int c0 = t.copy_start[dba], cnt = t.copy_start[dba + 1] - c0;
        Fold e;
        for (int c = 0; c < C; ++c) {
          const int krow = t.copy_rows[clampi(c0 + c, 0, t.K - 1)];
          e.add((c < cnt && !route(krow).in) ? pair_e(frozen(a, chain, krow), gt, p, inv_nfpb)
                                             : 0.0f);
        }
        a.p4_f[at * 2] = e.v;
        a.p4_f[at * 2 + 1] = __fmul_rn(vn, gt.a);
        keep = ent;
      }
    }
    a.p4_ent[at] = keep;
  }
  for (int i = rank * F1_THREADS + tid; i < t.s_max * C; i += K * F1_THREADS) {
    const int si = i / C, c = i - si * C;
    const int dba = t.data_id[clampi(fs + si, 0, t.K - 1)];
    const int c0 = t.copy_start[dba], cnt = t.copy_start[dba + 1] - c0;
    const Route q = route(t.copy_rows[clampi(c0 + c, 0, t.K - 1)]);
    a.ca_mini[(long long)slot * t.s_max * C + i] = (c < cnt && q.in) ? q.mrow : -1;
  }
}

// F1's dynamic shared memory: the router, and three ints a row of a D-row
// block's run
__host__ __device__ __forceinline__ long long f1_smem(const CorrArgs& a) {
  const long long router = a.router == STAGED ? a.f_max : 2LL * bitmap_words(a.t.n);
  const long long rb = (a.R + a.cluster - 1) / a.cluster;
  return 4 * (router + 3 * rb);
}

// F1: a grid (K, 2 M + C) in clusters of (K, 1, 1). Grid row y < 2 M is
// slot y / 2's D-row cluster (y even) or entry cluster (y odd); the last C
// rows are the chains' (block 0 of each sums w_all).
template <int KIND>
__global__ void __launch_bounds__(F1_THREADS) corr_frozen_kernel(CorrArgs a) {
  extern __shared__ int smem[];          // the router, then a D-row block's rows
  __shared__ int wsum[2 * F1_WARPS];
  __shared__ int s_block[2];             // a D-row block's totals, read by its peers
  __shared__ double red[F1_THREADS];
  const Tables& t = a.t;
  const int tid = threadIdx.x;
  const int rank = (int)blockIdx.x;      // the block's rank in its cluster
  const int n_slots = a.C * a.m;
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) atomicAdd(a.frozen_counter, 1ULL);

  if ((int)blockIdx.y >= 2 * n_slots) {  // a chain's active accu mass
    if (rank != 0) return;
    const int chain = blockIdx.y - 2 * n_slots;
    double acc = 0.0;
    for (int k = tid; k < t.K; k += F1_THREADS)
      if (state_at(a, ACTIV, chain, t.owner[k]) == 1) acc = __dadd_rn(acc, (double)t.accu[k]);
    const double w = block_sum(acc, red);
    if (tid == 0) a.w_all[chain] = w;
    return;
  }
  const int slot = blockIdx.y >> 1;
  const Router<KIND> route = build_router<KIND>(a, slot, smem, wsum);
  if (blockIdx.y & 1) {
    entries(a, route, slot, rank);
  } else {
    const int router_ints = KIND == STAGED ? a.f_max : 2 * bitmap_words(t.n);
    d_rows(a, route, slot, rank, smem + router_ints, wsum, s_block);
  }
}

// ---- F2 --------------------------------------------------------------------

// n rounded up to a multiple of the fold lanes: where a group of F2's record
// sequence ends
__device__ __forceinline__ int pad_fold(int n) { return (n + F2_FOLD - 1) / F2_FOLD * F2_FOLD; }

// The genome geometry Geo of lane `src` of this lane's group of `width`
__device__ __forceinline__ Geo shfl_geo_w(const Geo& g, int src, int width) {
  Geo out;
  out.mid = __shfl_sync(FULL, g.mid, src, width);
  out.stot = __shfl_sync(FULL, g.stot, src, width);
  out.a = __shfl_sync(FULL, g.a, src, width);
  out.idc = __shfl_sync(FULL, g.idc, src, width);
  out.circ = __shfl_sync(FULL, (int)g.circ, src, width) != 0;
  return out;
}

// A place of F2's record sequence as a thread stages it: first its ints
// (`load_ints`), then its rows' geometry and its entry's (ob, lf)
// (`load_rows`), then its f32 term (`term`); a thread takes PLACES
// places through each step before the next, so their loads are in flight
// together. Copies past F2_COPIES are loaded F2_COPIES at a time as the
// term is folded.
enum PlaceKind { P_ZERO = 0, P_MIXED, P_PART4, P_SAME, P_ENTRY };

struct Place {
  int kind, i;               // i: the place's index in its group
  int u, ent;                // mixed: D row, entry; part 4: -, entry; same-bin: first row
  int v[F2_COPIES];          // mixed / part 4: the copies' mini rows; same-bin: v[0]
  float s0, s1;              // mixed: aout; part 4: f0, f1
  float ob, lf;
  Geo gu;
  Geo gv[F2_COPIES];         // mid, idc and a (part 4: a alone)
};

// The geometry pair_e reads of a v end: mid, idc, a (every load issued)
__device__ __forceinline__ Geo v_end(const Mini& g, int k, int r) {
  const int i = k * g.R + r;
  Geo out;
  out.mid = g.mid[i];
  out.idc = g.idc[i];
  const float ac = g.accu[r];
  out.a = g.act[i] ? ac : 0.0f;
  out.stot = 0.0f;
  out.circ = false;
  return out;
}

// Place q of the sequence (laid out as in corr_sums_kernel); q < 0: none
__device__ __forceinline__ void load_ints(const CorrArgs& a, int slot, int q, int n_mx, int p_dd,
                                          int ndd, int p_p4, int n4, int p_sb, int n_sb,
                                          Place& pl) {
  const Tables& t = a.t;
  const int C = t.c_max;
  pl.kind = P_ZERO;
  if (q < 0) return;
  if (q < p_dd) {
    if (q >= n_mx) return;
    pl.kind = P_MIXED;
    pl.i = q;
    const long long at = (long long)slot * a.R * t.capm + q;
    const int* rec = a.mx_rec + at * (2 + C);
    pl.u = rec[0];
    pl.ent = rec[1];
#pragma unroll
    for (int c = 0; c < F2_COPIES; ++c) pl.v[c] = c < C ? rec[2 + c] : -1;
    pl.s0 = a.mx_aout[at];
  } else if (q < p_p4) {
    if (q - p_dd < ndd) pl.kind = P_ENTRY;
  } else if (q < p_sb) {
    const int i = q - p_p4;
    if (i >= n4) return;
    pl.kind = P_PART4;
    pl.i = i;
    const long long at = (long long)slot * t.s_max * t.capd + i;
    const int* cm = a.ca_mini + ((long long)slot * t.s_max + i / t.capd) * C;
    pl.ent = a.p4_ent[at];
#pragma unroll
    for (int c = 0; c < F2_COPIES; ++c) pl.v[c] = c < C ? cm[c] : -1;
    pl.s0 = a.p4_f[at * 2];
    pl.s1 = a.p4_f[at * 2 + 1];
  } else if (q - p_sb < n_sb) {
    pl.kind = P_SAME;
    pl.i = q - p_sb;
    const int* pair = a.sb_pair + ((long long)slot * a.R * t.c_max + pl.i) * 2;
    pl.u = pair[0];
    pl.v[0] = pair[1];
  }
}

__device__ __forceinline__ void load_rows(const CorrArgs& a, const Mini& g, int k, Place& pl) {
  const Tables& t = a.t;
  if (pl.kind == P_MIXED) {
    pl.ob = t.mx_vals[pl.ent];
    pl.lf = t.mx_lf[pl.ent];
    pl.gu = g.at(k, pl.u);
#pragma unroll
    for (int c = 0; c < F2_COPIES; ++c) pl.gv[c] = v_end(g, k, max(pl.v[c], 0));
  } else if (pl.kind == P_PART4) {
    if (pl.ent >= 0) {
      pl.ob = t.so_vals[pl.ent];
      pl.lf = t.so_lf[pl.ent];
    }
#pragma unroll
    for (int c = 0; c < F2_COPIES; ++c) pl.gv[c].a = g.a(k, max(pl.v[c], 0));
  } else if (pl.kind == P_SAME) {
    pl.gu = g.at(k, pl.u);
    pl.gv[0] = v_end(g, k, pl.v[0]);
  }
}

// The place's f32 term, op for op the plain version's: mixed, its copies'
// left fold plus the frozen trans mass, ob log e - lf where e > 0; part 4,
// f0 + f1 x the left fold of the bin's copies' activity; same-bin, the
// pair's linear contacts. 0 for a padding place.
__device__ __forceinline__ float term(const CorrArgs& a, const Mini& g, int k, int slot,
                                     const RippeCell& p, float vn, const Place& pl) {
  const Tables& t = a.t;
  const int C = t.c_max;
  if (pl.kind == P_MIXED) {
    Fold e;
#pragma unroll
    for (int c = 0; c < F2_COPIES; ++c)
      if (c < C) e.add(pl.v[c] >= 0 ? pair_e(pl.gu, pl.gv[c], p, t.inv_nfpb) : 0.0f);
    if (C > F2_COPIES) {
      const int* rec = a.mx_rec + ((long long)slot * a.R * t.capm + pl.i) * (2 + C);
      for (int c0 = F2_COPIES; c0 < C; c0 += F2_COPIES) {
        int vm[F2_COPIES];
        Geo gv[F2_COPIES];
#pragma unroll
        for (int j = 0; j < F2_COPIES; ++j) vm[j] = c0 + j < C ? rec[2 + c0 + j] : -1;
#pragma unroll
        for (int j = 0; j < F2_COPIES; ++j) gv[j] = v_end(g, k, max(vm[j], 0));
#pragma unroll
        for (int j = 0; j < F2_COPIES; ++j)
          if (c0 + j < C) e.add(vm[j] >= 0 ? pair_e(pl.gu, gv[j], p, t.inv_nfpb) : 0.0f);
      }
    }
    const float e_mix = __fadd_rn(e.v, __fmul_rn(__fmul_rn(vn, pl.gu.a), pl.s0));
    return e_mix > 0.0f ? __fsub_rn(__fmul_rn(pl.ob, logf(e_mix)), pl.lf) : 0.0f;
  }
  if (pl.kind == P_PART4) {
    if (pl.ent < 0) return 0.0f;
    Fold ad;
#pragma unroll
    for (int c = 0; c < F2_COPIES; ++c)
      if (c < C) ad.add(pl.v[c] >= 0 ? pl.gv[c].a : 0.0f);
    if (C > F2_COPIES) {
      const int* cm = a.ca_mini + ((long long)slot * t.s_max + pl.i / t.capd) * C;
      for (int c0 = F2_COPIES; c0 < C; c0 += F2_COPIES) {
        int vm[F2_COPIES];
        float av[F2_COPIES];
#pragma unroll
        for (int j = 0; j < F2_COPIES; ++j) vm[j] = c0 + j < C ? cm[c0 + j] : -1;
#pragma unroll
        for (int j = 0; j < F2_COPIES; ++j) av[j] = g.a(k, max(vm[j], 0));
#pragma unroll
        for (int j = 0; j < F2_COPIES; ++j)
          if (c0 + j < C) ad.add(vm[j] >= 0 ? av[j] : 0.0f);
      }
    }
    const float e4 = __fadd_rn(pl.s0, __fmul_rn(pl.s1, ad.v));
    return e4 > 0.0f ? __fsub_rn(__fmul_rn(pl.ob, logf(e4)), pl.lf) : 0.0f;
  }
  if (pl.kind == P_SAME) return pair_e(pl.gu, pl.gv[0], p, t.inv_nfpb);
  return 0.0f;
}

// The multi-multi entries [d0, d1) of the slot for genome k, staged at
// stage[d + off]: a group of GW lanes an entry, lane l of a group copy row
// cu = l (+ GW, ...) of the u end, each row folded over cv left to right
// with the v end's geometry passed by shuffles, the rows folded in cu
// order; so every sum is the plain left fold. Called by every thread of
// the genome's TG (warp-uniform loops).
template <int TG>
__device__ void multi_multi_terms(const CorrArgs& a, const Mini& g, int k, int slot,
                                  const RippeCell& p, float vn, int d0, int d1, float* stage,
                                  int off, int th) {
  const Tables& t = a.t;
  const int C = t.c_max;
  int gw = 1;
  while (gw < C && gw < 32) gw <<= 1;
  const int per_warp = 32 / gw;
  const int lane = th & 31, sub = lane & (gw - 1), grp = lane / gw;
  for (int base = d0 + (th >> 5) * per_warp; base < d1; base += (TG / 32) * per_warp) {
    const int d = base + grp;
    const bool live = d < d1;
    const long long at = (long long)slot * t.ndd + (live ? d : d0);
    const int* um = a.dd_mini + (at * 2) * C;
    const int* vm = a.dd_mini + (at * 2 + 1) * C;
    Fold ee, au, av;
    for (int ub = 0; ub < C; ub += gw) {
      const int cu = ub + sub, nu = min(gw, C - ub);
      const int u = cu < C ? um[cu] : -1;
      const Geo gu = g.at(k, max(u, 0));
      Fold row;
      for (int vb = 0; vb < C; vb += gw) {
        const int cv = vb + sub, nv = min(gw, C - vb);
        const int v = cv < C ? vm[cv] : -1;
        const Geo gv = g.at(k, max(v, 0));
        if (ub == 0)
          for (int q = 0; q < nv; ++q) {        // every lane shuffles, then selects
            const int vq = __shfl_sync(FULL, v, q, gw);
            const float aq = __shfl_sync(FULL, gv.a, q, gw);
            av.add(vq >= 0 ? aq : 0.0f);
          }
        for (int q = 0; q < nv; ++q) {
          const Geo gq = shfl_geo_w(gv, q, gw);
          const bool vq = __shfl_sync(FULL, v, q, gw) >= 0;
          row.add((u >= 0 && vq) ? pair_e(gu, gq, p, t.inv_nfpb) : 0.0f);
        }
      }
      for (int q = 0; q < nu; ++q) {
        ee.add(__shfl_sync(FULL, row.v, q, gw));
        const int uq = __shfl_sync(FULL, u, q, gw);
        const float aq = __shfl_sync(FULL, gu.a, q, gw);
        au.add(uq >= 0 ? aq : 0.0f);
      }
    }
    if (live && sub == 0) {
      const float e_dd = __fadd_rn(
          __fadd_rn(a.dd_f[at * 3], ee.v),
          __fmul_rn(vn, __fadd_rn(__fmul_rn(au.v, a.dd_f[at * 3 + 2]),
                                  __fmul_rn(a.dd_f[at * 3 + 1], av.v))));
      stage[d + off] = e_dd > 0.0f
                           ? __fsub_rn(__fmul_rn(t.dd_ob[d], logf(e_dd)), t.dd_lf[d])
                           : 0.0f;
    }
  }
}

// The fixed tree over 128 f64 partials p[0..127] as the earlier design
// folded them (strides 64, 32 in shared memory, then 16 ... 1): called by
// one warp, lane 0 gets the sum.
__device__ __forceinline__ double tree128(const double* p, int lane) {
  double s = __dadd_rn(__dadd_rn(p[lane], p[lane + 64]), __dadd_rn(p[lane + 32], p[lane + 96]));
  for (int o = 16; o > 0; o >>= 1) s = __dadd_rn(s, __shfl_down_sync(FULL, s, o));
  return s;
}

// The same over 256 partials (strides 128, 64, 32, then 16 ... 1).
__device__ __forceinline__ double tree256(const double* p, int lane) {
  const double a0 = __dadd_rn(__dadd_rn(p[lane], p[lane + 128]),
                              __dadd_rn(p[lane + 64], p[lane + 192]));
  const double a1 = __dadd_rn(__dadd_rn(p[lane + 32], p[lane + 160]),
                              __dadd_rn(p[lane + 96], p[lane + 224]));
  double s = __dadd_rn(a0, a1);
  for (int o = 16; o > 0; o >>= 1) s = __dadd_rn(s, __shfl_down_sync(FULL, s, o));
  return s;
}

// F2: a grid (14, M) in clusters of (14, 1, 1), a cluster a slot; block
// k sums genome k (0 the base) with TG threads.
template <int TG, int PLACES>
__global__ void __launch_bounds__(TG, sums_sm_threads(PLACES) / TG)
    corr_sums_kernel(CorrArgs a) {
  constexpr int LANES = TG >= F2_CROSS ? 1 : F2_CROSS / TG;   // cross lanes a thread
  __shared__ float stage[F2_TILE];
  __shared__ double red[F2_CROSS];
  __shared__ double s_base[2];             // block 0: corr[0] and w_out, read by the peers
  static_assert(TG >= F2_FOLD && TG % 32 == 0 && (TG % F2_CROSS == 0 || F2_CROSS % TG == 0),
                "F2's layout");
  cg::cluster_group cluster = cg::this_cluster();
  const Tables& t = a.t;
  const int k = (int)blockIdx.x, slot = (int)blockIdx.y, th = threadIdx.x;
  const int chain = slot / a.m, R = a.R;
  if (k == 0 && slot == 0 && th == 0) atomicAdd(a.sums_counter, 1ULL);
  const RippeCell p(a.pvec + (long long)slot * N_PARAMS);
  const float vn = __fmul_rn(p.v_inter, t.inv_nfpb);
  const long long off = (long long)slot * N_GEN * R;
  const Mini g{a.mid + off, a.idc + off, a.act + off, a.circ + off, a.stot + off,
               a.accu_sub + (long long)slot * R, R};
  const float* o_same = a.o_same + (long long)slot * R;

  // first the base genome's D mass, which waits for nothing; thread th
  // holds lanes th (+ TG) of the 256
  double dmass[LANES];
#pragma unroll
  for (int l = 0; l < LANES; ++l) {
    const int lane = th + l * TG;
    dmass[l] = 0.0;
    if (k == 0 && th < F2_CROSS) {
#pragma unroll 4
      for (int r = lane; r < R; r += F2_CROSS) dmass[l] = __dadd_rn(dmass[l], (double)g.a(0, r));
    }
  }

  // the record sequence: mixed, multi-multi, part 4, same-bin, each padded
  const int n_mx = a.n_rec[slot * 2], n_sb = a.n_rec[slot * 2 + 1];
  const int n4 = t.s_max * t.capd, ndd = t.ndd;
  const int p_dd = pad_fold(n_mx), p_p4 = p_dd + pad_fold(ndd), p_sb = p_p4 + pad_fold(n4);
  const int n_seq = p_sb + pad_fold(n_sb);
  double acc = 0.0;
  for (int t0 = 0; t0 < n_seq; t0 += F2_TILE) {
    const int t1 = min(n_seq, t0 + F2_TILE);
    for (int b = t0 + th; b < t1; b += TG * PLACES) {
      Place pl[PLACES];
#pragma unroll
      for (int j = 0; j < PLACES; ++j) {
        const int q = b + j * TG;
        load_ints(a, slot, q < t1 ? q : -1, n_mx, p_dd, ndd, p_p4, n4, p_sb, n_sb, pl[j]);
      }
#pragma unroll
      for (int j = 0; j < PLACES; ++j) load_rows(a, g, k, pl[j]);
#pragma unroll
      for (int j = 0; j < PLACES; ++j) {
        const int q = b + j * TG;
        if (q < t1 && pl[j].kind != P_ENTRY) stage[q - t0] = term(a, g, k, slot, p, vn, pl[j]);
      }
    }
    const int d0 = max(t0 - p_dd, 0), d1 = min(t1 - p_dd, ndd);
    if (d0 < d1) multi_multi_terms<TG>(a, g, k, slot, p, vn, d0, d1, stage, p_dd - t0, th);
    __syncthreads();
    if (th < F2_FOLD)
      for (int q = th; q < t1 - t0; q += F2_FOLD) acc = __dadd_rn(acc, (double)stage[q]);
    __syncthreads();
  }
  // a candidate's first cross rows, loaded while the sums fold and block 0
  // finds w_out (not before the terms: registers the places use)
  float da[LANES][F2_PRE], os[LANES][F2_PRE];
  if (k > 0 && th < F2_CROSS) {
#pragma unroll
    for (int l = 0; l < LANES; ++l)
#pragma unroll
      for (int q = 0; q < F2_PRE; ++q) {
        const int r = th + l * TG + q * F2_CROSS;
        da[l][q] = r < R ? __fsub_rn(g.a(k, r), g.a(0, r)) : 0.0f;
        os[l][q] = r < R ? o_same[r] : 0.0f;
      }
  }
  if (th < F2_FOLD) red[th] = acc;
  __syncthreads();
  double corr_k = 0.0;
  if (th < 32) corr_k = tree128(red, th);
  __syncthreads();
  if (k == 0) {
    if (th < F2_CROSS)
#pragma unroll
      for (int l = 0; l < LANES; ++l) red[th + l * TG] = dmass[l];
    __syncthreads();
    if (th < 32) {
      const double w_out = __dsub_rn(a.w_all[chain], tree256(red, th));
      if (th == 0) {
        s_base[0] = corr_k;
        s_base[1] = w_out;
        a.corr[(long long)slot * N_GEN] = corr_k;
      }
    }
  }
  cluster.sync();                          // corr[0] and w_out in block 0's shared memory

  if (k > 0 && th < F2_CROSS) {
    const double w_out = *cluster.map_shared_rank(&s_base[1], 0);
#pragma unroll
    for (int l = 0; l < LANES; ++l) {
      const int lane = th + l * TG;
      double x = 0.0;
#pragma unroll
      for (int q = 0; q < F2_PRE; ++q)
        if (lane + q * F2_CROSS < R)
          x = __dadd_rn(x, __dmul_rn((double)da[l][q], __dsub_rn(w_out, (double)os[l][q])));
      for (int r = lane + F2_PRE * F2_CROSS; r < R; r += F2_CROSS)
        x = __dadd_rn(x, __dmul_rn((double)__fsub_rn(g.a(k, r), g.a(0, r)),
                                   __dsub_rn(w_out, (double)o_same[r])));
      red[lane] = x;
    }
  }
  const double corr0 = *cluster.map_shared_rank(&s_base[0], 0);
  cluster_arrive();                        // done reading block 0's shared memory
  __syncthreads();
  if (k > 0 && th < 32) {
    const double cross = __dmul_rn((double)vn, tree256(red, th));
    if (th == 0) {
      const long long o = (long long)slot * N_OPS + k - 1;
      a.corr[(long long)slot * N_GEN + k] = corr_k;
      a.cross[o] = cross;
      a.dll[o] = (float)__dsub_rn(__dadd_rn((double)a.dll1[o], __dsub_rn(corr_k, corr0)), cross);
    }
  }
  cluster_wait();                          // no block leaves while a peer may read it
}

// F2's launch configuration: `slots` clusters of 14 blocks of TG threads
template <int TG>
struct SumsLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  SumsLaunch(int slots, cudaStream_t s) {
    cfg.gridDim = dim3(N_GEN, static_cast<unsigned>(slots), 1);
    cfg.blockDim = dim3(TG, 1, 1);
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = N_GEN;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <int TG, int PLACES>
cudaError_t launch_sums(const CorrArgs& a, cudaStream_t s) {
  SumsLaunch<TG> l(a.C * a.m, s);
  const cudaError_t e = cudaLaunchKernelEx(&l.cfg, corr_sums_kernel<TG, PLACES>, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The clusters of F2's layout the current device holds at once, or
// -cudaError_t
template <int TG, int PLACES>
long long sums_fit() {
  SumsLaunch<TG> l(1, nullptr);
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(
      &n, reinterpret_cast<const void*>(corr_sums_kernel<TG, PLACES>), &l.cfg);
  return e == cudaSuccess ? n : -static_cast<long long>(e);
}

template <int KIND>
cudaError_t launch_frozen(const CorrArgs& a, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.cluster), 2 * a.C * a.m + a.C, 1);
  cfg.blockDim = dim3(F1_THREADS, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(f1_smem(a));
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, corr_frozen_kernel<KIND>, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

int launch(bool sums, const void* args, void* stream) {
  const CorrArgs* a = static_cast<const CorrArgs*>(args);
  if (a->t.c_max < 1 || a->C < 1 || a->m < 1) return (int)cudaErrorInvalidValue;
  const int slots = a->C * a->m;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sums) {
    if (a->sums_counter == nullptr || slots > 65535) return (int)cudaErrorInvalidValue;
    switch (a->sums_plan) {
      case W512: return (int)launch_sums<512, 2>(*a, s);
      case W256: return (int)launch_sums<256, 2>(*a, s);
      case W128: return (int)launch_sums<128, 2>(*a, s);
      case D512: return (int)launch_sums<512, 1>(*a, s);
      case D256: return (int)launch_sums<256, 1>(*a, s);
      case D128: return (int)launch_sums<128, 1>(*a, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (a->frozen_counter == nullptr || a->cluster < 1 || a->cluster > MAX_CLUSTER
      || (a->router != STAGED && a->router != BITMAP) || 2LL * slots + a->C > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)(a->router == STAGED ? launch_frozen<STAGED>(*a, s) : launch_frozen<BITMAP>(*a, s));
}

}  // namespace

extern "C" {

// sizeof the argument block, for the wrapper's check of its ctypes mirror
int repeat_corr_args_size() { return (int)sizeof(CorrArgs); }

// F1's dynamic shared memory (bytes) for the block's plan and shapes
long long repeat_corr_frozen_smem(const void* args) {
  return f1_smem(*static_cast<const CorrArgs*>(args));
}

// Opt F1 in to the current device's largest dynamic shared memory, and F2's
// 14-block clusters in to a cluster size past the portable one: once a
// device, outside any capture. Returns the bytes a launch may now ask (the
// opt-in limit less F1's static shared memory), or -cudaError_t.
long long repeat_corr_init() {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const void* fns[2] = {reinterpret_cast<const void*>(corr_frozen_kernel<STAGED>),
                        reinterpret_cast<const void*>(corr_frozen_kernel<BITMAP>)};
  long long most = optin;
  for (int k = 0; k < 2 && e == cudaSuccess; ++k) {
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, fns[k]);
    if (e != cudaSuccess) break;
    const int dyn = optin - static_cast<int>(fa.sharedSizeBytes);
    e = cudaFuncSetAttribute(fns[k], cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    most = most < dyn ? most : dyn;
  }
  // F2's clusters of 14 blocks pass the portable size of 8
  const void* wide[6] = {reinterpret_cast<const void*>(corr_sums_kernel<512, 2>),
                         reinterpret_cast<const void*>(corr_sums_kernel<256, 2>),
                         reinterpret_cast<const void*>(corr_sums_kernel<128, 2>),
                         reinterpret_cast<const void*>(corr_sums_kernel<512, 1>),
                         reinterpret_cast<const void*>(corr_sums_kernel<256, 1>),
                         reinterpret_cast<const void*>(corr_sums_kernel<128, 1>)};
  for (int k = 0; k < 6 && e == cudaSuccess; ++k)
    e = cudaFuncSetAttribute(wide[k], cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e == cudaSuccess ? most : -static_cast<long long>(e);
}

// Each entry point launches its kernel on `stream` (F1: the clusters of
// its plan; F2: a cluster a slot, of its layout) from the argument block the
// wrapper filled, does not synchronise, and returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a block it refuses). F2 reads what F1
// wrote: launch them in that order on one stream.
int repeat_corr_frozen(const void* args, void* stream) { return launch(false, args, stream); }

int repeat_corr_sums(const void* args, void* stream) { return launch(true, args, stream); }

// The clusters of F2's layout `plan` (SumsPlan) the current device holds at
// once (cudaOccupancyMaxActiveClusters; after repeat_corr_init), or
// -cudaError_t.
long long repeat_corr_sums_fit(int plan) {
  switch (plan) {
    case W512: return sums_fit<512, 2>();
    case W256: return sums_fit<256, 2>();
    case W128: return sums_fit<128, 2>();
    case D512: return sums_fit<512, 1>();
    case D256: return sums_fit<256, 1>();
    case D128: return sums_fit<128, 1>();
    default: return -static_cast<long long>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
