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
// What the design does about it: it is latency-bound, so it spreads the
// work over enough blocks and packs what F2 walks.
//  - Two launches a scoring call, however many chains. The wrapper
//    (ops/repeat_corr_cuda.py) passes fresh outputs and scratch and reads
//    nothing back, so a captured step (core.graphs.Scan) captures both.
//  - F1 (`corr_frozen_kernel`): one block of 1,024 threads a (chain,
//    neighbour) slot, and one a chain for the chain's active accu mass
//    w_all (a fixed-order f64 sum over the K copy rows). A slot's block
//    does the candidate-independent half once: each thread takes a run of
//    D rows, counts their mixed records and same-bin pairs, a block scan
//    gives each run its place, and a second pass writes the records packed
//    at the front of the slot's scratch (with each record's in-D mini rows
//    and frozen trans mass) and o_same; then the multi-multi entries'
//    frozen pair sums and masses, and part 4's frozen sums and
//    coefficients.
//  - Routing. The plain version maps fragments to mini slots through an
//    (m, n + 1) scatter (O(m n) scratch). The member rows of a slot are an
//    ascending valid prefix (core/delta.py extract_rows_each: top-k of a key
//    that puts members first, in index order), so F1 binary-searches the
//    prefix, staged in shared memory up to SMEM_ROWS rows, for a copy row's
//    owner instead.
//  - F2 (`corr_sums_kernel`): one block of 256 threads a (slot, candidate);
//    threads 0-127 sum the base genome's terms, 128-255 the candidate's,
//    each over the packed records, in f64, folded by a fixed tree. Every
//    block sums the base the same way, so corr[0] is one value. The order
//    is not torch's, so a correction agrees with the plain version to f64
//    rounding (rtol 1e-12 in chip_smoke.py 3f) and dll to one f32 ulp.
//    Then the candidate's cross term over the D rows, and its delta.
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
//    A second build with c_max fixed at 2 (unrolled loops) was a few
//    percent faster on an H100, under a percent of a step, and was not
//    kept.
//
// Launch keys (ops/counts.py): "frozen" (F1), "sums" (F2).

#include <cuda_runtime.h>
#include <math.h>

#include "scorer_common.cuh"

namespace {

constexpr int F1_THREADS = 1024;
constexpr int F2_THREADS = 256;
constexpr int HALF = F2_THREADS / 2;  // F2: the threads of one genome
constexpr int N_GEN = 14;             // base + 13 candidates a neighbour slot
constexpr int N_OPS = 13;
constexpr int N_STATE = 6;
constexpr int SMEM_ROWS = 4096;       // member rows F1 stages in shared memory

enum StateField { START = 0, ORI, IDC, CIRC, LCONT, ACTIV };

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
  double* corr;               // out: (M, 14)
  double* cross;              // (M, 13)
  float* dll;                 // (M, 13)
  int C, m, f_max, R;
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

  __device__ __forceinline__ float a(int k, int r) const {
    return act[k * R + r] ? accu[r] : 0.0f;
  }
  __device__ __forceinline__ Geo at(int k, int r) const {
    const int i = k * R + r;
    Geo g;
    g.mid = mid[i];
    g.idc = idc[i];
    g.circ = circ[i] == 1;
    g.stot = stot[i];
    g.a = act[i] ? accu[r] : 0.0f;
    return g;
  }
};

// A copy row's place in the slot's mini-state: in D, and its mini row.
struct Route {
  bool in;
  int mrow;
};

struct Router {
  const long long* rows;  // the slot's member rows
  const int* srows;       // the same in shared memory, or null
  int nvalid;             // the length of their valid (ascending) prefix
  const int* owner;
  const int* sub_start;
  int s_max, R;

  __device__ __forceinline__ long long row(int i) const { return srows ? srows[i] : rows[i]; }

  // the plain version's inv_f[owner] and mini row, by binary search
  __device__ __forceinline__ Route operator()(int krow) const {
    const int g = owner[krow];
    int lo = 0, hi = nvalid;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (row(mid) < g) lo = mid + 1;
      else hi = mid;
    }
    const int slot = (lo < nvalid && row(lo) == g) ? lo : -1;
    return Route{slot >= 0, clampi(max(slot, 0) * s_max + (krow - sub_start[g]), 0, R - 1)};
  }
};

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

// One D row's candidate-independent work (F1): its same-bin copies' routes
// and o_same, and how many mixed records and same-bin pairs it has; with
// ``mx`` / ``sb`` (the row's first record and pair), it also writes them.
__device__ void d_row(const CorrArgs& a, const Router& route, int slot, int chain, int r,
                      int* n_mx, int* n_sb, int* mx, int* sb) {
  const Tables& t = a.t;
  const int R = a.R, s_max = t.s_max, C = t.c_max;
  const long long* rows = a.rows + (long long)slot * a.f_max;
  const int j = r / s_max, si = r - j * s_max;
  const int frag = (int)rows[j];
  const bool sv = a.valid[(long long)slot * a.f_max + j] && si < t.sub_count[frag];
  const int db = t.data_id[clampi(t.sub_start[frag] + si, 0, t.K - 1)];
  const bool db_dup = t.dup[db] && sv;
  const int c0 = t.copy_start[db], cnt = t.copy_start[db + 1] - c0;
  Fold out_a;
  for (int c = 0; c < C; ++c) {
    const int krow = t.copy_rows[clampi(c0 + c, 0, t.K - 1)];
    const bool ok = c < cnt;
    const Route q = route(krow);
    if (q.in && ok && db_dup && q.mrow > r) {
      if (sb != nullptr) {
        int* pair = a.sb_pair + ((long long)slot * R * C + *n_sb) * 2;
        pair[0] = r;
        pair[1] = q.mrow;
      }
      ++*n_sb;
    }
    out_a.add((ok && !q.in) ? frozen_a(a, chain, krow) : 0.0f);
  }
  if (sb == nullptr) a.o_same[(long long)slot * R + r] = out_a.v;
  if (t.capm == 0 || !sv || db_dup) return;
  const int w0 = t.mx_start[db], w1 = min(t.mx_start[db + 1], w0 + t.capm);
  for (int ent = w0; ent < w1; ++ent) {
    if (mx != nullptr) {
      const long long at = (long long)slot * R * t.capm + *n_mx;
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
    ++*n_mx;
  }
}

__global__ void __launch_bounds__(F1_THREADS) corr_frozen_kernel(CorrArgs a) {
  const Tables& t = a.t;
  const int C = t.c_max;
  const int tid = threadIdx.x;
  const int n_slots = a.C * a.m;
  __shared__ int s_nvalid;
  __shared__ int srows[SMEM_ROWS];
  __shared__ int scan[2][2][F1_THREADS];
  __shared__ double red[F1_THREADS];

  if ((int)blockIdx.x >= n_slots) {  // a chain's active accu mass
    const int chain = blockIdx.x - n_slots;
    double acc = 0.0;
    for (int k = tid; k < t.K; k += F1_THREADS)
      if (state_at(a, ACTIV, chain, t.owner[k]) == 1) acc = __dadd_rn(acc, (double)t.accu[k]);
    const double w = block_sum(acc, red);
    if (tid == 0) a.w_all[chain] = w;
    return;
  }
  const int slot = blockIdx.x, chain = slot / a.m;
  const int R = a.R, s_max = t.s_max;
  const long long* rows = a.rows + (long long)slot * a.f_max;
  const unsigned char* valid = a.valid + (long long)slot * a.f_max;
  const RippeCell p(a.pvec + (long long)slot * N_PARAMS);
  const float inv_nfpb = t.inv_nfpb;
  const float vn = __fmul_rn(p.v_inter, inv_nfpb);

  if (tid == 0) {  // the valid rows are a prefix: its length
    int lo = 0, hi = a.f_max;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (valid[mid]) lo = mid + 1;
      else hi = mid;
    }
    s_nvalid = lo;
  }
  __syncthreads();
  const int nvalid = s_nvalid;
  const bool staged = nvalid <= SMEM_ROWS;
  if (staged)
    for (int i = tid; i < nvalid; i += F1_THREADS) srows[i] = (int)rows[i];
  __syncthreads();
  const Router route{rows, staged ? srows : nullptr, nvalid, t.owner, t.sub_start, s_max, R};

  // ---- the D rows, a contiguous run each: counts, a scan, the records ----
  const int chunk = (R + F1_THREADS - 1) / F1_THREADS;
  const int r0 = min(tid * chunk, R), r1 = min(r0 + chunk, R);
  int n_mx = 0, n_sb = 0;
  for (int r = r0; r < r1; ++r) d_row(a, route, slot, chain, r, &n_mx, &n_sb, nullptr, nullptr);
  int cur = 0;  // inclusive scan of both counts (Hillis-Steele, double-buffered)
  scan[0][0][tid] = n_mx;
  scan[0][1][tid] = n_sb;
  __syncthreads();
  for (int off = 1; off < F1_THREADS; off <<= 1) {
    for (int k = 0; k < 2; ++k)
      scan[cur ^ 1][k][tid] = scan[cur][k][tid] + (tid >= off ? scan[cur][k][tid - off] : 0);
    cur ^= 1;
    __syncthreads();
  }
  int mx = scan[cur][0][tid] - n_mx, sb = scan[cur][1][tid] - n_sb;
  if (tid == F1_THREADS - 1) {
    a.n_rec[slot * 2] = scan[cur][0][tid];
    a.n_rec[slot * 2 + 1] = scan[cur][1][tid];
  }
  for (int r = r0; r < r1; ++r) d_row(a, route, slot, chain, r, &mx, &sb, &mx, &sb);

  // ---- multi-multi entries: frozen x frozen pairs, frozen masses ---------
  for (int d = tid; d < t.ndd; d += F1_THREADS) {
    const long long at = (long long)slot * t.ndd + d;
    const int* ur = t.ddu_rows + d * C;
    const int* vr = t.ddv_rows + d * C;
    const unsigned char* uok = t.ddu_ok + d * C;
    const unsigned char* vok = t.ddv_ok + d * C;
    Fold ee, au, av;
    for (int cu = 0; cu < C; ++cu) {
      const bool u_out = uok[cu] && !route(ur[cu]).in;
      const Geo gu = frozen(a, chain, ur[cu]);
      Fold row;
      for (int cv = 0; cv < C; ++cv) {
        const bool v_out = vok[cv] && !route(vr[cv]).in;
        row.add((u_out && v_out) ? pair_e(gu, frozen(a, chain, vr[cv]), p, inv_nfpb) : 0.0f);
      }
      ee.add(row.v);
    }
    for (int c = 0; c < C; ++c) {
      const Route qu = route(ur[c]), qv = route(vr[c]);
      a.dd_mini[(at * 2) * C + c] = (uok[c] && qu.in) ? qu.mrow : -1;
      a.dd_mini[(at * 2 + 1) * C + c] = (vok[c] && qv.in) ? qv.mrow : -1;
      au.add((uok[c] && !qu.in) ? frozen_a(a, chain, ur[c]) : 0.0f);
      av.add((vok[c] && !qv.in) ? frozen_a(a, chain, vr[c]) : 0.0f);
    }
    a.dd_f[at * 3] = ee.v;
    a.dd_f[at * 3 + 1] = au.v;
    a.dd_f[at * 3 + 2] = av.v;
  }

  // ---- part 4: fA's multi-copy bins x frozen single-copy partners --------
  if (t.capd == 0) return;
  const int fa = (int)a.fa[chain * a.fa_s];
  const int fs = t.sub_start[fa], fc = t.sub_count[fa];
  const int n4 = s_max * t.capd;
  for (int i = tid; i < n4; i += F1_THREADS) {
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
  for (int i = tid; i < s_max * C; i += F1_THREADS) {
    const int si = i / C, c = i - si * C;
    const int dba = t.data_id[clampi(fs + si, 0, t.K - 1)];
    const int c0 = t.copy_start[dba], cnt = t.copy_start[dba + 1] - c0;
    const Route q = route(t.copy_rows[clampi(c0 + c, 0, t.K - 1)]);
    a.ca_mini[(long long)slot * s_max * C + i] = (c < cnt && q.in) ? q.mrow : -1;
  }
}

// The terms of genome k of one slot, this thread's share (records th,
// th + HALF, ...), summed in f64.
__device__ double genome_terms(const CorrArgs& a, const Mini& g, int k, int slot,
                               const RippeCell& p, float vn, int th) {
  const Tables& t = a.t;
  const int R = a.R, C = t.c_max;
  const float inv_nfpb = t.inv_nfpb;
  double acc = 0.0;
  // mixed windows
  const int n_mx = a.n_rec[slot * 2];
  for (int i = th; i < n_mx; i += HALF) {
    const long long at = (long long)slot * R * t.capm + i;
    const int* rec = a.mx_rec + at * (2 + C);
    const int ent = rec[1];
    const Geo u = g.at(k, rec[0]);
    Fold e;
    for (int c = 0; c < C; ++c) {
      const int vm = rec[2 + c];
      e.add(vm >= 0 ? pair_e(u, g.at(k, vm), p, inv_nfpb) : 0.0f);
    }
    const float e_mix = __fadd_rn(e.v, __fmul_rn(__fmul_rn(vn, u.a), a.mx_aout[at]));
    if (e_mix > 0.0f)
      acc = __dadd_rn(acc, (double)__fsub_rn(__fmul_rn(t.mx_vals[ent], logf(e_mix)),
                                             t.mx_lf[ent]));
  }
  // multi-multi entries
  for (int d = th; d < t.ndd; d += HALF) {
    const long long at = (long long)slot * t.ndd + d;
    const int* um = a.dd_mini + (at * 2) * C;
    const int* vm = a.dd_mini + (at * 2 + 1) * C;
    Fold ee, au, av;
    for (int cu = 0; cu < C; ++cu) {
      const Geo gu = g.at(k, max(um[cu], 0));
      Fold row;
      for (int cv = 0; cv < C; ++cv)
        row.add((um[cu] >= 0 && vm[cv] >= 0) ? pair_e(gu, g.at(k, vm[cv]), p, inv_nfpb) : 0.0f);
      ee.add(row.v);
    }
    for (int c = 0; c < C; ++c) {
      au.add(um[c] >= 0 ? g.a(k, um[c]) : 0.0f);
      av.add(vm[c] >= 0 ? g.a(k, vm[c]) : 0.0f);
    }
    const float e_dd = __fadd_rn(
        __fadd_rn(a.dd_f[at * 3], ee.v),
        __fmul_rn(vn, __fadd_rn(__fmul_rn(au.v, a.dd_f[at * 3 + 2]),
                                __fmul_rn(a.dd_f[at * 3 + 1], av.v))));
    if (e_dd > 0.0f)
      acc = __dadd_rn(acc, (double)__fsub_rn(__fmul_rn(t.dd_ob[d], logf(e_dd)), t.dd_lf[d]));
  }
  // part 4
  const int n4 = t.s_max * t.capd;
  for (int i = th; i < n4; i += HALF) {
    const long long at = (long long)slot * n4 + i;
    const int ent = a.p4_ent[at];
    if (ent < 0) continue;
    const int si = i / t.capd;
    Fold ad;
    for (int c = 0; c < C; ++c) {
      const int cm = a.ca_mini[((long long)slot * t.s_max + si) * C + c];
      ad.add(cm >= 0 ? g.a(k, cm) : 0.0f);
    }
    const float e4 = __fadd_rn(a.p4_f[at * 2], __fmul_rn(a.p4_f[at * 2 + 1], ad.v));
    if (e4 > 0.0f)
      acc = __dadd_rn(acc, (double)__fsub_rn(__fmul_rn(t.so_vals[ent], logf(e4)),
                                             t.so_lf[ent]));
  }
  // same-bin pairs
  const int n_sb = a.n_rec[slot * 2 + 1];
  for (int i = th; i < n_sb; i += HALF) {
    const int* pair = a.sb_pair + ((long long)slot * R * C + i) * 2;
    acc = __dadd_rn(acc, (double)pair_e(g.at(k, pair[0]), g.at(k, pair[1]), p, inv_nfpb));
  }
  return acc;
}

// One block a (slot, candidate j): threads 0-127 sum the base genome's
// terms, 128-255 candidate j's; then the candidate's cross term and delta.
// Every block sums the base genome in the same order, so corr[0] is one
// value whichever block writes it.
__global__ void __launch_bounds__(F2_THREADS) corr_sums_kernel(CorrArgs a) {
  const int slot = blockIdx.x / N_OPS, j = blockIdx.x - slot * N_OPS;
  const int chain = slot / a.m, tid = threadIdx.x;
  const int half = tid / HALF, th = tid - half * HALF;
  const int k = half ? j + 1 : 0;
  const int R = a.R;
  const RippeCell p(a.pvec + (long long)slot * N_PARAMS);
  const float vn = __fmul_rn(p.v_inter, a.t.inv_nfpb);
  const long long off = (long long)slot * N_GEN * R;
  const Mini g{a.mid + off, a.idc + off, a.act + off, a.circ + off, a.stot + off,
               a.accu_sub + (long long)slot * R, R};
  __shared__ double red[F2_THREADS];

  red[tid] = genome_terms(a, g, k, slot, p, vn, th);
  __syncthreads();
  for (int stride = HALF / 2; stride > 0; stride >>= 1) {
    if (th < stride) red[tid] = __dadd_rn(red[tid], red[tid + stride]);
    __syncthreads();
  }
  const double corr0 = red[0], corr_k = red[HALF];
  __syncthreads();

  // the cross term: w_out = w_all - the base genome's D mass
  double base = 0.0;
  for (int r = tid; r < R; r += F2_THREADS) base = __dadd_rn(base, (double)g.a(0, r));
  const double w_out = __dsub_rn(a.w_all[chain], block_sum(base, red));
  const float* o_same = a.o_same + (long long)slot * R;
  double x = 0.0;
  for (int r = tid; r < R; r += F2_THREADS)
    x = __dadd_rn(x, __dmul_rn((double)__fsub_rn(g.a(j + 1, r), g.a(0, r)),
                               __dsub_rn(w_out, (double)o_same[r])));
  const double cross = __dmul_rn((double)vn, block_sum(x, red));

  if (tid == 0) {
    const long long o = (long long)slot * N_OPS + j;
    a.corr[(long long)slot * N_GEN + j + 1] = corr_k;
    if (j == 0) a.corr[(long long)slot * N_GEN] = corr0;
    a.cross[o] = cross;
    a.dll[o] = (float)__dsub_rn(__dadd_rn((double)a.dll1[o], __dsub_rn(corr_k, corr0)), cross);
  }
}

int launch(bool sums, const void* args, void* stream) {
  const CorrArgs* a = static_cast<const CorrArgs*>(args);
  if (a->t.c_max < 1 || a->C < 1 || a->m < 1) return (int)cudaErrorInvalidValue;
  const int slots = a->C * a->m;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sums) corr_sums_kernel<<<slots * N_OPS, F2_THREADS, 0, s>>>(*a);
  else corr_frozen_kernel<<<slots + a->C, F1_THREADS, 0, s>>>(*a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// sizeof the argument block, for the wrapper's check of its ctypes mirror
int repeat_corr_args_size() { return (int)sizeof(CorrArgs); }

// Each entry point launches its kernel on `stream` (F1: one block a slot and
// one a chain; F2: one block a (slot, candidate)) from the argument block the
// wrapper filled, does not synchronise, and returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a block it refuses). F2 reads what F1
// wrote: launch them in that order on one stream.
int repeat_corr_frozen(const void* args, void* stream) { return launch(false, args, stream); }

int repeat_corr_sums(const void* args, void* stream) { return launch(true, args, stream); }

}  // extern "C"
