// The scalar and control work of a sampler step, for NVIDIA Hopper (sm_90a):
// the nuisance move (D1), the neighbour draw (D2) and the selection and
// commit (D3).
//
// Replaces no Pallas kernel: the JAX package writes these as jnp code inside
// its jitted step (graal_tpu/core/mcmc.py:444 jits the cycle, and XLA fuses
// the scanned step into a few device programs). D1 is
// graal_tpu/core/mcmc.py:297 `make_nuisance_proposer` (with `solve_d_max`
// :272 and `nuisance_accept` :368), D2 is :144 `sample_neighbours`, D3 is
// :178 `select_score_slot` with the step's pick and commit (mcmc.py:232-260,
// graal_tpu/core/delta.py:767-840). The plain torch versions beside the
// public functions (graal_tpu_torch/core/mcmc.py `nuisance_propose_plain`,
// `nuisance_accept_plain`, `sample_neighbours_plain`,
// `select_commit_dense_plain`; core/delta.py `select_commit_delta_plain`)
// run each as tens of one-element torch kernels a step.
//
// What bounds it on the card: neither bytes nor operations. A call reads a
// few hundred bytes a chain (D3's commit also copies the chosen candidate:
// 11 x n int32 on the dense path, 8 x f_max on the delta path) and does a
// few thousand operations; every kernel is launch-bound, a few microseconds
// a call at a tiny share of its bound.
//
// What the design does about it.
//  - One launch per entry point and step, every chain of a chains axis in
//    one grid (D1, D2: one block a chain; D3: one cluster a chain), no
//    host read and no allocation: the
//    wrapper (ops/step_cuda.py) passes fresh outputs, so a captured step
//    (core.graphs.Scan) captures each launch.
//  - Bit-identity with the plain versions on the card. Each torch op rounds
//    on its own, so every float operation here is an explicit round-to-
//    nearest intrinsic, in the plain version's order: nvcc never contracts
//    those into an FMA, and the file builds with the same flags as the
//    others, as torch's kernels build with nvcc's defaults. The math
//    library calls are the ones torch's CUDA kernels make: expf, logf,
//    log10f and the general powf (torch.pow(x, -3.0) takes powf; its
//    special exponents 2, 3, -1, -2 do not occur; torch.pow(10.0, t) is
//    powf(10, t)). A division by a Python float is a product with its f32
//    reciprocal, as torch does on the card with a CPU scalar (the wrapper
//    computes it in f32), and a division by a device tensor is an IEEE
//    division.
//  - D1 (`nuisance_propose`): 256 threads a chain, 4 proposals x 64
//    multisection points: each of solve_d_max's 5 passes is one curve
//    evaluation a thread and a count of two warp ballots, so all four
//    proposals' brackets shrink together as the plain version's batch
//    does. Thread 0 picks the proposal id_modif names, applies the support
//    test and the cap, and writes the test set's 10-float row of the dense
//    scorers (ops/likelihood_cuda.py `params_vector`; the code is
//    params_row.cuh's, which H1 in vectors.cu shares). `nuisance_accept`:
//    one thread a chain, the Metropolis test and the selects.
//  - D2 (`neighbours_kernel`): one block a chain. The Gumbel keys of the
//    n_top partners, then a rank each (the number of keys before it in a
//    stable ascending sort of -g: ties, the -inf entries among them, keep
//    the lower index) gives the top delta; the copy expansion, the other
//    copies of f_a's bin and the masks are per entry; a second rank by (id,
//    or 2^30 when invalid; index) is the stable sort by id with invalid
//    entries last. Ranks are O(m^2) with m = (delta + 1) x max_copies (80 on
//    a copy-dense table), a few thousand comparisons spread over 128
//    threads.
//  - D3 (`select_commit_*`): one launch a call, a thread block cluster of
//    K blocks of 256 threads a chain (`cudaLaunchKernelEx` with the
//    cluster dimension; K from what it commits, ops/step_cuda.py
//    `select_cluster`: a block a chunk of 256 fragments on the dense path
//    or of 256 rows of f_max on the delta path, at most 8). Every warp of
//    every block selects, from the same inputs in the same order, so every
//    warp draws the same slot with no block or cluster barrier (7-9%
//    faster at every shape timed than block 0 selecting and its peers
//    reading the slot through DSMEM between two cluster barriers; the
//    cluster only schedules a chain's blocks together). A warp's 32 lanes
//    take the m x 13 slots lane-strided (lane l: slots l, l + 32, ...; its
//    first LANE_SLOTS loaded together into registers), and each quantity
//    is a warp reduction by shuffles (a shuffle-down tree whose lane 0 is
//    broadcast): the validity mask, the minimum, the 30-window, the count
//    of positive slots, the normaliser, the tempered log-weights plus
//    Gumbel noise and both argmaxes (ties to the lower index, NaN
//    greatest, as torch.argmax). The normaliser's order: lane l sums its
//    slots l, l + 32, l + 64, ... left to right from 0, then the 32 lane
//    sums fold as s[l] += s[l + o] for o = 16, 8, 4, 2, 1, and s[0] is the
//    total. That is not torch's reduction order, so a slot's weight may
//    differ from the plain version's by an ulp, and the drawn slot with it
//    when the two best keys are that close; every other value is exact
//    (minima, maxima, counts and argmaxes are exact in any order). Then
//    the cluster commits, thread t of block r the fragments (rows)
//    r x 256 + t, stepping by K x 256, every load of a fragment (of
//    ROWS_AHEAD rows, past the cap of 8 blocks) issued before its stores,
//    so a thread waits on memory once a fragment (4 rows), not once a
//    field. The dense path writes the chosen candidate's 11 fields (or the
//    state, for a blacklisted f_a) into a new state; the delta path writes
//    the 8 mutable fields of the chosen mini-state's valid rows into the
//    state (O(f_max), the plain version's inverse map and selects are
//    O(n)), nothing when f_a is blacklisted or every selectable slot
//    overflows. A chain's valid rows are distinct (they are top-k
//    indices), so the writes never collide. Block 0 of a chain, thread 0,
//    writes sel, score / d_sel, op, fb and n_over; block 0 of the grid,
//    thread 0, adds one to the launch key's int64 counter (ops/counts.py
//    `LaunchCount.counter`), so no counting kernel runs beside D3.
//
// Launch keys (ops/counts.py): "nuisance_propose", "nuisance_accept",
// "neighbours", "select_dense", "select_delta".

#include <cuda_runtime.h>
#include <math.h>

#include "params_row.cuh"

namespace {

constexpr int N_PARAMS = 8;          // RippeParams: kuhn lm c1 slope d d_max fact v_inter
constexpr int N_FIELDS = 11;         // GenomeState
constexpr int N_MUTABLE = 8;         // core.state.MUTABLE_FIELDS
constexpr int N_OPS = 13;            // candidates a neighbour slot
constexpr int WIDTH = 64;            // solve_d_max's multisection points
constexpr int PASSES = 5;            // solve_d_max's passes
constexpr int PROPOSALS = 4;         // fact, slope, d_max, v_inter
constexpr int PROPOSE_THREADS = PROPOSALS * WIDTH;
constexpr int ACCEPT_THREADS = 128;
constexpr int NB_THREADS = 128;
constexpr int SELECT_THREADS = 256;
constexpr int MAX_SELECT_CLUSTER = 8;
constexpr int ROWS_AHEAD = 4;        // D3's delta commit: rows a thread loads before storing
constexpr int LANE_SLOTS = 8;        // D3's selection: slots a lane holds in registers (m <= 19)
constexpr int INVALID_KEY = 1 << 30;
constexpr unsigned FULL = 0xffffffffu;

enum Param { KUHN = 0, LM, C1, SLOPE, D, D_MAX, FACT, V_INTER };

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// ---- D1: the nuisance move ---------------------------------------------------

struct ProposeArgs {
  const float* p[N_PARAMS];     // the parameters, one value or one a chain
  long long ps[N_PARAMS];       // their strides between chains (0: shared)
  const long long* idm;         // id_modif, int64
  long long idm_s;
  const float* eps;
  long long eps_s;
  const float* log_nfpb;        // nullptr: no parameter row
  float* out;                   // (5, C): c1, slope, d_max, fact, v_inter
  unsigned char* ok;            // (C,) in_support
  float* row;                   // (C, 10) or nullptr
  float cap;                    // the d_max cap (f32), when has_cap
  int has_cap;
  float llo0, lhi0, inv_w;      // f32 log(1e-2), log(1e6) and 1 / (WIDTH - 1)
  int C;
};

// mcmc.py `_device_peval`: fact * 0.53 * kuhn^-3 * n^slope * exp((d - 2) /
// (n^2 + d)), n = s * lm / kuhn, each product rounded in that order.
__device__ __forceinline__ float peval(float s, float kuhn, float lm, float slope, float d,
                                       float fact) {
  const float n = fdiv(fmul(s, lm), kuhn);
  const float k3 = powf(kuhn, -3.0f);
  const float e = expf(fdiv(fsub(d, 2.0f), fadd(fmul(n, n), d)));
  return fmul(fmul(fmul(fmul(fact, 0.53f), k3), powf(n, slope)), e);
}

__global__ void __launch_bounds__(PROPOSE_THREADS) nuisance_propose_kernel(ProposeArgs a) {
  __shared__ int counts[PROPOSE_THREADS / 32];
  __shared__ float solved[PROPOSALS];
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int q = t / WIDTH;        // this thread's proposal
  const int j = t % WIDTH;        // and multisection point
  float p[N_PARAMS];
#pragma unroll
  for (int k = 0; k < N_PARAMS; ++k) p[k] = a.p[k][a.ps[k] * c];
  const float e = a.eps[a.eps_s * c];
  // the four proposals, built as the plain version builds them all
  const float new_fact =
      fadd(p[FACT], fmul(e, powf(10.0f, fsub(log10f(p[FACT]), 2.0f))));
  const float new_slope = fadd(p[SLOPE], fmul(e, 0.05f));
  const float new_d_max = fadd(p[D_MAX], fmul(e, 100.0f));
  const float v_d_max = peval(new_d_max, p[KUHN], p[LM], p[SLOPE], p[D], p[FACT]);
  const float new_v = fadd(p[V_INTER], fmul(e, 0.5f));
  // solve_d_max on proposal q: rippe(s) == v on the decreasing branch
  const float fact_q = q == 0 ? new_fact : p[FACT];
  const float slope_q = q == 1 ? new_slope : p[SLOPE];
  const float v_q = q == 2 ? v_d_max : (q == 3 ? new_v : p[V_INTER]);
  const float frac = fmul(static_cast<float>(j), a.inv_w);
  float llo = a.llo0, lhi = a.lhi0;
  for (int pass = 0; pass < PASSES; ++pass) {
    const float x = expf(fadd(llo, fmul(fsub(lhi, llo), frac)));
    const bool above = peval(x, p[KUHN], p[LM], slope_q, p[D], fact_q) > v_q;
    const unsigned votes = __ballot_sync(0xffffffffu, above);
    if ((t & 31) == 0) counts[t >> 5] = __popc(votes);
    __syncthreads();
    const int n_above = counts[2 * q] + counts[2 * q + 1];
    __syncthreads();
    const int idx = min(max(n_above - 1, 0), WIDTH - 2);
    const float step = fmul(fsub(lhi, llo), a.inv_w);
    llo = fadd(llo, fmul(static_cast<float>(idx), step));
    lhi = fadd(llo, step);
  }
  if (j == 0) solved[q] = expf(fmul(fadd(llo, lhi), 0.5f));
  __syncthreads();
  if (t != 0) return;
  // the proposal id_modif names (0 fact, 1 slope, 2 d_max, 3 v_inter)
  const long long idm = a.idm[a.idm_s * c];
  float c1 = p[C1], slope = p[SLOPE], d_max, fact = p[FACT], v = p[V_INTER];
  bool ok;
  if (idm == 0) {
    fact = new_fact;
    d_max = solved[0];
    ok = new_fact > 0.0f;
  } else if (idm == 1) {
    slope = new_slope;
    c1 = fmul(fmul(0.53f, powf(fdiv(p[LM], p[KUHN]), new_slope)), powf(p[KUHN], -3.0f));
    d_max = solved[1];
    ok = new_slope >= -2.0f && new_slope <= -0.5f;
  } else if (idm == 2) {
    d_max = new_d_max;
    v = v_d_max;
    ok = new_d_max > 0.0f && new_d_max <= 10000.0f;
  } else {
    d_max = solved[3];
    v = new_v;
    ok = new_v > 0.0f && new_v <= 100.0f;
  }
  if (a.has_cap) ok = ok && d_max <= a.cap;
  const int C = a.C;
  a.out[c] = c1;
  a.out[C + c] = slope;
  a.out[2 * C + c] = d_max;
  a.out[3 * C + c] = fact;
  a.out[4 * C + c] = v;
  a.ok[c] = ok;
  if (a.row == nullptr) return;
  // ops/likelihood_cuda.py `params_vector` of the test set (params_row.cuh,
  // which H1 in vectors.cu shares)
  write_params_row(a.row + static_cast<long long>(c) * PARAMS_ROW, p[KUHN], p[LM], c1, slope,
                   p[D], d_max, fact, v, *a.log_nfpb);
}

struct AcceptArgs {
  const float* test[N_PARAMS];  // the test parameters
  long long ts[N_PARAMS];
  const float* par[N_PARAMS];   // the current parameters
  long long ps[N_PARAMS];
  const float* u;
  long long us;
  const float* l_star;
  long long lss;
  const float* l_t;
  long long lts;
  const unsigned char* ok;      // in_support
  long long oks;
  const float* ft;              // nullptr: multiply by ft_inv
  long long fts;
  float ft_inv;
  float* out;                   // (8, C) parameters
  float* l_out;                 // (C,)
  unsigned char* accept;        // (C,)
  int C;
};

__global__ void __launch_bounds__(ACCEPT_THREADS) nuisance_accept_kernel(AcceptArgs a) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= a.C) return;
  const float l_star = a.l_star[a.lss * c];
  const float l_t = a.l_t[a.lts * c];
  const float diff = fsub(l_star, l_t);
  const float ratio = expf(a.ft ? fdiv(diff, a.ft[a.fts * c]) : fmul(diff, a.ft_inv));
  const bool acc = a.ok[a.oks * c] && ratio >= a.u[a.us * c];
#pragma unroll
  for (int k = 0; k < N_PARAMS; ++k)
    a.out[k * a.C + c] = acc ? a.test[k][a.ts[k] * c] : a.par[k][a.ps[k] * c];
  a.l_out[c] = acc ? l_star : l_t;
  a.accept[c] = acc;
}

// ---- D2: the neighbour draw --------------------------------------------------

struct NeighbourArgs {
  const float* u;               // (C, n_top) uniforms
  long long u_rs, u_cs;
  const long long* fa;          // f_a, int64
  long long fa_s;
  const int* id_d;              // (C, n) the state's id_d and rep
  long long idd_rs, idd_cs;
  const int* rep;
  long long rep_rs, rep_cs;
  const float* pk;              // (n_bins, n_top) contiguous
  const int* xk;                // (n_bins, n_top) contiguous
  const int* disp;              // (n_bins, mc) contiguous
  const unsigned char* blacklist;
  int* ids;                     // (C, m) out
  unsigned char* valid;         // (C, m) out
  int n_top, mc, d_eff, m;      // d_eff = min(delta, n_top), m = (d_eff + 1) mc
};

// torch's sort comparator: NaN greatest
__device__ __forceinline__ bool before(float x, float y) {
  return x < y || (isnan(y) && !isnan(x));
}

__global__ void __launch_bounds__(NB_THREADS) neighbours_kernel(NeighbourArgs a) {
  extern __shared__ int shared[];
  float* key = reinterpret_cast<float*>(shared);   // n_top sort keys -g
  int* top = shared + a.n_top;                      // d_eff partner slots
  int* sid = top + a.d_eff;                         // m entries: id
  int* skey = sid + a.m;                            //            sort key
  int* sval = skey + a.m;                           //            valid
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const long long fa = a.fa[a.fa_s * c];
  const int bin_a = a.id_d[a.idd_rs * c + a.idd_cs * fa];
  const float* pk = a.pk + static_cast<long long>(bin_a) * a.n_top;
  const int* xk = a.xk + static_cast<long long>(bin_a) * a.n_top;
  for (int k = t; k < a.n_top; k += blockDim.x) {
    const float pv = pk[k];
    const float g = pv > 0.0f ? logf(pv) : -INFINITY;
    const float u = a.u[a.u_rs * c + a.u_cs * k];
    key[k] = -fsub(g, logf(fadd(-logf(fadd(u, 1e-20f)), 1e-20f)));
  }
  __syncthreads();
  // top-d_eff of a stable ascending sort of -g
  for (int k = t; k < a.n_top; k += blockDim.x) {
    const float v = key[k];
    int rank = 0;
    for (int i = 0; i < a.n_top; ++i) {
      const float w = key[i];
      rank += before(w, v) || (i < k && !before(v, w));
    }
    if (rank < a.d_eff) top[rank] = k;
  }
  __syncthreads();
  const bool rep_a = a.rep[a.rep_rs * c + a.rep_cs * fa] == 1;
  for (int e = t; e < a.m; e += blockDim.x) {
    int id;
    bool ok;
    if (e < a.mc) {   // the other copies of f_a's own bin
      id = a.disp[static_cast<long long>(bin_a) * a.mc + e];
      ok = id >= 0 && id != fa && rep_a;
    } else {          // the copies of the drawn partner bins
      const int k = top[(e - a.mc) / a.mc];
      id = a.disp[static_cast<long long>(xk[k]) * a.mc + (e - a.mc) % a.mc];
      ok = id >= 0 && pk[k] > 0.0f;
    }
    ok = ok && !a.blacklist[max(id, 0)] && id != fa;
    id = max(id, 0);
    sid[e] = id;
    sval[e] = ok;
    skey[e] = ok ? id : INVALID_KEY;
  }
  __syncthreads();
  // stable sort by id, invalid entries last
  for (int e = t; e < a.m; e += blockDim.x) {
    const int v = skey[e];
    int rank = 0;
    for (int i = 0; i < a.m; ++i) {
      const int w = skey[i];
      rank += w < v || (w == v && i < e);
    }
    const long long at = static_cast<long long>(c) * a.m + rank;
    a.ids[at] = sid[e];
    a.valid[at] = sval[e];
  }
}

// ---- D3: the selection and the commit ----------------------------------------

struct Pick {
  float v;
  int i;
};

// a beats b under torch.argmax: the larger value (NaN largest), ties to the
// lower index
__device__ __forceinline__ bool beats(Pick a, Pick b) {
  const bool an = isnan(a.v), bn = isnan(b.v);
  if (an || bn) return an && (!bn || a.i < b.i);
  return a.v > b.v || (a.v == b.v && a.i < b.i);
}

struct MinNaN {                 // torch.amin: NaN wins
  __device__ float operator()(float a, float b) const { return (isnan(a) || a < b) ? a : b; }
};

struct MaxNaN {                 // torch.amax: NaN wins
  __device__ float operator()(float a, float b) const { return (isnan(a) || a > b) ? a : b; }
};

struct Add {
  __device__ float operator()(float a, float b) const { return fadd(a, b); }
};

// warp reductions: a shuffle-down tree (lane l takes lane l + o for o = 16,
// 8, 4, 2, 1), lane 0's value broadcast to every lane
template <class Op>
__device__ __forceinline__ float warp_f(float x, Op op) {
  for (int o = 16; o > 0; o >>= 1) x = op(x, __shfl_down_sync(FULL, x, o));
  return __shfl_sync(FULL, x, 0);
}

__device__ __forceinline__ Pick warp_pick(Pick x) {
  for (int o = 16; o > 0; o >>= 1) {
    const Pick y{__shfl_down_sync(FULL, x.v, o), __shfl_down_sync(FULL, x.i, o)};
    if (beats(y, x)) x = y;
  }
  return Pick{__shfl_sync(FULL, x.v, 0), __shfl_sync(FULL, x.i, 0)};
}

struct SelectArgs {
  const float* score;           // (C, m, 13) contiguous
  const float* gumbel;          // (C, m x 13), row stride g_rs (0: shared)
  long long g_rs;
  const unsigned char* valid_nb;   // (C, m) contiguous
  const unsigned char* overflow;   // (C, m) contiguous, or nullptr
  const float* ft;              // nullptr: multiply by ft_inv
  long long fts;
  float ft_inv;
  float thresh;                 // the window below the best slot
  const unsigned char* blacklist;
  const long long* fa;          // f_a, int64
  long long fa_s;
  const int* ids;               // (C, m) contiguous
  long long* sel;               // (C,) out: the drawn slot
  float* score_out;             // (C,) out: its score (dense) or delta (delta)
  long long* op;                // (C,) out
  long long* fb;                // (C,) out
  unsigned long long* counter;  // the launch key's int64 counter
  int C, m;
  int cluster;                  // K: blocks a chain
};

struct Selected {
  int sel;
  bool any;                     // some slot was selectable
};

// mcmc.py `select_score_slot` for chain c in one warp, every lane taking
// part: the slot drawn (argmax of the tempered log-weights plus the Gumbel
// noise; the best score when at most one slot survives the window).
__device__ Selected select_warp(const SelectArgs& a, int c) {
  const int S = a.m * N_OPS;
  const float* score = a.score + static_cast<long long>(c) * S;
  const float* gumbel = a.gumbel + a.g_rs * c;
  const unsigned char* valid_nb = a.valid_nb + static_cast<long long>(c) * a.m;
  const unsigned char* over = a.overflow ? a.overflow + static_cast<long long>(c) * a.m : nullptr;
  auto selectable = [&](int k) {
    const int nb = k / N_OPS, op = k % N_OPS;
    if (op < 2 && nb > 0) return false;   // eject / flip: neighbour slot 0 only
    const bool v = valid_nb[nb] || (nb == 0 && op < 2);
    return v && !(over && over[nb]);
  };
  const int lane = threadIdx.x & 31;
  // a lane's first LANE_SLOTS slots (lane, lane + 32, ...), loaded together
  // into registers; any further slots are read where they lie
  float sv[LANE_SLOTS], gv[LANE_SLOTS];
  bool okv[LANE_SLOTS];
#pragma unroll
  for (int j = 0; j < LANE_SLOTS; ++j) {
    const int k = lane + 32 * j;
    okv[j] = k < S && selectable(k);
    sv[j] = k < S ? score[k] : 0.0f;
    gv[j] = k < S ? gumbel[k] : 0.0f;
  }
  // f(slot, score, selectable, noise) over the lane's slots in ascending order
  auto each = [&](auto&& f) {
#pragma unroll
    for (int j = 0; j < LANE_SLOTS; ++j)
      if (lane + 32 * j < S) f(lane + 32 * j, sv[j], okv[j], gv[j]);
    for (int k = lane + 32 * LANE_SLOTS; k < S; k += 32) f(k, score[k], selectable(k), gumbel[k]);
  };
  float lo = INFINITY;
  bool any = false;
  Pick best{-INFINITY, 0x7fffffff};
  each([&](int k, float x, bool ok, float) {
    if (ok) {
      lo = MinNaN()(lo, x);
      any = true;
    }
    const Pick y{ok ? x : -INFINITY, k};
    if (beats(y, best)) best = y;
  });
  lo = warp_f(lo, MinNaN());
  any = __any_sync(FULL, any);
  best = warp_pick(best);
  float hi = -INFINITY;
  each([&](int, float x, bool ok, float) { hi = MaxNaN()(hi, ok ? fsub(x, lo) : 0.0f); });
  hi = warp_f(hi, MaxNaN());
  const float base = fsub(hi, a.thresh);
  auto filtered = [&](float x, bool ok) {
    if (!ok) return 0.0f;
    const float y = fsub(fsub(x, lo), base);
    return isnan(y) ? y : (y < 0.0f ? 0.0f : y);
  };
  float total = 0.0f;
  int n_pos = 0;
  each([&](int, float x, bool ok, float) {
    const float y = filtered(x, ok);
    total = fadd(total, y);
    n_pos += y > 0.0f;
  });
  total = warp_f(total, Add());
  n_pos = __reduce_add_sync(FULL, n_pos);
  const float ft = a.ft ? a.ft[a.fts * c] : 0.0f;
  Pick cat{-INFINITY, 0x7fffffff};
  each([&](int k, float x, bool ok, float g) {
    const float pr = fdiv(filtered(x, ok), total);
    float lw = -INFINITY;
    if (pr > 0.0f) lw = a.ft ? fdiv(logf(pr), ft) : fmul(logf(pr), a.ft_inv);
    const Pick y{fadd(lw, g), k};
    if (beats(y, cat)) cat = y;
  });
  cat = warp_pick(cat);
  const int sel = n_pos <= 1 ? best.i : cat.i;
  return Selected{min(sel, S - 1), any};
}

struct DenseArgs {
  SelectArgs s;
  const int* cand[N_FIELDS];    // chain c's slot k, fragment i at
  long long cs_c[N_FIELDS];     //   cand[f][c cs_c + k cs_k + i cs_i]
  long long cs_k[N_FIELDS];
  long long cs_i[N_FIELDS];
  const int* state[N_FIELDS];   // chain c's fragment i at state[f][c ss_c + i ss_i]
  long long ss_c[N_FIELDS];
  long long ss_i[N_FIELDS];
  int* out;                     // (11, C, n) the new states
  int n;
};

__global__ void __launch_bounds__(SELECT_THREADS) select_commit_dense_kernel(DenseArgs a) {
  const int K = a.s.cluster;
  const int c = blockIdx.x / K, rank = blockIdx.x - c * K;
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(a.s.counter, 1ULL);
  const Selected s = select_warp(a.s, c);
  const long long fa = a.s.fa[a.s.fa_s * c];
  const bool skip = a.s.blacklist[fa];
  const int nb = s.sel / N_OPS, op = s.sel % N_OPS;
  if (rank == 0 && threadIdx.x == 0) {
    const long long S = static_cast<long long>(a.s.m) * N_OPS;
    a.s.sel[c] = s.sel;
    a.s.score_out[c] = skip ? -INFINITY : a.s.score[c * S + s.sel];
    a.s.op[c] = skip ? -1 : op;
    a.s.fb[c] = skip ? fa : a.s.ids[static_cast<long long>(c) * a.s.m + nb];
  }
  // a thread a fragment: its 11 fields loaded together, then stored
  const int* src[N_FIELDS];
  long long src_i[N_FIELDS];
#pragma unroll
  for (int f = 0; f < N_FIELDS; ++f) {
    src[f] = skip ? a.state[f] + a.ss_c[f] * c : a.cand[f] + a.cs_c[f] * c + a.cs_k[f] * s.sel;
    src_i[f] = skip ? a.ss_i[f] : a.cs_i[f];
  }
  const long long n = a.n, step = static_cast<long long>(K) * blockDim.x;
  for (long long i = static_cast<long long>(rank) * blockDim.x + threadIdx.x; i < n; i += step) {
    int v[N_FIELDS];
#pragma unroll
    for (int f = 0; f < N_FIELDS; ++f) v[f] = src[f][src_i[f] * i];
#pragma unroll
    for (int f = 0; f < N_FIELDS; ++f) a.out[(static_cast<long long>(f) * a.s.C + c) * n + i] = v[f];
  }
}

struct DeltaArgs {
  SelectArgs s;
  const int* cand[N_MUTABLE];   // chain c's neighbour slot j, op o, mini row i at
  long long cs_c[N_MUTABLE];    //   cand[f][c cs_c + j cs_j + o cs_o + i cs_i]
  long long cs_j[N_MUTABLE];
  long long cs_o[N_MUTABLE];
  long long cs_i[N_MUTABLE];
  int* dst[N_MUTABLE];          // chain c's fragment r at dst[f][c ds_c + r ds_i]
  long long ds_c[N_MUTABLE];
  long long ds_i[N_MUTABLE];
  const long long* rows;        // (C, m, f_max) contiguous member rows
  const unsigned char* rows_valid;
  long long* n_over;            // (C,) out: overflowed neighbour slots
  int f_max;
};

__global__ void __launch_bounds__(SELECT_THREADS) select_commit_delta_kernel(DeltaArgs a) {
  const int K = a.s.cluster;
  const int c = blockIdx.x / K, rank = blockIdx.x - c * K;
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(a.s.counter, 1ULL);
  const Selected s = select_warp(a.s, c);
  const long long fa = a.s.fa[a.s.fa_s * c];
  // a no-op when f_a is blacklisted or every selectable slot overflows
  const bool skip = a.s.blacklist[fa] || !s.any;
  const int nb = s.sel / N_OPS, op = s.sel % N_OPS;
  if (rank == 0 && threadIdx.x == 0) {
    const long long S = static_cast<long long>(a.s.m) * N_OPS;
    const unsigned char* over = a.s.overflow + static_cast<long long>(c) * a.s.m;
    long long n_over = 0;
    for (int j = 0; j < a.s.m; ++j) n_over += over[j] != 0;
    a.s.sel[c] = s.sel;
    a.s.score_out[c] = skip ? 0.0f : a.s.score[c * S + s.sel];
    a.s.op[c] = skip ? -1 : op;
    a.s.fb[c] = skip ? fa : a.s.ids[static_cast<long long>(c) * a.s.m + nb];
    a.n_over[c] = n_over;
  }
  if (skip) return;
  // thread t of block r: rows r x 256 + t + j x K x 256; ROWS_AHEAD of
  // them loaded together (flag, row, the 8 fields), then stored
  const long long at = (static_cast<long long>(c) * a.s.m + nb) * a.f_max;
  const int* src[N_MUTABLE];
#pragma unroll
  for (int f = 0; f < N_MUTABLE; ++f)
    src[f] = a.cand[f] + a.cs_c[f] * c + a.cs_j[f] * nb + a.cs_o[f] * op;
  const int step = K * blockDim.x;
  for (int i0 = rank * blockDim.x + threadIdx.x; i0 < a.f_max; i0 += ROWS_AHEAD * step) {
    bool ok[ROWS_AHEAD];
    long long row[ROWS_AHEAD];
    int v[ROWS_AHEAD][N_MUTABLE];
#pragma unroll
    for (int u = 0; u < ROWS_AHEAD; ++u) {
      const int i = i0 + u * step;
      ok[u] = false;
      if (i < a.f_max) {
        ok[u] = a.rows_valid[at + i];
        row[u] = a.rows[at + i];
#pragma unroll
        for (int f = 0; f < N_MUTABLE; ++f) v[u][f] = src[f][a.cs_i[f] * i];
      }
    }
#pragma unroll
    for (int u = 0; u < ROWS_AHEAD; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int f = 0; f < N_MUTABLE; ++f) a.dst[f][a.ds_c[f] * c + a.ds_i[f] * row[u]] = v[u][f];
    }
  }
}

// D3's launch: K blocks a chain as one cluster
template <class Args>
cudaError_t launch_select(void (*kernel)(Args), const Args& a, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.s.C) * a.s.cluster, 1, 1);
  cfg.blockDim = dim3(SELECT_THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.s.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

bool select_ok(const SelectArgs& s) {
  return s.C > 0 && s.m > 0 && s.counter != nullptr && s.cluster >= 1 &&
         s.cluster <= MAX_SELECT_CLUSTER && static_cast<long long>(s.C) * s.cluster <= 0x7fffffffLL;
}

// dynamic shared memory of neighbours_kernel: keys, top slots, 3 ints an entry
int neighbours_smem(int n_top, int d_eff, int m) { return 4 * (n_top + d_eff + 3 * m); }

}  // namespace

extern "C" {

// sizeof each argument block, for the wrapper's check of its ctypes mirror:
// 0 propose, 1 accept, 2 neighbours, 3 dense, 4 delta
int step_args_size(int which) {
  switch (which) {
    case 0: return sizeof(ProposeArgs);
    case 1: return sizeof(AcceptArgs);
    case 2: return sizeof(NeighbourArgs);
    case 3: return sizeof(DenseArgs);
    case 4: return sizeof(DeltaArgs);
  }
  return -1;
}

// Each entry point launches one kernel on `stream` from the argument block
// the wrapper filled (`args`, a pointer to the block of the kernel's
// *Args struct), does not synchronise, and returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a block it refuses).

int nuisance_propose(const void* args, void* stream) {
  const ProposeArgs* a = static_cast<const ProposeArgs*>(args);
  if (a->C <= 0) return (int)cudaErrorInvalidValue;
  nuisance_propose_kernel<<<a->C, PROPOSE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

int nuisance_accept(const void* args, void* stream) {
  const AcceptArgs* a = static_cast<const AcceptArgs*>(args);
  if (a->C <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (a->C + ACCEPT_THREADS - 1) / ACCEPT_THREADS;
  nuisance_accept_kernel<<<blocks, ACCEPT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

int neighbours(const void* args, int n_chains, void* stream) {
  const NeighbourArgs* a = static_cast<const NeighbourArgs*>(args);
  if (n_chains <= 0 || a->n_top <= 0 || a->mc <= 0 || a->d_eff < 0 || a->d_eff > a->n_top ||
      a->m != (a->d_eff + 1) * a->mc)
    return (int)cudaErrorInvalidValue;
  const int smem = neighbours_smem(a->n_top, a->d_eff, a->m);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  neighbours_kernel<<<n_chains, NB_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

int select_commit_dense(const void* args, void* stream) {
  const DenseArgs* a = static_cast<const DenseArgs*>(args);
  if (!select_ok(a->s) || a->n <= 0) return (int)cudaErrorInvalidValue;
  return (int)launch_select(select_commit_dense_kernel, *a, static_cast<cudaStream_t>(stream));
}

int select_commit_delta(const void* args, void* stream) {
  const DeltaArgs* a = static_cast<const DeltaArgs*>(args);
  if (!select_ok(a->s) || a->f_max <= 0 || a->s.overflow == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)launch_select(select_commit_delta_kernel, *a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
