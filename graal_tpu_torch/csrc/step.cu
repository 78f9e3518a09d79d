// The scalar and control work of a sampler step, for NVIDIA Hopper (sm_90a):
// the nuisance move (D1), the neighbour draw (D2) and the selection and
// commit (D3), as three kernels: the step's head (D2 with D1's proposal),
// the selection and commit (D3) and the step's tail (D1's acceptance with
// the cycle body's l_t select and metrics).
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
//    one grid (the head and the tail: one block a chain; D3: one cluster a
//    chain), no host read and no allocation: the
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
//  - The step's head (`step_head_kernel`: D2's neighbour draw, with D1's
//    proposal beside it). The nuisance proposal reads only the carried
//    parameters and the step's own draws (id_modif, eps), not the state
//    the step commits, so it runs at the start of the step in the same
//    launch as the draw: a block a chain, warp 0 drawing and warp 1
//    proposing, with no block barrier between them (either part can be off:
//    the delta and tempered steps draw only, `make_nuisance_step` and the
//    runners' cycle end propose only; the block is then one warp).
//    The draw loads rep[f_a] and the n_top keys' pk / xk / u, and ranks
//    the Gumbel keys by shuffles (n_top <= 32; a lane-strided loop over
//    shared memory above): a key's rank is the number of keys before it in
//    torch's stable ascending sort of -g (NaN greatest, ties to the lower
//    index), and the d_eff lowest ranks are the partners. Only then does it
//    load the m = (d_eff + 1) x max_copies entries it keeps (f_a's bin's
//    dispatcher row and the drawn partners', and the blacklist at each
//    id): 6% faster on the draw alone than loading every partner bin's row
//    and flags before the ranks (n_top + 1 rows), 2% slower with the
//    proposal beside it. The entries (80
//    on a copy-dense table) are then ranked lane-strided by (id, or 2^30 when
//    invalid; index), which is the stable sort by id with invalid entries
//    last. The proposal solves only the bracket of the proposal id_modif
//    names, none for a d_max proposal (id 2): each of solve_d_max's 5
//    passes evaluates the curve at 64 points, lane l at points l and l +
//    32, and counts them by __popc of two ballots. The arithmetic is the
//    plain version's in its order, so the five test parameters, in_support
//    and the dense scorers' 10-float parameter row (params_row.cuh, H1's
//    code) are bit for bit the plain version's.
//  - The step's tail (`step_tail_kernel`: D1's Metropolis test, with the
//    dense cycle bodies' glue folded in). Per chain, in the plain body's
//    order: l_t <- D3's score where it is finite; when a proposal exists,
//    the test exp((l* - l_t) / F_t) >= u and the selects of the 8
//    parameters and l_t; the metrics: n_contigs (the count of pos == 0),
//    active_bp (the int64 sum of len_bp over activ == 1) and mean_len =
//    active_bp / n_contigs (both rounded to f32, then an IEEE division), and
//    success. A block of 256 a chain for the two reductions over n (exact
//    in any order: they are integer sums), one warp when no metric is
//    asked for (the cycle end and `nuisance_accept` alone).
//  - Both count themselves: block 0 of the grid, thread 0, adds one to the
//    launch key's int64 counter (ops/counts.py `LaunchCount.counter`), so
//    no counting kernel runs beside them.
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
// Launch keys (ops/counts.py): "step_head", "step_tail", "select_dense",
// "select_delta".

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
constexpr int TAIL_THREADS = 256;    // the tail's block when it reduces the metrics
constexpr int MAX_SHUFFLE_KEYS = 32; // the head ranks up to this many keys by shuffles
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

// ---- the step's head: D2's neighbour draw and D1's proposal ---------------------

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
  int C;                        // chains drawn; 0: no draw
};

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
  int C;                        // chains proposing; 0: no proposal
};

struct HeadArgs {
  NeighbourArgs nb;
  ProposeArgs pr;
  unsigned long long* counter;  // the launch key's int64 counter
};

// torch's sort comparator: NaN greatest
__device__ __forceinline__ bool before(float x, float y) {
  return x < y || (isnan(y) && !isnan(x));
}

// the draw's shared memory in ints: the keys (above MAX_SHUFFLE_KEYS only),
// the d_eff partner slots, each output entry's id, sort key and flag
int head_smem_ints(int n_top, int d_eff, int m) {
  return (n_top > MAX_SHUFFLE_KEYS ? n_top : 0) + d_eff + 3 * m;
}

// mcmc.py `sample_neighbours_plain` for chain c on one warp
__device__ void draw_warp(const NeighbourArgs& a, int c, int lane, int* smem) {
  const int n_top = a.n_top, mc = a.mc, m = a.m;
  const bool shuffled = n_top <= MAX_SHUFFLE_KEYS;
  float* key = reinterpret_cast<float*>(smem);
  int* top = smem + (shuffled ? 0 : n_top);
  int* sid = top + a.d_eff;
  int* skey = sid + m;
  int* sval = skey + m;
  const long long fa = a.fa[a.fa_s * c];
  const int bin_a = a.id_d[a.idd_rs * c + a.idd_cs * fa];
  const bool rep_a = a.rep[a.rep_rs * c + a.rep_cs * fa] == 1;
  const float* pk = a.pk + static_cast<long long>(bin_a) * n_top;
  const int* xk = a.xk + static_cast<long long>(bin_a) * n_top;
  // the Gumbel keys -g of the n_top partners (lane k holds key k when
  // shuffled, else they go to shared memory)
  float v = 0.0f;
  for (int k = lane; k < n_top; k += 32) {
    const float pv = pk[k];
    const float g = pv > 0.0f ? logf(pv) : -INFINITY;
    const float u = a.u[a.u_rs * c + a.u_cs * k];
    const float x = -fsub(g, logf(fadd(-logf(fadd(u, 1e-20f)), 1e-20f)));
    if (shuffled)
      v = x;
    else
      key[k] = x;
  }
  // the top d_eff of a stable ascending sort of -g
  if (shuffled) {
    int rank = 0;
    for (int i = 0; i < n_top; ++i) {
      const float w = __shfl_sync(FULL, v, i);
      rank += before(w, v) || (i < lane && !before(v, w));
    }
    if (lane < n_top && rank < a.d_eff) top[rank] = lane;
  } else {
    __syncwarp();
    for (int k = lane; k < n_top; k += 32) {
      const float x = key[k];
      int rank = 0;
      for (int i = 0; i < n_top; ++i) {
        const float w = key[i];
        rank += before(w, x) || (i < k && !before(x, w));
      }
      if (rank < a.d_eff) top[rank] = k;
    }
  }
  __syncwarp();
  // the m entries, loaded once the partners are known: f_a's bin's copies,
  // then the copies of each drawn partner, with their blacklist flags
  for (int e = lane; e < m; e += 32) {
    int id;
    bool ok;
    if (e < mc) {
      id = a.disp[static_cast<long long>(bin_a) * mc + e];
      ok = rep_a;
    } else {
      const int k = top[(e - mc) / mc];
      id = a.disp[static_cast<long long>(xk[k]) * mc + (e - mc) % mc];
      ok = pk[k] > 0.0f;
    }
    ok = ok && id >= 0 && id != fa && !a.blacklist[max(id, 0)];
    sid[e] = max(id, 0);
    sval[e] = ok;
    skey[e] = ok ? max(id, 0) : INVALID_KEY;
  }
  __syncwarp();
  // stable sort by id, invalid entries last
  for (int e = lane; e < m; e += 32) {
    const int x = skey[e];
    int rank = 0;
    for (int i = 0; i < m; ++i) {
      const int w = skey[i];
      rank += w < x || (w == x && i < e);
    }
    const long long at = static_cast<long long>(c) * m + rank;
    a.ids[at] = sid[e];
    a.valid[at] = sval[e];
  }
}

// mcmc.py `_device_peval`: fact * 0.53 * kuhn^-3 * n^slope * exp((d - 2) /
// (n^2 + d)), n = s * lm / kuhn, each product rounded in that order.
__device__ __forceinline__ float peval(float s, float kuhn, float lm, float slope, float d,
                                       float fact) {
  const float n = fdiv(fmul(s, lm), kuhn);
  const float k3 = powf(kuhn, -3.0f);
  const float e = expf(fdiv(fsub(d, 2.0f), fadd(fmul(n, n), d)));
  return fmul(fmul(fmul(fmul(fact, 0.53f), k3), powf(n, slope)), e);
}

// mcmc.py `solve_d_max` of one parameter set on one warp: rippe(s) == v on
// the decreasing branch, lane l at multisection points l and l + 32
__device__ float solve_warp(const ProposeArgs& a, const float* p, float slope, float fact,
                            float v, int lane) {
  const float frac0 = fmul(static_cast<float>(lane), a.inv_w);
  const float frac1 = fmul(static_cast<float>(lane + 32), a.inv_w);
  float llo = a.llo0, lhi = a.lhi0;
  for (int pass = 0; pass < PASSES; ++pass) {
    const float x0 = expf(fadd(llo, fmul(fsub(lhi, llo), frac0)));
    const float x1 = expf(fadd(llo, fmul(fsub(lhi, llo), frac1)));
    const bool above0 = peval(x0, p[KUHN], p[LM], slope, p[D], fact) > v;
    const bool above1 = peval(x1, p[KUHN], p[LM], slope, p[D], fact) > v;
    const int n_above = __popc(__ballot_sync(FULL, above0)) + __popc(__ballot_sync(FULL, above1));
    const int idx = min(max(n_above - 1, 0), WIDTH - 2);
    const float step = fmul(fsub(lhi, llo), a.inv_w);
    llo = fadd(llo, fmul(static_cast<float>(idx), step));
    lhi = fadd(llo, step);
  }
  return expf(fmul(fadd(llo, lhi), 0.5f));
}

// mcmc.py `nuisance_propose_plain` for chain c on one warp: the proposal
// id_modif names (0 fact, 1 slope, 2 d_max, 3 v_inter), built as the plain
// version builds it, and only its bracket solved
__device__ void propose_warp(const ProposeArgs& a, int c, int lane) {
  float p[N_PARAMS];
#pragma unroll
  for (int k = 0; k < N_PARAMS; ++k) p[k] = a.p[k][a.ps[k] * c];
  const float e = a.eps[a.eps_s * c];
  const long long idm = a.idm[a.idm_s * c];
  float c1 = p[C1], slope = p[SLOPE], d_max, fact = p[FACT], v = p[V_INTER];
  bool ok;
  if (idm == 2) {
    d_max = fadd(p[D_MAX], fmul(e, 100.0f));
    v = peval(d_max, p[KUHN], p[LM], p[SLOPE], p[D], p[FACT]);
    ok = d_max > 0.0f && d_max <= 10000.0f;
  } else {
    if (idm == 0) {
      fact = fadd(p[FACT], fmul(e, powf(10.0f, fsub(log10f(p[FACT]), 2.0f))));
      ok = fact > 0.0f;
    } else if (idm == 1) {
      slope = fadd(p[SLOPE], fmul(e, 0.05f));
      c1 = fmul(fmul(0.53f, powf(fdiv(p[LM], p[KUHN]), slope)), powf(p[KUHN], -3.0f));
      ok = slope >= -2.0f && slope <= -0.5f;
    } else {
      v = fadd(p[V_INTER], fmul(e, 0.5f));
      ok = v > 0.0f && v <= 100.0f;
    }
    d_max = solve_warp(a, p, slope, fact, v, lane);
  }
  if (lane != 0) return;
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

// A block a chain: warp 0 draws when the draw is on, the other warp (or
// warp 0 when the draw is off) proposes; no block barrier between them.
__global__ void __launch_bounds__(64) step_head_kernel(HeadArgs a) {
  extern __shared__ int smem[];
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(a.counter, 1ULL);
  const int c = blockIdx.x, lane = threadIdx.x & 31;
  if (a.nb.C > 0 && threadIdx.x < 32) {
    if (c < a.nb.C) draw_warp(a.nb, c, lane, smem);
  } else if (c < a.pr.C) {
    propose_warp(a.pr, c, lane);
  }
}

// ---- the step's tail: D1's acceptance, the l_t select and the metrics --------------

struct AcceptArgs {
  const float* test[N_PARAMS];  // the test parameters
  long long ts[N_PARAMS];
  const float* par[N_PARAMS];   // the current parameters
  long long ps[N_PARAMS];
  const float* u;               // nullptr: no proposal to test
  long long us;
  const float* l_star;
  long long lss;
  const float* l_t;             // the carried l_t
  long long lts;
  const unsigned char* ok;      // in_support
  long long oks;
  const float* ft;              // nullptr: multiply by ft_inv
  long long fts;
  float ft_inv;
  float* out;                   // (8, C) parameters
  float* l_out;                 // (C,)
  unsigned char* accept;        // (C,) accepted (success: true without a proposal)
  int C;
};

struct TailArgs {
  AcceptArgs acc;
  const float* score;           // D3's score, or nullptr: l_t kept
  long long sc_s;
  const int* pos;               // (C, n) at strides, or nullptr: no metrics
  long long pos_rs, pos_cs;
  const int* activ;
  long long act_rs, act_cs;
  const int* len_bp;
  long long len_rs, len_cs;
  long long* n_contigs;         // (C,) out
  float* mean_len;              // (C,) out
  unsigned long long* counter;  // the launch key's int64 counter
  int n;
};

__global__ void __launch_bounds__(TAIL_THREADS) step_tail_kernel(TailArgs a) {
  __shared__ long long parts[2][TAIL_THREADS / 32];
  const int c = blockIdx.x, t = threadIdx.x;
  if (c == 0 && t == 0) atomicAdd(a.counter, 1ULL);
  // thread 0's inputs, loaded before the reductions so that they overlap
  const AcceptArgs& r = a.acc;
  const bool test = r.u != nullptr;
  float l = 0.0f, s = 0.0f, l_star = 0.0f, u = 0.0f, ft = 0.0f;
  float par[N_PARAMS], tst[N_PARAMS];
  bool in_support = false;
  if (t == 0) {
    l = r.l_t[r.lts * c];
    if (a.score != nullptr) s = a.score[a.sc_s * c];
    if (test) {
      l_star = r.l_star[r.lss * c];
      u = r.u[r.us * c];
      in_support = r.ok[r.oks * c];
      if (r.ft != nullptr) ft = r.ft[r.fts * c];
#pragma unroll
      for (int k = 0; k < N_PARAMS; ++k) {
        tst[k] = r.test[k][r.ts[k] * c];
        par[k] = r.par[k][r.ps[k] * c];
      }
    }
  }
  long long n_contigs = 0, active_bp = 0;
  if (a.pos != nullptr) {      // the same for the whole block
    for (long long i = t; i < a.n; i += blockDim.x) {
      n_contigs += a.pos[a.pos_rs * c + a.pos_cs * i] == 0;
      if (a.activ[a.act_rs * c + a.act_cs * i] == 1) active_bp += a.len_bp[a.len_rs * c + a.len_cs * i];
    }
    for (int o = 16; o > 0; o >>= 1) {
      n_contigs += __shfl_down_sync(FULL, n_contigs, o);
      active_bp += __shfl_down_sync(FULL, active_bp, o);
    }
    if ((t & 31) == 0) {
      parts[0][t >> 5] = n_contigs;
      parts[1][t >> 5] = active_bp;
    }
    __syncthreads();
    if (t == 0) {
      for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) {
        n_contigs += parts[0][w];
        active_bp += parts[1][w];
      }
    }
  }
  if (t != 0) return;
  if (a.score != nullptr && isfinite(s)) l = s;
  bool acc = true;
  if (test) {
    const float diff = fsub(l_star, l);
    const float ratio = expf(r.ft ? fdiv(diff, ft) : fmul(diff, r.ft_inv));
    acc = in_support && ratio >= u;
#pragma unroll
    for (int k = 0; k < N_PARAMS; ++k) r.out[k * r.C + c] = acc ? tst[k] : par[k];
    if (acc) l = l_star;
  }
  r.l_out[c] = l;
  r.accept[c] = acc;
  if (a.pos == nullptr) return;
  a.n_contigs[c] = n_contigs;
  a.mean_len[c] = fdiv(__ll2float_rn(active_bp), __ll2float_rn(n_contigs));
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

}  // namespace

extern "C" {

// sizeof each argument block, for the wrapper's check of its ctypes mirror:
// 0 propose, 1 accept, 2 neighbours, 3 dense, 4 delta, 5 head, 6 tail
int step_args_size(int which) {
  switch (which) {
    case 0: return sizeof(ProposeArgs);
    case 1: return sizeof(AcceptArgs);
    case 2: return sizeof(NeighbourArgs);
    case 3: return sizeof(DenseArgs);
    case 4: return sizeof(DeltaArgs);
    case 5: return sizeof(HeadArgs);
    case 6: return sizeof(TailArgs);
  }
  return -1;
}

// Each entry point launches one kernel on `stream` from the argument block
// the wrapper filled (`args`, a pointer to the block of the kernel's
// *Args struct), does not synchronise, and returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a block it refuses).

// the head: max(nb.C, pr.C) blocks of one warp a part that is on
int step_head(const void* args, void* stream) {
  const HeadArgs* a = static_cast<const HeadArgs*>(args);
  const NeighbourArgs& nb = a->nb;
  const bool draw = nb.C > 0, propose = a->pr.C > 0;
  if ((!draw && !propose) || nb.C < 0 || a->pr.C < 0 || a->counter == nullptr)
    return (int)cudaErrorInvalidValue;
  int smem = 0;
  if (draw) {
    if (nb.n_top <= 0 || nb.mc <= 0 || nb.d_eff < 1 || nb.d_eff > nb.n_top ||
        nb.m != (nb.d_eff + 1) * nb.mc)
      return (int)cudaErrorInvalidValue;
    smem = 4 * head_smem_ints(nb.n_top, nb.d_eff, nb.m);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  }
  const int blocks = max(nb.C, a->pr.C);
  step_head_kernel<<<blocks, 32 * (draw + propose), smem, static_cast<cudaStream_t>(stream)>>>(
      *a);
  return (int)cudaGetLastError();
}

// the tail: a block a chain, TAIL_THREADS with the metrics, one warp without
int step_tail(const void* args, void* stream) {
  const TailArgs* a = static_cast<const TailArgs*>(args);
  const AcceptArgs& r = a->acc;
  if (r.C <= 0 || a->counter == nullptr || r.l_t == nullptr || r.l_out == nullptr ||
      r.accept == nullptr || (r.u != nullptr && (r.l_star == nullptr || r.ok == nullptr ||
                                                 r.out == nullptr)) ||
      (a->pos != nullptr && (a->n <= 0 || a->activ == nullptr || a->len_bp == nullptr ||
                             a->n_contigs == nullptr || a->mean_len == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int threads = a->pos != nullptr ? TAIL_THREADS : 32;
  step_tail_kernel<<<r.C, threads, 0, static_cast<cudaStream_t>(stream)>>>(*a);
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
