// The control work of a multiple-try Metropolis (MTM) or Metropolis-Hastings
// (MH) refinement step, for NVIDIA Hopper (sm_90a): the neighbour set and its
// discard mask (E1), the forward weights, slot draw and proposal (E2), and
// the backward weights, acceptance and commit (E3).
//
// Replaces no Pallas kernel: the JAX package writes these as jnp code inside
// its jitted step and XLA fuses them (graal_tpu/core/mtm.py). E1 is
// `_prev_next` :75, `_impossibility_mask` :96 and `_neighbour_set` :124; E2
// the forward halves of the MTM step :181-218, the MH step :235-278, the
// delta MTM step :362-423 and the delta MH step :446-513; E3 their backward
// halves, ratios and commits. The plain torch versions beside the public
// functions (graal_tpu_torch/core/mtm.py `move_set_plain`,
// `forward_dense_plain`, `forward_delta_plain`, `accept_dense_plain`,
// `accept_delta_plain`) run each as tens of small torch kernels a step, and
// the delta path's commit as two genome-length rewrites of 11 fields.
//
// What bounds it on the card: neither bytes nor operations. E1 reads the
// genome's contig ids and positions once (8 n bytes: 0.8 MB at n = 100,000,
// 0.24 us of HBM); E2 and E3 read the m x 13 slots (m = delta + 2 = 7: 91
// slots) and write the proposal (dense: 11 x n int32; delta: 8 fields of the
// chosen neighbour's valid rows, with their old values saved). Every call is
// launch-bound or, for E1 at n = 100,000, bound by the loads its SMs keep in
// flight.
//
// What the design does about it.
//  - One launch per kernel and pass (E2, E3 one block; E1 one cluster), no
//    host read and no allocation: the wrapper (ops/mtm_cuda.py) passes
//    fresh outputs, so a captured step (core.graphs.Scan) captures each
//    launch. A step launches E1 twice (the forward set; the backward mask,
//    or with corrected=True on MTM the backward set pivoted at f*), E2 once
//    and E3 once.
//  - E1 (`mtm_set_kernel`): a thread block cluster of 8 blocks x 1,024
//    threads strides over the genome once: the pivot's prev and next (the
//    first index in its contig at pos - 1 / pos + 1, or across a circular
//    contig's wrap, as `_prev_next`'s argmax), the largest contig id (the
//    delta engine's max_id, which replaces a genome-length amax a pass) and
//    the count of contig heads (the step's n_contigs before the move); four
//    block reductions a block, then block 0 folds the other blocks' partials
//    out of their shared memory (distributed shared memory, between two
//    cluster barriers: one launch, no global scratch). One block's pass read
//    the 0.8 MB of a 100,000-fragment genome at 0.029 ms warm, 0.05 inside
//    a graphed step (latency-bound: one SM keeps too few loads in flight).
//    Then one thread of block 0 a neighbour slot: the partners, prev and
//    next, the duplicate test against the slots before it (validity as
//    given, not as deduplicated: the plain version's `dup & valid[None,
//    :]`), the pivot test, the clamp and the thirteen discard flags at the
//    mask pivot. The mask-only mode takes the slots as given and skips prev
//    / next; the backward mask is an E1 launch, not folded into E3.
//  - E2 (`mtm_draw_kernel`) and E3 (`mtm_accept_kernel`): 256 threads over
//    the slots; maxima, minima, sums and the argmax are shared-memory tree
//    reductions in a fixed order. The maxima, minima and argmax are exact;
//    a sum's order is not torch's, so a weight sum, a slot's probability
//    and a ratio may differ from the plain version's in the last ulps, and
//    the drawn slot or the acceptance with them when two keys, or the ratio
//    and the uniform, are that close. Everything else is bit for bit.
//  - Rounding. Each torch op rounds on its own, so every float operation is
//    an explicit round-to-nearest intrinsic in the plain version's order,
//    which nvcc never contracts into an FMA, and the math library calls are
//    torch's: expf and logf, never the __expf intrinsics, and the file builds
//    without fast-math. The temperature: a division by a device tensor (a
//    captured cycle's 0-d f32 buffer) is an IEEE division, by a Python number
//    a product with its f32 reciprocal, as torch divides by a CPU scalar on
//    the card. The MH ratio's default form adds the probabilities to the
//    log-likelihoods inside the exponent, left to right, as the plain
//    version does. NaN follows torch: amax / amin / maximum / clamp
//    propagate it, argmax takes it as the largest, a NaN ratio fails the
//    test.
//  - Degenerate passes follow the plain code. Every forward slot discarded:
//    the dense MTM / MH weights are 0 / 0 = NaN, every slot takes log 1e-30
//    and the draw is the Gumbel argmax; the delta forms clamp the sum at
//    1e-30 and draw the same way, then reject (sw = 0). A zero backward sum:
//    the dense ratio is inf or NaN; the delta steps reject. Every forward
//    neighbour overflowing f_max: the same as all discarded. f_a in its own
//    partner row: the slot is invalid. A circular contig at the pivot: the
//    wrap's prev / next, a one-fragment circle's own index (then invalid).
//  - The delta proposal is written in place. E2 writes the chosen
//    mini-state's 8 mutable fields at the chosen neighbour's valid member
//    rows into the state it is given (a captured cycle's carry, or a copy of
//    the mutable fields) and saves the values it overwrote (8 x f_max
//    int32); the backward pass then scores that state; E3 writes the saved
//    values back when the step is rejected, so a rejected step leaves every
//    field as it came in, and counts the contig heads the move changed
//    (n_contigs = E1's count - old heads + new heads of those rows). The
//    rows of one neighbour are distinct (top-k indices), so no two writes
//    collide.
//
// Launch keys (ops/counts.py): "set", "draw", "accept".

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int N_FIELDS = 11;         // GenomeState
constexpr int N_MUTABLE = 8;         // core.state.MUTABLE_FIELDS
constexpr int N_OPS = 13;            // candidates a neighbour slot
constexpr int MAX_M = 64;            // neighbour slots (delta + 2)
constexpr int SET_THREADS = 1024;
constexpr int SET_BLOCKS = 8;        // E1's cluster: each block a slice of the genome
constexpr int MOVE_THREADS = 256;

enum SetField { POS = 0, IDC, CIRC, LCONT };

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// torch.maximum / clamp_min / clamp_max: NaN propagates
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float clamp_min(float a, float lo) {
  return isnan(a) ? a : fmaxf(a, lo);
}
__device__ __forceinline__ float clamp_max(float a, float hi) {
  return isnan(a) ? a : fminf(a, hi);
}

struct MaxNaN {                 // torch.amax
  __device__ float operator()(float a, float b) const { return (isnan(a) || a > b) ? a : b; }
};
struct MinNaN {                 // torch.amin
  __device__ float operator()(float a, float b) const { return (isnan(a) || a < b) ? a : b; }
};
struct AddF {
  __device__ float operator()(float a, float b) const { return fadd(a, b); }
};
struct MinI {
  __device__ int operator()(int a, int b) const { return min(a, b); }
};
struct MaxI {
  __device__ int operator()(int a, int b) const { return max(a, b); }
};
struct AddL {
  __device__ long long operator()(long long a, long long b) const { return a + b; }
};

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

struct BeatsOp {
  __device__ Pick operator()(Pick a, Pick b) const { return beats(b, a) ? b : a; }
};

// A block reduction in a fixed order: every thread's value in shared memory,
// then a halving tree (blockDim.x a power of two). Every thread gets the
// result.
template <class T, class Op>
__device__ T block_reduce(T x, Op op, T* sh) {
  const int t = threadIdx.x;
  sh[t] = x;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] = op(sh[t], sh[t + s]);
    __syncthreads();
  }
  const T out = sh[0];
  __syncthreads();
  return out;
}

// ---- E1: the neighbour set and its discard mask --------------------------------

struct SetArgs {
  const int* field[4];          // pos, id_c, circ, l_cont of the genome (n,)
  long long stride[4];
  const int* frags;             // (n, delta) contiguous: the jump table
  const long long* fa;          // pivot of the neighbour set; nullptr: mask-only mode
  const long long* mp;          // pivot of the mask
  const long long* ids_in;      // mask-only mode: (m,) the slots' ids
  const unsigned char* valid_in;   //                 and validity
  long long* ids;               // (m,) out (full mode)
  unsigned char* valid;         // (m,) out (full mode)
  unsigned char* discard;       // (m, 13) out
  int* max_id;                  // () out: the largest contig id
  long long* n_contigs;         // () out: the contig heads (pos == 0)
  int n, delta, m;
};

// one block's pass over its slice of the genome
struct SetPartial {
  int prev, next, max_id;
  long long heads;
};

__global__ void __cluster_dims__(SET_BLOCKS, 1, 1) __launch_bounds__(SET_THREADS)
    mtm_set_kernel(SetArgs a) {
  __shared__ int sh_i[SET_THREADS];
  __shared__ long long sh_l[SET_THREADS];
  __shared__ SetPartial part;
  __shared__ long long raw[MAX_M];
  __shared__ unsigned char raw_ok[MAX_M];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x;
  auto at = [&](int f, long long i) { return a.field[f][a.stride[f] * i]; };
  const bool full = a.fa != nullptr;
  const long long fa = full ? *a.fa : 0;
  int c = 0, p = 0, l = 0;
  bool circ = false;
  if (full) {
    c = at(IDC, fa);
    p = at(POS, fa);
    l = at(LCONT, fa);
    circ = at(CIRC, fa) == 1;
  }
  int prev = INT_MAX, next = INT_MAX, mx = INT_MIN;
  long long heads = 0;
#pragma unroll 4
  for (int i = rank * blockDim.x + t; i < a.n; i += SET_BLOCKS * blockDim.x) {
    const int ic = at(IDC, i), ps = at(POS, i);
    mx = max(mx, ic);
    heads += ps == 0;
    if (full && ic == c) {
      if (ps == p - 1 || (ps == l - 1 && p == 0 && circ)) prev = min(prev, i);
      if (ps == p + 1 || (ps == 0 && p == l - 1 && circ)) next = min(next, i);
    }
  }
  prev = block_reduce(prev, MinI(), sh_i);
  next = block_reduce(next, MinI(), sh_i);
  mx = block_reduce(mx, MaxI(), sh_i);
  heads = block_reduce(heads, AddL(), sh_l);
  if (t == 0) part = SetPartial{prev, next, mx, heads};
  // block 0 folds the cluster's partials out of their shared memory (exact:
  // minima, a maximum and an integer sum), then the other blocks may leave
  cluster.sync();
  if (rank == 0 && t == 0) {
    for (int r = 1; r < SET_BLOCKS; ++r) {
      const SetPartial q = *cluster.map_shared_rank(&part, r);
      part.prev = min(part.prev, q.prev);
      part.next = min(part.next, q.next);
      part.max_id = max(part.max_id, q.max_id);
      part.heads += q.heads;
    }
  }
  cluster.sync();
  if (rank != 0) return;
  prev = part.prev;
  next = part.next;
  if (t == 0) {
    *a.max_id = part.max_id;
    *a.n_contigs = part.heads;
  }
  if (t < a.m) {
    long long id;
    bool ok;
    if (!full) {
      id = a.ids_in[t];
      ok = a.valid_in[t] != 0;
    } else if (t < a.delta) {     // the pivot's partners
      id = a.frags[fa * a.delta + t];
      ok = true;
    } else {                      // its prev, then its next
      const int pn = t == a.delta ? prev : next;
      id = pn == INT_MAX ? -1 : pn;
      ok = id != -1;
    }
    raw[t] = id;
    raw_ok[t] = ok;
  }
  __syncthreads();
  if (t >= a.m) return;
  long long id = raw[t];
  bool ok = raw_ok[t] != 0;
  if (full) {
    // the first valid occurrence of an id stays; the pivot itself goes
    bool dup = false;
    for (int i = 0; i < t; ++i) dup = dup || (raw[i] == id && raw_ok[i]);
    ok = ok && !dup && id != fa;
    id = max(id, 0LL);
    a.ids[t] = id;
    a.valid[t] = ok;
  }
  // detect_impossibility at the mask pivot: a paste needs both fragments at
  // linear-contig extremities, a translocation fB at the matching one
  const long long mp = *a.mp;
  const int pa = at(POS, mp);
  const bool fa_ok = at(CIRC, mp) == 0 && (pa == 0 || pa == at(LCONT, mp) - 1);
  const bool lin = at(CIRC, id) == 0;
  const int pb = at(POS, id), lb = at(LCONT, id);
  const bool fb_ok = lin && (pb == 0 || pb == lb - 1);
  const bool down = lin && pb == lb - 1;
  const bool up = lin && pb == 0;
  unsigned char* row = a.discard + static_cast<long long>(t) * N_OPS;
  for (int o = 0; o < N_OPS; ++o) {
    bool d = !ok;
    if (o == 8) d = d || !(fa_ok && fb_ok);
    else if (o == 9 || o == 11) d = d || !down;
    else if (o == 10 || o == 12) d = d || !up;
    row[o] = d;
  }
}

// ---- the slots' weights (E2 and E3) ----------------------------------------------

struct Slots {
  const float* score;           // (S,) dense: log-likelihoods; delta: deltas
  const float* base;            // delta: the value added to each delta; nullptr: dense
  const unsigned char* discard; // (S,)
  const unsigned char* overflow;   // delta: (m,) a neighbour slot's overflow
  const float* ft;              // the temperature (a device scalar), or nullptr:
  float ft_inv;                 //   multiply by its f32 reciprocal
  float thresh;                 // the window below the best kept slot
  int mh;                       // 0: MTM weights; 1: MH probabilities
  int S;

  __device__ float tdiv(float x) const { return ft ? fdiv(x, *ft) : fmul(x, ft_inv); }
  __device__ float ll(int k) const { return base ? fadd(*base, score[k]) : score[k]; }
  __device__ bool gone(int k) const {
    return discard[k] != 0 || (overflow != nullptr && overflow[k / N_OPS] != 0);
  }
};

struct Weights {
  float mx;                     // the best kept tempered score
  float cut;                    // mx - thresh
  float lo;                     // MH: the minimum over every slot of max(s, cut)
  float sum;                    // the weights' sum (block order)
};

struct Scratch {
  float f[MOVE_THREADS];
  Pick p[MOVE_THREADS];
  long long l[MOVE_THREADS];
};

// MTM (`_mtm_weights`): w = exp(s - mx) of the tempered scores s within thresh
// of mx (the others -inf); MH (`_mh_probs`, `_mh_return_prob`): s clamped to
// mx - thresh from below, shifted by its minimum over every slot (discarded
// ones included), exponentiated. Discarded slots weigh 0.
__device__ __forceinline__ float weight(const Slots& s, const Weights& w, int k) {
  if (s.gone(k)) return 0.0f;
  const float x = s.tdiv(s.ll(k));
  if (s.mh) return expf(fsub(maximum(x, w.cut), w.lo));
  return expf(fsub(x <= w.cut ? -INFINITY : x, w.mx));
}

__device__ Weights weights(const Slots& s, Scratch& sh) {
  const int t = threadIdx.x;
  Weights w;
  float mx = -INFINITY;
  for (int k = t; k < s.S; k += blockDim.x)
    if (!s.gone(k)) mx = MaxNaN()(mx, s.tdiv(s.ll(k)));
  w.mx = block_reduce(mx, MaxNaN(), sh.f);
  w.cut = fsub(w.mx, s.thresh);
  w.lo = 0.0f;
  if (s.mh) {
    float lo = INFINITY;
    for (int k = t; k < s.S; k += blockDim.x) lo = MinNaN()(lo, maximum(s.tdiv(s.ll(k)), w.cut));
    w.lo = block_reduce(lo, MinNaN(), sh.f);
  }
  float sum = 0.0f;
  for (int k = t; k < s.S; k += blockDim.x) sum = fadd(sum, weight(s, w, k));
  w.sum = block_reduce(sum, AddF(), sh.f);
  return w;
}

// ---- E2: the forward weights, the draw and the proposal --------------------------

struct DrawArgs {
  Slots s;
  const float* gumbel;          // (S,) the draw's Gumbel noise
  const long long* ids;         // (m,) the neighbour slots' ids
  long long* omega;             // () out: the drawn slot
  long long* f_star;            // () out: its neighbour
  float* ll_star;               // () out: its log-likelihood
  float* p_fwd;                 // () out: its probability
  float* sw;                    // () out: the weights' sum
  float* mx;                    // () out: the best kept tempered score
  unsigned char* ok;            // () out (delta): sw > 0 and the neighbour fits f_max
  // dense: row omega of the flat catalogue's 11 fields, (m x 13, n) each
  const int* cand[N_FIELDS];
  long long cs_k[N_FIELDS];
  long long cs_i[N_FIELDS];
  int* g_star;                  // (11, n) out, or nullptr (delta)
  int n;
  // delta: neighbour j, op o, mini row i of field f at mini[f][j ms_j + o ms_o + i ms_i]
  const int* mini[N_MUTABLE];
  long long ms_j[N_MUTABLE];
  long long ms_o[N_MUTABLE];
  long long ms_i[N_MUTABLE];
  int* dst[N_MUTABLE];          // the state written in place: fragment r at dst[f][r ds_i]
  long long ds_i[N_MUTABLE];
  const long long* rows;        // (m, f_max) contiguous member rows
  const unsigned char* rows_valid;
  int* undo;                    // (8, f_max) out: the overwritten values
  int f_max;
  int m;
};

__global__ void __launch_bounds__(MOVE_THREADS) mtm_draw_kernel(DrawArgs a) {
  __shared__ Scratch sh;
  const Slots& s = a.s;
  const int t = threadIdx.x;
  const Weights w = weights(s, sh);
  // p = w / sum (the delta forms clamp the sum at 1e-30); the slot is the
  // argmax of log(p, or 1e-30 where p is not > 0) + Gumbel
  const float den = s.base ? clamp_min(w.sum, 1e-30f) : w.sum;
  Pick best{-INFINITY, INT_MAX};
  for (int k = t; k < s.S; k += blockDim.x) {
    const float p = fdiv(weight(s, w, k), den);
    const Pick x{fadd(logf(p > 0.0f ? p : 1e-30f), a.gumbel[k]), k};
    if (beats(x, best)) best = x;
  }
  const int omega = min(block_reduce(best, BeatsOp(), sh.p).i, s.S - 1);
  const int nb = omega / N_OPS, op = omega % N_OPS;
  if (t == 0) {
    *a.omega = omega;
    *a.f_star = a.ids[nb];
    *a.ll_star = s.ll(omega);
    *a.p_fwd = fdiv(weight(s, w, omega), den);
    *a.sw = w.sum;
    *a.mx = w.mx;
    if (a.ok) *a.ok = w.sum > 0.0f && !(s.overflow != nullptr && s.overflow[nb] != 0);
  }
  if (a.g_star != nullptr) {
    const long long n = a.n;
    for (int f = 0; f < N_FIELDS; ++f) {
      const int* src = a.cand[f] + a.cs_k[f] * omega;
      int* out = a.g_star + f * n;
      for (long long i = t; i < n; i += blockDim.x) out[i] = src[a.cs_i[f] * i];
    }
    return;
  }
  const long long at = static_cast<long long>(nb) * a.f_max;
  for (int i = t; i < a.f_max; i += blockDim.x) {
    if (!a.rows_valid[at + i]) continue;
    const long long r = a.rows[at + i];
#pragma unroll
    for (int f = 0; f < N_MUTABLE; ++f) {
      int* d = a.dst[f] + a.ds_i[f] * r;
      a.undo[f * a.f_max + i] = *d;
      *d = a.mini[f][a.ms_j[f] * nb + a.ms_o[f] * op + a.ms_i[f] * i];
    }
  }
}

// ---- E3: the backward weights, the acceptance and the commit ---------------------

struct AcceptArgs {
  Slots s;                      // the backward pass (delta: base = ll_star)
  const float* l_t;             // () the current log-likelihood
  const float* u;               // () the acceptance uniform
  const long long* omega;       // E2's outputs
  const float* ll_star;
  const float* p_fwd;
  const float* sw;
  const float* mx;
  const unsigned char* ok;      // delta, or nullptr
  int corrected;                // MH: the canonical ratio
  float* l_out;                 // () out
  unsigned char* accepted;      // () out
  long long* n_contigs;         // () out
  float* ratio;                 // () out: the acceptance ratio (before min(., 1))
  // dense: where(accept, g*, state) of the 11 fields into out
  const int* gs[N_FIELDS];
  long long gs_i[N_FIELDS];
  const int* st[N_FIELDS];
  long long st_i[N_FIELDS];
  int* out;                     // (11, n) or nullptr (delta)
  int n;
  // delta: the rows E2 wrote, restored from undo on a rejection
  int* dst[N_MUTABLE];
  long long ds_i[N_MUTABLE];
  const long long* rows;
  const unsigned char* rows_valid;
  const int* undo;
  const long long* n_in;        // E1's contig heads of the state before the move
  int f_max;
};

__global__ void __launch_bounds__(MOVE_THREADS) mtm_accept_kernel(AcceptArgs a) {
  __shared__ Scratch sh;
  const Slots& s = a.s;
  const int t = threadIdx.x;
  const bool delta = a.out == nullptr;
  const Weights w = weights(s, sh);
  const float ll_star = *a.ll_star, l_t = *a.l_t;
  const float den = delta ? clamp_min(w.sum, 1e-30f) : w.sum;
  float ratio;
  if (!s.mh) {          // exp(max_f - max_b) sum_f / sum_b
    ratio = fdiv(fmul(expf(fsub(*a.mx, w.mx)), *a.sw), den);
  } else {              // the probability of returning to the current genome
    const float target = fsub(maximum(s.tdiv(l_t), w.cut), w.lo);
    const float p_bwd = fdiv(expf(target), den);
    const float p_fwd = *a.p_fwd;
    ratio = a.corrected
                ? fdiv(fmul(expf(s.tdiv(fsub(ll_star, l_t))), p_bwd), clamp_min(p_fwd, 1e-30f))
                : expf(s.tdiv(fsub(fsub(fadd(ll_star, p_bwd), l_t), p_fwd)));
  }
  const bool ok = !delta || (*a.ok != 0 && w.sum > 0.0f);
  const bool accept = ok && clamp_max(ratio, 1.0f) >= *a.u;
  if (t == 0) {
    *a.l_out = accept ? ll_star : l_t;
    *a.accepted = accept;
    *a.ratio = ratio;
  }
  long long heads = 0;
  if (!delta) {
    const long long n = a.n;
    for (int f = 0; f < N_FIELDS; ++f) {
      const int* src = accept ? a.gs[f] : a.st[f];
      const long long si = accept ? a.gs_i[f] : a.st_i[f];
      int* out = a.out + f * n;
      for (long long i = t; i < n; i += blockDim.x) {
        const int v = src[si * i];
        out[i] = v;
        if (f == POS) heads += v == 0;
      }
    }
    heads = block_reduce(heads, AddL(), sh.l);
    if (t == 0) *a.n_contigs = heads;
    return;
  }
  // the heads the move took away and brought, over the rows it wrote
  const int nb = static_cast<int>(*a.omega / N_OPS);
  const long long at = static_cast<long long>(nb) * a.f_max;
  for (int i = t; i < a.f_max; i += blockDim.x) {
    if (!a.rows_valid[at + i]) continue;
    const long long r = a.rows[at + i];
    heads += (a.dst[0][a.ds_i[0] * r] == 0) - (a.undo[i] == 0);   // field 0 is pos
    if (!accept) {
#pragma unroll
      for (int f = 0; f < N_MUTABLE; ++f) a.dst[f][a.ds_i[f] * r] = a.undo[f * a.f_max + i];
    }
  }
  heads = block_reduce(heads, AddL(), sh.l);
  if (t == 0) *a.n_contigs = *a.n_in + (accept ? heads : 0);
}

}  // namespace

extern "C" {

// sizeof each argument block, for the wrapper's check of its ctypes mirror:
// 0 set, 1 draw, 2 accept
int mtm_args_size(int which) {
  switch (which) {
    case 0: return sizeof(SetArgs);
    case 1: return sizeof(DrawArgs);
    case 2: return sizeof(AcceptArgs);
  }
  return -1;
}

// Each entry point launches one kernel on `stream` (mtm_set a cluster of
// SET_BLOCKS blocks, mtm_draw and mtm_accept one block each) from the
// argument block the wrapper filled, does not synchronise, and returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a block it refuses).

int mtm_set(const void* args, void* stream) {
  const SetArgs* a = static_cast<const SetArgs*>(args);
  if (a->n <= 0 || a->m <= 0 || a->m > MAX_M || (a->fa != nullptr && a->m != a->delta + 2) ||
      (a->fa == nullptr && (a->ids_in == nullptr || a->valid_in == nullptr)))
    return (int)cudaErrorInvalidValue;
  mtm_set_kernel<<<SET_BLOCKS, SET_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

int mtm_draw(const void* args, void* stream) {
  const DrawArgs* a = static_cast<const DrawArgs*>(args);
  if (a->m <= 0 || a->m > MAX_M || a->s.S != a->m * N_OPS ||
      (a->g_star == nullptr && (a->f_max <= 0 || a->s.base == nullptr || a->ok == nullptr)))
    return (int)cudaErrorInvalidValue;
  mtm_draw_kernel<<<1, MOVE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

int mtm_accept(const void* args, void* stream) {
  const AcceptArgs* a = static_cast<const AcceptArgs*>(args);
  if (a->s.S <= 0 || a->s.S > MAX_M * N_OPS ||
      (a->out == nullptr && (a->f_max <= 0 || a->s.base == nullptr || a->ok == nullptr)))
    return (int)cudaErrorInvalidValue;
  mtm_accept_kernel<<<1, MOVE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

}  // extern "C"
