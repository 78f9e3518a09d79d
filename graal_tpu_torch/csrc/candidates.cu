// The 13-candidate catalogues of a sampler step, for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package builds its catalogues from
// the primitives of graal_tpu/core/ops.py inside its jitted step, and XLA
// fuses them. C1 (em_catalogue) is graal_tpu/core/candidates.py:48
// `build_candidates`, C2 (mh_catalogue) is :86 `mh_candidates`. Given B
// genomes (one broadcast state of n fragments, or one row a genome), a
// fragment f_a and a neighbour f_b each, and the largest contig id in use,
// they write the 13 candidate genomes of every (genome, f_a, f_b): out
// (11, B, S, n) int32, the GenomeState fields in order, S = 13 (or 14 with
// the base in slot 0, the delta engine's layout). The plain torch versions
// (graal_tpu_torch/core/candidates.py `build_candidates_plain`,
// `mh_candidates_plain`) run each primitive as a chain of masked selects
// over the whole (B, n) batch, hundreds of small kernels a call.
//
// What bounds it on the card. Bytes: every candidate field is written,
// 11 x B x S x n x 4 bytes (187 MB at the top tier, B = 20, n = 16,384),
// against n x 11 x 4 bytes of state read (B times that for per-genome
// rows). The arithmetic is a few hundred integer operations a fragment.
//
// What the design does about it.
//  - Every primitive (ops.py: flip, swap_activity, pop_out, pop_in_1..4,
//    split, paste) maps a fragment's own fields, the fields of f_a / f_b
//    in the state it reads, and a fresh-id maximum to the fragment's new
//    fields. So a catalogue is per fragment once those per-genome scalars
//    are known, and the chains pop_out -> pop_in_k and split(A) ->
//    split(B) -> paste compose per fragment.
//  - Two passes, one launch pair a call. (a) `*_scalars`, one block a
//    genome: the records of f_a and f_b in the base, in the popped state,
//    in both splits at f_a and in the four double splits, and the fresh-id
//    maxima as exact block reductions over the intermediate contig ids
//    (the base's maximum when max_id is not given, m2 = max of the popped
//    state's ids, m1 = max of each split state's ids). The translocations'
//    second maximum (mt) feeds paste, which takes no fresh id, so it is not
//    computed. (b) `*_write`, a grid of (genome, 256-fragment chunk)
//    blocks, so that the top tier's writes spread over every SM: each
//    thread evaluates the 13 candidates of one fragment from the records
//    (staged in shared memory) and stores each field at once; neighbouring
//    threads store neighbouring fragments (128-byte warp stores). No
//    intermediate state touches device memory.
//  - Exactness. Every field is int32 and the arithmetic is the plain
//    version's, in the same order, on the same int32 values (indices are
//    compared as integers), so the result is the plain version's bit for
//    bit. The reference's quirks are kept: C2's translocations take their
//    fresh ids from the split state's own maximum, without max_id; its
//    paste (mode 8) is gated by both fragments being linear-contig
//    extremities and its translocations (9-12) by f_b being the matching
//    extremity; every op is total (f_a == f_b, inactive fragments,
//    singletons, circular contigs).
//  - The state is read in place at its strides: the delta engine's
//    mini-states are views of one (M, f_max, 11) gather, so a field's
//    fragments lie 11 elements apart; a broadcast genome has a row stride
//    of 0. The 11 fields of a fragment share its cache lines.
//  - Index widths: B <= 65,535 genomes, n < 2^31 fragments; output offsets
//    are size_t products. f_a, f_b and max_id may be int32 or int64
//    tensors (a stride of 0 broadcasts one value), or a value.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int N_FIELDS = 11;
constexpr int N_CANDIDATES = 13;
constexpr int N_RECORDS = 14;          // A0 B0 PA PB T1B[2] T2A[4] T2B[4]
constexpr int SCRATCH = N_RECORDS * N_FIELDS + 6;   // + fa fb mx m2 m1[2]
constexpr int INT_MIN_ = -2147483647 - 1;

enum Rec { A0 = 0, B0, PA, PB, T1B, T2A = T1B + 2, T2B = T2A + 4 };
enum Tail { FA = N_RECORDS * N_FIELDS, FB, MX, M2, M1 };

struct Frag {
  int pos, id_c, start_bp, len_bp, circ, l_cont, l_cont_bp, ori, rep, activ, id_d;
};

struct Index {                // an index or maximum: a tensor or a value
  const void* ptr;            // nullptr: `value`
  long long value;
  long long stride;           // elements between genomes (0: broadcast)
  int is64;
};

struct Args {
  const int* field[N_FIELDS];
  long long row_stride[N_FIELDS];   // elements between genomes (0: broadcast)
  long long col_stride[N_FIELDS];   // elements between fragments
  int n, B;
  int base_rows;              // rows the state holds: 1 (broadcast) or B
  Index fa, fb, mx;
  int mx_none;                // 1: max_id is the state's own maximum
  int* scratch;               // (B, SCRATCH)
  int* out;                   // (11, B, slots, n)
  int slots;                  // 13, or 14 with the base in slot 0
};

__device__ __forceinline__ long long load(const Index& x, int b) {
  if (x.ptr == nullptr) return x.value;
  const long long k = x.stride * b;
  return x.is64 ? static_cast<const long long*>(x.ptr)[k] : static_cast<const int*>(x.ptr)[k];
}

__device__ __forceinline__ Frag frag_at(const Args& a, int b, int i) {
  int v[N_FIELDS];
#pragma unroll
  for (int f = 0; f < N_FIELDS; ++f) v[f] = a.field[f][a.row_stride[f] * b + a.col_stride[f] * i];
  return Frag{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], v[9], v[10]};
}

__device__ __forceinline__ void put(int* dst, const Frag& x) {
  dst[0] = x.pos; dst[1] = x.id_c; dst[2] = x.start_bp; dst[3] = x.len_bp;
  dst[4] = x.circ; dst[5] = x.l_cont; dst[6] = x.l_cont_bp; dst[7] = x.ori;
  dst[8] = x.rep; dst[9] = x.activ; dst[10] = x.id_d;
}

__device__ __forceinline__ Frag get(const int* src) {
  return Frag{src[0], src[1], src[2], src[3], src[4], src[5],
              src[6], src[7], src[8], src[9], src[10]};
}

// ---- the primitives of core/ops.py, per fragment ----------------------
// x: the fragment's fields in the state the op reads; S*: the fields of
// the op's fragments in that state; is_f: x is the op's fragment (f_a).

__device__ __forceinline__ Frag flip(Frag x, bool is_f) {
  if (is_f) x.ori = -x.ori;
  return x;
}

__device__ __forceinline__ Frag swap_activity(Frag x, bool is_f, const Frag& S, int mx) {
  if (is_f && x.rep == 1) {
    const bool on = S.activ == 1;
    x.activ = on ? 0 : 1;
    x.id_c = on ? S.id_c : mx + 1;
  }
  return x;
}

__device__ __forceinline__ Frag pop_out(const Frag& x, bool is_f, const Frag& S, int mx) {
  if (!(S.l_cont > 1)) return x;       // already a singleton: identity
  Frag y = x;
  const bool in_c = x.id_c == S.id_c && !is_f;
  if (in_c && x.pos > S.pos) {
    y.pos = x.pos - 1;
    y.start_bp = x.start_bp - S.len_bp;
  }
  if (in_c) {
    y.l_cont = x.l_cont - 1;
    y.l_cont_bp = x.l_cont_bp - S.len_bp;
    if (S.l_cont == 2) y.circ = 0;
  }
  if (is_f) {
    y.pos = 0; y.id_c = mx + 1; y.start_bp = 0; y.circ = 0; y.ori = 1;
    y.l_cont = 1; y.l_cont_bp = S.len_bp;
  }
  return y;
}

// Si: the insertion target f_ins, Sp: the popped fragment f_pop (both in
// the popped state); `distinct`: f_pop != f_ins.
__device__ __forceinline__ bool guard(const Frag& Sp, const Frag& Si, bool distinct) {
  return Sp.activ == 1 && Si.activ == 1 && distinct;
}

__device__ __forceinline__ Frag pop_in_1(const Frag& x, bool is_pop, const Frag& Si,
                                         const Frag& Sp, int ori_pop, int mx, bool distinct) {
  if (!guard(Sp, Si, distinct)) return x;
  const int ci = Si.id_c, Pi = Si.pos, Li = Si.l_cont, Lbpi = Si.l_cont_bp, si = Si.start_bp;
  const int len_pop = Sp.len_bp;
  const bool in_ci = x.id_c == ci && !is_pop;
  const bool before = in_ci && x.pos < Pi;
  const bool at_or_after = in_ci && x.pos >= Pi;
  const bool lin = Si.circ == 0;
  Frag y = x;
  if (is_pop || at_or_after) y.id_c = lin ? mx + 1 : ci;
  if (is_pop) { y.pos = 0; y.start_bp = 0; }
  if (at_or_after) { y.pos = x.pos - Pi + 1; y.start_bp = x.start_bp - si + len_pop; }
  if (before && !lin) {
    y.pos = Li - Pi + x.pos + 1;
    y.start_bp = Lbpi - si + x.start_bp + len_pop;
  }
  const int l_new = lin ? Li - Pi + 1 : Li + 1;
  const int lbp_new = lin ? Lbpi - si + len_pop : Lbpi + len_pop;
  if (is_pop || at_or_after || (before && !lin)) { y.l_cont = l_new; y.l_cont_bp = lbp_new; }
  if (before && lin) { y.l_cont = Pi; y.l_cont_bp = si; }
  if (is_pop || in_ci) y.circ = 0;
  if (is_pop) y.ori = ori_pop;
  return y;
}

__device__ __forceinline__ Frag pop_in_2(const Frag& x, bool is_pop, const Frag& Si,
                                         const Frag& Sp, int ori_pop, int mx, bool distinct) {
  if (!guard(Sp, Si, distinct)) return x;
  const int ci = Si.id_c, Pi = Si.pos, Li = Si.l_cont, Lbpi = Si.l_cont_bp, si = Si.start_bp;
  const int len_ins = Si.len_bp, len_pop = Sp.len_bp;
  const bool in_ci = x.id_c == ci && !is_pop;
  const bool at_or_before = in_ci && x.pos <= Pi;
  const bool after = in_ci && x.pos > Pi;
  const bool lin = Si.circ == 0;
  Frag y = x;
  if (is_pop) {
    y.pos = lin ? Pi + 1 : Li;
    y.start_bp = lin ? si + len_ins : Lbpi;
  }
  if (at_or_before && !lin) {
    y.pos = Li - (Pi + 1) + x.pos;
    y.start_bp = Lbpi - (si + len_ins) + x.start_bp;
  }
  if (after) {
    y.pos = x.pos - (Pi + 1);
    y.start_bp = x.start_bp - (si + len_ins);
  }
  if (is_pop) y.id_c = ci;
  if (after && lin) y.id_c = mx + 1;
  const int l_keep = lin ? Pi + 2 : Li + 1;
  const int lbp_keep = lin ? si + len_ins + len_pop : Lbpi + len_pop;
  if (is_pop || at_or_before) { y.l_cont = l_keep; y.l_cont_bp = lbp_keep; }
  if (after) {
    y.l_cont = lin ? Li - (Pi + 1) : l_keep;
    y.l_cont_bp = lin ? Lbpi - (si + len_ins) : lbp_keep;
  }
  if (is_pop || in_ci) y.circ = 0;
  if (is_pop) y.ori = ori_pop;
  return y;
}

// pop_in_3 (right of f_ins, `right`) and pop_in_4 (left of it)
__device__ __forceinline__ Frag pop_in_34(const Frag& x, bool is_pop, const Frag& Si,
                                          const Frag& Sp, int ori_pop, bool distinct,
                                          bool right) {
  if (!guard(Sp, Si, distinct)) return x;
  const int Pi = Si.pos, len_pop = Sp.len_bp;
  const bool in_ci = x.id_c == Si.id_c && !is_pop;
  const bool shifted = in_ci && (right ? x.pos > Pi : x.pos >= Pi);
  Frag y = x;
  if (shifted) { y.pos = x.pos + 1; y.start_bp = x.start_bp + len_pop; }
  if (is_pop) {
    y.pos = right ? Pi + 1 : Pi;
    y.start_bp = right ? Si.start_bp + Si.len_bp : Si.start_bp;
    y.id_c = Si.id_c; y.circ = Si.circ; y.ori = ori_pop;
  }
  if (is_pop || in_ci) { y.l_cont = Si.l_cont + 1; y.l_cont_bp = Si.l_cont_bp + len_pop; }
  return y;
}

// S: the cut fragment in the state split reads; up: 1 cuts before it.
__device__ __forceinline__ bool split_right(const Frag& x, const Frag& S, int up) {
  const int bound = up ? S.pos : S.pos + 1;
  return x.id_c == S.id_c && x.pos >= bound;
}

__device__ __forceinline__ bool split_ok(const Frag& S) { return S.activ == 1 && S.l_cont > 1; }

__device__ __forceinline__ Frag split(const Frag& x, const Frag& S, int up, int mx) {
  if (!split_ok(S)) return x;
  const int bound = up ? S.pos : S.pos + 1;
  const int bound_bp = up ? S.start_bp : S.start_bp + S.len_bp;
  const bool in_c = x.id_c == S.id_c;
  const bool right = in_c && x.pos >= bound;
  const bool left = in_c && x.pos < bound;
  Frag y = x;
  if (S.circ == 0) {               // the right part becomes a new contig
    if (right) {
      y.pos = x.pos - bound; y.start_bp = x.start_bp - bound_bp; y.id_c = mx + 1;
      y.l_cont = S.l_cont - bound; y.l_cont_bp = S.l_cont_bp - bound_bp;
    } else if (left) {
      y.l_cont = bound; y.l_cont_bp = bound_bp;
    }
  } else {                         // rotate to linearise: ids and sizes kept
    if (right) {
      y.pos = x.pos - bound; y.start_bp = x.start_bp - bound_bp;
    } else if (left) {
      y.pos = x.pos + (S.l_cont - bound);
      y.start_bp = x.start_bp + (S.l_cont_bp - bound_bp);
    }
  }
  if (in_c) y.circ = 0;
  return y;
}

// SA, SB: f_a and f_b in the state paste reads; `distinct`: f_a != f_b.
__device__ __forceinline__ Frag paste(const Frag& x, const Frag& SA, const Frag& SB,
                                      bool distinct) {
  if (!(SA.activ == 1 && SB.activ == 1 && distinct)) return x;
  const int cA = SA.id_c, cB = SB.id_c, pA = SA.pos, pB = SB.pos, LA = SA.l_cont;
  const bool in_A = x.id_c == cA, in_B = x.id_c == cB;
  Frag y = x;
  if (cA == cB) {                  // circularise when they are the two ends
    const bool can = ((pA == 0 && pB == LA - 1) || (pA == LA - 1 && pB == 0)) && LA > 1;
    if (can && in_A) y.circ = 1;
    return y;
  }
  if (in_A) {
    const bool rev = pA == 0;
    y.pos = rev ? LA - 1 - x.pos : x.pos;
    y.start_bp = rev ? SA.l_cont_bp - (x.start_bp + x.len_bp) : x.start_bp;
    y.ori = rev ? -x.ori : x.ori;
  } else if (in_B) {
    const bool rev = pB != 0;
    y.pos = rev ? LA + (SB.l_cont - 1 - x.pos) : LA + x.pos;
    y.start_bp = rev ? SA.l_cont_bp + (SB.l_cont_bp - (x.start_bp + x.len_bp))
                     : SA.l_cont_bp + x.start_bp;
    y.ori = rev ? -x.ori : x.ori;
    y.id_c = cA;
  }
  if (in_A || in_B) {
    y.l_cont = LA + SB.l_cont; y.l_cont_bp = SA.l_cont_bp + SB.l_cont_bp; y.circ = 0;
  }
  return y;
}

__device__ __forceinline__ bool is_extremity(const Frag& S) {
  return (S.pos == 0 || S.pos == S.l_cont - 1) && S.circ == 0;
}

// ---- pass (a): the per-genome records and maxima ----------------------

__device__ __forceinline__ int block_max(int v, int* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] = max(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  const int out = red[0];
  __syncthreads();
  return out;
}

template <bool MH>
__device__ void scalars(const Args& a) {
  __shared__ int red[THREADS];
  const int b = blockIdx.x;
  const int fa = static_cast<int>(load(a.fa, b));
  const int fb = static_cast<int>(load(a.fb, b));
  const Frag A = frag_at(a, b, fa), Bf = frag_at(a, b, fb);
  const int* id_c = a.field[1] + a.row_stride[1] * b;
  const int* pos = a.field[0] + a.row_stride[0] * b;
  const long long id_step = a.col_stride[1], pos_step = a.col_stride[0];

  int mx;
  if (a.mx_none) {                 // the whole state's maximum, as amax()
    int m = INT_MIN_;
    const long long total = static_cast<long long>(a.base_rows) * a.n;
    for (long long k = threadIdx.x; k < total; k += THREADS) {
      const long long r = k / a.n, i = k - r * a.n;
      m = max(m, a.field[1][a.row_stride[1] * r + id_step * i]);
    }
    mx = block_max(m, red);
  } else {
    mx = static_cast<int>(load(a.mx, b));
  }

  // the popped state's ids and both split states' ids, fragment by fragment
  const bool popping = A.l_cont > 1, cutting = split_ok(A) && A.circ == 0;
  int m_pop = INT_MIN_, m_t1[2] = {INT_MIN_, INT_MIN_};
  for (int i = threadIdx.x; i < a.n; i += THREADS) {
    const int c = id_c[id_step * i];
    m_pop = max(m_pop, popping && i == fa ? mx + 1 : c);
    Frag x;
    x.id_c = c;
    x.pos = pos[pos_step * i];
#pragma unroll
    for (int u = 0; u < 2; ++u)
      m_t1[u] = max(m_t1[u], cutting && split_right(x, A, u) ? mx + 1 : c);
  }
  const int m2 = max(block_max(m_pop, red), mx);
  int m1[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int t = block_max(m_t1[u], red);
    m1[u] = MH ? t : max(t, mx);
  }

  if (threadIdx.x == 0) {
    int* s = a.scratch + static_cast<size_t>(b) * SCRATCH;
    put(s + A0 * N_FIELDS, A);
    put(s + B0 * N_FIELDS, Bf);
    put(s + PA * N_FIELDS, pop_out(A, true, A, mx));
    put(s + PB * N_FIELDS, pop_out(Bf, fb == fa, A, mx));
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const Frag t1a = split(A, A, u, mx), t1b = split(Bf, A, u, mx);
      put(s + (T1B + u) * N_FIELDS, t1b);
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        put(s + (T2A + 2 * u + v) * N_FIELDS, split(t1a, t1b, v, m1[u]));
        put(s + (T2B + 2 * u + v) * N_FIELDS, split(t1b, t1b, v, m1[u]));
      }
    }
    s[FA] = fa; s[FB] = fb; s[MX] = mx; s[M2] = m2; s[M1] = m1[0]; s[M1 + 1] = m1[1];
  }
}

// ---- pass (b): every candidate of every fragment -----------------------

template <bool MH>
__device__ void write(const Args& a) {
  __shared__ int s[SCRATCH];
  const int chunks = (a.n + THREADS - 1) / THREADS;
  const int b = blockIdx.x / chunks;
  const int i = (blockIdx.x - b * chunks) * THREADS + threadIdx.x;
  for (int k = threadIdx.x; k < SCRATCH; k += THREADS)
    s[k] = a.scratch[static_cast<size_t>(b) * SCRATCH + k];
  __syncthreads();
  if (i >= a.n) return;

  const size_t field_stride = static_cast<size_t>(a.B) * a.slots * a.n;
  int* out = a.out + static_cast<size_t>(b) * a.slots * a.n + i;
  int slot = 0;
  auto store = [&](const Frag& y) {
    int* o = out + static_cast<size_t>(slot++) * a.n;
    o[0] = y.pos; o[field_stride] = y.id_c; o[2 * field_stride] = y.start_bp;
    o[3 * field_stride] = y.len_bp; o[4 * field_stride] = y.circ;
    o[5 * field_stride] = y.l_cont; o[6 * field_stride] = y.l_cont_bp;
    o[7 * field_stride] = y.ori; o[8 * field_stride] = y.rep;
    o[9 * field_stride] = y.activ; o[10 * field_stride] = y.id_d;
  };

  const Frag x = frag_at(a, b, i);
  const bool is_a = i == s[FA];
  const bool distinct = s[FA] != s[FB];
  const int mx = s[MX], m2 = s[M2];
  const Frag A = get(s + A0 * N_FIELDS), Bf = get(s + B0 * N_FIELDS);
  const Frag Pa = get(s + PA * N_FIELDS), Pb = get(s + PB * N_FIELDS);

  if (a.slots == N_CANDIDATES + 1) store(x);
  const Frag popped = pop_out(x, is_a, A, mx);
  store(popped);                                                  // 0: eject
  store(flip(x, is_a));                                           // 1: flip
  if (!MH) {
    store(pop_in_1(popped, is_a, Pb, Pa, 1, m2, distinct));       // 2
    store(pop_in_1(popped, is_a, Pb, Pa, -1, m2, distinct));      // 3
    store(pop_in_2(popped, is_a, Pb, Pa, 1, m2, distinct));       // 4
    store(pop_in_2(popped, is_a, Pb, Pa, -1, m2, distinct));      // 5
    store(pop_in_34(popped, is_a, Pb, Pa, 1, distinct, true));    // 6
    store(pop_in_34(popped, is_a, Pb, Pa, -1, distinct, true));   // 7
    store(swap_activity(popped, is_a, Pa, m2));                   // 8
  } else {
    store(pop_in_34(popped, is_a, Pb, Pa, 1, distinct, true));    // 2
    store(pop_in_34(popped, is_a, Pb, Pa, -1, distinct, true));   // 3
    store(pop_in_34(popped, is_a, Pb, Pa, 1, distinct, false));   // 4
    store(pop_in_34(popped, is_a, Pb, Pa, -1, distinct, false));  // 5
    store(split(x, A, 0, mx));                                    // 6
    store(split(x, A, 1, mx));                                    // 7
    store(is_extremity(A) && is_extremity(Bf) ? paste(x, A, Bf, distinct) : x);   // 8
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {                                   // 9-12
    const Frag t1 = split(x, A, u, mx), t1b = get(s + (T1B + u) * N_FIELDS);
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const Frag t2 = split(t1, t1b, v, s[M1 + u]);
      const Frag y = paste(t2, get(s + (T2A + 2 * u + v) * N_FIELDS),
                           get(s + (T2B + 2 * u + v) * N_FIELDS), distinct);
      if (!MH) {
        store(y);
      } else {
        // f_b must be the matching extremity of a linear contig before
        // the cuts (the last fragment for a cut after it, the first before)
        const bool valid = Bf.circ == 0 && (v == 0 ? Bf.pos == Bf.l_cont - 1 : Bf.pos == 0);
        store(valid ? y : x);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS) em_catalogue_scalars(Args a) { scalars<false>(a); }
__global__ void __launch_bounds__(THREADS) mh_catalogue_scalars(Args a) { scalars<true>(a); }
__global__ void __launch_bounds__(THREADS) em_catalogue_write(Args a) { write<false>(a); }
__global__ void __launch_bounds__(THREADS) mh_catalogue_write(Args a) { write<true>(a); }

Index make_index(const void* ptr, long long value, long long stride, int is64) {
  Index x;
  x.ptr = ptr; x.value = value; x.stride = stride; x.is64 = is64;
  return x;
}

}  // namespace

extern "C" {

int catalogue_scratch_ints() { return SCRATCH; }

// Build the catalogue (mh = 0: C1, the EM one; 1: C2, the MH one) of B
// genomes into out (11, B, slots, n) int32, slots 13 or 14 (base first).
// fields: the 11 int32 field pointers of the state, row_strides their
// elements between genomes (0: one state broadcast), col_strides between
// fragments; base_rows 1 or B. f_a / f_b / max_id: a device pointer
// (int64 when *_is64) with a stride of 0 or 1, or a null pointer and a
// value; mx_none = 1 takes the state's own maximum instead. scratch: B x
// catalogue_scratch_ints() int32. Indices must lie in [0, n). Launches
// both passes on `stream`, does not synchronise, returns the cudaError_t
// of the launches.
int catalogue(int mh, const void* const* fields, const long long* row_strides,
              const long long* col_strides, int n, int B,
              int base_rows, const void* fa, long long fa_value, long long fa_stride,
              int fa_is64, const void* fb, int fb_is64, const void* mx, long long mx_value,
              long long mx_stride, int mx_is64, int mx_none, int* scratch, int* out, int slots,
              void* stream) {
  if (n <= 0 || B <= 0 || B > 65535 || (base_rows != 1 && base_rows != B) || fb == nullptr ||
      (slots != N_CANDIDATES && slots != N_CANDIDATES + 1))
    return (int)cudaErrorInvalidValue;
  Args a;
  for (int f = 0; f < N_FIELDS; ++f) {
    a.field[f] = static_cast<const int*>(fields[f]);
    a.row_stride[f] = row_strides[f];
    a.col_stride[f] = col_strides[f];
  }
  a.n = n; a.B = B; a.base_rows = base_rows;
  a.fa = make_index(fa, fa_value, fa_stride, fa_is64);
  a.fb = make_index(fb, 0, 1, fb_is64);
  a.mx = make_index(mx, mx_value, mx_stride, mx_is64);
  a.mx_none = mx_none;
  a.scratch = scratch; a.out = out; a.slots = slots;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long chunks = (n + THREADS - 1) / THREADS;
  if (chunks * B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (mh) {
    mh_catalogue_scalars<<<B, THREADS, 0, s>>>(a);
    mh_catalogue_write<<<(unsigned)(chunks * B), THREADS, 0, s>>>(a);
  } else {
    em_catalogue_scalars<<<B, THREADS, 0, s>>>(a);
    em_catalogue_write<<<(unsigned)(chunks * B), THREADS, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
