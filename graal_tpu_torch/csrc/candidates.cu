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
// At the main path's shapes (B = 5-20, n = 384-1,024) a call moves well
// under a megabyte and its time is the launch's and the chain of
// dependent steps inside it.
//
// What the design does about it.
//  - Every primitive (ops.py: flip, swap_activity, pop_out, pop_in_1..4,
//    split, paste) maps a fragment's own fields, the fields of f_a / f_b
//    in the state it reads, and a fresh-id maximum to the fragment's new
//    fields. So a catalogue is per fragment once those per-genome scalars
//    are known, and the chains pop_out -> pop_in_k and split(A) ->
//    split(B) -> paste compose per fragment.
//  - One launch a call: a thread block cluster of K blocks of 256 threads
//    a genome (`cudaLaunchKernelEx` with the cluster dimension; K from n,
//    ops/candidates_cuda.py `plan`: one block a 256-fragment chunk, at
//    most 8). Block r of a cluster owns the chunks r, r + K, r + 2K, ...
//    Each block reads f_a's and f_b's records and its first fragments
//    before anything waits on them, reduces its own chunks' contig ids to
//    partial maxima (warp reductions, `__reduce_max_sync`, and one block
//    barrier), and after one cluster barrier folds all K partials out of
//    its peers' shared memory (DSMEM): every block then holds the same
//    scalars. An integer maximum is exact in any order, so they are the
//    plain version's bit for bit. The maxima: the base's maximum when
//    max_id is not given (over the whole state: with one row a genome,
//    each cluster reads every row, as the plain version's `amax` does);
//    m2, the popped state's maximum; m1, each split state's. A fresh id
//    mx + 1 enters a maximum only through fragments it relabels, so each
//    partial is the maximum of the ids a fragment keeps plus a flag that
//    some fragment takes mx + 1, and mx + 1 is folded in once mx is known.
//    The translocations' second maximum (mt) feeds paste, which takes no
//    fresh id, so it is not computed. Then the block builds the 14
//    records (f_a and f_b in the base, in the popped state, in both
//    splits at f_a and in the four double splits) in shared memory and
//    writes its own chunks: each thread evaluates the 13 candidates of one
//    fragment and stores each field at once; neighbouring threads store
//    neighbouring fragments (128-byte warp stores). No intermediate state
//    and no scalar touches device memory; a block signals that it is done
//    reading its peers before its writes and waits for them only at its
//    end, so no block leaves while a peer may still read it.
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
//  - The launch counts itself: block 0's thread 0 adds one to the launch
//    key's int64 counter on the card (ops/counts.py `LaunchCount.counter`),
//    so no counting kernel runs beside it and a captured launch counts at
//    every replay.
//  - Index widths: B <= 65,535 genomes, n < 2^31 fragments; output offsets
//    are size_t products. f_a, f_b and max_id may be int32 or int64
//    tensors (a stride of 0 broadcasts one value), or a value.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int N_FIELDS = 11;
constexpr int N_CANDIDATES = 13;
constexpr int N_RECORDS = 14;          // A0 B0 PA PB T1B[2] T2A[4] T2B[4]
constexpr int MAX_CLUSTER = 8;         // the portable cluster size
constexpr int INT_MIN_ = -2147483647 - 1;

enum Rec { A0 = 0, B0, PA, PB, T1B, T2A = T1B + 2, T2B = T2A + 4 };
// a block's partial maxima: the state's ids (max_id not given), the ids
// the popped state keeps, the ids each split state keeps, and whether some
// fragment of each split state takes the fresh id
enum Part { P_MX = 0, P_POP, P_T1, P_RIGHT = P_T1 + 2, N_PART = P_RIGHT + 2 };

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
  unsigned long long* counter;  // the launch key's int64 counter
  int* out;                   // (11, B, slots, n)
  int slots;                  // 13, or 14 with the base in slot 0
  int cluster;                // K: blocks a genome
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

// ---- the scalars: partial maxima, folded over the cluster ---------------

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// record k of the 14 (enum Rec) from f_a's and f_b's base records
__device__ __forceinline__ Frag record(int k, const Frag& A, const Frag& Bf, bool same, int mx,
                                       const int* m1) {
  if (k == A0) return A;
  if (k == B0) return Bf;
  if (k == PA) return pop_out(A, true, A, mx);
  if (k == PB) return pop_out(Bf, same, A, mx);
  if (k < T2A) return split(Bf, A, k - T1B, mx);
  const int j = k < T2B ? k - T2A : k - T2B, u = j >> 1, v = j & 1;
  const Frag t1b = split(Bf, A, u, mx);
  return split(k < T2B ? split(A, A, u, mx) : t1b, t1b, v, m1[u]);
}

// ---- every candidate of one fragment ------------------------------------

template <bool MH>
__device__ __forceinline__ void write_fragment(const Args& a, int b, int i, const Frag& x,
                                               const int* rec, int fa, bool distinct, int mx,
                                               int m2, const int* m1) {
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

  const bool is_a = i == fa;
  const Frag A = get(rec + A0 * N_FIELDS), Bf = get(rec + B0 * N_FIELDS);
  const Frag Pa = get(rec + PA * N_FIELDS), Pb = get(rec + PB * N_FIELDS);

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
    const Frag t1 = split(x, A, u, mx), t1b = get(rec + (T1B + u) * N_FIELDS);
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const Frag t2 = split(t1, t1b, v, m1[u]);
      const Frag y = paste(t2, get(rec + (T2A + 2 * u + v) * N_FIELDS),
                           get(rec + (T2B + 2 * u + v) * N_FIELDS), distinct);
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

// ---- the kernel: a cluster of K blocks a genome ---------------------------

template <bool MH>
__global__ void __launch_bounds__(THREADS) catalogue_kernel(Args a) {
  __shared__ int warp_part[WARPS][N_PART];
  __shared__ int part[N_PART];          // this block's partials, read by its peers
  __shared__ int whole[N_PART];         // the cluster's
  __shared__ int rec[N_RECORDS * N_FIELDS];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = a.cluster;
  const int b = blockIdx.x / K;
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x, lane = t & 31;
  if (blockIdx.x == 0 && t == 0) atomicAdd(a.counter, 1ULL);

  // every load that does not wait for the maxima is issued first: f_a's
  // and f_b's records, and this thread's fragment of the block's first chunk
  const int fa = static_cast<int>(load(a.fa, b));
  const int fb = static_cast<int>(load(a.fb, b));
  const int mx_given = a.mx_none ? 0 : static_cast<int>(load(a.mx, b));
  const Frag A = frag_at(a, b, fa), Bf = frag_at(a, b, fb);
  const int first = rank * THREADS + t;
  Frag x0{};
  if (first < a.n) x0 = frag_at(a, b, first);

  // this block's chunks: its partial maxima of the ids each state keeps
  const bool popping = A.l_cont > 1, cutting = split_ok(A) && A.circ == 0;
  const bool own_mx = a.mx_none && a.base_rows == 1;   // the state is this genome's row
  int p[N_PART] = {INT_MIN_, INT_MIN_, INT_MIN_, INT_MIN_, 0, 0};
  for (int i = first; i < a.n; i += K * THREADS) {
    Frag x = x0;
    if (i != first) {
      x.id_c = a.field[1][a.row_stride[1] * b + a.col_stride[1] * i];
      x.pos = a.field[0][a.row_stride[0] * b + a.col_stride[0] * i];
    }
    const int c = x.id_c;
    if (own_mx) p[P_MX] = max(p[P_MX], c);
    if (!(popping && i == fa)) p[P_POP] = max(p[P_POP], c);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (cutting && split_right(x, A, u)) p[P_RIGHT + u] = 1;
      else p[P_T1 + u] = max(p[P_T1 + u], c);
    }
  }
  if (a.mx_none && a.base_rows != 1) {   // one row a genome: the whole state, as amax()
    const long long total = static_cast<long long>(a.base_rows) * a.n;
    for (long long k = first; k < total; k += static_cast<long long>(K) * THREADS) {
      const long long r = k / a.n, i = k - r * a.n;
      p[P_MX] = max(p[P_MX], a.field[1][a.row_stride[1] * r + a.col_stride[1] * i]);
    }
  }
#pragma unroll
  for (int k = 0; k < N_PART; ++k) p[k] = __reduce_max_sync(0xffffffffu, p[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N_PART; ++k) warp_part[t >> 5][k] = p[k];
  }
  __syncthreads();
  if (t < N_PART) {
    int v = warp_part[0][t];
    for (int w = 1; w < WARPS; ++w) v = max(v, warp_part[w][t]);
    part[t] = v;
  }
  cluster.sync();
  if (t < N_PART) {
    int v = part[t];
    for (int r = 0; r < K; ++r)
      if (r != rank) v = max(v, *cluster.map_shared_rank(&part[t], r));
    whole[t] = v;
  }
  cluster_arrive();            // done reading the peers' shared memory
  __syncthreads();

  const int mx = a.mx_none ? whole[P_MX] : mx_given;
  const int m2 = max(max(whole[P_POP], popping ? mx + 1 : INT_MIN_), mx);
  int m1[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int m = max(whole[P_T1 + u], whole[P_RIGHT + u] ? mx + 1 : INT_MIN_);
    m1[u] = MH ? m : max(m, mx);
  }
  if (t < N_RECORDS) put(rec + t * N_FIELDS, record(t, A, Bf, fb == fa, mx, m1));
  __syncthreads();

  for (int i = first; i < a.n; i += K * THREADS)
    write_fragment<MH>(a, b, i, i == first ? x0 : frag_at(a, b, i), rec, fa, fa != fb, mx, m2,
                       m1);
  cluster_wait();              // no block leaves while a peer may read it
}

Index make_index(const void* ptr, long long value, long long stride, int is64) {
  Index x;
  x.ptr = ptr; x.value = value; x.stride = stride; x.is64 = is64;
  return x;
}

template <bool MH>
cudaError_t launch(const Args& a, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.B) * a.cluster, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, catalogue_kernel<MH>, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

extern "C" {

// Build the catalogue (mh = 0: C1, the EM one; 1: C2, the MH one) of B
// genomes into out (11, B, slots, n) int32, slots 13 or 14 (base first).
// fields: the 11 int32 field pointers of the state, row_strides their
// elements between genomes (0: one state broadcast), col_strides between
// fragments; base_rows 1 or B. f_a / f_b / max_id: a device pointer
// (int64 when *_is64) with a stride of 0 or 1, or a null pointer and a
// value; mx_none = 1 takes the state's own maximum instead. counter: the
// launch key's int64 on the card, one added a launch. cluster: K blocks
// of 256 threads a genome (1 to 8). Indices must lie in [0, n). Launches
// one kernel on `stream`, does not synchronise, returns the cudaError_t of
// the launch.
int catalogue(int mh, const void* const* fields, const long long* row_strides,
              const long long* col_strides, int n, int B,
              int base_rows, const void* fa, long long fa_value, long long fa_stride,
              int fa_is64, const void* fb, int fb_is64, const void* mx, long long mx_value,
              long long mx_stride, int mx_is64, int mx_none, void* counter, int* out, int slots,
              int cluster, void* stream) {
  if (n <= 0 || B <= 0 || B > 65535 || (base_rows != 1 && base_rows != B) || fb == nullptr ||
      counter == nullptr || (slots != N_CANDIDATES && slots != N_CANDIDATES + 1) ||
      cluster < 1 || cluster > MAX_CLUSTER)
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
  a.counter = static_cast<unsigned long long*>(counter);
  a.out = out; a.slots = slots; a.cluster = cluster;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(mh ? launch<true>(a, s) : launch<false>(a, s));
}

}  // extern "C"
