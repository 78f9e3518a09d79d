// The delta engine's per-call inputs of its scorers, for NVIDIA Hopper
// (sm_90a): I1, the neighbour slots' scalars and parameter rows, one launch
// a scoring call before the catalogue (candidates.cu); I2, the sub-row
// vectors of every slot's 14 genomes and B4's keys, one launch a scoring
// call after it.
//
// Replaces no Pallas kernel: the JAX package computes these as jnp code
// that XLA fuses into the operands of the mini-grid scorer's pallas_call
// (graal_tpu/ops/likelihood_pallas.py `_mini_kernel`, the call :463):
// graal_tpu/core/delta.py `make_delta_scorer`'s `lf_a` / `lf_b` (:637-638),
// `sub_rows_of` (:374-384), `geometry` (:386-396), the obs keys (:555-557,
// :563-565), `accu_sub` and `log_accu` (:650-651) and `la` (:672), and the
// scorer's `params_vec` (likelihood_pallas.py :410-419). The plain torch
// versions (graal_tpu_torch/core/delta.py `slot_inputs_plain`,
// `sub_vectors_plain`) take some sixty small kernels a call on the card:
// twelve gathers, two argmaxes, the casts, divisions, sums, logs and
// selects.
//
// I1, for slot s = (chain c, neighbour j) of the C x m slots:
//   lf_a[s]   = first i with rows[c, j, i] == f_a[c], else 0
//   lf_b[s]   = first i with rows[c, j, i] == ids[c, j], else 0
//               (torch.argmax of the int mask: the first maximum wins;
//               padding rows included)
//   max_id[s] = max_id[c]
//   pvec[s]   = params_vector of chain c's parameters (params_row.cuh)
// I2, for slot s, genome g (0 the base, 1-13 the candidates) and sub row
// k = i * s_max + t of R = f_max * s_max, with f = rows[c, j, i]:
//   sub       = sub_start[f] + t,  sub_valid = valid[c, j, i] && t < sub_count[f]
//   sc        = clamp(sub, 0, K - 1)
//   mid       = sub_mid(start_bp, ori, prefix[sc], suffix[sc], len_kb[sc] * 0.5)
//   idc, circ (f32), stot = l_cont_bp / 1000, of genome g's fragment i
//   act       = activ == 1 && sub_valid
//   la        = act ? log(accu[sc]) : -1e9
//   keys[s, k] = base act ? (key_of ? key_of[sc] : sc) : -1     (int32)
// and, for the repeat engine's copy corrections (F1 / F2) and the banded
// route, act (bool), circ (int32) and accu_sub[s, k] = accu[sc].
//
// What bounds them on the card: bytes, and below some hundred thousand
// entries latency. I2 writes five 4-byte (M, 14, R) planes: 1.4 MB at M =
// 5, R = 1,024, under half a microsecond at 3.35 TB/s; 92 MB at M = 20,
// R = 16,384, 27 microseconds. I1 reads each slot's rows up to its first
// matches and writes 15 words a slot.
//
// What the design does about it.
//  - I1: a block a slot, of as many warps as hold its f_max rows at up to
//    SLOT_ROWS a thread (1 to 32 warps: `slot_threads`). Warp w takes the
//    run of 32 x SLOT_ROWS rows from w x 32 x SLOT_ROWS (past 32 warps'
//    rows, the next runs in turn), pass q of it the 32 consecutive rows
//    from q x 32: every thread issues all its row loads of a run before
//    the first compare. Then, pass by pass in row order, a ballot of
//    the lanes whose row is f_a (and one for the neighbour) and the lowest
//    set bit give the warp's first match; the warps' runs rise with w, so
//    the least over the warps (one shared-memory round, one barrier, a
//    warp's __reduce_min_sync) is the slot's first match. The scalars do
//    not wait for the scan: the last warp's lane 0 loads max_id and the
//    parameters at the start and writes max_id and the parameter row
//    (params_row.cuh, the code D1 and H1 write theirs with) beside it.
//  - I2: a thread an output (slot, genome, sub row), the sub rows of a
//    slot consecutive across threads, so every plane is written coalesced;
//    the base genome's threads also write the keys and accu_sub.
//  - Each counts its own launches: block 0's thread 0 adds one to its
//    launch key's int64 on the card (ops/counts.py), so no counting kernel
//    runs beside them.
//  - Both read their inputs in place at their strides (the extraction's
//    (C, m, f_max) rows and valid, eager or graphed; the catalogue's (M, 14,
//    f_max) views of one buffer), make no host read and allocate nothing:
//    the wrapper passes fresh outputs, so a captured step (core.graphs.Scan)
//    captures the launches.
//  - Bit-identity with the plain versions on the card: the divisions by
//    1,000 are products with the f32 reciprocal and the midpoint a left-to-
//    right sum of round-to-nearest intrinsics (sub_geometry.cuh, shared
//    with H1); la is logf, as torch's log kernel; int32 -> float is cvt.rn.
//
// Launch keys (ops/counts.py): "delta_slots" (I1), "delta_vectors" (I2).

#include <cuda_runtime.h>

#include "params_row.cuh"
#include "sub_geometry.cuh"

namespace {

constexpr int SLOT_ROWS = 16;        // I1: rows a thread loads at once, at most
constexpr int MAX_SLOT_THREADS = 1024;
constexpr int VEC_THREADS = 256;
constexpr int N_GEN = 14;            // the base genome and its 13 candidates
constexpr int N_PARAMS = 8;          // RippeParams: kuhn lm c1 slope d d_max fact v_inter
constexpr int NO_MATCH = 0x7fffffff;
constexpr float DEAD_LA = -1e9f;     // la of padding and inactive rows
enum Field { START_BP = 0, ORI, ID_C, CIRC, L_CONT_BP, ACTIV, N_READ };
enum Param { KUHN = 0, LM, C1, SLOPE, D, D_MAX, FACT, V_INTER };

struct SlotArgs {
  const long long* rows;        // (C, m, f_max) int64 at strides
  long long rows_cs, rows_ms, rows_is;
  const void* f_a;              // (C,) int32 or int64 (fa64)
  const void* ids;              // (C, m) int32 or int64 (ids64)
  const void* max_id;           // (C,) int32 or int64 (mx64)
  long long fa_s, ids_cs, ids_ms, mx_s;
  const float* par[N_PARAMS];   // the parameters, f32: one value or one a chain
  long long par_s[N_PARAMS];    // their strides between chains (0: shared)
  const float* log_nfpb;        // 0-d f32
  long long* lf;                // (2, M) int64 outputs: lf_a, then lf_b
  void* max_id_out;             // (M,) of max_id's type
  float* pvec;                  // (M, 10)
  unsigned long long* counter;  // the launch key's int64 (ops/counts.py)
  int C, m, f_max;
  int fa64, ids64, mx64;
};

struct VecArgs {
  const int* g[N_READ];            // the genomes' fields, (M, 14, f_max) int32 at strides
  long long g_ss[N_READ];          // their strides between slots,
  long long g_gs[N_READ];          // between genomes
  long long g_is[N_READ];          // and between fragments
  const long long* rows;           // (C, m, f_max) int64 at strides
  long long rows_cs, rows_ms, rows_is;
  const unsigned char* valid;      // (C, m, f_max) bool at strides
  long long valid_cs, valid_ms, valid_is;
  const long long* sub_start;      // (n,) a fragment's first sub row
  const long long* sub_count;      // (n,) its sub rows
  const float* prefix;             // (K,) kb before the sub row on a forward fragment
  const float* suffix;             // (K,) ... on a reversed one
  const float* len_kb;             // (K,)
  const float* accu;               // (K,)
  const long long* key_of;         // (K,) the data sub of a sub row, or nullptr
  float* mid;                      // (M, 14, R) outputs
  int* idc;
  float* circ;
  float* stot;
  float* la;
  int* keys;                       // (M, R)
  unsigned char* act;              // (M, 14, R), or nullptr (with circ_i and accu_sub)
  int* circ_i;                     // (M, 14, R)
  float* accu_sub;                 // (M, R)
  unsigned long long* counter;     // the launch key's int64 (ops/counts.py)
  float inv_kb;                    // f32 1 / 1000
  int C, m, f_max, s_max, R, K;
  int pad;
};

__device__ __forceinline__ long long load_index(const void* p, long long i, int is64) {
  return is64 ? static_cast<const long long*>(p)[i] : static_cast<const int*>(p)[i];
}

// I1's threads for f_max rows: the warps that hold them at SLOT_ROWS a
// thread, 1 to 32
__host__ __device__ __forceinline__ int slot_threads(int f_max) {
  const int warps = (f_max + 32 * SLOT_ROWS - 1) / (32 * SLOT_ROWS);
  return 32 * (warps < 1 ? 1 : (warps > MAX_SLOT_THREADS / 32 ? MAX_SLOT_THREADS / 32 : warps));
}

__global__ void __launch_bounds__(MAX_SLOT_THREADS)
    delta_slots_kernel(const __grid_constant__ SlotArgs a) {
  __shared__ int first[2][MAX_SLOT_THREADS / 32];
  const int s = blockIdx.x;
  const int c = s / a.m, j = s - c * a.m;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  if (s == 0 && tid == 0) atomicAdd(a.counter, 1ULL);
  const long long* row = a.rows + a.rows_cs * c + a.rows_ms * j;
  const long long fa = load_index(a.f_a, a.fa_s * c, a.fa64);
  const long long fb = load_index(a.ids, a.ids_cs * c + a.ids_ms * j, a.ids64);
  if (warp == n_warps - 1 && lane == 0) {   // the scalars, beside the scan
    const long long mx = load_index(a.max_id, a.mx_s * c, a.mx64);
    auto p = [&](int k) { return a.par[k][a.par_s[k] * c]; };
    if (a.mx64) static_cast<long long*>(a.max_id_out)[s] = mx;
    else static_cast<int*>(a.max_id_out)[s] = static_cast<int>(mx);
    write_params_row(a.pvec + static_cast<long long>(PARAMS_ROW) * s, p(KUHN), p(LM), p(C1),
                     p(SLOPE), p(D), p(D_MAX), p(FACT), p(V_INTER), *a.log_nfpb);
  }
  // the warp's first matches: the first pass with a hit, its lowest lane;
  // past 32 warps' rows the warps take the next runs, in order
  int ia = NO_MATCH, ib = NO_MATCH;
  for (int run = warp * 32 * SLOT_ROWS; run < a.f_max && (ia == NO_MATCH || ib == NO_MATCH);
       run += n_warps * 32 * SLOT_ROWS) {
    long long r[SLOT_ROWS];                 // every row of the run loaded before any compare
#pragma unroll
    for (int q = 0; q < SLOT_ROWS; ++q) {
      const int i = run + q * 32 + lane;
      r[q] = i < a.f_max ? row[a.rows_is * i] : 0;
    }
#pragma unroll
    for (int q = 0; q < SLOT_ROWS; ++q) {
      const bool in = run + q * 32 + lane < a.f_max;
      const unsigned ha = __ballot_sync(0xffffffffu, in && r[q] == fa);
      const unsigned hb = __ballot_sync(0xffffffffu, in && r[q] == fb);
      if (ia == NO_MATCH && ha) ia = run + q * 32 + __ffs(ha) - 1;
      if (ib == NO_MATCH && hb) ib = run + q * 32 + __ffs(hb) - 1;
    }
  }
  if (n_warps > 1) {
    if (lane == 0) {
      first[0][warp] = ia;
      first[1][warp] = ib;
    }
    __syncthreads();
    if (warp != 0) return;
    ia = __reduce_min_sync(0xffffffffu, lane < n_warps ? first[0][lane] : NO_MATCH);
    ib = __reduce_min_sync(0xffffffffu, lane < n_warps ? first[1][lane] : NO_MATCH);
  }
  if (tid != 0) return;
  const long long big_m = static_cast<long long>(a.C) * a.m;
  a.lf[s] = ia == NO_MATCH ? 0 : ia;
  a.lf[big_m + s] = ib == NO_MATCH ? 0 : ib;
}

__global__ void __launch_bounds__(VEC_THREADS) delta_vectors_kernel(const __grid_constant__ VecArgs a) {
  const int k = blockIdx.x * VEC_THREADS + threadIdx.x;
  if (k == 0 && blockIdx.y == 0 && blockIdx.z == 0) atomicAdd(a.counter, 1ULL);
  if (k >= a.R) return;
  const int gen = blockIdx.y;
  const int s = blockIdx.z;
  const int c = s / a.m, j = s - c * a.m;
  const int i = k / a.s_max, t = k - i * a.s_max;
  const long long f = a.rows[a.rows_cs * c + a.rows_ms * j + a.rows_is * i];
  const bool row_ok = a.valid[a.valid_cs * c + a.valid_ms * j + a.valid_is * i] != 0;
  const long long sub = a.sub_start[f] + t;
  const bool sub_valid = row_ok && t < a.sub_count[f];
  const long long sc = sub < 0 ? 0 : (sub > a.K - 1 ? a.K - 1 : sub);
  auto field = [&](int q) { return a.g[q][a.g_ss[q] * s + a.g_gs[q] * gen + a.g_is[q] * i]; };
  const long long e = (static_cast<long long>(s) * N_GEN + gen) * a.R + k;
  const bool act = field(ACTIV) == 1 && sub_valid;
  const int circ = field(CIRC);
  a.mid[e] = sub_mid(field(START_BP), field(ORI), a.prefix[sc], a.suffix[sc],
                     __fmul_rn(a.len_kb[sc], 0.5f), a.inv_kb);
  a.idc[e] = field(ID_C);
  a.circ[e] = __int2float_rn(circ);
  a.stot[e] = kb_of(field(L_CONT_BP), a.inv_kb);
  a.la[e] = act ? logf(a.accu[sc]) : DEAD_LA;
  if (a.act != nullptr) {
    a.act[e] = act;
    a.circ_i[e] = circ;
  }
  if (gen != 0) return;
  const long long r = static_cast<long long>(s) * a.R + k;
  a.keys[r] = act ? static_cast<int>(a.key_of != nullptr ? a.key_of[sc] : sc) : -1;
  if (a.accu_sub != nullptr) a.accu_sub[r] = a.accu[sc];
}

}  // namespace

extern "C" {

// sizeof the argument blocks, for the wrapper's check of their ctypes mirrors
int delta_slot_args_size() { return (int)sizeof(SlotArgs); }
int delta_vector_args_size() { return (int)sizeof(VecArgs); }

// Launch I1 / I2 on `stream` from the argument block the wrapper filled; do
// not synchronise; return the cudaError_t of the launch
// (cudaErrorInvalidValue for a block they refuse, a null counter among it).
int delta_slots(const void* args, void* stream) {
  const SlotArgs* a = static_cast<const SlotArgs*>(args);
  const long long big_m = static_cast<long long>(a->C) * a->m;
  if (a->C < 1 || a->m < 1 || a->f_max < 1 || big_m > 65535 || a->counter == nullptr)
    return (int)cudaErrorInvalidValue;
  delta_slots_kernel<<<(int)big_m, slot_threads(a->f_max), 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

int delta_vectors(const void* args, void* stream) {
  const VecArgs* a = static_cast<const VecArgs*>(args);
  const long long big_m = static_cast<long long>(a->C) * a->m;
  if (a->C < 1 || a->m < 1 || a->f_max < 1 || a->s_max < 1 || a->K < 1 || big_m > 65535
      || a->R != static_cast<long long>(a->f_max) * a->s_max || a->counter == nullptr)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a->R + VEC_THREADS - 1) / VEC_THREADS, N_GEN, (unsigned)big_m);
  delta_vectors_kernel<<<grid, VEC_THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // extern "C"
