// The dense scorers' per-candidate sub-fragment vectors and their parameter
// row, for NVIDIA Hopper (sm_90a): H1, one launch a scoring call of B1
// (ll_dense.cu) or B3 (ll_repeat.cu).
//
// Replaces no Pallas kernel: the JAX package computes these as jnp code that
// XLA fuses into the operands of its pallas_call (graal_tpu/ops/
// likelihood_pallas.py `sub_vectors` :259-279, `params_vector` :215-225 and
// :651 for repeats, `copy_vectors` :666-686). The plain torch versions
// (graal_tpu_torch/ops/likelihood_cuda.py `CopyRowScorer.geometry`,
// ops/repeat_cuda.py `RepeatScorer.vectors_plain`, which adds the copy-order
// `a` column, and `params_vector`) take some twenty elementwise and gather
// kernels a call: five gathers at `owner`, the int-to-float conversions,
// the divisions by 1,000, the orientation select and the sums, and four
// logs and some ten products for the row.
//
// The function, for candidate b and sub row k (in the scorer's `rows`
// order), with f = owner[k]:
//   mid[b, k]  = (start_bp[b, f] / 1000 + (ori[b, f] == 1 ? prefix[k]
//                 : suffix[k])) + len_half[k]
//   idc[b, k]  = id_c[b, f]
//   circ[b, k] = circ[b, f]
//   stot[b, k] = l_cont_bp[b, f] / 1000
//   a[b, k]    = activ[b, f] == 1 ? accu[k] : 0         (B3 only)
// and, when the call has no row yet, the 10 floats of params_vector.
//
// What bounds it on the card: bytes, and at these sizes latency. A call
// reads 5 or 6 int32 fields of each of B genomes (B x n x 4 bytes each) and
// 4 or 5 float vectors of the table, and writes 4 or 5 (B, K) planes: 1.5 MB
// at B = 65, K = 1,152, half a microsecond at 3.35 TB/s; a launch and two
// dependent loads (owner[k], then the fields at f) cost more than that.
//
// What the design does about it.
//  - One launch a call, shaped for latency: a block of `threads` threads
//    takes a chunk of sub rows for a group of G genomes (the wrapper's
//    `plan` picks both from (B, K)). Each thread loads owner, prefix,
//    suffix, len_half (and accu) once for its k, then issues all G
//    genomes' field loads before any store, so they are in flight
//    together; the stores are coalesced along k. The plan keeps G = 1 (128
//    threads, 32 registers, 16 blocks an SM) wherever the grid fits one
//    wave of resident blocks, and takes G = 2 or 4 only past that
//    (tempered chains, B = 260): measured on the card, more genomes a
//    thread (G = 8 or 16, 66 and 120 registers) left too few warps to hide
//    the latency and were slower at every shape (PERF.md §6).
//  - The genomes' fields are read at their strides (C1's (B, n) output or
//    the nuisance call's x[None] view, both without a copy). Block (0, 0)'s
//    thread 0 also writes the parameter row (params_row.cuh, the code D1
//    writes its row with) and adds one to the launch key's int64 counter
//    (ops/counts.py `LaunchCount.counter`), so no counting kernel runs
//    beside H1. No host read and no allocation: the wrapper passes fresh
//    outputs, so a captured step (core.graphs.Scan) captures the launch.
//  - Bit-identity with the plain version on the card. Each torch op rounds
//    on its own, so every float operation is an explicit round-to-nearest
//    intrinsic in the plain order: int32 -> float is cvt.rn
//    (__int2float_rn, as .float()); the division by the Python float 1000.0
//    is a product with its f32 reciprocal (torch on the card computes a
//    division by a CPU scalar so; the wrapper passes the reciprocal, made in
//    f32 on the host); the sum start_kb + w + len_half is taken left to
//    right with __fadd_rn, so nvcc cannot contract it (sub_geometry.cuh,
//    which I2 in delta_inputs.cu shares).
//
// Launch key (ops/counts.py): "vectors".

#include <cuda_runtime.h>

#include "params_row.cuh"
#include "sub_geometry.cuh"

namespace {

constexpr int MAX_THREADS = 256;
constexpr int N_PARAMS = 8;          // RippeParams: kuhn lm c1 slope d d_max fact v_inter
enum Field { START_BP = 0, ORI, ID_C, CIRC, L_CONT_BP, ACTIV, N_READ };
enum Param { KUHN = 0, LM, C1, SLOPE, D, D_MAX, FACT, V_INTER };

struct VectorsArgs {
  const int* st[N_READ];        // the genomes' fields read, (B, n) int32 at any strides
  long long st_bs[N_READ];      // their strides between genomes
  long long st_is[N_READ];      // and between fragments
  const int* owner;             // (K,) the fragment of each sub row, in the scorer's order
  const float* prefix;          // (K,) kb before the sub row on a forward fragment
  const float* suffix;          // (K,) ... on a reversed one
  const float* len_half;        // (K,) half the sub row's length, kb
  const float* accu;            // (K,) B3's copy-order accu, or nullptr (no `a`)
  float* mid;                   // (B, K) outputs
  int* idc;
  float* circ;
  float* stot;
  float* a;                     // (B, K), or nullptr
  const float* par[N_PARAMS];   // 0-d f32 parameters, read when row is not nullptr
  const float* log_nfpb;
  float* row;                   // (10,) or nullptr
  unsigned long long* counter;  // the launch key's int64 counter
  float inv_kb;                 // f32 1 / 1000
  int B, K;
  int threads;                  // a block's threads: its chunk of sub rows
  int group;                    // G: a block's genomes
  int pad;
};

// Block (x, y): sub rows [x * threads, (x + 1) * threads), genomes
// [y * G, (y + 1) * G) clipped to B; a thread one sub row k of G genomes.
template <int G>
__global__ void __launch_bounds__(MAX_THREADS)
    vectors_kernel(const __grid_constant__ VectorsArgs a) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int b0 = blockIdx.y * G;
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    atomicAdd(a.counter, 1ULL);
    if (a.row != nullptr) {
      const float* const* p = a.par;
      write_params_row(a.row, *p[KUHN], *p[LM], *p[C1], *p[SLOPE], *p[D], *p[D_MAX], *p[FACT],
                       *p[V_INTER], *a.log_nfpb);
    }
  }
  if (k >= a.K) return;
  const bool with_a = a.a != nullptr;
  const long long f = a.owner[k];
  const float prefix = a.prefix[k], suffix = a.suffix[k], len_half = a.len_half[k];
  const float accu = with_a ? a.accu[k] : 0.0f;
  const int n_read = with_a ? N_READ : ACTIV;
  // every genome's fields first, so that the G x 5 or 6 loads are in flight together
  int v[G][N_READ];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const long long b = b0 + g;
    if (b < a.B) {
#pragma unroll
      for (int i = 0; i < N_READ; ++i)
        if (i < n_read) v[g][i] = a.st[i][a.st_bs[i] * b + a.st_is[i] * f];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const long long b = b0 + g;
    if (b < a.B) {
      const long long e = b * a.K + k;
      a.mid[e] = sub_mid(v[g][START_BP], v[g][ORI], prefix, suffix, len_half, a.inv_kb);
      a.idc[e] = v[g][ID_C];
      a.circ[e] = __int2float_rn(v[g][CIRC]);
      a.stot[e] = kb_of(v[g][L_CONT_BP], a.inv_kb);
      if (with_a) a.a[e] = v[g][ACTIV] == 1 ? accu : 0.0f;
    }
  }
}

template <int G>
int launch(const VectorsArgs* a, cudaStream_t stream) {
  const dim3 grid((a->K + a->threads - 1) / a->threads, (a->B + G - 1) / G);
  vectors_kernel<G><<<grid, a->threads, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// sizeof the argument block, for the wrapper's check of its ctypes mirror
int vectors_args_size() { return (int)sizeof(VectorsArgs); }

// Launches H1 on `stream` from the argument block the wrapper filled, does
// not synchronise, and returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a block it refuses: G other than 1, 2 or 4,
// threads not a multiple of 32 in [32, 256], no counter).
int vectors(const void* args, void* stream) {
  const VectorsArgs* a = static_cast<const VectorsArgs*>(args);
  if (a->B < 1 || a->K < 1 || a->counter == nullptr || a->threads < 32
      || a->threads > MAX_THREADS || a->threads % 32 != 0 || a->group < 1
      || (a->B + a->group - 1) / a->group > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (a->group) {
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 4: return launch<4>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
