// Shared by the candidate scorers ll_dense.cu, ll_mini.cu and ll_repeat.cu:
// the per-cell Rippe math of the Pallas `_tile_body` and `_repeat_kernel`
// (graal_tpu/ops/likelihood_pallas.py) -- the expectation of a same-contig
// sub-fragment pair, in log space and in linear space -- and the
// enumeration of the upper-triangle tiles of a pair grid, and their
// persistent schedule (schedule.cuh) and fixed-order sums.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "schedule.cuh"

// params vector layout (params_vector in ops/likelihood_cuda.py)
enum {
  P_LOG_C1FACT = 0, P_SLOPE, P_D, P_D_MAX, P_LMK, P_LOG_V, P_V_INTER,
  P_LOG_NORM_CIRC, P_LOG_K3FACT, P_LOG_NFPB, N_PARAMS
};

struct RippeCell {
  float log_c1fact, slope, d, d_max, lmk, log_v, v_inter, log_norm_circ,
      log_k3fact, log_nfpb;

  __device__ __forceinline__ explicit RippeCell(const float* __restrict__ pvec)
      : log_c1fact(pvec[P_LOG_C1FACT]), slope(pvec[P_SLOPE]), d(pvec[P_D]),
        d_max(pvec[P_D_MAX]), lmk(pvec[P_LMK]), log_v(pvec[P_LOG_V]),
        v_inter(pvec[P_V_INTER]), log_norm_circ(pvec[P_LOG_NORM_CIRC]),
        log_k3fact(pvec[P_LOG_K3FACT]), log_nfpb(pvec[P_LOG_NFPB]) {}

  // Unclamped log of the same-contig model at midpoint distance s (kb):
  // the linear curve, or on a circular row (circ_row) the circular one
  // normalised by the clamped linear value. *in_range: 0 < s < d_max.
  __device__ __forceinline__ float log_cis_raw(float s, bool circ_row,
                                               float stot, bool* in_range) const {
    const float safe_s = fmaxf(s, 1e-9f);
    const float n_lin = safe_s * lmk;
    const float log_lin = log_c1fact + slope * logf(safe_s)
                          + (d - 2.0f) / (n_lin * n_lin + d);
    *in_range = (s > 0.0f) && (s < d_max);
    if (!circ_row) return log_lin;
    const float n_circ = lmk * safe_s * fmaxf(stot - s, 1e-9f) / fmaxf(stot, 1e-9f);
    const float log_val_circ = log_k3fact + slope * logf(n_circ)
                               + (d - 2.0f) / (n_circ * n_circ + d);
    // the reference normalises by the *clamped* linear value
    const float log_norm_lin = *in_range ? fmaxf(log_lin, log_v) : log_v;
    return log_val_circ + log_norm_lin - log_norm_circ;
  }

  // log E / (accu_u accu_v / nfpb) of a same-contig pair: log_cis_raw
  // clamped below by log v_inter and equal to it outside (0, d_max).
  __device__ __forceinline__ float log_cis(float s, bool circ_row,
                                           float stot) const {
    bool in_range;
    const float out = log_cis_raw(s, circ_row, stot, &in_range);
    return in_range ? fmaxf(out, log_v) : log_v;
  }

  // log_cis with every operation rounded on its own, in the order of the
  // plain torch version (ops/mini_grid_cuda.py log_cis_plain): nvcc never
  // contracts the _rn intrinsics into an FMA, so the copy corrections
  // (repeat_corr.cu) take torch's value term for term.
  __device__ __forceinline__ float log_cis_rn(float s, bool circ_row, float stot) const {
    if (!((s > 0.0f) && (s < d_max))) return log_v;
    const float safe_s = fmaxf(s, 1e-9f);
    const float d2 = __fsub_rn(d, 2.0f);
    const float n_lin = __fmul_rn(safe_s, lmk);
    const float log_lin = __fadd_rn(__fadd_rn(log_c1fact, __fmul_rn(slope, logf(safe_s))),
                                    __fdiv_rn(d2, __fadd_rn(__fmul_rn(n_lin, n_lin), d)));
    if (!circ_row) return fmaxf(log_lin, log_v);
    const float n_circ = __fdiv_rn(__fmul_rn(__fmul_rn(lmk, safe_s),
                                             fmaxf(__fsub_rn(stot, s), 1e-9f)),
                                   fmaxf(stot, 1e-9f));
    const float log_val_circ =
        __fadd_rn(__fadd_rn(log_k3fact, __fmul_rn(slope, logf(n_circ))),
                  __fdiv_rn(d2, __fadd_rn(__fmul_rn(n_circ, n_circ), d)));
    return fmaxf(__fsub_rn(__fadd_rn(log_val_circ, fmaxf(log_lin, log_v)), log_norm_circ),
                 log_v);
  }

  // The same in linear space, as the copy-summing scorer takes it:
  // max(exp(raw), v_inter) inside (0, d_max), v_inter outside.
  __device__ __forceinline__ float cis(float s, bool circ_row, float stot) const {
    bool in_range;
    const float out = log_cis_raw(s, circ_row, stot, &in_range);
    return in_range ? fmaxf(expf(out), v_inter) : v_inter;
  }
};

// The upper-triangle tiles of an n_rb x n_rb tile grid by diagonal: the
// n_rb diagonal tiles (i, i), then the n_rb - 1 tiles (i, i + 1), and so
// on: tile t -> (bi, bj).
__device__ __forceinline__ void band_coords(int t, int n_rb, int* bi, int* bj) {
  int d = 0;
  int rem = t;
  while (rem >= n_rb - d) {
    rem -= n_rb - d;
    ++d;
  }
  *bi = rem;
  *bj = rem + d;
}

// Let the kernel's blocks use the most shared memory an SM has, so the
// blocks that cudaOccupancyMaxActiveBlocksPerMultiprocessor counts are
// resident together and a persistent grid of that size runs in one round.
template <class Kernel>
__host__ cudaError_t prefer_shared(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// Sum over the 32 lanes in a fixed butterfly; lane 0 holds the total.
__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// One item's partial of one candidate: its 8 warp sums added in warp order.
__device__ __forceinline__ void flush_partial(const float* warp_sums, float* out) {
  float tot = 0.0f;
  for (int w = 0; w < persistent::WARPS; ++w) tot += warp_sums[w];
  *out = tot;
}

// Sum of partial[0 .. n) in f64 by one warp in a fixed order: lane l adds
// the elements l, l + 32, ..., then a fixed tree; lane 0 holds the total.
__device__ __forceinline__ double warp_sum_f64(const float* __restrict__ partial, int n) {
  const int lane = threadIdx.x & 31;
  double acc = 0.0;
  for (int e = lane; e < n; e += 32) acc += (double)partial[e];
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  return acc;
}
