// The dense scorers' 10-float parameter row, shared by step.cu (D1 writes
// the nuisance test set's row) and vectors.cu (H1 writes the row of the
// parameters a scoring call is given), so that the two rows cannot drift
// apart. The layout is ops/likelihood_cuda.py `params_vector`'s (and
// scorer_common.cuh's P_* order): [log_c1fact, slope, d, d_max, lm/kuhn,
// log_v_inter, v_inter, log_norm_circ, log_k3fact, log_nfpb].
//
// Bit for bit the plain version on the card: each float operation is an
// explicit round-to-nearest intrinsic in params_vector's order, so nvcc
// never contracts two of them into an FMA; the math library calls are the
// ones torch's CUDA kernels make (logf, and the general powf for
// torch.pow(kuhn, -3.0)); a division of two tensors is an IEEE division.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

constexpr int PARAMS_ROW = 10;

__device__ __forceinline__ void write_params_row(float* r, float kuhn, float lm, float c1,
                                                 float slope, float d, float d_max, float fact,
                                                 float v_inter, float log_nfpb) {
  const float log_k3fact = logf(__fmul_rn(powf(kuhn, -3.0f), fact));
  const float nmax = __fdiv_rn(lm, kuhn);
  r[0] = logf(__fmul_rn(c1, fact));
  r[1] = slope;
  r[2] = d;
  r[3] = d_max;
  r[4] = nmax;
  r[5] = logf(v_inter);
  r[6] = v_inter;
  r[7] = __fadd_rn(__fadd_rn(log_k3fact, __fmul_rn(slope, logf(nmax))),
                   __fdiv_rn(__fsub_rn(d, 2.0f), __fadd_rn(__fmul_rn(nmax, nmax), d)));
  r[8] = log_k3fact;
  r[9] = log_nfpb;
}
