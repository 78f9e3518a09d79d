// A sub row's geometry in kb, shared by vectors.cu (H1, the dense scorers'
// vectors) and delta_inputs.cu (I2, the delta engine's), so that the two
// cannot drift apart.
//
// Bit for bit torch on the card: x.float() / 1000.0 there is cvt.rn
// (__int2float_rn) and then a product with the f32 reciprocal of the
// Python float (torch computes a division by a CPU scalar so; the wrappers
// pass the reciprocal, made in f32 on the host). The midpoint
// start_kb + w + len_half is taken left to right, each step an explicit
// round-to-nearest intrinsic, so nvcc cannot contract it into an FMA.
#pragma once

#include <cuda_runtime.h>

// bp -> kb as torch computes bp.float() / 1000.0 on the card
__device__ __forceinline__ float kb_of(int bp, float inv_kb) {
  return __fmul_rn(__int2float_rn(bp), inv_kb);
}

// a sub row's midpoint in kb: (start_kb + (ori == 1 ? prefix : suffix)) +
// len_half, with `prefix` / `suffix` the kb before the sub row on a forward
// / reversed fragment and `len_half` half its length
__device__ __forceinline__ float sub_mid(int start_bp, int ori, float prefix, float suffix,
                                         float len_half, float inv_kb) {
  const float w = ori == 1 ? prefix : suffix;
  return __fadd_rn(__fadd_rn(kb_of(start_bp, inv_kb), w), len_half);
}
