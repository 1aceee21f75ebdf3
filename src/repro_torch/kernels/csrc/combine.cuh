// The receive-side update every wire codec shares (Hopper, sm_90a).
//
// Counterpart of combine_core in repro/kernels/bitpack.py, which the int8
// kernel dequant_combine_payload_pallas computes too.  Per element, with
// d_* the values decoded from the self / left / right wire payloads:
//
//   x_t'  = x_t + deamp * d_s
//   m'    = m + (w_side * deamp) * (d_l + d_r)
//   comb  = w_self * x_t' + m'
//
// Every product and sum is a _rn intrinsic in the reference's order, so no
// FMA contraction moves a bit (the build also passes -fmad=false).  The
// caller decodes 4 consecutive elements of a 512-wide row; combine_quad
// moves the fp32 shadows and outputs as 16-byte vectors.

#pragma once

#include <cuda_runtime.h>

namespace wire {

__device__ __forceinline__ void combine_quad(
    const float d_s[4], const float d_l[4], const float d_r[4],
    const float* __restrict__ x_tilde, const float* __restrict__ m_agg,
    float* __restrict__ xt_out, float* __restrict__ m_out,
    float* __restrict__ comb_out, long long e, float w_self,
    float w_side_deamp, float deamp) {
  const float4 xt4 = *reinterpret_cast<const float4*>(x_tilde + e);
  const float4 m4 = *reinterpret_cast<const float4*>(m_agg + e);
  const float xt[4] = {xt4.x, xt4.y, xt4.z, xt4.w};
  const float mm[4] = {m4.x, m4.y, m4.z, m4.w};
  float xo[4], mo[4], co[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    xo[j] = __fadd_rn(xt[j], __fmul_rn(deamp, d_s[j]));
    mo[j] = __fadd_rn(mm[j],
                      __fmul_rn(w_side_deamp, __fadd_rn(d_l[j], d_r[j])));
    co[j] = __fadd_rn(__fmul_rn(w_self, xo[j]), mo[j]);
  }
  *reinterpret_cast<float4*>(xt_out + e) =
      make_float4(xo[0], xo[1], xo[2], xo[3]);
  *reinterpret_cast<float4*>(m_out + e) =
      make_float4(mo[0], mo[1], mo[2], mo[3]);
  *reinterpret_cast<float4*>(comb_out + e) =
      make_float4(co[0], co[1], co[2], co[3]);
}

}  // namespace wire
