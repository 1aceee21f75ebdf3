// Arithmetic shared by the sub-byte and top-k wire encoders (sm_90a).
//
// Counterparts of _row_scale, _sr_clip and _bf16_round in
// repro/kernels/bitpack.py.  Every rounding is spelled: __fdiv_rn for
// y / scale, _rn products and sums, bf16 rounding to nearest-even with
// __float2bfloat16_rn.  The float constants are the reference's float32
// values given by their bit patterns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wire {

constexpr int kBlock = 512;        // quantization block (row width)

__device__ __forceinline__ float eps_scale() {   // float32(1e-30)
  return __uint_as_float(0x0DA24260u);
}

__device__ __forceinline__ void load4(const float* y, int idx, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(y + idx);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* y, int idx,
                                      float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(y + idx);
  // bf16 -> f32 is exact: the bf16 bits are the high half of the f32
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xffff0000u);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// bf16 bits of a bf16-exact float (its high half)
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __float_as_uint(x) >> 16;
}

// adaptive grid: max(absmax, 1e-30) * f32(1 / code_max), rounded to bf16,
// one bf16 ulp up (times f32(1 + 2^-7)) where the nearest bf16 fell short
__device__ __forceinline__ float adaptive_scale(float absmax, float inv_cm) {
  const float scale = __fmul_rn(fmaxf(absmax, eps_scale()), inv_cm);
  const float s_near = bf16_round(scale);
  const float s_up = bf16_round(__fmul_rn(s_near, 1.0078125f));
  return s_near < scale ? s_up : s_near;
}

// stochastic round of y / scale with uniform u, clipped to +-code_max
__device__ __forceinline__ int sr_code(float y, float scale, float u,
                                       float code_max) {
  const float s = __fdiv_rn(y, scale);
  const float lo = floorf(s);
  const float frac = __fsub_rn(s, lo);
  float q = __fadd_rn(lo, (u < frac) ? 1.0f : 0.0f);
  q = fminf(fmaxf(q, -code_max), code_max);
  return static_cast<int>(q);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

}  // namespace wire
