// Stochastic int8 quantization to separate codes and scales (sm_90a).
//
// Replaces the TPU kernel repro/kernels/quantize.py::quantize_blocks_pallas
// (bodies _adaptive_kernel / _fixed_kernel), which the per-leaf reference
// transport and compressed_dgd run once per leaf.  Per 512-wide row y,
// with caller-provided uniform noise u:
//
//   scale = max(absmax(y), 1e-30) * f32(1/127)   (adaptive)
//         = step                                  (fixed)
//   code  = clip(floor(y/scale) + (u < frac(y/scale)), -127, 127)
//
// and the outputs are the (n, 512) int8 codes and the (n, 1) f32 scales.
// The arithmetic is that of the payload quantizer (quantize_payload.cu),
// taken from encode.cuh: only the output layout differs.
//
// Bound: device-memory bytes.  Per row it reads 2 KiB of y (1 KiB in bf16)
// and 2 KiB of noise and writes 516 B, with ~10 float ops per element.
// Design: one warp per row, each lane reading 4 consecutive elements per
// pass with one 16-byte (8-byte for bf16) load, 4 passes per row; the
// absmax is a warp-shuffle reduction in registers, so y is read once.  The
// code rows are 512 B apart, so each lane stores its 4 codes of a pass as
// one aligned 32-bit word; lane 0 stores the row's scale.
//
// Bit-exactness with the plain PyTorch version: y/scale is the correctly
// rounded __fdiv_rn, every other sum is a _rn intrinsic (the build also
// passes -fmad=false), and f32(1/127) is numpy's float32(1/127) by its bit
// pattern.  Padding rows (y == 0) give code 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "encode.cuh"

namespace {

constexpr int kWarpsPerCta = 8;
constexpr int kPasses = wire::kBlock / (32 * 4);

__device__ __forceinline__ uint32_t code_byte(float y, float scale, float u) {
  return static_cast<uint32_t>(static_cast<uint8_t>(
      static_cast<int8_t>(wire::sr_code(y, scale, u, 127.0f))));
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerCta)
quantize_blocks_kernel(const T* __restrict__ y,
                       const float* __restrict__ noise,
                       int8_t* __restrict__ codes,
                       float* __restrict__ scales, long long n_rows,
                       int fixed, float step) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const T* yr = y + row * wire::kBlock;
  const float* ur = noise + row * wire::kBlock;

  float v[kPasses][4];
  float absmax = 0.0f;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    wire::load4(yr, p * 128 + lane * 4, v[p]);
#pragma unroll
    for (int j = 0; j < 4; ++j) absmax = fmaxf(absmax, fabsf(v[p][j]));
  }
  float scale;
  if (fixed) {
    scale = step;
  } else {
    // float32(1/127) == 0x3C010204, as in the reference
    scale = __fmul_rn(fmaxf(wire::warp_max(absmax), wire::eps_scale()),
                      __uint_as_float(0x3C010204u));
  }

  int8_t* crow = codes + row * wire::kBlock;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int idx = p * 128 + lane * 4;
    const float4 u = *reinterpret_cast<const float4*>(ur + idx);
    const uint32_t word = code_byte(v[p][0], scale, u.x)
                          | (code_byte(v[p][1], scale, u.y) << 8)
                          | (code_byte(v[p][2], scale, u.z) << 16)
                          | (code_byte(v[p][3], scale, u.w) << 24);
    *reinterpret_cast<uint32_t*>(crow + idx) = word;
  }
  if (lane == 0) scales[row] = scale;
}

}  // namespace

// y: (n_rows, 512) f32 (y_is_bf16 == 0) or bf16, noise: (n_rows, 512) f32,
// codes: (n_rows, 512) int8, scales: (n_rows,) f32 — all contiguous.
// fixed != 0 uses `step` as every row's scale.  Returns cudaGetLastError()
// after the launch.
extern "C" int quantize_blocks_launch(const void* y, int y_is_bf16,
                                      const float* noise, int8_t* codes,
                                      float* scales, long long n_rows,
                                      int fixed, float step, void* stream) {
  if (n_rows <= 0) return 0;
  const dim3 grid(static_cast<unsigned>(
      (n_rows + kWarpsPerCta - 1) / kWarpsPerCta));
  const dim3 block(32 * kWarpsPerCta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (y_is_bf16) {
    quantize_blocks_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(y), noise, codes, scales, n_rows,
        fixed, step);
  } else {
    quantize_blocks_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(y), noise, codes, scales, n_rows, fixed,
        step);
  }
  return static_cast<int>(cudaGetLastError());
}
