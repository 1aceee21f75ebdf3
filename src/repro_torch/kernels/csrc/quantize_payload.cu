// Fused stochastic int8 quantize-to-wire for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/quantize.py::quantize_payload_pallas
// (bodies _payload_adaptive_kernel / _payload_fixed_kernel).  Per 512-wide
// row y of the packed differential, with caller-provided uniform noise u:
//
//   scale = max(absmax(y), 1e-30) * f32(1/127)   (adaptive)
//         = step                                  (fixed)
//   code  = clip(floor(y/scale) + (u < frac(y/scale)), -127, 127)
//   out   = 512 int8 code bytes || 4 little-endian fp32 scale bytes
//
// Bound: device-memory bytes.  Per row it reads 2 KiB of y (1 KiB in bf16)
// and 2 KiB of noise and writes 516 B, with ~10 float ops per element — far
// below the card's flop/byte balance.  Design: one warp per row, each lane
// reading 4 consecutive floats per pass with 16-byte loads (a warp pass
// covers 512 contiguous bytes, fully coalesced), 4 passes per row.  The
// absmax is a warp-shuffle reduction in registers, so y is read once.
// The payload row stride is 516 B, only 4-byte aligned: each lane stores
// its 4 codes of a pass as one aligned 32-bit word, lane 0 the scale word.
//
// Bit-exactness with the plain PyTorch version: y/scale is the correctly
// rounded __fdiv_rn, every other product/sum is spelled with a _rn
// intrinsic (no FMA contraction; the build also passes -fmad=false), and
// f32(1/127) is the literal bit pattern of numpy's float32(1/127).  Padding
// rows (y == 0) give s == 0, frac == 0 and therefore code 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 512;            // quantization block (row width)
constexpr int kPayload = kBlock + 4;   // codes + fp32 scale bytes
constexpr int kWarpsPerCta = 8;
constexpr int kPasses = kBlock / (32 * 4);

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

__device__ __forceinline__ uint32_t code_byte(float y, float scale, float u) {
  const float s = __fdiv_rn(y, scale);
  const float lo = floorf(s);
  const float frac = __fsub_rn(s, lo);
  float q = __fadd_rn(lo, (u < frac) ? 1.0f : 0.0f);
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<uint8_t>(
      static_cast<int8_t>(static_cast<int>(q))));
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerCta)
quantize_payload_kernel(const T* __restrict__ y,
                        const float* __restrict__ noise,
                        long long noise_stride, uint8_t* __restrict__ out,
                        long long n_rows, int fixed, float step) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const T* yr = y + row * kBlock;
  const float* ur = noise + row * noise_stride;   // leading kBlock cols

  float v[kPasses][4];
  float absmax = 0.0f;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    load4(yr, p * 128 + lane * 4, v[p]);
#pragma unroll
    for (int j = 0; j < 4; ++j) absmax = fmaxf(absmax, fabsf(v[p][j]));
  }
  float scale;
  if (fixed) {
    scale = step;
  } else {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      absmax = fmaxf(absmax, __shfl_xor_sync(0xffffffffu, absmax, off));
    // 1e-30f and float32(1/127) == 0x3C010204, as in the reference
    scale = __fmul_rn(fmaxf(absmax, 1e-30f), __uint_as_float(0x3C010204u));
  }

  uint8_t* orow = out + row * kPayload;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int idx = p * 128 + lane * 4;
    const float4 u = *reinterpret_cast<const float4*>(ur + idx);
    const uint32_t word = code_byte(v[p][0], scale, u.x)
                          | (code_byte(v[p][1], scale, u.y) << 8)
                          | (code_byte(v[p][2], scale, u.z) << 16)
                          | (code_byte(v[p][3], scale, u.w) << 24);
    *reinterpret_cast<uint32_t*>(orow + idx) = word;   // 516*row+idx: 4-aligned
  }
  if (lane == 0)
    *reinterpret_cast<uint32_t*>(orow + kBlock) = __float_as_uint(scale);
}

}  // namespace

// y: (n_rows, 512) f32 (y_is_bf16 == 0) or bf16, contiguous; noise: rows
// of >= 512 f32 (the leading 512 read) every `noise_stride` floats, a
// multiple of 4 so each row is 16-byte aligned; out: (n_rows, 516) u8,
// contiguous.  Base pointers already at the chunk's first row.  fixed != 0
// uses `step` as every row's scale.  Returns cudaGetLastError() after the
// launch.
extern "C" int quantize_payload_launch(const void* y, int y_is_bf16,
                                       const float* noise,
                                       long long noise_stride, uint8_t* out,
                                       long long n_rows, int fixed,
                                       float step, void* stream) {
  if (n_rows <= 0) return 0;
  const dim3 grid(static_cast<unsigned>(
      (n_rows + kWarpsPerCta - 1) / kWarpsPerCta));
  const dim3 block(32 * kWarpsPerCta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (y_is_bf16) {
    quantize_payload_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(y), noise, noise_stride, out,
        n_rows, fixed, step);
  } else {
    quantize_payload_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(y), noise, noise_stride, out, n_rows,
        fixed, step);
  }
  return static_cast<int>(cudaGetLastError());
}
