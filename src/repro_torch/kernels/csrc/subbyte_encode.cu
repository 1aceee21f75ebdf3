// Bit-packed int4 / int2 stochastic quantize-to-wire for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bitpack.py::subbyte_encode_pallas
// (core _subbyte_encode_core).  Per 512-wide row y of the packed
// differential, with caller-provided uniform noise u and code_max =
// 2^(b-1) - 1 (7 for int4, 1 for int2):
//
//   scale = bf16_up(max(absmax(y), 1e-30) * f32(1/code_max))   (adaptive)
//         = bf16(step)                                          (fixed)
//   code  = clip(floor(y/scale) + (u < frac(y/scale)), +-code_max)
//   field = code + code_max + 1, packed 8/b per byte, low code first
//   out   = 512/(8/b) field bytes || 2 bf16 scale bytes, LSB first
//
// Bound: device-memory bytes.  Per row it reads 2 KiB of y (1 KiB in bf16)
// and the 2 KiB leading noise columns and writes 258 B (int4) or 130 B
// (int2), with ~10 float ops per element.  Design: one warp per row as in
// the int8 encoder, each lane reading 4 consecutive floats per pass with
// 16-byte loads (4 passes per row, fully coalesced), the absmax a warp
// shuffle reduction in registers.  The payload rows are only 2-byte
// aligned: a lane stores its 4 codes of a pass as one 16-bit word (int4) or
// one byte (int2), lane 0 the scale as one 16-bit word.  The noise row
// stride is an argument: the kernel reads the leading 512 columns of a
// buffer of any width.
//
// Bit-exactness with the plain PyTorch version: see encode.cuh; the build
// passes -fmad=false and never --use_fast_math.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "encode.cuh"

namespace {

using wire::kBlock;
constexpr int kWarpsPerCta = 8;
constexpr int kPasses = kBlock / (32 * 4);

template <typename T, int kBits>
__global__ void __launch_bounds__(32 * kWarpsPerCta)
subbyte_encode_kernel(const T* __restrict__ y,
                      const float* __restrict__ noise, long long noise_stride,
                      uint8_t* __restrict__ out, long long n_rows, int fixed,
                      float step) {
  constexpr int kCodeMax = (1 << (kBits - 1)) - 1;
  constexpr int kCodeBytes = kBlock * kBits / 8;
  constexpr int kWidth = kCodeBytes + 2;
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const T* yr = y + row * kBlock;
  const float* ur = noise + row * noise_stride;

  float v[kPasses][4];
  float absmax = 0.0f;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    wire::load4(yr, p * 128 + lane * 4, v[p]);
#pragma unroll
    for (int j = 0; j < 4; ++j) absmax = fmaxf(absmax, fabsf(v[p][j]));
  }
  // float32(1/7) == 0x3E124925; 1/1 is exact
  const float inv_cm = kBits == 4 ? __uint_as_float(0x3E124925u) : 1.0f;
  const float scale = fixed ? wire::bf16_round(step)
                            : wire::adaptive_scale(wire::warp_max(absmax),
                                                   inv_cm);

  uint8_t* orow = out + row * kWidth;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int idx = p * 128 + lane * 4;
    const float4 u = *reinterpret_cast<const float4*>(ur + idx);
    const float uu[4] = {u.x, u.y, u.z, u.w};
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int field = wire::sr_code(v[p][j], scale, uu[j],
                                      static_cast<float>(kCodeMax))
                        + kCodeMax + 1;
      word |= static_cast<uint32_t>(field) << (kBits * j);
    }
    if (kBits == 4) {   // 4 codes -> 2 bytes at idx/2 (row stride 258: even)
      *reinterpret_cast<uint16_t*>(orow + idx / 2) =
          static_cast<uint16_t>(word);
    } else {            // 4 codes -> 1 byte at idx/4
      orow[idx / 4] = static_cast<uint8_t>(word);
    }
  }
  if (lane == 0)
    *reinterpret_cast<uint16_t*>(orow + kCodeBytes) =
        static_cast<uint16_t>(wire::bf16_bits(scale));
}

template <int kBits>
void launch(const void* y, int y_is_bf16, const float* noise,
            long long noise_stride, uint8_t* out, long long n_rows,
            int fixed, float step, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(
      (n_rows + kWarpsPerCta - 1) / kWarpsPerCta));
  const dim3 block(32 * kWarpsPerCta);
  if (y_is_bf16) {
    subbyte_encode_kernel<__nv_bfloat16, kBits><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(y), noise, noise_stride, out,
        n_rows, fixed, step);
  } else {
    subbyte_encode_kernel<float, kBits><<<grid, block, 0, s>>>(
        static_cast<const float*>(y), noise, noise_stride, out, n_rows,
        fixed, step);
  }
}

}  // namespace

// y: (n_rows, 512) f32 (y_is_bf16 == 0) or bf16, contiguous; noise: rows of
// noise_stride floats (16-byte aligned), of which the leading 512 are read;
// out: (n_rows, 512*code_bits/8 + 2) u8, contiguous.  Base pointers are
// already at the chunk's first row.  fixed != 0 uses bf16(step) as every
// row's scale.  Returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a code width other than 4 or 2).
extern "C" int subbyte_encode_launch(const void* y, int y_is_bf16,
                                     const float* noise,
                                     long long noise_stride, uint8_t* out,
                                     long long n_rows, int code_bits,
                                     int fixed, float step, void* stream) {
  if (code_bits != 4 && code_bits != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bits == 4)
    launch<4>(y, y_is_bf16, noise, noise_stride, out, n_rows, fixed, step, s);
  else
    launch<2>(y, y_is_bf16, noise, noise_stride, out, n_rows, fixed, step, s);
  return static_cast<int>(cudaGetLastError());
}
