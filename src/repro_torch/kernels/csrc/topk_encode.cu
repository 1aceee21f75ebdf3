// Top-k sparse quantize-to-wire for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bitpack.py::topk_encode_pallas
// (core _topk_encode_core with _topk_select).  Per 512-wide row y, split
// into k strata of g = 512/k elements, with a uniform noise row u of at
// least 512 + k columns:
//
//   w_i   = |y_i| + 1e-30
//   key_i = -log(max(u_i, 1e-37)) / w_i                 (columns [0, 512))
//   pick  = the lowest index of the stratum's least key
//   v_s   = y_pick * (sum_stratum(w) / w_pick)          sum in runs of 32
//   scale = bf16_up(max(absmax(v), 1e-30) * f32(1/127)) (adaptive)
//         = bf16(step)                                  (fixed)
//   q_s   = clip(floor(v_s/scale) + (u_{512+s} < frac), +-127)
//   out   = 64-byte pick bitmap (bit j of byte i = element 8i+j)
//           || k int8 values || 2 bf16 scale bytes, LSB first
//
// Bound: device-memory bytes.  Per row it reads 2 KiB of y, 2 KiB + 4k B of
// noise and writes 66 + k B, with ~25 float ops per element (one logf).
// Design, simple first: one warp per row.  The warp stages y and the race
// noise in shared memory with coalesced 16-byte loads; then each lane runs
// whole strata (s = lane, lane + 32, ...): one pass over the g elements
// keeps the least key (strict <, so ties go to the lowest index) and adds
// the weights in the order of the reference's compiled CPU reduction: left
// to right within each run of 32 elements, then the runs' sums left to
// right (g > 32 only, i.e. k < 16).
// The absmax over the k values is a warp shuffle reduction.  k is a
// runtime argument, any divisor of 512; below k = 32 some lanes idle.
// Payload rows are 66 + k bytes, not even 2-byte aligned for k = 1, so the
// row is written with byte stores.
//
// Bit-exactness with the plain PyTorch version: logf (never __logf),
// __fdiv_rn for -log(u)/w, sum/w and v/scale, _rn products and sums; see
// encode.cuh.  The build passes -fmad=false and never --use_fast_math.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "encode.cuh"

namespace {

using wire::kBlock;
constexpr int kWarpsPerCta = 8;
constexpr int kPasses = kBlock / (32 * 4);
constexpr int kBitmapBytes = kBlock / 8;
constexpr int kSumRun = 32;      // XLA's CPU reduction run length

__device__ __forceinline__ float eps_noise() {   // float32(1e-37)
  return __uint_as_float(0x02081CEAu);
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerCta)
topk_encode_kernel(const T* __restrict__ y, const float* __restrict__ noise,
                   long long noise_stride, uint8_t* __restrict__ out,
                   long long n_rows, int k, int fixed, float step) {
  __shared__ float sy[kWarpsPerCta][kBlock];   // y, then v_s at s*g
  __shared__ float su[kWarpsPerCta][kBlock];   // race noise
  __shared__ uint32_t sbits[kWarpsPerCta][kBlock / 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerCta
                        + warp;
  if (row >= n_rows) return;     // whole warps leave; only __syncwarp below
  const float* ur = noise + row * noise_stride;
  float* ys = sy[warp];
  float* us = su[warp];
  uint32_t* bits = sbits[warp];

#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int idx = p * 128 + lane * 4;
    float v[4];
    wire::load4(y + row * kBlock, idx, v);
    *reinterpret_cast<float4*>(ys + idx) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(us + idx) =
        *reinterpret_cast<const float4*>(ur + idx);
  }
  if (lane < kBlock / 32) bits[lane] = 0u;
  __syncwarp();

  const int g = kBlock / k;
  const float eps_w = wire::eps_scale();       // the same float32(1e-30)
  float absmax = 0.0f;
  for (int s = lane; s < k; s += 32) {
    const int base = s * g;
    float w = __fadd_rn(fabsf(ys[base]), eps_w);
    float kmin = __fdiv_rn(-logf(fmaxf(us[base], eps_noise())), w);
    float part = w;               // sum of the current run of 32
    float wsum = 0.0f;            // sum of the finished runs
    int sel = 0;
    for (int j = 1; j < g; ++j) {
      w = __fadd_rn(fabsf(ys[base + j]), eps_w);
      const float key = __fdiv_rn(-logf(fmaxf(us[base + j], eps_noise())), w);
      if (key < kmin) {
        kmin = key;
        sel = j;
      }
      if ((j & (kSumRun - 1)) == 0) {
        wsum = j == kSumRun ? part : __fadd_rn(wsum, part);
        part = w;
      } else {
        part = __fadd_rn(part, w);
      }
    }
    wsum = g <= kSumRun ? part : __fadd_rn(wsum, part);
    const float y_sel = ys[base + sel];
    const float w_sel = __fadd_rn(fabsf(y_sel), eps_w);
    const float v = __fmul_rn(y_sel, __fdiv_rn(wsum, w_sel));
    ys[base] = v;                 // this lane owns the stratum's slots
    absmax = fmaxf(absmax, fabsf(v));
    atomicOr(&bits[(base + sel) >> 5], 1u << ((base + sel) & 31));
  }
  // float32(1/127) == 0x3C010204
  const float scale = fixed ? wire::bf16_round(step)
                            : wire::adaptive_scale(wire::warp_max(absmax),
                                                   __uint_as_float(0x3C010204u));
  __syncwarp();

  uint8_t* orow = out + row * (kBitmapBytes + k + 2);
  for (int s = lane; s < k; s += 32) {
    const int q = wire::sr_code(ys[s * g], scale, ur[kBlock + s], 127.0f);
    orow[kBitmapBytes + s] = static_cast<uint8_t>(static_cast<int8_t>(q));
  }
  for (int i = lane; i < kBitmapBytes; i += 32)
    orow[i] = static_cast<uint8_t>(bits[i >> 2] >> (8 * (i & 3)));
  if (lane == 0) {
    const uint32_t b = wire::bf16_bits(scale);
    orow[kBitmapBytes + k] = static_cast<uint8_t>(b);
    orow[kBitmapBytes + k + 1] = static_cast<uint8_t>(b >> 8);
  }
}

}  // namespace

// y: (n_rows, 512) f32 (y_is_bf16 == 0) or bf16, contiguous; noise: rows of
// noise_stride >= 512 + k floats (16-byte aligned), columns [0, 512) for
// the race and [512, 512 + k) for the value rounding; out: (n_rows,
// 66 + k) u8, contiguous.  Base pointers are already at the chunk's first
// row.  fixed != 0 uses bf16(step) as every row's scale.  Returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue when k does
// not divide 512).
extern "C" int topk_encode_launch(const void* y, int y_is_bf16,
                                  const float* noise, long long noise_stride,
                                  uint8_t* out, long long n_rows, int k,
                                  int fixed, float step, void* stream) {
  if (k < 1 || kBlock % k != 0 || noise_stride < kBlock + k)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return 0;
  const dim3 grid(static_cast<unsigned>(
      (n_rows + kWarpsPerCta - 1) / kWarpsPerCta));
  const dim3 block(32 * kWarpsPerCta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (y_is_bf16) {
    topk_encode_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(y), noise, noise_stride, out,
        n_rows, k, fixed, step);
  } else {
    topk_encode_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(y), noise, noise_stride, out, n_rows, k,
        fixed, step);
  }
  return static_cast<int>(cudaGetLastError());
}
