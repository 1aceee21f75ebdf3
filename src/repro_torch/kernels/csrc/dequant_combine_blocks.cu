// int8 decode from separate codes/scales + shadow update + ring combine
// (Hopper, sm_90a).
//
// Replaces the TPU kernel repro/kernels/dequant_combine.py::
// dequant_combine_pallas (body _kernel), the receive side of the per-leaf
// reference transport.  Per element of a 512-wide row, with
// d_* = code * scale of the self / left / right operands:
//
//   x_t'  = x_t + deamp * d_s
//   m'    = m + (w_side * deamp) * (d_l + d_r)
//   comb  = w_self * x_t' + m'
//
// The combine arithmetic is the one every wire codec shares, in
// combine.cuh; only the decode differs from dequant_combine_payload.cu
// (codes and scales arrive as separate tensors instead of one payload).
//
// Bound: device-memory bytes.  Per row it reads 3 x 512 B of codes, 3 x 4 B
// of scales and 2 x 2 KiB of fp32 shadows and writes 3 x 2 KiB, with ~13
// float ops per element.  Design: one thread per 4 elements; each reads its
// 4 codes of each operand as one aligned 32-bit word, the row's three
// scales as words (broadcast within the row's 128 threads), and moves the
// fp32 operands as 16-byte vectors: neighbouring threads touch neighbouring
// addresses, so every access is coalesced.  No shared memory.
//
// Bit-exactness with the plain PyTorch version: every product and sum is a
// _rn intrinsic in the reference's order (no FMA contraction; the build
// also passes -fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

#include "combine.cuh"

namespace {

constexpr int kBlock = 512;
constexpr int kThreads = 256;

__device__ __forceinline__ float code_at(uint32_t word, int j) {
  return static_cast<float>(static_cast<int8_t>((word >> (8 * j)) & 0xffu));
}

__global__ void __launch_bounds__(kThreads)
dequant_combine_blocks_kernel(
    const int8_t* __restrict__ c_self, const float* __restrict__ s_self,
    const int8_t* __restrict__ c_left, const float* __restrict__ s_left,
    const int8_t* __restrict__ c_right, const float* __restrict__ s_right,
    const float* __restrict__ x_tilde, const float* __restrict__ m_agg,
    float* __restrict__ xt_out, float* __restrict__ m_out,
    float* __restrict__ comb_out, long long n_quads, float w_self,
    float w_side_deamp, float deamp) {
  const long long q =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= n_quads) return;
  const long long row = q / (kBlock / 4);
  const long long e = q * 4;            // == row * kBlock + column

  const uint32_t cs = *reinterpret_cast<const uint32_t*>(c_self + e);
  const uint32_t cl = *reinterpret_cast<const uint32_t*>(c_left + e);
  const uint32_t cr = *reinterpret_cast<const uint32_t*>(c_right + e);
  const float ss = s_self[row], sl = s_left[row], sr = s_right[row];

  float d_s[4], d_l[4], d_r[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    d_s[j] = __fmul_rn(code_at(cs, j), ss);
    d_l[j] = __fmul_rn(code_at(cl, j), sl);
    d_r[j] = __fmul_rn(code_at(cr, j), sr);
  }
  wire::combine_quad(d_s, d_l, d_r, x_tilde, m_agg, xt_out, m_out, comb_out,
                     e, w_self, w_side_deamp, deamp);
}

}  // namespace

// Three (n_rows, 512) int8 code tensors with their (n_rows,) f32 scales,
// two (n_rows, 512) f32 shadows in, three (n_rows, 512) f32 outputs — all
// contiguous.  w_side_deamp is the float32 product w_side * deamp.
// Returns cudaGetLastError() after the launch.
extern "C" int dequant_combine_blocks_launch(
    const int8_t* c_self, const float* s_self, const int8_t* c_left,
    const float* s_left, const int8_t* c_right, const float* s_right,
    const float* x_tilde, const float* m_agg, float* xt_out, float* m_out,
    float* comb_out, long long n_rows, float w_self, float w_side_deamp,
    float deamp, void* stream) {
  if (n_rows <= 0) return 0;
  const long long n_quads = n_rows * (kBlock / 4);
  const dim3 grid(static_cast<unsigned>((n_quads + kThreads - 1) / kThreads));
  dequant_combine_blocks_kernel<<<grid, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      c_self, s_self, c_left, s_left, c_right, s_right, x_tilde, m_agg,
      xt_out, m_out, comb_out, n_quads, w_self, w_side_deamp, deamp);
  return static_cast<int>(cudaGetLastError());
}
