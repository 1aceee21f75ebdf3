// Fused int8 wire decode + shadow update + ring combine for Hopper (sm_90a).
//
// Replaces the TPU kernel
// repro/kernels/dequant_combine.py::dequant_combine_payload_pallas (body
// _payload_kernel with _decode_payload_tile / _bytes_to_scale).  Per element
// of a 512-wide row, with d_* = code * scale decoded from the self / left /
// right wire payloads (512 int8 codes || 4 little-endian fp32 scale bytes):
//
//   x_t'  = x_t + deamp * d_s
//   m'    = m + (w_side * deamp) * (d_l + d_r)
//   comb  = w_self * x_t' + m'
//
// Bound: device-memory bytes.  Per row it reads 3 x 516 B of payload and
// 2 x 2 KiB of fp32 shadows and writes 3 x 2 KiB, with ~13 float ops per
// element.  Design: one thread per 4 elements.  A thread reads each
// payload's 4 code bytes as one aligned 32-bit word (row stride 516 B is
// 4-byte aligned) and the row's scale as one aligned word at byte 512, and
// moves the fp32 operands as 16-byte vectors; neighbouring threads touch
// neighbouring addresses, so every access is coalesced.  No shared memory.
//
// Bit-exactness with the plain PyTorch version: every product and sum is a
// _rn intrinsic in the reference's order (no FMA contraction); the combine
// arithmetic is the one every codec shares, in combine.cuh.
//
// Chunk view: payload and shadow base pointers arrive already offset to the
// chunk's first row (chunk-height operands at row 0, full-height ones at
// row_offset), so the kernel itself only sees n_rows contiguous rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "combine.cuh"

namespace {

constexpr int kBlock = 512;
constexpr int kPayload = kBlock + 4;
constexpr int kThreads = 256;

__device__ __forceinline__ float code_at(uint32_t word, int j) {
  return static_cast<float>(static_cast<int8_t>((word >> (8 * j)) & 0xffu));
}

__global__ void __launch_bounds__(kThreads)
dequant_combine_payload_kernel(
    const uint8_t* __restrict__ p_self, const uint8_t* __restrict__ p_left,
    const uint8_t* __restrict__ p_right, const float* __restrict__ x_tilde,
    const float* __restrict__ m_agg, float* __restrict__ xt_out,
    float* __restrict__ m_out, float* __restrict__ comb_out,
    long long n_quads, float w_self, float w_side_deamp, float deamp) {
  const long long q =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= n_quads) return;
  const long long row = q / (kBlock / 4);
  const int col = static_cast<int>(q % (kBlock / 4)) * 4;
  const long long pb = row * kPayload;

  const uint32_t cs = *reinterpret_cast<const uint32_t*>(p_self + pb + col);
  const uint32_t cl = *reinterpret_cast<const uint32_t*>(p_left + pb + col);
  const uint32_t cr = *reinterpret_cast<const uint32_t*>(p_right + pb + col);
  const float ss = __uint_as_float(
      *reinterpret_cast<const uint32_t*>(p_self + pb + kBlock));
  const float sl = __uint_as_float(
      *reinterpret_cast<const uint32_t*>(p_left + pb + kBlock));
  const float sr = __uint_as_float(
      *reinterpret_cast<const uint32_t*>(p_right + pb + kBlock));

  float d_s[4], d_l[4], d_r[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    d_s[j] = __fmul_rn(code_at(cs, j), ss);
    d_l[j] = __fmul_rn(code_at(cl, j), sl);
    d_r[j] = __fmul_rn(code_at(cr, j), sr);
  }
  wire::combine_quad(d_s, d_l, d_r, x_tilde, m_agg, xt_out, m_out, comb_out,
                     row * kBlock + col, w_self, w_side_deamp, deamp);
}

}  // namespace

// Three (n_rows, 516) u8 payloads, two (n_rows, 512) f32 shadows in, three
// (n_rows, 512) f32 outputs — all contiguous from the given base pointers.
// w_side_deamp is the float32 product w_side * deamp.  Returns
// cudaGetLastError() after the launch.
extern "C" int dequant_combine_payload_launch(
    const uint8_t* p_self, const uint8_t* p_left, const uint8_t* p_right,
    const float* x_tilde, const float* m_agg, float* xt_out, float* m_out,
    float* comb_out, long long n_rows, float w_self, float w_side_deamp,
    float deamp, void* stream) {
  if (n_rows <= 0) return 0;
  const long long n_quads = n_rows * (kBlock / 4);
  const dim3 grid(static_cast<unsigned>((n_quads + kThreads - 1) / kThreads));
  dequant_combine_payload_kernel<<<grid, kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      p_self, p_left, p_right, x_tilde, m_agg, xt_out, m_out, comb_out,
      n_quads, w_self, w_side_deamp, deamp);
  return static_cast<int>(cudaGetLastError());
}
