// Bit-packed int4 / int2 wire decode + shadow update + ring combine for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bitpack.py::subbyte_combine_pallas
// (decode _subbyte_decode_core, then combine_core).  Per element of a
// 512-wide row, each of the self / left / right payloads decodes as
//
//   d = (field - code_max - 1) * scale,   scale = the row's bf16 bytes
//
// and the three feed the combine of combine.cuh, the same arithmetic as the
// int8 kernel dequant_combine_payload.cu.
//
// Bound: device-memory bytes.  Per row it reads 3 x 258 B (int4) or 3 x
// 130 B (int2) of payload and 2 x 2 KiB of fp32 shadows and writes 3 x
// 2 KiB, with ~13 float ops per element.  Design: one thread per 4
// elements, as in the int8 kernel.  The payload rows are only 2-byte
// aligned, so a thread reads its 4 codes as one 16-bit word (int4) or one
// byte (int2) and the row's scale as one 16-bit word; the fp32 operands
// move as 16-byte vectors, neighbouring threads on neighbouring addresses.
//
// Chunk view: base pointers arrive already offset to the chunk's first row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "combine.cuh"

namespace {

constexpr int kBlock = 512;
constexpr int kThreads = 256;

template <int kBits>
__device__ __forceinline__ void decode4(const uint8_t* __restrict__ p,
                                        long long pb, int col, float d[4]) {
  constexpr int kCodeMax = (1 << (kBits - 1)) - 1;
  constexpr int kCodeBytes = kBlock * kBits / 8;
  const uint32_t word =
      kBits == 4 ? *reinterpret_cast<const uint16_t*>(p + pb + col / 2)
                 : p[pb + col / 4];
  const float scale = __uint_as_float(
      static_cast<uint32_t>(
          *reinterpret_cast<const uint16_t*>(p + pb + kCodeBytes)) << 16);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int field = (word >> (kBits * j)) & ((1u << kBits) - 1);
    d[j] = __fmul_rn(static_cast<float>(field - kCodeMax - 1), scale);
  }
}

template <int kBits>
__global__ void __launch_bounds__(kThreads)
subbyte_combine_kernel(
    const uint8_t* __restrict__ p_self, const uint8_t* __restrict__ p_left,
    const uint8_t* __restrict__ p_right, const float* __restrict__ x_tilde,
    const float* __restrict__ m_agg, float* __restrict__ xt_out,
    float* __restrict__ m_out, float* __restrict__ comb_out,
    long long n_quads, float w_self, float w_side_deamp, float deamp) {
  constexpr int kWidth = kBlock * kBits / 8 + 2;
  const long long q =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= n_quads) return;
  const long long row = q / (kBlock / 4);
  const int col = static_cast<int>(q % (kBlock / 4)) * 4;
  const long long pb = row * kWidth;
  float d_s[4], d_l[4], d_r[4];
  decode4<kBits>(p_self, pb, col, d_s);
  decode4<kBits>(p_left, pb, col, d_l);
  decode4<kBits>(p_right, pb, col, d_r);
  wire::combine_quad(d_s, d_l, d_r, x_tilde, m_agg, xt_out, m_out, comb_out,
                     row * kBlock + col, w_self, w_side_deamp, deamp);
}

}  // namespace

// Three (n_rows, 512*code_bits/8 + 2) u8 payloads, two (n_rows, 512) f32
// shadows in, three (n_rows, 512) f32 outputs — all contiguous from the
// given base pointers.  w_side_deamp is the float32 product w_side * deamp.
// Returns cudaGetLastError() after the launch (or cudaErrorInvalidValue
// for a code width other than 4 or 2).
extern "C" int subbyte_combine_launch(
    const uint8_t* p_self, const uint8_t* p_left, const uint8_t* p_right,
    const float* x_tilde, const float* m_agg, float* xt_out, float* m_out,
    float* comb_out, long long n_rows, int code_bits, float w_self,
    float w_side_deamp, float deamp, void* stream) {
  if (code_bits != 4 && code_bits != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return 0;
  const long long n_quads = n_rows * (kBlock / 4);
  const dim3 grid(static_cast<unsigned>((n_quads + kThreads - 1) / kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bits == 4)
    subbyte_combine_kernel<4><<<grid, kThreads, 0, s>>>(
        p_self, p_left, p_right, x_tilde, m_agg, xt_out, m_out, comb_out,
        n_quads, w_self, w_side_deamp, deamp);
  else
    subbyte_combine_kernel<2><<<grid, kThreads, 0, s>>>(
        p_self, p_left, p_right, x_tilde, m_agg, xt_out, m_out, comb_out,
        n_quads, w_self, w_side_deamp, deamp);
  return static_cast<int>(cudaGetLastError());
}
