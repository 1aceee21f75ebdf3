// Top-k sparse wire decode + shadow update + ring combine for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bitpack.py::topk_combine_pallas
// (decode _topk_decode_core, then combine_core).  Each of the self / left /
// right payloads (64-byte bitmap || k int8 values || 2 bf16 scale bytes)
// decodes element i of stratum s = i / (512/k) as
//
//   d_i = bit_i * (value_s * scale)
//
// (the reference's product: an unpicked element is 0 * value, a signed
// zero), and the three feed the combine of combine.cuh, the same arithmetic
// as the int8 kernel dequant_combine_payload.cu.
//
// Bound: device-memory bytes.  Per row it reads 3 x (66 + k) B of payload
// and 2 x 2 KiB of fp32 shadows and writes 3 x 2 KiB, with ~16 float ops
// per element.  Design: one thread per 4 elements, as in the int8 kernel:
// it reads the bitmap nibble of its 4 elements, the value bytes of their
// strata and the row's scale with byte loads (rows of 66 + k bytes have no
// alignment to rely on; the row's bytes stay in L1 for its 128 threads),
// and moves the fp32 operands as 16-byte vectors.
//
// Chunk view: base pointers arrive already offset to the chunk's first row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "combine.cuh"

namespace {

constexpr int kBlock = 512;
constexpr int kBitmapBytes = kBlock / 8;
constexpr int kThreads = 256;

__device__ __forceinline__ void decode4(const uint8_t* __restrict__ p,
                                        long long pb, int col, int k, int g,
                                        float d[4]) {
  const uint32_t nibble = (p[pb + col / 8] >> (col & 7)) & 0xfu;
  const uint32_t sb = p[pb + kBitmapBytes + k]
                      | (static_cast<uint32_t>(p[pb + kBitmapBytes + k + 1])
                         << 8);
  const float scale = __uint_as_float(sb << 16);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int s = (col + j) / g;
    const float code = static_cast<float>(
        static_cast<int8_t>(p[pb + kBitmapBytes + s]));
    const float bit = ((nibble >> j) & 1u) ? 1.0f : 0.0f;
    d[j] = __fmul_rn(bit, __fmul_rn(code, scale));
  }
}

__global__ void __launch_bounds__(kThreads)
topk_combine_kernel(
    const uint8_t* __restrict__ p_self, const uint8_t* __restrict__ p_left,
    const uint8_t* __restrict__ p_right, const float* __restrict__ x_tilde,
    const float* __restrict__ m_agg, float* __restrict__ xt_out,
    float* __restrict__ m_out, float* __restrict__ comb_out,
    long long n_quads, int k, float w_self, float w_side_deamp,
    float deamp) {
  const long long q =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= n_quads) return;
  const long long row = q / (kBlock / 4);
  const int col = static_cast<int>(q % (kBlock / 4)) * 4;
  const long long pb = row * (kBitmapBytes + k + 2);
  const int g = kBlock / k;
  float d_s[4], d_l[4], d_r[4];
  decode4(p_self, pb, col, k, g, d_s);
  decode4(p_left, pb, col, k, g, d_l);
  decode4(p_right, pb, col, k, g, d_r);
  wire::combine_quad(d_s, d_l, d_r, x_tilde, m_agg, xt_out, m_out, comb_out,
                     row * kBlock + col, w_self, w_side_deamp, deamp);
}

}  // namespace

// Three (n_rows, 66 + k) u8 payloads, two (n_rows, 512) f32 shadows in,
// three (n_rows, 512) f32 outputs — all contiguous from the given base
// pointers.  w_side_deamp is the float32 product w_side * deamp.  Returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue when k
// does not divide 512).
extern "C" int topk_combine_launch(
    const uint8_t* p_self, const uint8_t* p_left, const uint8_t* p_right,
    const float* x_tilde, const float* m_agg, float* xt_out, float* m_out,
    float* comb_out, long long n_rows, int k, float w_self,
    float w_side_deamp, float deamp, void* stream) {
  if (k < 1 || kBlock % k != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return 0;
  const long long n_quads = n_rows * (kBlock / 4);
  const dim3 grid(static_cast<unsigned>((n_quads + kThreads - 1) / kThreads));
  topk_combine_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      p_self, p_left, p_right, x_tilde, m_agg, xt_out, m_out, comb_out,
      n_quads, k, w_self, w_side_deamp, deamp);
  return static_cast<int>(cudaGetLastError());
}
