// One-token GQA flash-decode partials over a KV cache (Hopper, sm_90a).
//
// Replaces the TPU kernel repro/kernels/gqa_decode.py::gqa_decode_pallas
// (body _kernel).  For every batch row b, KV head h and query j < g of
// that head's group, over the cache positions s with valid[s]:
//
//   score_s = q . k_s / sqrt(hd)      (then cap * tanh(score / cap) if cap)
//   m       = max_s score_s           (-1e30 where no position is valid)
//   p_s     = exp(score_s - m), 0 where !valid[s]
//   l       = sum_s p_s,   acc = sum_s p_s v_s
//
// q is (b, kvh, g, hd) float32; k and v are read in place in the cache's
// (b, S, kvh, hd) layout, float32 or bf16; valid is (S,) bytes.  Any S.
//
// Bound: device-memory bytes.  Each valid position's K and V rows are read
// once (2 x hd x 4 B in float32) for 4 x g x hd float operations: ~0.4
// operations per byte at g = 3, far below the card's balance.
// Design:
// * The TPU kernel walks S sequentially on one core; here S is cut into
//   n_splits contiguous ranges, one CTA per (b, h, range), so that
//   b * kvh * n_splits CTAs fill the 132 SMs even when b * kvh is 3-96.
//   Each CTA writes its range's partials (m, l, acc); a second small
//   launch merges the ranges with the log-sum-exp rule.
// * A CTA's 4 warps take 32 positions at a time, one position per lane:
//   the lane reads its K row with 16-byte loads and forms the g scores
//   against q held in shared memory (broadcast reads), so the g queries of
//   the head share one pass over K.  The warp max then rescales the
//   running (m, l, acc), and the warp walks the chunk's valid positions,
//   each lane accumulating hd/32 dimensions of p * v from one coalesced
//   V row read per position.  Chunks with no valid position are skipped
//   before any K/V byte is read; the positions past the causal frontier
//   cost one byte of `valid` each.
// * The warps' states merge in shared memory at the end of the CTA.
//
// Arithmetic: expf and tanhf (never the fast __expf/__tanhf), correctly
// rounded division; dot products and the weighted sums use explicit fused
// multiply-adds.  Masked scores are -1e30 and p is zeroed where invalid,
// so a fully masked range or row gives m = -1e30, l = 0, acc = 0 exactly,
// as the reference does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kGMax = 8;           // queries per KV head (g) supported
constexpr float kNeg = -1e30f;

__device__ __forceinline__ void load8(const float* p, float o[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

// bf16 -> f32 is exact: the bf16 bits are the high half of the f32
__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float o[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  o[0] = lo_bf16(t.x); o[1] = hi_bf16(t.x);
  o[2] = lo_bf16(t.y); o[3] = hi_bf16(t.y);
  o[4] = lo_bf16(t.z); o[5] = hi_bf16(t.z);
  o[6] = lo_bf16(t.w); o[7] = hi_bf16(t.w);
}

// N = hd / 32 consecutive elements (2 or 4)
template <int N>
__device__ __forceinline__ void load_n(const float* p, float o[N]) {
  if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    o[0] = a.x; o[1] = a.y;
  } else {
    const float4 a = *reinterpret_cast<const float4*>(p);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  }
}

template <int N>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p, float o[N]) {
  if constexpr (N == 2) {
    const uint32_t a = *reinterpret_cast<const uint32_t*>(p);
    o[0] = lo_bf16(a); o[1] = hi_bf16(a);
  } else {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    o[0] = lo_bf16(a.x); o[1] = hi_bf16(a.x);
    o[2] = lo_bf16(a.y); o[3] = hi_bf16(a.y);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
gqa_decode_split_kernel(const float* __restrict__ q,
                        const T* __restrict__ k, const T* __restrict__ v,
                        const uint8_t* __restrict__ valid,
                        float* __restrict__ m_part,
                        float* __restrict__ l_part,
                        float* __restrict__ acc_part, int S, int kvh, int g,
                        int split_len, float scale, float softcap) {
  constexpr int kPer = HD / 32;                 // dims per lane
  __shared__ __align__(16) float q_s[kGMax * HD];
  __shared__ float p_s[kWarps][kGMax][32];
  __shared__ float m_w[kWarps][kGMax];
  __shared__ float l_w[kWarps][kGMax];
  __shared__ float acc_w[kWarps][kGMax * HD];

  const int n_splits = gridDim.y;
  const int split = blockIdx.y;
  const long long row = blockIdx.x;             // b * kvh + h
  const long long b = row / kvh;
  const int h = static_cast<int>(row % kvh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < g * HD; i += kThreads)
    q_s[i] = q[row * g * HD + i];
  __syncthreads();

  const long long stride = static_cast<long long>(kvh) * HD;   // per position
  const T* kb = k + (b * S * kvh + h) * HD;
  const T* vb = v + (b * S * kvh + h) * HD;

  float m[kGMax], l[kGMax], acc[kGMax][kPer];
#pragma unroll
  for (int gi = 0; gi < kGMax; ++gi) {
    m[gi] = kNeg;
    l[gi] = 0.0f;
#pragma unroll
    for (int d = 0; d < kPer; ++d) acc[gi][d] = 0.0f;
  }

  const int s0 = split * split_len;
  const int s1 = min(S, s0 + split_len);
  for (int base = s0 + warp * 32; base < s1; base += kWarps * 32) {
    const int pos = base + lane;
    const bool ok = pos < s1 && valid[pos] != 0;
    const unsigned live = __ballot_sync(0xffffffffu, ok);
    if (live == 0) continue;                    // nothing valid: no K/V read

    float sc[kGMax];
#pragma unroll
    for (int gi = 0; gi < kGMax; ++gi) sc[gi] = 0.0f;
    if (ok) {
      const T* kr = kb + pos * stride;
#pragma unroll
      for (int e = 0; e < HD; e += 8) {
        float kk[8];
        load8(kr + e, kk);
#pragma unroll
        for (int gi = 0; gi < kGMax; ++gi) {
          if (gi < g) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              sc[gi] = __fmaf_rn(q_s[gi * HD + e + j], kk[j], sc[gi]);
          }
        }
      }
    }
#pragma unroll
    for (int gi = 0; gi < kGMax; ++gi) {
      if (gi < g) {
        float s = __fmul_rn(sc[gi], scale);
        if (softcap > 0.0f)
          s = __fmul_rn(softcap, tanhf(__fdiv_rn(s, softcap)));
        s = ok ? s : kNeg;
        const float m_new = fmaxf(m[gi], warp_max(s));
        const float corr = expf(m[gi] - m_new);
        const float p = ok ? expf(s - m_new) : 0.0f;
        l[gi] = __fmaf_rn(l[gi], corr, p);
#pragma unroll
        for (int d = 0; d < kPer; ++d)
          acc[gi][d] = __fmul_rn(acc[gi][d], corr);
        m[gi] = m_new;
        p_s[warp][gi][lane] = p;
      }
    }
    __syncwarp();
    unsigned rest = live;
    while (rest) {
      const int j = __ffs(rest) - 1;
      rest &= rest - 1;
      float vv[kPer];
      load_n<kPer>(vb + (base + j) * stride + lane * kPer, vv);
#pragma unroll
      for (int gi = 0; gi < kGMax; ++gi) {
        if (gi < g) {
          const float p = p_s[warp][gi][j];
#pragma unroll
          for (int d = 0; d < kPer; ++d)
            acc[gi][d] = __fmaf_rn(p, vv[d], acc[gi][d]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int gi = 0; gi < kGMax; ++gi) {
    if (gi < g) {
      const float lw = warp_sum(l[gi]);
      if (lane == 0) {
        m_w[warp][gi] = m[gi];
        l_w[warp][gi] = lw;
      }
#pragma unroll
      for (int d = 0; d < kPer; ++d)
        acc_w[warp][gi * HD + lane * kPer + d] = acc[gi][d];
    }
  }
  __syncthreads();

  // merge the warps' states: one thread per (query, dimension)
  const long long out = (row * n_splits + split) * g;
  for (int i = threadIdx.x; i < g * HD; i += kThreads) {
    const int gi = i / HD;
    float mx = m_w[0][gi];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, m_w[w][gi]);
    float a = 0.0f, lsum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_w[w][gi] - mx);
      a = __fmaf_rn(acc_w[w][i], c, a);
      lsum = __fmaf_rn(l_w[w][gi], c, lsum);
    }
    acc_part[out * HD + i] = a;
    if (i % HD == 0) {
      m_part[out + gi] = mx;
      l_part[out + gi] = lsum;
    }
  }
}

// Log-sum-exp merge of the ranges' partials, one thread per output
// element of acc: m = max_r m_r, l = sum_r l_r e^(m_r - m),
// acc = sum_r acc_r e^(m_r - m).
__global__ void __launch_bounds__(256)
gqa_decode_merge_kernel(const float* __restrict__ m_part,
                        const float* __restrict__ l_part,
                        const float* __restrict__ acc_part,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        float* __restrict__ acc_out, long long n_queries,
                        int g, int hd, int n_splits) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n_queries * hd) return;
  const long long qi = i / hd;                  // (b * kvh + h) * g + gi
  const int d = static_cast<int>(i % hd);
  const long long row = qi / g;
  const int gi = static_cast<int>(qi % g);
  float mx = kNeg;
  for (int r = 0; r < n_splits; ++r)
    mx = fmaxf(mx, m_part[(row * n_splits + r) * g + gi]);
  float a = 0.0f, lsum = 0.0f;
  for (int r = 0; r < n_splits; ++r) {
    const long long pr = (row * n_splits + r) * g + gi;
    const float c = expf(m_part[pr] - mx);
    a = __fmaf_rn(acc_part[pr * hd + d], c, a);
    lsum = __fmaf_rn(l_part[pr], c, lsum);
  }
  acc_out[i] = a;
  if (d == 0) {
    m_out[qi] = mx;
    l_out[qi] = lsum;
  }
}

template <typename T, int HD>
void launch_split(const float* q, const void* k, const void* v,
                  const uint8_t* valid, float* m_part, float* l_part,
                  float* acc_part, int b, int S, int kvh, int g,
                  int split_len, int n_splits, float scale, float softcap,
                  cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(b * kvh),
                  static_cast<unsigned>(n_splits));
  gqa_decode_split_kernel<T, HD><<<grid, kThreads, 0, s>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), valid, m_part,
      l_part, acc_part, S, kvh, g, split_len, scale, softcap);
}

}  // namespace

// q: (b, kvh, g, hd) f32; k, v: (b, S, kvh, hd) f32 (kv_is_bf16 == 0) or
// bf16; valid: (S,) bytes; partials: m/l (b*kvh, n_splits, g) and acc
// (b*kvh, n_splits, g, hd) f32 scratch; outputs m/l (b, kvh, g) and acc
// (b, kvh, g, hd) f32 — all contiguous.  hd is 64 or 128, g <= 8,
// split_len * n_splits >= S.  softcap <= 0 means none.  Returns
// cudaGetLastError() after the two launches (or 1 for an unsupported hd
// or g).
extern "C" int gqa_decode_launch(
    const float* q, const void* k, const void* v, int kv_is_bf16,
    const uint8_t* valid, float* m_part, float* l_part, float* acc_part,
    float* m_out, float* l_out, float* acc_out, int b, int S, int kvh, int g,
    int hd, int split_len, int n_splits, float scale, float softcap,
    void* stream) {
  if (g < 1 || g > kGMax || (hd != 64 && hd != 128)) return 1;
  if (b <= 0 || kvh <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_is_bf16) {
    if (hd == 64)
      launch_split<__nv_bfloat16, 64>(q, k, v, valid, m_part, l_part,
                                      acc_part, b, S, kvh, g, split_len,
                                      n_splits, scale, softcap, s);
    else
      launch_split<__nv_bfloat16, 128>(q, k, v, valid, m_part, l_part,
                                       acc_part, b, S, kvh, g, split_len,
                                       n_splits, scale, softcap, s);
  } else {
    if (hd == 64)
      launch_split<float, 64>(q, k, v, valid, m_part, l_part, acc_part, b, S,
                              kvh, g, split_len, n_splits, scale, softcap, s);
    else
      launch_split<float, 128>(q, k, v, valid, m_part, l_part, acc_part, b,
                               S, kvh, g, split_len, n_splits, scale,
                               softcap, s);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_queries = static_cast<long long>(b) * kvh * g;
  const long long n = n_queries * hd;
  gqa_decode_merge_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                            s>>>(m_part, l_part, acc_part, m_out, l_out,
                                 acc_out, n_queries, g, hd, n_splits);
  return static_cast<int>(cudaGetLastError());
}
