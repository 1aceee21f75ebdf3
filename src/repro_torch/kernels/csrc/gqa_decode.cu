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
// (b, S, kvh, hd) layout, float32 or bf16; valid is (S,) bytes, any mask.
//
// Bound: device-memory bytes.  Each valid position's K and V rows are read
// once (2 x hd x 4 B in float32) for 4 x g x hd float operations: ~0.4
// operations per byte at g = 3, far below the card's balance, so the
// design keeps enough bytes in flight and spends few instructions on them.
// * One launch.  A CTA takes one (b, kv head) row and one range of its
//   positions; the grid is sized to the card (decode_splits in
//   kernels/gqa_decode.py: about two waves of the CTAs an SM holds, 3
//   (2 for float32 at hd 256), in ranges of at least 20 tiles, so 3
//   ranges per row at the serve shape and 2 at decode_32k's).  The ranges
//   of a row form one thread block cluster, and rank 0 merges their
//   (m, l, acc) by log-sum-exp over distributed shared memory: no partials
//   in device memory, no second launch.  A range holds at most 32,768
//   positions (its mask bits live in shared memory), so a row of up to
//   262,144 positions is a portable cluster of 8, and one of up to 524,288
//   a non-portable cluster of 16 (Hopper allows 16 when the kernel asks).
// * A pipelined shared-memory stream.  Tiles of kTile positions of one
//   head (8 KB of K plus 8 KB of V) flow through a ring of kStages stages
//   by 16-byte cp.async copies with commit/wait groups: three tiles are in
//   flight while the fourth is consumed, ~48 KB per CTA and ~140 KB per
//   SM (Little's law at 3.35 TB/s and ~1 us of latency wants ~25 KB per
//   SM).  cp.async, not TMA: the cache
//   base changes with every layer, and a tensor map would be encoded on
//   the host at every call; the rows of one head are 256 B runs at a
//   kvh x hd stride, which 16-byte copies take coalesced.  Rows past S are
//   zero-filled by the copy.
// * Masked tiles cost nothing.  The CTA first packs its range's `valid`
//   bytes into bits in shared memory and lists the tiles with a valid
//   position; only those are copied, so the positions past the causal
//   frontier cost one byte of `valid` each.
// * Compute from shared memory only.  Scores: kLanes lanes share one
//   position (8 up to hd 128, the whole warp at hd 256), each lane takes
//   16-byte chunks j, j + kLanes, ... of the K row (so the lanes read
//   contiguous bytes: no bank conflict, no padding) against q held in
//   registers, then log2(kLanes) shuffles sum the dot product; 32 / kLanes
//   positions per warp instruction.  At hd 256 a quarter-warp group would
//   hold 32 x g floats of q per lane (256 registers at g = 8).  p . V:
//   each lane owns hd / 32 dimensions of the V row, in vectors of 16
//   bytes at most, each vector contiguous across the warp, and reads p
//   from shared memory by broadcast.  The position loop has no
//   global load.  CUDA cores in float32 (~0.4 operations per byte: tensor
//   cores would not pay, and TF32 would break the 1e-5 contract).
// * Templated on g, so registers hold exactly the g queries of a head.
//
// Arithmetic: expf and tanhf (never the fast __expf/__tanhf), correctly
// rounded division; dot products and the weighted sums use explicit fused
// multiply-adds.  Masked scores are -1e30 and p is zeroed where invalid,
// so a fully masked range or row gives m = -1e30, l = 0, acc = 0 exactly,
// as the reference does.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 4;
constexpr int kTileBytes = 8192;    // one K (or V) tile in shared memory
constexpr int kMaxRange = 32768;    // positions one CTA takes at most
constexpr int kMaxRanges = 16;      // CTAs of one row (a cluster)
constexpr int kGMax = 8;            // queries per KV head (g) supported
constexpr float kNeg = -1e30f;

template <typename T, int HD>
struct Geo {
  static constexpr int kElt = static_cast<int>(sizeof(T));
  static constexpr int kTile = kTileBytes / (HD * kElt);  // positions
  static constexpr int kE = 16 / kElt;          // elements per 16 B chunk
  static constexpr int kChunks = HD / kE;       // 16 B chunks per row
  static constexpr int kLanes = HD <= 128 ? 8 : 32;  // lanes per score
  static constexpr int kGroups = 32 / kLanes;   // positions per pass
  static constexpr int kCpl = kChunks / kLanes; // chunks per score lane
  static constexpr int kPerWarp = kTile / kWarps;
  static constexpr int kPasses = kPerWarp / kGroups;
  static constexpr int kDims = HD / 32;         // p . V dims per lane
  static constexpr int kVec = kDims < kE ? kDims : kE;  // dims per load
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kSmem = kStages * kStageBytes;
  static_assert(kPerWarp % kGroups == 0 && kPasses >= 1, "tile geometry");
  static_assert(kCpl >= 1 && kChunks % kLanes == 0, "score lanes");
  static_assert(kTile * kChunks * 16 == kTileBytes &&
                (kTile * kChunks) % kThreads == 0, "tile bytes");
  // the dimension of the row that lane `lane` holds in its slot d
  static __device__ __forceinline__ int dim(int lane, int d) {
    return (d / kVec) * 32 * kVec + lane * kVec + d % kVec;
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// bf16 -> f32 is exact: the bf16 bits are the high half of the f32
__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// one 16-byte chunk of a row in shared memory as floats
__device__ __forceinline__ void chunk(const float*, const uint4& u,
                                      float o[4]) {
  o[0] = __uint_as_float(u.x); o[1] = __uint_as_float(u.y);
  o[2] = __uint_as_float(u.z); o[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void chunk(const __nv_bfloat16*, const uint4& u,
                                      float o[8]) {
  o[0] = lo_bf16(u.x); o[1] = hi_bf16(u.x);
  o[2] = lo_bf16(u.y); o[3] = hi_bf16(u.y);
  o[4] = lo_bf16(u.z); o[5] = hi_bf16(u.z);
  o[6] = lo_bf16(u.w); o[7] = hi_bf16(u.w);
}

// N consecutive elements (2, 4, or 8 of bf16) of a row in shared memory
template <int N>
__device__ __forceinline__ void dims(const float* p, float o[N]) {
  if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    o[0] = a.x; o[1] = a.y;
  } else {
    const float4 a = *reinterpret_cast<const float4*>(p);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  }
}
template <int N>
__device__ __forceinline__ void dims(const __nv_bfloat16* p, float o[N]) {
  if constexpr (N == 2) {
    const uint32_t a = *reinterpret_cast<const uint32_t*>(p);
    o[0] = lo_bf16(a); o[1] = hi_bf16(a);
  } else if constexpr (N == 4) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    o[0] = lo_bf16(a.x); o[1] = hi_bf16(a.x);
    o[2] = lo_bf16(a.y); o[3] = hi_bf16(a.y);
  } else {
    chunk(p, *reinterpret_cast<const uint4*>(p), o);
  }
}

// bit i set where byte i of w is nonzero
__device__ __forceinline__ uint32_t byte_bits(uint32_t w) {
  return static_cast<uint32_t>((w & 0xffu) != 0) |
         static_cast<uint32_t>((w & 0xff00u) != 0) << 1 |
         static_cast<uint32_t>((w & 0xff0000u) != 0) << 2 |
         static_cast<uint32_t>((w & 0xff000000u) != 0) << 3;
}

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
gqa_decode_kernel(const float* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const uint8_t* __restrict__ valid,
                  float* __restrict__ m_out, float* __restrict__ l_out,
                  float* __restrict__ acc_out, int S, int kvh, int range_len,
                  int n_ranges, float scale, float softcap) {
  using Ge = Geo<T, HD>;
  constexpr int kTile = Ge::kTile, kE = Ge::kE, kChunks = Ge::kChunks;
  constexpr int kCpl = Ge::kCpl, kPerWarp = Ge::kPerWarp;
  constexpr int kPasses = Ge::kPasses, kDims = Ge::kDims;
  constexpr int kLanes = Ge::kLanes, kGroups = Ge::kGroups;
  constexpr int kVec = Ge::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint16_t mask16[kMaxRange / 16];
  __shared__ int16_t live[kMaxRange / kTile];
  __shared__ float p_s[kWarps][G][kPerWarp];
  __shared__ int n_live_s;

  const long long row = blockIdx.x / n_ranges;  // b * kvh + h
  const int range = static_cast<int>(blockIdx.x % n_ranges);
  const long long b = row / kvh;
  const int h = static_cast<int>(row % kvh);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane / kLanes, j = lane % kLanes;  // score group, lane

  // 1. the range's mask as bits, and the list of tiles with a valid bit
  const int s0 = range * range_len;
  const int len = max(0, min(S, s0 + range_len) - s0);
  const int n_tiles = (len + kTile - 1) / kTile;
  const int n16 = (len + 15) / 16;
  for (int c = tid; c < (n_tiles * kTile + 15) / 16; c += kThreads) {
    uint32_t bits = 0;
    const int p = s0 + 16 * c;
    if (c < n16) {
      if (p + 16 <= S) {
        const uint4 w = *reinterpret_cast<const uint4*>(valid + p);
        bits = byte_bits(w.x) | byte_bits(w.y) << 4 |
               byte_bits(w.z) << 8 | byte_bits(w.w) << 12;
      } else {
        for (int i = 0; p + i < S; ++i)
          bits |= static_cast<uint32_t>(valid[p + i] != 0) << i;
      }
    }
    mask16[c] = static_cast<uint16_t>(bits);
  }
  __syncthreads();
  if (warp == 0) {
    int count = 0;
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
      const int t = t0 + lane;
      bool any = false;
      if (t < n_tiles) {
        if constexpr (kTile >= 16) {
#pragma unroll
          for (int x = 0; x < kTile / 16; ++x)
            any |= mask16[t * (kTile / 16) + x] != 0;
        } else {                  // a tile is part of one halfword
          const int bit = t * kTile;
          any = (mask16[bit >> 4] >> (bit & 15)) & ((1u << kTile) - 1u);
        }
      }
      const unsigned bal = __ballot_sync(0xffffffffu, any);
      if (any) live[count + __popc(bal & ((1u << lane) - 1u))] =
          static_cast<int16_t>(t);
      count += __popc(bal);
    }
    if (lane == 0) n_live_s = count;
  }

  // q in registers: lane j of a score group holds chunks j, j + 8, ...
  float qr[G][kCpl * kE];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int cc = 0; cc < kCpl; ++cc) {
      const float* src = q + (row * G + gi) * HD + (j + kLanes * cc) * kE;
#pragma unroll
      for (int e = 0; e < kE; e += 4) {
        const float4 a = *reinterpret_cast<const float4*>(src + e);
        qr[gi][cc * kE + e] = a.x; qr[gi][cc * kE + e + 1] = a.y;
        qr[gi][cc * kE + e + 2] = a.z; qr[gi][cc * kE + e + 3] = a.w;
      }
    }
  }
  __syncthreads();
  const int n_live = n_live_s;

  // 2. stream the live tiles through the ring of stages
  const long long stride = static_cast<long long>(kvh) * HD;  // elements
  const T* kb = k + (b * S * kvh + h) * HD;
  const T* vb = v + (b * S * kvh + h) * HD;
  auto issue = [&](int t, int stage) {
    unsigned char* ks = smem + stage * Ge::kStageBytes;
    unsigned char* vs = ks + kTileBytes;
    const int p0 = s0 + t * kTile;
#pragma unroll
    for (int x = 0; x < kTile * kChunks / kThreads; ++x) {
      const int i = tid + x * kThreads;
      const int r = i / kChunks, c = i % kChunks;
      const bool in = p0 + r < S;
      const long long off = in ? (p0 + r) * stride + c * kE : 0;
      cp_async16(ks + i * 16, kb + off, in ? 16 : 0);
      cp_async16(vs + i * 16, vb + off, in ? 16 : 0);
    }
  };

  float m[G], l[G], acc[G][kDims];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kNeg;
    l[gi] = 0.0f;
#pragma unroll
    for (int d = 0; d < kDims; ++d) acc[gi][d] = 0.0f;
  }

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_live) issue(live[i], i);
    cp_async_commit();
  }
  const int r0 = warp * kPerWarp;               // the warp's rows of a tile
  for (int i = 0; i < n_live; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();          // tile i landed; every warp is done with i - 1
    const int nx = i + kStages - 1;
    if (nx < n_live) issue(live[nx], nx % kStages);
    cp_async_commit();

    const int tp = live[i] * kTile;             // tile's first position - s0
    bool ok[kPasses];
    bool any = false;
#pragma unroll
    for (int ps = 0; ps < kPasses; ++ps) {
      const int rel = tp + r0 + kGroups * ps + grp;
      ok[ps] = (mask16[rel >> 4] >> (rel & 15)) & 1u;
      any |= ok[ps];
    }
    if (!__any_sync(0xffffffffu, any)) continue;  // the warp's rows: masked

    const unsigned char* ks = smem + (i % kStages) * Ge::kStageBytes;
    const T* vs = reinterpret_cast<const T*>(ks + kTileBytes);
    float sc[kPasses][G];
#pragma unroll
    for (int ps = 0; ps < kPasses; ++ps) {
      const int r = r0 + kGroups * ps + grp;
      float dot[G];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) dot[gi] = 0.0f;
#pragma unroll
      for (int cc = 0; cc < kCpl; ++cc) {
        const uint4 u = *reinterpret_cast<const uint4*>(
            ks + (r * kChunks + j + kLanes * cc) * 16);
        float kk[kE];
        chunk(static_cast<const T*>(nullptr), u, kk);
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
#pragma unroll
          for (int e = 0; e < kE; ++e)
            dot[gi] = __fmaf_rn(qr[gi][cc * kE + e], kk[e], dot[gi]);
        }
      }
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float s = dot[gi];
#pragma unroll
        for (int off = 1; off < kLanes; off <<= 1)
          s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
        s = __fmul_rn(s, scale);
        if (softcap > 0.0f)
          s = __fmul_rn(softcap, tanhf(__fdiv_rn(s, softcap)));
        sc[ps][gi] = ok[ps] ? s : kNeg;
      }
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float mx = sc[0][gi];
#pragma unroll
      for (int ps = 1; ps < kPasses; ++ps) mx = fmaxf(mx, sc[ps][gi]);
#pragma unroll
      for (int off = kLanes; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[gi], mx);
      const float corr = expf(m[gi] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int ps = 0; ps < kPasses; ++ps) {
        const float p = ok[ps] ? expf(sc[ps][gi] - m_new) : 0.0f;
        psum = __fadd_rn(psum, p);
        if (j == 0) p_s[warp][gi][kGroups * ps + grp] = p;
      }
#pragma unroll
      for (int off = kLanes; off < 32; off <<= 1)
        psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, off));
      l[gi] = __fmaf_rn(l[gi], corr, psum);
      m[gi] = m_new;
#pragma unroll
      for (int d = 0; d < kDims; ++d) acc[gi][d] = __fmul_rn(acc[gi][d], corr);
    }
    __syncwarp();
#pragma unroll
    for (int rr = 0; rr < kPerWarp; ++rr) {
      float vv[kDims];
#pragma unroll
      for (int x = 0; x < kDims / kVec; ++x)
        dims<kVec>(vs + (r0 + rr) * HD + Ge::dim(lane, x * kVec),
                   vv + x * kVec);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float p = p_s[warp][gi][rr];
#pragma unroll
        for (int d = 0; d < kDims; ++d)
          acc[gi][d] = __fmaf_rn(p, vv[d], acc[gi][d]);
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncthreads();                    // the stages are free for the merge

  // 3. merge the warps' states, then the cluster's ranges
  float* m_w = reinterpret_cast<float*>(smem);  // [kWarps][G]
  float* l_w = m_w + kWarps * G;                // [kWarps][G]
  float* acc_w = l_w + kWarps * G;              // [kWarps][G * HD]
  float* cm = acc_w + kWarps * G * HD;          // this CTA's m, l, acc
  float* cl = cm + G;
  float* cacc = cl + G;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (lane == 0) {
      m_w[warp * G + gi] = m[gi];
      l_w[warp * G + gi] = l[gi];
    }
#pragma unroll
    for (int d = 0; d < kDims; ++d)
      acc_w[(warp * G + gi) * HD + Ge::dim(lane, d)] = acc[gi][d];
  }
  __syncthreads();
  const long long out = row * G;
  for (int i = tid; i < G * HD; i += kThreads) {
    const int gi = i / HD;
    float mx = m_w[gi];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, m_w[w * G + gi]);
    float a = 0.0f, lsum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_w[w * G + gi] - mx);
      a = __fmaf_rn(acc_w[w * G * HD + i], c, a);
      lsum = __fmaf_rn(l_w[w * G + gi], c, lsum);
    }
    if (n_ranges == 1) {
      acc_out[out * HD + i] = a;
      if (i % HD == 0) {
        m_out[out + gi] = mx;
        l_out[out + gi] = lsum;
      }
    } else {
      cacc[i] = a;
      if (i % HD == 0) {
        cm[gi] = mx;
        cl[gi] = lsum;
      }
    }
  }
  if (n_ranges == 1) return;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                     // every range's state is in place
  if (cluster.block_rank() == 0) {
    for (int i = tid; i < G * HD; i += kThreads) {
      const int gi = i / HD;
      float mx = kNeg;
      for (int r = 0; r < n_ranges; ++r)
        mx = fmaxf(mx, cluster.map_shared_rank(cm, r)[gi]);
      float a = 0.0f, lsum = 0.0f;
      for (int r = 0; r < n_ranges; ++r) {
        const float c = expf(cluster.map_shared_rank(cm, r)[gi] - mx);
        a = __fmaf_rn(cluster.map_shared_rank(cacc, r)[i], c, a);
        lsum = __fmaf_rn(cluster.map_shared_rank(cl, r)[gi], c, lsum);
      }
      acc_out[out * HD + i] = a;
      if (i % HD == 0) {
        m_out[out + gi] = mx;
        l_out[out + gi] = lsum;
      }
    }
  }
  cluster.sync();                     // rank 0 has read every range
}

// Sets, once per device, the kernel's dynamic shared memory (64 KB, past
// the 48 KB default) and leave to form clusters past the portable 8.
template <typename T, int HD, int G>
cudaError_t prepare() {
  static unsigned set_on = 0;   // devices whose attributes are set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 32 || (set_on >> dev & 1u)) return err;
  auto kern = gqa_decode_kernel<T, HD, G>;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Geo<T, HD>::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) set_on |= 1u << dev;
  return err;
}

// CTAs of the kernel one SM holds, and clusters of n_ranges CTAs the card
// holds at once (0 when such a cluster cannot be placed).
template <typename T, int HD, int G>
int occupancy(int n_ranges, int* ctas_per_sm, int* clusters) {
  auto kern = gqa_decode_kernel<T, HD, G>;
  cudaError_t err = prepare<T, HD, G>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, kern, kThreads, Geo<T, HD>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_ranges));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Geo<T, HD>::kSmem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(n_ranges);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kern,
                                                         &cfg));
}

template <typename T, int HD, int G>
int launch(const float* q, const void* k, const void* v,
           const uint8_t* valid, float* m, float* l, float* acc, int rows,
           int S, int kvh, int range_len, int n_ranges, float scale,
           float softcap, cudaStream_t s) {
  using Ge = Geo<T, HD>;
  // the merge's arrays reuse the stages
  static_assert((2 * kWarps * G + kWarps * G * HD + 2 * G + G * HD) * 4 <=
                    Ge::kSmem, "merge scratch");
  if (range_len % Ge::kTile != 0 || range_len > kMaxRange) return 1;
  auto kern = gqa_decode_kernel<T, HD, G>;
  cudaError_t err = prepare<T, HD, G>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * n_ranges));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Ge::kSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(n_ranges);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, q, static_cast<const T*>(k),
                           static_cast<const T*>(v), valid, m, l, acc, S,
                           kvh, range_len, n_ranges, scale, softcap);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_g(int g, const float* q, const void* k, const void* v,
             const uint8_t* valid, float* m, float* l, float* acc, int rows,
             int S, int kvh, int range_len, int n_ranges, float scale,
             float softcap, cudaStream_t s) {
#define GQA_CASE(G)                                                       \
  case G:                                                                 \
    return launch<T, HD, G>(q, k, v, valid, m, l, acc, rows, S, kvh,      \
                            range_len, n_ranges, scale, softcap, s);
  switch (g) {
    GQA_CASE(1) GQA_CASE(2) GQA_CASE(3) GQA_CASE(4)
    GQA_CASE(5) GQA_CASE(6) GQA_CASE(7) GQA_CASE(8)
    default: return 1;
  }
#undef GQA_CASE
}

template <typename T, int HD>
int occupancy_g(int g, int n_ranges, int* ctas_per_sm, int* clusters) {
#define GQA_CASE(G) \
  case G: return occupancy<T, HD, G>(n_ranges, ctas_per_sm, clusters);
  switch (g) {
    GQA_CASE(1) GQA_CASE(2) GQA_CASE(3) GQA_CASE(4)
    GQA_CASE(5) GQA_CASE(6) GQA_CASE(7) GQA_CASE(8)
    default: return 1;
  }
#undef GQA_CASE
}

// Calls F<T, HD>(args...) for the cache's element type and head dim, or
// returns 1 for a head dim the kernel is not compiled for.
#define GQA_DISPATCH(F, bf16, hd, ...)                                    \
  do {                                                                    \
    if (bf16) {                                                           \
      switch (hd) {                                                       \
        case 64: return F<__nv_bfloat16, 64>(__VA_ARGS__);                \
        case 128: return F<__nv_bfloat16, 128>(__VA_ARGS__);              \
        case 256: return F<__nv_bfloat16, 256>(__VA_ARGS__);              \
        default: return 1;                                                \
      }                                                                   \
    }                                                                     \
    switch (hd) {                                                         \
      case 64: return F<float, 64>(__VA_ARGS__);                          \
      case 128: return F<float, 128>(__VA_ARGS__);                        \
      case 256: return F<float, 256>(__VA_ARGS__);                        \
      default: return 1;                                                  \
    }                                                                     \
  } while (0)

}  // namespace

// q: (b, kvh, g, hd) f32; k, v: (b, S, kvh, hd) f32 (kv_is_bf16 == 0) or
// bf16; valid: (S,) bytes; outputs m/l (b, kvh, g) and acc (b, kvh, g, hd)
// f32 — all contiguous, q, k, v and valid 16-byte aligned.  hd is 64, 128
// or 256, 1 <= g <= 8; each row's positions are cut into n_ranges <= 16
// ranges of range_len positions (a multiple of the tile, at most 32,768;
// range_len * n_ranges >= S).  softcap <= 0 means none.  Returns 0, the
// CUDA error of the launch, or 1 for an unsupported shape.
extern "C" int gqa_decode_launch(const float* q, const void* k,
                                 const void* v, int kv_is_bf16,
                                 const uint8_t* valid, float* m, float* l,
                                 float* acc, int b, int S, int kvh, int g,
                                 int hd, int range_len, int n_ranges,
                                 float scale, float softcap, void* stream) {
  if (g < 1 || g > kGMax || n_ranges < 1 || n_ranges > kMaxRanges ||
      static_cast<long long>(range_len) * n_ranges < S)
    return 1;
  if (b <= 0 || kvh <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GQA_DISPATCH(launch_g, kv_is_bf16, hd, g, q, k, v, valid, m, l, acc,
               b * kvh, S, kvh, range_len, n_ranges, scale, softcap, s);
}

// The kernel's CTAs per SM for (element type, hd, g), and how many
// clusters of n_ranges CTAs the current device holds at once.  Returns 0,
// a CUDA error, or 1 for an unsupported shape.
extern "C" int gqa_decode_occupancy(int kv_is_bf16, int hd, int g,
                                    int n_ranges, int* ctas_per_sm,
                                    int* clusters) {
  if (g < 1 || g > kGMax || n_ranges < 1 || n_ranges > kMaxRanges) return 1;
  GQA_DISPATCH(occupancy_g, kv_is_bf16, hd, g, n_ranges, ctas_per_sm,
               clusters);
}
