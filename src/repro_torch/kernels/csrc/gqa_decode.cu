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
// q is (b, kvh, g, hd); k and v are read in place in the cache's
// (b, S, kvh, hd) layout; valid is (S,) bytes, any mask.  Two kernels:
// gqa_decode_kernel for a float32 cache (and q), gqa_decode_mma_kernel for
// a bfloat16 cache under a bfloat16 or float32 q.
//
// Bound: device-memory bytes, in both.  Each valid position's K and V
// rows are read once (2 x hd x 4 B in float32, 2 x hd x 2 B in bfloat16)
// for 4 x g x hd operations: ~0.4 operations per byte at g = 3 in float32,
// g per byte in bfloat16 (8 at chameleon-34b's g 8), far below the card's
// balance in either.  What both share:
// * One launch.  A CTA takes one (b, kv head) row and one range of its
//   positions; the grid is sized to the card (decode_splits in
//   kernels/gqa_decode.py).  The ranges of a row form one thread block
//   cluster and merge their (m, l, acc) by log-sum-exp over distributed
//   shared memory: no partials in device memory, no second launch.  A
//   range holds at most 32,768 positions (its mask bits live in shared
//   memory), so a row of up to 262,144 positions is a portable cluster of
//   8, and one of up to 524,288 a non-portable cluster of 16 (Hopper
//   allows 16 when the kernel asks).
// * Masked positions cost a byte.  The CTA first packs its range's
//   `valid` bytes into bits in shared memory and lists the tiles with a
//   valid position; only those are copied, so the positions past the
//   causal frontier cost one byte of `valid` each.
// * cp.async, not TMA: the cache base changes with every layer, and a
//   tensor map would be encoded on the host at every call; the rows of
//   one head are 128-1,024 B runs at a kvh x hd stride, which 16-byte
//   copies take coalesced.  Rows past S are zero-filled by the copy.
//
// The float32 kernel.  Tiles of kTile positions of one
// head (8 KB of K plus 8 KB of V) flow through a CTA-wide ring of kStages
// stages: three tiles in flight while the fourth is consumed, ~48 KB per
// CTA and ~140 KB per SM (Little's law at 3.35 TB/s and ~1 us of latency
// wants ~25 KB per SM).  The grid: about two waves of the CTAs an SM holds
// (3; 2 at hd 256), in ranges of at least 20 tiles.  Compute from shared
// memory only: kLanes lanes share one position (8 up to hd 128, the whole
// warp at hd 256), each lane takes 16-byte chunks j, j + kLanes, ... of
// the K row (contiguous bytes across the lanes: no bank conflict, no
// padding) against q held in registers, then log2(kLanes) shuffles sum
// the dot product; 32 / kLanes positions per warp instruction.  At hd 256
// a quarter-warp group would hold 32 x g floats of q per lane (256
// registers at g = 8).  p . V: each lane owns hd / 32 dimensions of the V
// row, in vectors of 16 bytes at most, each vector contiguous across the
// warp, and reads p from shared memory by broadcast.  CUDA cores in
// float32 (~0.4 operations per byte: tensor cores would not pay, and TF32
// would break the 1e-5 contract).  Templated on g, so registers hold
// exactly the g queries of a head.
//
// The bfloat16 kernel.  At g 8 the byte bound asks ~27 TFLOP/s of
// products, more than CUDA cores issuing one position at a time give, and
// a bfloat16 x bfloat16 product is exact in float32, so the products run
// on tensor cores (mma.sync m16n8k16, float32 accumulators; wgmma's 64-row
// tiles would be 8-64x empty with g <= 8 queries, and the kernel needs ~1%
// of the tensor-core rate):
// * Exact slices.  q is split into bfloat16 slices whose float32 sum is q:
//   one for a bfloat16 q, three for a float32 q (the remainders are exact,
//   the third has at most 8 bits left); so is p, into three.  Every
//   product of slices is exact, and the kernel differs from the plain
//   version only in how its float32 sums are ordered and rounded.
// * Scores S^T = K Q^T per 16-position chunk: A is the K chunk (positions
//   x dims) read from shared memory by ldmatrix, B the queries (zero past
//   g) in registers, one mma per slice and 16 dims.  The accumulator's
//   rows are positions, its columns queries: scale, softcap, mask and the
//   online max and sum run on it in registers, the max over a chunk by
//   three shuffles.  p v as O^T = V^T P^T: A is the V chunk read by
//   ldmatrix.trans, B is p's slices, each 8x8 block of the accumulator
//   transposed in registers by movmatrix: no trip through shared memory.
//   Not templated on g: an mma's 8 columns hold every group size.
// * Rows land with their 16-byte chunk index XORed with the row (mod 8),
//   so the 8 rows one ldmatrix reads fall on distinct bank groups.
// * Each warp streams its share of the range's live chunks (warp, warp +
//   kW, ...) through a ring of its own of 2 chunks: 8 warps at hd 64, 4
//   above, so 64 KB of rings a CTA (128 KB at hd 256).  The stage of the
//   chunk just computed refills before the next chunk is waited for: 2
//   chunks are in flight while a warp waits, and warps never wait for each
//   other.
// * The grid (decode_splits): rows x ranges near 3/4 of the SMs, one CTA
//   each, clusters of at most 8.  Filling the card with 2-3 CTAs per SM
//   loses at these shapes: more ranges add cluster merges, and clusters
//   that share SMs finish unevenly (chip_smoke.py's bfloat16 range sweeps,
//   PERF.md).
//
// Arithmetic: expf and tanhf (never the fast __expf/__tanhf), correctly
// rounded division; the float32 kernel's dot products and weighted sums
// use explicit fused multiply-adds, the bfloat16 kernel's run on tensor
// cores.  Masked scores are -1e30 and p is zeroed where invalid, so a
// fully masked range or row gives m = -1e30, l = 0, acc = 0 exactly, as
// the reference does.

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

// one 16-byte chunk of a row in shared memory as floats
__device__ __forceinline__ void chunk(const float*, const uint4& u,
                                      float o[4]) {
  o[0] = __uint_as_float(u.x); o[1] = __uint_as_float(u.y);
  o[2] = __uint_as_float(u.z); o[3] = __uint_as_float(u.w);
}

// N consecutive elements (2 or 4) of a row in shared memory
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

// ---------------------------------------------------------------------
// The bfloat16 branch: tensor-core products on exact bfloat16 slices.

constexpr int kChunk = 16;          // positions of one m16n8k16 tile

// q's bfloat16 slices whose float32 sum is q: 1 for a bfloat16 q, 3 for
// a float32 one (its 24-bit significand is three 8-bit ones)
template <typename QT> constexpr int kSlices = 1;
template <> constexpr int kSlices<float> = 3;

template <typename QT, int HD>
struct MmaGeo {
  // warps of a CTA, each with a ring of kStages chunks: 64 KB of rings at
  // hd 64 (8 warps) and 128 (4 warps), so 3 CTAs fit on an SM where a grid
  // needs them; 128 KB at hd 256 (4 warps)
  static constexpr int kW = HD == 64 ? 8 : 4;
  static constexpr int kT = 32 * kW;
  static constexpr int kStages = 2;
  static constexpr int kRowBytes = 2 * HD;           // one K or V row
  static constexpr int kChunkBytes = kChunk * kRowBytes;  // K (or V)
  static constexpr int kSteps = HD / 16;  // k-steps of q.k, m-tiles of p v
  static constexpr int kRowChunks = HD / 8;          // 16 B chunks per row
  static constexpr int kCopies = kChunkBytes / 16 / 32;   // per lane
  static constexpr int kStageBytes = 2 * kChunkBytes;
  static constexpr int kWarpBytes = kStages * kStageBytes;
  static constexpr int kSmem = kW * kWarpBytes;
  static constexpr int kMinBlocks = HD == 256 ? 1 : 3;
  static_assert(kCopies >= 1 && kRowChunks >= 8, "chunk geometry");
  static_assert((2 * kW * kGMax + kW * kGMax * HD + 2 * kGMax +
                 kGMax * HD) * 4 <= kSmem, "merge scratch");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices of shared memory, one row address per lane
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t r[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t r[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 float32
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// an 8x8 bf16 matrix in the fragment layout, transposed in registers
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16;
}

// x as three bfloat16 whose float32 sum is x: each remainder is exact in
// float32, and the third has at most 8 significant bits left
__device__ __forceinline__ void split3(float x, __nv_bfloat16 s[3]) {
  s[0] = __float2bfloat16_rn(x);
  const float r = __fsub_rn(x, __bfloat162float(s[0]));
  s[1] = __float2bfloat16_rn(r);
  s[2] = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(s[1])));
}

// Lane (gq, tq) of a warp holds, for query gq (zero past g), the elements
// 16 ks + 2 tq + {0, 1} and + {8, 9} of q's row: the B fragments of
// S^T = K Q^T, one per slice and k-step.
template <typename QT, int HD>
__device__ __forceinline__ void load_q(
    const QT* q, bool on, int tq,
    uint32_t qf[kSlices<QT>][MmaGeo<QT, HD>::kSteps][2]) {
#pragma unroll
  for (int ks = 0; ks < MmaGeo<QT, HD>::kSteps; ++ks) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int d = 16 * ks + 2 * tq + 8 * hh;
      if constexpr (kSlices<QT> == 1) {
        qf[0][ks][hh] = on ? *reinterpret_cast<const uint32_t*>(q + d) : 0u;
      } else {
        const float2 x = on ? *reinterpret_cast<const float2*>(q + d)
                            : make_float2(0.0f, 0.0f);
        __nv_bfloat16 lo[3], hi[3];
        split3(x.x, lo);
        split3(x.y, hi);
#pragma unroll
        for (int sl = 0; sl < 3; ++sl)
          qf[sl][ks][hh] = pack_bf16(lo[sl], hi[sl]);
      }
    }
  }
}

template <typename QT, int HD>
__global__ void __launch_bounds__(MmaGeo<QT, HD>::kT,
                                  MmaGeo<QT, HD>::kMinBlocks)
gqa_decode_mma_kernel(const QT* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const uint8_t* __restrict__ valid,
                      float* __restrict__ m_out, float* __restrict__ l_out,
                      float* __restrict__ acc_out, int S, int kvh, int g,
                      int range_len, int n_ranges, float scale,
                      float softcap) {
  using Ge = MmaGeo<QT, HD>;
  constexpr int kWarps = Ge::kW, kThreads = Ge::kT;
  constexpr int kSteps = Ge::kSteps, kSt = Ge::kStages, kSl = kSlices<QT>;
  constexpr int kRowBytes = Ge::kRowBytes, kRowChunks = Ge::kRowChunks;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint16_t mask16[kMaxRange / kChunk];   // a chunk's bits
  __shared__ int16_t live[kMaxRange / kChunk];
  __shared__ float w_s[kMaxRanges][kGMax];
  __shared__ int n_live_s;

  const long long row = blockIdx.x / n_ranges;  // b * kvh + h
  const int range = static_cast<int>(blockIdx.x % n_ranges);
  const long long b = row / kvh;
  const int h = static_cast<int>(row % kvh);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;   // fragment row, column pair

  // 1. the range's mask, 16 bits a chunk, and the list of live chunks
  const int s0 = range * range_len;
  const int len = max(0, min(S, s0 + range_len) - s0);
  const int n_chunks = (len + kChunk - 1) / kChunk;
  for (int c = tid; c < n_chunks; c += kThreads) {
    uint32_t bits = 0;
    const int p = s0 + kChunk * c;
    if (p + kChunk <= S) {
      const uint4 w = *reinterpret_cast<const uint4*>(valid + p);
      bits = byte_bits(w.x) | byte_bits(w.y) << 4 | byte_bits(w.z) << 8 |
             byte_bits(w.w) << 12;
    } else {
      for (int i = 0; p + i < S; ++i)
        bits |= static_cast<uint32_t>(valid[p + i] != 0) << i;
    }
    mask16[c] = static_cast<uint16_t>(bits);
  }
  uint32_t qf[kSl][kSteps][2];
  load_q<QT, HD>(q + (row * g + (gq < g ? gq : 0)) * HD, gq < g, tq, qf);
  __syncthreads();
  if (warp == 0) {
    int count = 0;
    for (int t0 = 0; t0 < n_chunks; t0 += 32) {
      const int t = t0 + lane;
      const bool any = t < n_chunks && mask16[t] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, any);
      if (any) live[count + __popc(bal & ((1u << lane) - 1u))] =
          static_cast<int16_t>(t);
      count += __popc(bal);
    }
    if (lane == 0) n_live_s = count;
  }
  __syncthreads();
  const int n_live = n_live_s;

  // 2. each warp streams live chunks warp, warp + kWarps, ... through a
  // ring of its own.  Rows land with their 16-byte chunk index XORed with
  // the row (mod 8): the 8 rows an ldmatrix reads at once then fall on 8
  // distinct bank groups.
  const long long stride = static_cast<long long>(kvh) * HD;  // elements
  const __nv_bfloat16* kb = k + (b * S * kvh + h) * HD;
  const __nv_bfloat16* vb = v + (b * S * kvh + h) * HD;
  unsigned char* ring = smem + warp * Ge::kWarpBytes;
  const int n_mine = n_live > warp ? (n_live - warp + kWarps - 1) / kWarps
                                   : 0;
  auto fetch = [&](int j) {
    unsigned char* ks = ring + (j % kSt) * Ge::kStageBytes;
    unsigned char* vs = ks + Ge::kChunkBytes;
    const int p0 = s0 + live[warp + j * kWarps] * kChunk;
#pragma unroll
    for (int x = 0; x < Ge::kCopies; ++x) {
      const int i = lane + 32 * x;
      const int r = i / kRowChunks, c = i % kRowChunks;
      const bool in = p0 + r < S;
      const long long off = in ? (p0 + r) * stride + c * 8 : 0;
      const int dst = r * kRowBytes + ((c ^ (r & 7)) << 4);
      cp_async16(ks + dst, kb + off, in ? 16 : 0);
      cp_async16(vs + dst, vb + off, in ? 16 : 0);
    }
  };

  float mrun[2] = {kNeg, kNeg}, lrun[2] = {0.0f, 0.0f};  // columns 2tq, +1
  float acc[kSteps][4];                 // O^T: dims 16 mt + gq (+8) x cols
#pragma unroll
  for (int mt = 0; mt < kSteps; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.0f;

#pragma unroll
  for (int j = 0; j < kSt - 1; ++j) {
    if (j < n_mine) fetch(j);
    cp_async_commit();
  }
  // this lane's ldmatrix row: K as A (positions x dims), V as A^T
  const int krow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int vrow = (lane & 7) + (lane >> 4) * 8;
  for (int j = 0; j < n_mine; ++j) {
    // the stage of chunk j - 1 refills before chunk j is waited for, so
    // kSt chunks are in flight while the warp waits, kSt - 1 while it
    // computes
    __syncwarp();                     // the warp is done with chunk j - 1
    if (j + kSt - 1 < n_mine) fetch(j + kSt - 1);
    cp_async_commit();
    cp_async_wait<kSt - 1>();
    __syncwarp();                     // chunk j landed for every lane

    const uint32_t ka = smem_u32(ring + (j % kSt) * Ge::kStageBytes);
    const uint32_t va = ka + Ge::kChunkBytes;
    const uint32_t bits = mask16[live[warp + j * kWarps]];
    // scores S^T (16 positions x 8 queries), every slice of q
    float sc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const int c = 2 * ks + (lane >> 4);
      uint32_t a[4];
      ldsm_x4(ka + krow * kRowBytes + ((c ^ (krow & 7)) << 4), a);
#pragma unroll
      for (int sl = 0; sl < kSl; ++sl)
        mma_bf16(sc, a, qf[sl][ks][0], qf[sl][ks][1]);
    }
    // lane holds positions gq, gq + 8 of columns 2tq, 2tq + 1
    const bool ok[2] = {((bits >> gq) & 1u) != 0,
                        ((bits >> (gq + 8)) & 1u) != 0};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float s = __fmul_rn(sc[e], scale);
      if (softcap > 0.0f) s = __fmul_rn(softcap, tanhf(__fdiv_rn(s, softcap)));
      sc[e] = ok[e >> 1] ? s : kNeg;
    }
    float p[4], corr[2];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      float mx = fmaxf(sc[jj], sc[jj + 2]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(mrun[jj], mx);
      corr[jj] = expf(mrun[jj] - m_new);
      mrun[jj] = m_new;
      p[jj] = ok[0] ? expf(sc[jj] - m_new) : 0.0f;
      p[jj + 2] = ok[1] ? expf(sc[jj + 2] - m_new) : 0.0f;
      lrun[jj] = __fmaf_rn(lrun[jj], corr[jj], __fadd_rn(p[jj], p[jj + 2]));
    }
    if (!__all_sync(0xffffffffu, corr[0] == 1.0f && corr[1] == 1.0f)) {
#pragma unroll
      for (int mt = 0; mt < kSteps; ++mt) {
        acc[mt][0] = __fmul_rn(acc[mt][0], corr[0]);
        acc[mt][1] = __fmul_rn(acc[mt][1], corr[1]);
        acc[mt][2] = __fmul_rn(acc[mt][2], corr[0]);
        acc[mt][3] = __fmul_rn(acc[mt][3], corr[1]);
      }
    }
    // P^T as B fragments: three bfloat16 slices of p, each 8x8 block
    // (positions x queries) transposed in registers
    uint32_t pb[3][2];
    {
      __nv_bfloat16 s[4][3];
#pragma unroll
      for (int e = 0; e < 4; ++e) split3(p[e], s[e]);
#pragma unroll
      for (int sl = 0; sl < 3; ++sl) {
        pb[sl][0] = transpose8x8(pack_bf16(s[0][sl], s[1][sl]));
        pb[sl][1] = transpose8x8(pack_bf16(s[2][sl], s[3][sl]));
      }
    }
    // O^T (dims x queries) += V^T P^T
#pragma unroll
    for (int mt = 0; mt < kSteps; ++mt) {
      const int c = 2 * mt + ((lane >> 3) & 1);
      uint32_t a[4];
      ldsm_x4_t(va + vrow * kRowBytes + ((c ^ (vrow & 7)) << 4), a);
#pragma unroll
      for (int sl = 0; sl < 3; ++sl)
        mma_bf16(acc[mt], a, pb[sl][0], pb[sl][1]);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      lrun[jj] = __fadd_rn(lrun[jj], __shfl_xor_sync(0xffffffffu, lrun[jj],
                                                     off));
  __syncthreads();                    // the rings are free for the merge

  // 3. merge the warps' states, then the cluster's ranges
  float* m_w = reinterpret_cast<float*>(smem);  // [kWarps][kGMax]
  float* l_w = m_w + kWarps * kGMax;            // [kWarps][kGMax]
  float* acc_w = l_w + kWarps * kGMax;          // [kWarps][kGMax][HD]
  float* cm = acc_w + kWarps * kGMax * HD;      // this CTA's m, l, acc
  float* cl = cm + kGMax;
  float* cacc = cl + kGMax;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int col = warp * kGMax + 2 * tq + jj;
    if (gq == 0) {
      m_w[col] = mrun[jj];
      l_w[col] = lrun[jj];
    }
#pragma unroll
    for (int mt = 0; mt < kSteps; ++mt) {
      acc_w[col * HD + 16 * mt + gq] = acc[mt][jj];
      acc_w[col * HD + 16 * mt + gq + 8] = acc[mt][jj + 2];
    }
  }
  __syncthreads();
  const long long out = row * g;
  for (int i = tid; i < g * HD; i += kThreads) {
    const int gi = i / HD, d = i % HD;
    float mx = m_w[gi];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, m_w[w * kGMax + gi]);
    float a = 0.0f, lsum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_w[w * kGMax + gi] - mx);
      a = __fmaf_rn(acc_w[(w * kGMax + gi) * HD + d], c, a);
      lsum = __fmaf_rn(l_w[w * kGMax + gi], c, lsum);
    }
    if (n_ranges == 1) {
      acc_out[out * HD + i] = a;
      if (d == 0) {
        m_out[out + gi] = mx;
        l_out[out + gi] = lsum;
      }
    } else {
      cacc[i] = a;
      if (d == 0) {
        cm[gi] = mx;
        cl[gi] = lsum;
      }
    }
  }
  if (n_ranges == 1) return;
  // every rank weighs every range's state by exp(m_r - max m) and sums
  // its own share of the g x hd outputs over the ranges' shared memory
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  cluster.sync();                     // every range's state is in place
  if (tid < n_ranges * g)
    w_s[tid / g][tid % g] = cluster.map_shared_rank(cm, tid / g)[tid % g];
  __syncthreads();
  if (tid < g) {
    float mx = kNeg;
    for (int r = 0; r < n_ranges; ++r) mx = fmaxf(mx, w_s[r][tid]);
    float lsum = 0.0f;
    for (int r = 0; r < n_ranges; ++r) {
      const float c = expf(w_s[r][tid] - mx);
      w_s[r][tid] = c;
      if (rank == 0)
        lsum = __fmaf_rn(cluster.map_shared_rank(cl, r)[tid], c, lsum);
    }
    if (rank == 0) {
      m_out[out + tid] = mx;
      l_out[out + tid] = lsum;
    }
  }
  __syncthreads();
  const int n_out = g * HD, per = (n_out + n_ranges - 1) / n_ranges;
  const int hi = min(n_out, (rank + 1) * per);
  for (int i = rank * per + tid; i < hi; i += kThreads) {
    const int gi = i / HD;
    float part[kMaxRanges];
#pragma unroll
    for (int r = 0; r < kMaxRanges; ++r)
      part[r] = r < n_ranges ? cluster.map_shared_rank(cacc, r)[i] : 0.0f;
    float a = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxRanges; ++r)
      if (r < n_ranges) a = __fmaf_rn(part[r], w_s[r][gi], a);
    acc_out[out * HD + i] = a;
  }
  cluster.sync();                     // no rank leaves while read
}

// The bfloat16 kernel's attributes, once per device (as prepare).
template <typename QT, int HD>
cudaError_t prepare_mma() {
  static unsigned set_on = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 32 || (set_on >> dev & 1u)) return err;
  auto kern = gqa_decode_mma_kernel<QT, HD>;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MmaGeo<QT, HD>::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) set_on |= 1u << dev;
  return err;
}

template <typename QT, int HD>
int occupancy_mma(int n_ranges, int* ctas_per_sm, int* clusters) {
  auto kern = gqa_decode_mma_kernel<QT, HD>;
  cudaError_t err = prepare_mma<QT, HD>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, kern, MmaGeo<QT, HD>::kT, MmaGeo<QT, HD>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_ranges));
  cfg.blockDim = dim3(MmaGeo<QT, HD>::kT);
  cfg.dynamicSmemBytes = MmaGeo<QT, HD>::kSmem;
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

template <typename QT, int HD>
int launch_mma(const void* q, const void* k, const void* v,
               const uint8_t* valid, float* m, float* l, float* acc,
               int rows, int S, int kvh, int g, int range_len, int n_ranges,
               float scale, float softcap, cudaStream_t s) {
  if (range_len % kChunk != 0 || range_len > kMaxRange) return 1;
  auto kern = gqa_decode_mma_kernel<QT, HD>;
  cudaError_t err = prepare_mma<QT, HD>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * n_ranges));
  cfg.blockDim = dim3(MmaGeo<QT, HD>::kT);
  cfg.dynamicSmemBytes = MmaGeo<QT, HD>::kSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(n_ranges);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const QT*>(q),
                           static_cast<const __nv_bfloat16*>(k),
                           static_cast<const __nv_bfloat16*>(v), valid, m, l,
                           acc, S, kvh, g, range_len, n_ranges, scale,
                           softcap);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Calls F<...>(args...) for the kernel of the cache's and q's element
// types and the head dim: the float32 kernel (templated on g) for a
// float32 cache and q, the bfloat16 one for a bfloat16 cache and a
// float32 or bfloat16 q; returns 1 for any other combination.
#define GQA_DISPATCH(F32, MMA, kv_bf16, q_bf16, hd, f32_args, mma_args)   \
  do {                                                                    \
    if (!kv_bf16) {                                                       \
      if (q_bf16) return 1;                                               \
      switch (hd) {                                                       \
        case 64: return F32<float, 64> f32_args;                          \
        case 128: return F32<float, 128> f32_args;                        \
        case 256: return F32<float, 256> f32_args;                        \
        default: return 1;                                                \
      }                                                                   \
    }                                                                     \
    if (q_bf16) {                                                         \
      switch (hd) {                                                       \
        case 64: return MMA<__nv_bfloat16, 64> mma_args;                  \
        case 128: return MMA<__nv_bfloat16, 128> mma_args;                \
        case 256: return MMA<__nv_bfloat16, 256> mma_args;                \
        default: return 1;                                                \
      }                                                                   \
    }                                                                     \
    switch (hd) {                                                         \
      case 64: return MMA<float, 64> mma_args;                            \
      case 128: return MMA<float, 128> mma_args;                          \
      case 256: return MMA<float, 256> mma_args;                          \
      default: return 1;                                                  \
    }                                                                     \
  } while (0)

}  // namespace

// q: (b, kvh, g, hd) float32, or bfloat16 over a bfloat16 cache
// (q_is_bf16); k, v: (b, S, kvh, hd) float32 (kv_is_bf16 == 0) or
// bfloat16; valid: (S,) bytes; outputs m/l (b, kvh, g) and acc (b, kvh,
// g, hd) float32 — all contiguous, q, k, v and valid 16-byte aligned.  hd
// is 64, 128 or 256, 1 <= g <= 8; each row's positions are cut into
// n_ranges <= 16 ranges of range_len positions (a multiple of the tile:
// 8 KB of K in float32, 16 positions in bfloat16; at most 32,768;
// range_len * n_ranges >= S).  softcap <= 0 means none.  Returns 0, the
// CUDA error of the launch, or 1 for an unsupported shape.
extern "C" int gqa_decode_launch(const void* q, int q_is_bf16,
                                 const void* k, const void* v,
                                 int kv_is_bf16, const uint8_t* valid,
                                 float* m, float* l, float* acc, int b,
                                 int S, int kvh, int g, int hd,
                                 int range_len, int n_ranges, float scale,
                                 float softcap, void* stream) {
  if (g < 1 || g > kGMax || n_ranges < 1 || n_ranges > kMaxRanges ||
      static_cast<long long>(range_len) * n_ranges < S)
    return 1;
  if (b <= 0 || kvh <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GQA_DISPATCH(launch_g, launch_mma, kv_is_bf16, q_is_bf16, hd,
               (g, static_cast<const float*>(q), k, v, valid, m, l, acc,
                b * kvh, S, kvh, range_len, n_ranges, scale, softcap, s),
               (q, k, v, valid, m, l, acc, b * kvh, S, kvh, g, range_len,
                n_ranges, scale, softcap, s));
}

// CTAs per SM of the kernel that takes (cache type, q type, hd, g), and
// how many clusters of n_ranges CTAs the current device holds at once.
// Returns 0, a CUDA error, or 1 for an unsupported shape.
extern "C" int gqa_decode_occupancy(int kv_is_bf16, int q_is_bf16, int hd,
                                    int g, int n_ranges, int* ctas_per_sm,
                                    int* clusters) {
  if (g < 1 || g > kGMax || n_ranges < 1 || n_ranges > kMaxRanges) return 1;
  GQA_DISPATCH(occupancy_g, occupancy_mma, kv_is_bf16, q_is_bf16, hd,
               (g, n_ranges, ctas_per_sm, clusters),
               (n_ranges, ctas_per_sm, clusters));
}
