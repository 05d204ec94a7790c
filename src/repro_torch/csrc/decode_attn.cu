// Decode attention over a KV cache: the score product and the PV product of
// one query a row, reading the cache in place.
//
// Replaces no TPU kernel: the JAX package leaves decode attention to XLA
// (src/repro/models/attention.py's einsums).  It replaces the port's own
// decode path, which cast each layer's bf16 key cache to fp32 and let
// einsum make a permuted contiguous copy of it and of the value cache
// before two batched gemvs: about 7 GB moved a layer to read 1.2 GB.
//
// Bound on the H100: device-memory bytes.  Each cache slot the mask keeps
// is read once, 2 * Dh bytes of keys and 2 * Dh of values, for 2 * g * Dh
// multiply-adds of each: at g <= 8 that is at most 8 operations a byte,
// far below the ~295 a byte where the tensor cores bind and below the
// ~20 a byte where the FP32 units would.  So the design only moves fewer
// bytes and keeps enough of them in flight:
//   - the keys and values are read in their (B, S, Hkv, Dh) layout, no
//     copy: a block takes one (batch row, KV head) pair, a slot of it is
//     2 * Dh contiguous bytes at a stride of Hkv * Dh elements;
//   - a lane owns 8 consecutive elements of a slot (one 16-byte load in
//     bf16, two in fp32), and `lanes` = the next power of 2 >= Dh / 8
//     neighbouring lanes take one slot, so a warp reads 32 / lanes slots a
//     load (Dh 96 leaves 4 of 16 lanes idle);
//   - a lane issues kUnroll = 4 slots' loads before it uses any, 64 bytes
//     in flight a thread, and keeps them in their packed form (4 registers
//     a slot in bf16) until it uses them; at 64 registers a thread an SM
//     keeps 1,024 threads, 64 KB in flight, well over Little's law (3.35
//     TB/s x ~0.7 us is ~18 KB an SM).  The loads are streaming (ld.cs):
//     the cache is read once a step.  Blocks of 128 threads, these loads
//     and 4 slots a lane measured best at olmo-1b.decode's shape among 128,
//     256 and 512 threads, 4 and 8 slots, ld.cs and ld.global.nc (8 slots
//     spill or cut the blocks an SM);
//   - only the slots in [lo, hi), the ones the causal and sliding-window
//     mask keeps at the query's position, are read; the score product
//     writes exactly `masked` (attention's NEG_INF) at the others, and the
//     PV product skips them, which is exact because the softmax gives 0
//     there (its exp is 0 below -87);
//   - the query stays in registers (g x 8 fp32 a lane); products of bf16
//     values are exact in fp32 and summed in fp32, so only the order of
//     the sums differs from an fp32 einsum;
//   - the score product's g sums of a slot are reduce-scattered over its
//     lanes with warp shuffles (g - 1 + log2(lanes / g) shuffles rather
//     than g log2(lanes)); the PV product's fp32 sums reduce over a warp's
//     slots by shuffles, over a block's warps in shared memory and over
//     the blocks of a cluster in distributed shared memory, each in a
//     fixed order, so a result repeats bit for bit from run to run;
//   - where the pairs are too few to fill the card (about two blocks an
//     SM; measured at olmo-1b.decode's 2,048 pairs, splitting more gained
//     nothing), the wrapper splits each pair's slots over k = 2, 4 or 8 blocks
//     (repro_torch/kernels/decode_attn.py:splits): independent blocks for
//     the scores, one cluster a pair for the PV product.
// Nothing is allocated here: the wrapper allocates the outputs.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kMaxDh = 256;
constexpr unsigned kFull = 0xffffffffu;

// Blocks an SM keeps at once, which __launch_bounds__ turns into a register
// cap: 1,024 threads (64 registers a thread) where a lane's query heads fit
// in them, 512 for 4 and 8 heads.
template <int G>
constexpr int kMinBlocks = (G <= 2 ? 1024 : 512) / kThreads;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 8 consecutive elements of a slot as loaded (16-byte aligned), unpacked
// to fp32 only where they are used: in bf16 they hold 4 registers.
template <typename T>
struct Raw8;
template <>
struct Raw8<__nv_bfloat16> {
  uint4 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    w = __ldcs(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { w = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void unpack(float* v) const {
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};
template <>
struct Raw8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldcs(reinterpret_cast<const float4*>(p));
    b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void zero() {
    a = make_float4(0.f, 0.f, 0.f, 0.f);
    b = a;
  }
  __device__ __forceinline__ void unpack(float* v) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};

// Sums the N values of v over the lanes of a slot, from lane offset o down
// to 1 (o = lanes a slot / 2).  While a lane holds more than one value and
// lanes are left, each step halves them: the lane whose bit o is set keeps
// the upper half and adds its partner's copy of it, the other the lower
// half (head0 counts where the lane's half starts); with one value left,
// the steps are a butterfly.  On return the lane holds n sums, of heads
// head0 .. head0 + n - 1.  Every sum is taken in one order, whichever lane
// holds it.
template <int N>
__device__ __forceinline__ void reduce_scatter(float* v, int c, int o,
                                               int& head0, int& n) {
  if constexpr (N > 1) {
    if (o < 1) {
      n = N;
      return;
    }
    const bool upper = c & o;
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const float send = upper ? v[j] : v[j + N / 2];
      const float keep = upper ? v[j + N / 2] : v[j];
      v[j] = keep + __shfl_xor_sync(kFull, send, o);
    }
    if (upper) head0 += N / 2;
    reduce_scatter<N / 2>(v, c, o / 2, head0, n);
  } else {
    for (; o >= 1; o /= 2) v[0] += __shfl_xor_sync(kFull, v[0], o);
    n = 1;
  }
}

// scores[b, h, i, 0, s] = scale * sum_d q[b, 0, h, i, d] * k[b, s, h, d] for
// s in [lo, hi), `masked` for the other s of this block's slots
// [blockIdx.y * split, +split).  Block: the pair blockIdx.x = b * hkv + h.
// G >= g is the query heads a KV head's lanes hold; a slot takes
// 2^lanes_log2 lanes.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks<G>)
    decode_scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         float* __restrict__ out, int hkv, int g, int dh,
                         int lanes_log2, int64_t S, int64_t lo, int64_t hi,
                         int64_t split, float scale, float masked) {
  const int lanes = 1 << lanes_log2;
  const int rows = 32 >> lanes_log2;  // slots a warp reads at once
  const int share = lanes > G ? lanes / G : 1;  // lanes holding each sum
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int c = lane & (lanes - 1);
  const int r = lane >> lanes_log2;
  const bool active = c * 8 < dh;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / hkv;
  const int64_t h = bh % hkv;

  float qv[G][8];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    Raw8<T> w;
    if (active && i < g) {
      w.load(q + (bh * g + i) * dh + c * 8);
    } else {
      w.zero();
    }
    w.unpack(qv[i]);
  }
  const int64_t stride = static_cast<int64_t>(hkv) * dh;
  const T* kp = k + (b * S * hkv + h) * dh + c * 8;
  float* op = out + bh * g * S;
  const int64_t s_begin = static_cast<int64_t>(blockIdx.y) * split;
  const int64_t s_end = S < s_begin + split ? S : s_begin + split;
  const int64_t step = static_cast<int64_t>(kWarps) * rows * kUnroll;

  // s0 is the same in every lane of a warp: the shuffles below see all 32.
  for (int64_t s0 = s_begin + static_cast<int64_t>(warp) * rows * kUnroll;
       s0 < s_end; s0 += step) {
    Raw8<T> kw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t s = s0 + u * rows + r;
      if (active && s < s_end && s >= lo && s < hi) {
        kw[u].load(kp + s * stride);
      } else {
        kw[u].zero();
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t s = s0 + u * rows + r;
      float kv[8];
      kw[u].unpack(kv);
      float v[G];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) d = fmaf(qv[i][j], kv[j], d);
        v[i] = d;
      }
      int head0 = 0;
      int n = 1;
      reduce_scatter<G>(v, c, lanes / 2, head0, n);
      if (s < s_end && (c & (share - 1)) == 0) {
        const bool keep = s >= lo && s < hi;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const int head = head0 + j;
          if (j < n && head < g) op[head * S + s] = keep ? v[j] * scale : masked;
        }
      }
    }
  }
}

// out[b, 0, h, i, :] = sum over s in [lo, hi) of p[b, h, i, 0, s] *
// v[b, s, h, :], in fp32, rounded once to T.  A cluster of k blocks takes
// the pair blockIdx.x / k; rank r of it the slots [lo + r * split, +split).
template <typename T, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks<G>)
    decode_pv_kernel(const T* __restrict__ p, const T* __restrict__ v,
                     T* __restrict__ out, int hkv, int g, int dh,
                     int lanes_log2, int64_t S, int64_t lo, int64_t hi,
                     int64_t split) {
  __shared__ float red[kWarps][kMaxDh];  // one head's sums, a row a warp
  __shared__ float part[G][kMaxDh];      // this block's sums, read by rank 0
  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lanes = 1 << lanes_log2;
  const int rows = 32 >> lanes_log2;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int c = lane & (lanes - 1);
  const int r = lane >> lanes_log2;
  const bool active = c * 8 < dh;
  const int64_t bh = blockIdx.x / k;
  const int64_t b = bh / hkv;
  const int64_t h = bh % hkv;

  const int64_t stride = static_cast<int64_t>(hkv) * dh;
  const T* vp = v + (b * S * hkv + h) * dh + c * 8;
  const T* pp = p + bh * g * S;
  const int64_t s_begin = lo + rank * split;
  const int64_t s_end = hi < s_begin + split ? hi : s_begin + split;
  const int64_t step = static_cast<int64_t>(kWarps) * rows * kUnroll;

  float acc[G][8];
#pragma unroll
  for (int i = 0; i < G; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  for (int64_t s0 = s_begin + static_cast<int64_t>(warp) * rows * kUnroll;
       s0 < s_end; s0 += step) {
    Raw8<T> vw[kUnroll];
    float pw[kUnroll][G];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t s = s0 + u * rows + r;
      const bool in = s < s_end;
      if (active && in) {
        vw[u].load(vp + s * stride);
      } else {
        vw[u].zero();
      }
#pragma unroll
      for (int i = 0; i < G; ++i) {
        pw[u][i] = in && i < g ? to_f32(pp[i * S + s]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float vv[8];
      vw[u].unpack(vv);
#pragma unroll
      for (int i = 0; i < G; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pw[u][i], vv[j], acc[i][j]);
      }
    }
  }
  // A warp's slots: lanes r > 0 into lane r = 0 of the same element.
  for (int o = lanes; o < 32; o *= 2) {
#pragma unroll
    for (int i = 0; i < G; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[i][j] += __shfl_xor_sync(kFull, acc[i][j], o);
      }
    }
  }
  // A block's warps, in warp order, a head at a time.
#pragma unroll
  for (int i = 0; i < G; ++i) {
    if (i < g) {  // g is the same in every thread: the barriers agree
      if (r == 0 && active) {
#pragma unroll
        for (int j = 0; j < 8; ++j) red[warp][c * 8 + j] = acc[i][j];
      }
      __syncthreads();
      for (int t = threadIdx.x; t < dh; t += kThreads) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[w][t];
        part[i][t] = s;
      }
      __syncthreads();
    }
  }
  // A cluster's blocks, in rank order, by rank 0.
  cluster.sync();
  if (rank == 0) {
    for (int e = threadIdx.x; e < g * dh; e += kThreads) {
      const int i = e / dh;
      const int t = e % dh;
      float s = 0.f;
      for (int q = 0; q < k; ++q) s += *cluster.map_shared_rank(&part[i][t], q);
      store(out + (bh * g + i) * dh + t, s);
    }
  }
  cluster.sync();  // no block leaves while rank 0 reads its sums
}

// The query heads a KV head's lanes hold: g rounded up to a power of 2.
inline int heads_bucket(int g) {
  return g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : g <= 8 ? 8 : 0;
}

// log2 of the lanes a slot takes: Dh / 8 rounded up to a power of 2.
inline int lanes_log2(int dh) {
  int l = 0;
  while ((8 << l) < dh) ++l;
  return l;
}

inline bool sizes_ok(int64_t batch, int hkv, int g, int dh, int64_t S,
                     int64_t lo, int64_t hi, int splits) {
  return batch > 0 && hkv > 0 && heads_bucket(g) > 0 && dh % 8 == 0 &&
         dh >= 8 && dh <= kMaxDh && S > 0 && lo >= 0 && lo < hi && hi <= S &&
         (splits == 1 || splits == 2 || splits == 4 || splits == 8) &&
         batch * hkv * splits < (int64_t{1} << 31);
}

template <typename T, int G>
int scores_as(const T* q, const T* k, float* out, int64_t batch, int hkv,
              int g, int dh, int64_t S, int64_t lo, int64_t hi, int splits,
              float scale, float masked, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>(batch * hkv), splits);
  const int64_t split = (S + splits - 1) / splits;
  decode_scores_kernel<T, G><<<grid, kThreads, 0, stream>>>(
      q, k, out, hkv, g, dh, lanes_log2(dh), S, lo, hi, split, scale,
      masked);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G>
int pv_as(const T* p, const T* v, T* out, int64_t batch, int hkv, int g,
          int dh, int64_t S, int64_t lo, int64_t hi, int splits,
          cudaStream_t stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned int>(batch * hkv * splits));
  config.blockDim = dim3(kThreads);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const int64_t split = (hi - lo + splits - 1) / splits;
  const cudaError_t e = cudaLaunchKernelEx(
      &config, &decode_pv_kernel<T, G>, p, v, out, hkv, g, dh, lanes_log2(dh),
      S, lo, hi, split);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scores(const T* q, const T* k, float* out, int64_t batch, int hkv,
                  int g, int dh, int64_t S, int64_t lo, int64_t hi,
                  int splits, float scale, float masked,
                  cudaStream_t stream) {
  if (!sizes_ok(batch, hkv, g, dh, S, lo, hi, splits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (heads_bucket(g)) {
    case 1: return scores_as<T, 1>(q, k, out, batch, hkv, g, dh, S, lo, hi,
                                   splits, scale, masked, stream);
    case 2: return scores_as<T, 2>(q, k, out, batch, hkv, g, dh, S, lo, hi,
                                   splits, scale, masked, stream);
    case 4: return scores_as<T, 4>(q, k, out, batch, hkv, g, dh, S, lo, hi,
                                   splits, scale, masked, stream);
    default: return scores_as<T, 8>(q, k, out, batch, hkv, g, dh, S, lo, hi,
                                    splits, scale, masked, stream);
  }
}

template <typename T>
int launch_pv(const T* p, const T* v, T* out, int64_t batch, int hkv, int g,
              int dh, int64_t S, int64_t lo, int64_t hi, int splits,
              cudaStream_t stream) {
  if (!sizes_ok(batch, hkv, g, dh, S, lo, hi, splits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (heads_bucket(g)) {
    case 1: return pv_as<T, 1>(p, v, out, batch, hkv, g, dh, S, lo, hi,
                               splits, stream);
    case 2: return pv_as<T, 2>(p, v, out, batch, hkv, g, dh, S, lo, hi,
                               splits, stream);
    case 4: return pv_as<T, 4>(p, v, out, batch, hkv, g, dh, S, lo, hi,
                               splits, stream);
    default: return pv_as<T, 8>(p, v, out, batch, hkv, g, dh, S, lo, hi,
                                splits, stream);
  }
}

}  // namespace

extern "C" int decode_scores_bf16(const __nv_bfloat16* q,
                                  const __nv_bfloat16* k, float* out,
                                  int64_t batch, int hkv, int g, int dh,
                                  int64_t S, int64_t lo, int64_t hi,
                                  int splits, float scale, float masked,
                                  cudaStream_t stream) {
  return launch_scores(q, k, out, batch, hkv, g, dh, S, lo, hi, splits, scale,
                       masked, stream);
}

extern "C" int decode_scores_f32(const float* q, const float* k, float* out,
                                 int64_t batch, int hkv, int g, int dh,
                                 int64_t S, int64_t lo, int64_t hi,
                                 int splits, float scale, float masked,
                                 cudaStream_t stream) {
  return launch_scores(q, k, out, batch, hkv, g, dh, S, lo, hi, splits, scale,
                       masked, stream);
}

extern "C" int decode_pv_bf16(const __nv_bfloat16* p, const __nv_bfloat16* v,
                              __nv_bfloat16* out, int64_t batch, int hkv,
                              int g, int dh, int64_t S, int64_t lo,
                              int64_t hi, int splits, cudaStream_t stream) {
  return launch_pv(p, v, out, batch, hkv, g, dh, S, lo, hi, splits, stream);
}

extern "C" int decode_pv_f32(const float* p, const float* v, float* out,
                             int64_t batch, int hkv, int g, int dh, int64_t S,
                             int64_t lo, int64_t hi, int splits,
                             cudaStream_t stream) {
  return launch_pv(p, v, out, batch, hkv, g, dh, S, lo, hi, splits, stream);
}
