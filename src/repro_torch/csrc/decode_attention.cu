// Decode attention -- one new token's query heads against a KV cache -- for
// Hopper (sm_90a), bound with ctypes.
//
// Replaces the plain PyTorch attend_decode (repro_torch/models/
// attention.py), which the JAX package computes outside any Pallas kernel
// (src/repro/models/attention.py attend_decode): there is no TPU
// counterpart.  The plain version is repro_torch/kernels/decode_attention/
// ref.py decode_attention_ref.
//
// Layout: q [B, 1, K, G, hd], k/v caches [B, S, K, hd], lengths [B] int32
// (row b attends over cache positions 0 .. lengths[b] - 1, a prefix; taken
// as clamped to 1 .. S), out [B, 1, K, G, hd] in q's dtype.  bf16 or f32,
// contiguous, hd a power of two from 8 to 256, G <= 16.
//
// Arithmetic, as the plain version: scores in f32 from the operands'
// products, times scale (1/sqrt(f32(hd)), a launch argument); softmax in
// f32; the normalised weights rounded to the operands' dtype (bf16: as the
// reference's w.astype(q.dtype)); the weighted sum of V in f32; the output
// rounded once.  Positions past a row's length are never read: their
// weight in the plain version is exp(-1e30 - m) = 0 exactly.  Only the
// order of the f32 sums differs from the plain version.  No atomics: every
// sum runs in a fixed order, so a result repeats bit for bit.
//
// What bounds it on this card (NVIDIA H100 80GB HBM3, 3.35 TB/s by the data
// sheet): the live bf16 K and V bytes, read once.  A position costs 4 hd
// bytes and ~4 G hd operations, at most ~16 operations a byte (G = 16),
// far below the ~20 f32 operations a byte where the CUDA cores would bound
// it.  Everything that is not K or V (q, the f32 scores written and read
// again, the chunks' partial sums, out) is under 2% of the bytes at the
// serving shapes.
//
// Design: three kernels on the stream, each block 4 warps.
// - decode_attn_scores_kernel: a block per (chunk of C positions, KV head,
//   row).  A thread owns 8 consecutive elements of hd (hd / 8 threads a
//   row, so a warp covers 32 / (hd / 8) rows a load); it holds q's 8
//   elements of every head of the group in registers (the G query heads
//   share each K load), loads U rows of K ahead as 16-byte streaming loads,
//   and sums each row's dot product over its hd / 8 lanes by shuffles.  The
//   block's f32 scores go to shared memory, then to device memory with the
//   chunk's max and sum of exp(score - max) per head.
// - decode_attn_values_kernel: the same grid.  Each block folds the row's
//   chunk maxima and sums in a fixed order (a warp per head), weights its
//   chunk's positions (exp(score - max) / sum, rounded to the dtype), and
//   sums the weighted V rows, loaded as K was; the block's partial output
//   per head is written to device memory.
// - decode_attn_merge_kernel: a thread per output element sums the row's
//   chunks' partial outputs in chunk order and rounds once.
// How the chunks fill the card: blocks whose chunk starts past the row's
// length return at once, so the work follows the live positions.  C is the
// largest power of two up to 256 positions at which B * K * ceil(S / C)
// blocks still number 8 a streaming multiprocessor, and no less than 16:
// 256 at the serving cells (512 and 256 (row, head) pairs), 16 for one row
// of one KV head (a batch-1 ring of 2048 positions: 128 blocks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 8;                     // elements of a row a thread owns
constexpr int MAX_HEAD_DIM = 256;          // ref.py HEAD_DIMS: VEC .. 256
constexpr int MAX_GROUP = 16;              // ref.py MAX_GROUP
constexpr unsigned FULL = 0xffffffffu;

// 8 elements at p (16-byte aligned) as f32, streamed past the caches
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// w rounded to the operands' dtype and back (the plain version's
// w.to(q.dtype))
__device__ __forceinline__ float round_as(float w, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(w));
}
__device__ __forceinline__ float round_as(float w, const float*) { return w; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ int live(const int* lengths, int b, int S) {
  return min(max(lengths[b], 1), S);
}

// Pass A: the chunk's scores, and its max and sum of exp per head.
template <typename T, int GMAX, int U>
__global__ void __launch_bounds__(THREADS)
decode_attn_scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const int* __restrict__ lengths,
                          float* __restrict__ scores,
                          float* __restrict__ cmax, float* __restrict__ csum,
                          int S, int K, int G, int hd, int C, int NC,
                          float scale) {
  extern __shared__ float sm[];            // [G][C] the chunk's scores
  const int c = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int len = live(lengths, b, S);
  const int p0 = c * C;
  if (p0 >= len) return;
  const int n = min(C, len - p0);
  const int tpr = hd / VEC;                // threads a row
  const int seg = threadIdx.x & (tpr - 1);
  const int rl = threadIdx.x / tpr;        // the thread's row lane
  const int R = THREADS / tpr;             // rows a load of the block
  const long bk = (long)b * K + kh;

  float qr[GMAX][VEC];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      load8(q + (bk * G + g) * hd + seg * VEC, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[g][e] = 0.f;
    }
  }
  const long stride = (long)K * hd;        // between positions
  const T* kp = k + ((long)b * S * K + kh) * hd + seg * VEC
                + (long)p0 * stride;
  // a block-uniform loop: every lane reaches every shuffle
  for (int base = 0; base < n; base += R * U) {
    float kv[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * R + rl;
      if (i < n) {
        load8(kp + (long)i * stride, kv[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kv[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * R + rl;
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) d = __fmaf_rn(qr[g][e], kv[u][e], d);
        for (int off = tpr >> 1; off > 0; off >>= 1)
          d += __shfl_xor_sync(FULL, d, off);
        if (seg == 0 && i < n) sm[g * C + i] = d * scale;
      }
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < G; g += WARPS) {
    const float* s = sm + g * C;
    float m = -INFINITY;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, s[i]);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
    float t = 0.f;
    for (int i = lane; i < n; i += 32) t += expf(s[i] - m);
    for (int off = 16; off > 0; off >>= 1)
      t += __shfl_xor_sync(FULL, t, off);
    if (lane == 0) {
      cmax[(bk * G + g) * NC + c] = m;
      csum[(bk * G + g) * NC + c] = t;
    }
  }
  float* out = scores + bk * G * S + p0;   // scores [B, K, G, S]
  for (int j = threadIdx.x; j < G * n; j += THREADS) {
    const int g = j / n, i = j - g * n;
    out[(long)g * S + i] = sm[g * C + i];
  }
}

// Pass B: the row's softmax from every chunk's max and sum, the chunk's
// weights, and its partial weighted sum of V per head.
template <typename T, int GMAX, int U>
__global__ void __launch_bounds__(THREADS)
decode_attn_values_kernel(const T* __restrict__ v,
                          const int* __restrict__ lengths,
                          const float* __restrict__ scores,
                          const float* __restrict__ cmax,
                          const float* __restrict__ csum,
                          float* __restrict__ partial, int S, int K, int G,
                          int hd, int C, int NC) {
  extern __shared__ float sm[];
  float* w = sm;                           // [G][C] the chunk's weights
  float* red = sm + G * C;                 // [WARPS][hd] the warps' sums
  float* mt = red + WARPS * hd;            // [G][2] the row's max and sum
  const int c = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int len = live(lengths, b, S);
  const int p0 = c * C;
  if (p0 >= len) return;
  const int n = min(C, len - p0);
  const int nlive = (len + C - 1) / C;
  const int tpr = hd / VEC;
  const int seg = threadIdx.x & (tpr - 1);
  const int rl = threadIdx.x / tpr;
  const int R = THREADS / tpr;
  const long bk = (long)b * K + kh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int g = warp; g < G; g += WARPS) {
    const float* cm = cmax + (bk * G + g) * NC;
    const float* cs = csum + (bk * G + g) * NC;
    float m = -INFINITY;
    for (int j = lane; j < nlive; j += 32) m = fmaxf(m, cm[j]);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
    float t = 0.f;
    for (int j = lane; j < nlive; j += 32) t += cs[j] * expf(cm[j] - m);
    for (int off = 16; off > 0; off >>= 1)
      t += __shfl_xor_sync(FULL, t, off);
    if (lane == 0) {
      mt[2 * g] = m;
      mt[2 * g + 1] = t;
    }
  }
  __syncthreads();
  const float* sc = scores + bk * G * S + p0;
  for (int j = threadIdx.x; j < G * n; j += THREADS) {
    const int g = j / n, i = j - g * n;
    w[g * C + i] = round_as(expf(sc[(long)g * S + i] - mt[2 * g])
                            / mt[2 * g + 1], v);
  }
  __syncthreads();

  float acc[GMAX][VEC];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  const long stride = (long)K * hd;
  const T* vp = v + ((long)b * S * K + kh) * hd + seg * VEC
                + (long)p0 * stride;
  for (int base = 0; base < n; base += R * U) {
    float vv[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * R + rl;
      if (i < n) {
        load8(vp + (long)i * stride, vv[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) vv[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * R + rl;
      if (i >= n) continue;
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        const float wt = w[g * C + i];
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[g][e] = __fmaf_rn(wt, vv[u][e], acc[g][e]);
      }
    }
  }
  // the row lanes' sums: within a warp by shuffles, across warps in
  // shared memory, both in a fixed order
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
    for (int off = tpr; off < 32; off <<= 1) {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], off);
    }
    if (lane < tpr) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) red[warp * hd + seg * VEC + e] = acc[g][e];
    }
    __syncthreads();
    for (int x = threadIdx.x; x < hd; x += THREADS) {
      float s = red[x];
      for (int r = 1; r < WARPS; ++r) s += red[r * hd + x];
      partial[((bk * G + g) * NC + c) * hd + x] = s;
    }
    __syncthreads();
  }
}

// Pass C: out = the chunks' partial sums in chunk order, rounded once.
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attn_merge_kernel(const int* __restrict__ lengths,
                         const float* __restrict__ partial,
                         T* __restrict__ out, int S, int K, int G, int hd,
                         int C, int NC, long total) {
  const long idx = (long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const long bkg = idx / hd;
  const int x = (int)(idx - bkg * hd);
  const int b = (int)(bkg / ((long)K * G));
  const int nlive = (live(lengths, b, S) + C - 1) / C;
  const float* p = partial + bkg * NC * hd + x;
  float s = p[0];
  for (int j = 1; j < nlive; ++j) s += p[(long)j * hd];
  store(out + idx, s);
}

template <typename T, int GMAX, int U>
int run(const T* q, const T* k, const T* v, const int* lengths, T* out,
        float* scores, float* cmax, float* csum, float* partial, int B,
        int S, int K, int G, int hd, int C, float scale,
        cudaStream_t stream) {
  const int NC = (S + C - 1) / C;
  const dim3 grid(NC, K, B);
  const size_t smem_a = sizeof(float) * G * C;
  const size_t smem_b = sizeof(float) * (G * C + WARPS * hd + 2 * G);
  decode_attn_scores_kernel<T, GMAX, U><<<grid, THREADS, smem_a, stream>>>(
      q, k, lengths, scores, cmax, csum, S, K, G, hd, C, NC, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_attn_values_kernel<T, GMAX, U><<<grid, THREADS, smem_b, stream>>>(
      v, lengths, scores, cmax, csum, partial, S, K, G, hd, C, NC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long total = (long)B * K * G * hd;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  decode_attn_merge_kernel<T><<<blocks, THREADS, 0, stream>>>(
      lengths, partial, out, S, K, G, hd, C, NC, total);
  return (int)cudaGetLastError();
}

// the instance for G heads a group: the register arrays are sized by the
// next power of two, and fewer rows are loaded ahead as they grow
template <typename T>
int dispatch(const T* q, const T* k, const T* v, const int* lengths, T* out,
             float* scores, float* cmax, float* csum, float* partial, int B,
             int S, int K, int G, int hd, int C, float scale,
             cudaStream_t stream) {
#define DECODE_ATTN_RUN(GM, U)                                              \
  return run<T, GM, U>(q, k, v, lengths, out, scores, cmax, csum, partial, \
                       B, S, K, G, hd, C, scale, stream)
  if (G <= 1) DECODE_ATTN_RUN(1, 4);
  if (G <= 2) DECODE_ATTN_RUN(2, 4);
  if (G <= 4) DECODE_ATTN_RUN(4, 4);
  if (G <= 8) DECODE_ATTN_RUN(8, 2);
  DECODE_ATTN_RUN(16, 1);
#undef DECODE_ATTN_RUN
}

}  // namespace

// q, k, v, out: device pointers of the dtype (bf16 = 1, else f32); lengths
// int32 [B]; scores [B, K, G, S], cmax and csum [B, K, G, ceil(S / C)],
// partial [B, K, G, ceil(S / C), hd], all f32 scratch.  Returns the CUDA
// error of the launches (0 on success).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* lengths, void* out, float* scores,
                                float* cmax, float* csum, float* partial,
                                int bf16, int B, int S, int K, int G, int hd,
                                int C, float scale, void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || G <= 0 || G > MAX_GROUP || C <= 0 ||
      hd < VEC || hd > MAX_HEAD_DIM || (hd & (hd - 1)) != 0 || B > 65535 ||
      K > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch(static_cast<const __nv_bfloat16*>(q),
                    static_cast<const __nv_bfloat16*>(k),
                    static_cast<const __nv_bfloat16*>(v), lengths,
                    static_cast<__nv_bfloat16*>(out), scores, cmax, csum,
                    partial, B, S, K, G, hd, C, scale, s);
  return dispatch(static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), lengths,
                  static_cast<float*>(out), scores, cmax, csum, partial, B,
                  S, K, G, hd, C, scale, s);
}
