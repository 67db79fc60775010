// Flash-attention forward (GQA, causal / local window, q_offset) for
// Hopper (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// kernel.py:93 flash_attention_fwd (its _kernel).  The plain version is
// repro_torch/kernels/flash_attention/ref.py attention_ref (full softmax
// in f32); the two agree to rounding.
//
// Layout: q [B, K, G, Sq, hd], k/v [B, K, Skv, hd], out like q; f32 or bf16
// in, the same dtype out, f32 inside.  Constants and order as the
// reference: q is scaled by 1/sqrt(f32(hd)) before the dot, masked scores
// are -1e30, the result is acc / max(l, 1e-30).
//
// What bounds it on this card: at the serving shapes (Sq = Skv in the
// thousands, hd 64-256) the QK and PV products, ~4 Sq Skv_visible hd G
// operations per slab, far outweigh the bytes (each of q, k, v, out moved
// once), so operations bound it.  This first kernel runs them on the f32
// CUDA cores, not the tensor cores, and its inner loops read 4 bytes of
// shared memory for every two fused multiply-adds (one K or V element for
// a warp's two pairs), so shared-memory bandwidth holds it below even the
// f32 peak; a tensor-core kernel is later work.
//
// Design: one block of 8 warps per 16 (query row, head) pairs of one
// (batch, KV head) slab, pairs taken row-major (row r, heads 0..G-1), so
// the G heads of a KV head share every K/V tile and repeated KV is never
// built.  Each warp owns 2 pairs; lane l owns head-dim elements l + 32 i,
// holding q (scaled) and the f32 accumulator in registers.  The block
// stages 32 keys of K and V at a time in shared memory (f32, 256 hd bytes:
// 64 KB at hd 256, above the default 48 KB, so the launcher opts in) and
// walks only the tiles its rows can see (causal and window bounds): fully
// masked tiles are skipped.  Per tile a lane forms partial dots of its
// elements with all 32 keys; a transposing butterfly (31 shuffles) leaves
// lane j with the score of key j.  The online softmax (running max m,
// denominator l, rescale of acc) uses warp shuffles for the tile's max and
// sum, and the P V product broadcasts each probability with a shuffle.
// Dot products use explicit fmaf (the library is built with -fmad=false,
// which forbids only the compiler's own contraction).  The ragged ends of
// Sq and Skv are masked in the kernel; nothing is padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_HEAD_DIM = 256;
constexpr int TILE_KV = 32;               // keys per tile: one per lane
constexpr int WARPS = 8;
constexpr int PAIRS = 2;                  // (query row, head) pairs a warp
constexpr int PAIRS_PER_BLOCK = WARPS * PAIRS;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float ld(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, long i, float x) { p[i] = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, long i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

// One step of the transposing butterfly: lanes with bit OFF set keep the
// upper half of their entries, the others the lower half, each adding its
// partner's copy.  After the steps 16, 8, 4, 2, 1 entry 0 of lane j holds
// the warp's sum of entry j.
template <int OFF>
__device__ __forceinline__ void fold(float (&v)[TILE_KV], int lane) {
  const bool up = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = up ? v[i] : v[i + OFF];
    const float keep = up ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, OFF);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// HPL: head-dim elements a lane owns (hd <= 32 HPL).
template <typename T, int HPL>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int groups,
                 int sq, int skv, int hd, int causal, int window,
                 int q_offset, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                       // [TILE_KV][hd]
  float* vs = smem + TILE_KV * hd;        // [TILE_KV][hd]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long slab = blockIdx.y;           // b * K + kv head
  const long n_pairs = (long)sq * groups;
  const long first = (long)blockIdx.x * PAIRS_PER_BLOCK;
  const long end = first + PAIRS_PER_BLOCK;
  const long last = (end < n_pairs ? end : n_pairs) - 1;

  // the keys the block's rows can see
  const int q_first = (int)(first / groups) + q_offset;
  const int q_last = (int)(last / groups) + q_offset;
  int kv_lo = 0, kv_hi = skv;
  if (window > 0) kv_lo = max(0, q_first - window + 1);
  if (causal) kv_hi = min(skv, q_last + 1);

  float qv[PAIRS][HPL], acc[PAIRS][HPL], m[PAIRS], l[PAIRS];
  int q_pos[PAIRS];
  long base[PAIRS];
  bool live[PAIRS];
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    const long pair = first + warp * PAIRS + p;
    live[p] = pair < n_pairs;
    const long r = live[p] ? pair / groups : 0;
    const long g = live[p] ? pair - r * groups : 0;
    q_pos[p] = (int)r + q_offset;
    base[p] = ((slab * groups + g) * sq + r) * hd;
#pragma unroll
    for (int i = 0; i < HPL; ++i) {
      const int e = lane + 32 * i;
      qv[p][i] = (live[p] && e < hd) ? ld(q, base[p] + e) * scale : 0.f;
      acc[p][i] = 0.f;
    }
    m[p] = NEG_INF;
    l[p] = 0.f;
  }

  const long kv_base = slab * (long)skv * hd;
  for (int t0 = (kv_lo / TILE_KV) * TILE_KV; t0 < kv_hi; t0 += TILE_KV) {
    __syncthreads();                      // the previous tile is consumed
    const int n = min(TILE_KV, skv - t0) * hd;
    for (int idx = threadIdx.x; idx < TILE_KV * hd; idx += blockDim.x) {
      const long src = kv_base + (long)t0 * hd + idx;
      ks[idx] = idx < n ? ld(k, src) : 0.f;
      vs[idx] = idx < n ? ld(v, src) : 0.f;
    }
    __syncthreads();

    // scores: partial dots of this lane's elements with every key
    float part[PAIRS][TILE_KV];
#pragma unroll
    for (int j = 0; j < TILE_KV; ++j) {
      float kj[HPL];
#pragma unroll
      for (int i = 0; i < HPL; ++i) {
        const int e = lane + 32 * i;
        kj[i] = e < hd ? ks[j * hd + e] : 0.f;
      }
#pragma unroll
      for (int p = 0; p < PAIRS; ++p) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < HPL; ++i) s = fmaf(qv[p][i], kj[i], s);
        part[p][j] = s;
      }
    }

    // online softmax: lane j holds key t0 + j
    const int kv_pos = t0 + lane;
    float prob[PAIRS];
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      fold<16>(part[p], lane);
      fold<8>(part[p], lane);
      fold<4>(part[p], lane);
      fold<2>(part[p], lane);
      fold<1>(part[p], lane);
      bool ok = kv_pos < skv;
      if (causal) ok = ok && kv_pos <= q_pos[p];
      if (window > 0) ok = ok && kv_pos > q_pos[p] - window;
      const float s = ok ? part[p][0] : NEG_INF;
      const float m_new = fmaxf(m[p], warp_max(s));
      prob[p] = expf(s - m_new);
      const float corr = expf(m[p] - m_new);
      l[p] = l[p] * corr + warp_sum(prob[p]);
#pragma unroll
      for (int i = 0; i < HPL; ++i) acc[p][i] *= corr;
      m[p] = m_new;
    }

    // acc += P V
#pragma unroll
    for (int j = 0; j < TILE_KV; ++j) {
      float vj[HPL];
#pragma unroll
      for (int i = 0; i < HPL; ++i) {
        const int e = lane + 32 * i;
        vj[i] = e < hd ? vs[j * hd + e] : 0.f;
      }
#pragma unroll
      for (int p = 0; p < PAIRS; ++p) {
        const float pj = __shfl_sync(FULL, prob[p], j);
#pragma unroll
        for (int i = 0; i < HPL; ++i) acc[p][i] = fmaf(pj, vj[i], acc[p][i]);
      }
    }
  }

#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    if (!live[p]) continue;
    const float den = fmaxf(l[p], 1e-30f);
#pragma unroll
    for (int i = 0; i < HPL; ++i) {
      const int e = lane + 32 * i;
      if (e < hd) st(out, base[p] + e, acc[p][i] / den);
    }
  }
}

template <typename T, int HPL>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int kh, int g, int sq, int skv, int hd, int causal, int window,
           int q_offset, float scale, cudaStream_t stream) {
  const size_t smem = 2 * TILE_KV * (size_t)hd * sizeof(float);
  auto kern = flash_fwd_kernel<T, HPL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long n_pairs = (long)sq * g;
  const dim3 grid((unsigned)((n_pairs + PAIRS_PER_BLOCK - 1) /
                             PAIRS_PER_BLOCK),
                  (unsigned)(b * kh));
  kern<<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), g, sq, skv, hd, causal,
      window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int b,
             int kh, int g, int sq, int skv, int hd, int causal, int window,
             int q_offset, float scale, cudaStream_t s) {
  if (hd <= 32)
    return launch<T, 1>(q, k, v, out, b, kh, g, sq, skv, hd, causal, window,
                        q_offset, scale, s);
  if (hd <= 64)
    return launch<T, 2>(q, k, v, out, b, kh, g, sq, skv, hd, causal, window,
                        q_offset, scale, s);
  if (hd <= 128)
    return launch<T, 4>(q, k, v, out, b, kh, g, sq, skv, hd, causal, window,
                        q_offset, scale, s);
  return launch<T, 8>(q, k, v, out, b, kh, g, sq, skv, hd, causal, window,
                      q_offset, scale, s);
}

}  // namespace

// C interface: contiguous device tensors q [b, kh, g, sq, hd], k and v
// [b, kh, skv, hd], out like q; bf16 != 0 for bf16 operands, else f32;
// hd <= 256; window <= 0 for no window; scale = 1/sqrt(f32(hd)); the
// current CUDA stream.  Returns cudaGetLastError() (or the error of the
// shared-memory opt-in); 1 (cudaErrorInvalidValue) for a bad hd.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int bf16, int b,
                                   int kh, int g, int sq, int skv, int hd,
                                   int causal, int window, int q_offset,
                                   float scale, void* stream) {
  if (hd <= 0 || hd > MAX_HEAD_DIM) return (int)cudaErrorInvalidValue;
  if ((long)b * kh * g * sq == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, b, kh, g, sq, skv, hd,
                                   causal, window, q_offset, scale, s);
  return dispatch<float>(q, k, v, out, b, kh, g, sq, skv, hd, causal, window,
                         q_offset, scale, s);
}
