// RG-LRU linear recurrence h_t = exp(log_a_t) * h_{t-1} + b_t for Hopper
// (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan/kernel.py:64
// rglru_scan (its blocked decay-matrix _kernel).  The plain version is
// repro_torch/kernels/rglru_scan/ref.py lru_ref, the sequential
// recurrence; this kernel runs the same recurrence in the same order (expf,
// then one multiply and one add, each rounded: the library is built with
// -fmad=false and without fast math, and the two operations are written
// as __fmul_rn / __fadd_rn), so the two agree bit for bit.
//
// Layout: log_a, b, h [B, S, C] f32, contiguous.  Any B, S and C.
//
// What bounds it on this card (NVIDIA H100 80GB HBM3, 700 W; 3.35 TB/s by
// the data sheet): it reads 8 bytes and writes 4 per element and does ~3
// operations on them, so bytes bound it.  Only one multiply and one add of
// each step depend on h_{t-1}: ~8 cycles a step, 2304 steps in ~0.01 ms,
// under the 0.021 ms that the bytes of a 2304-token prompt at full width
// take.  What has to be paid for is bytes in flight that cover the
// memory's latency (Little's law: ~2.5-3 MB across the card).  Measured on
// that card (PERF.md §6): about 2.2 TB/s, 67-72% of the bound; probe
// builds ran the loads alone at 2.5 TB/s and showed the recurrence's chain
// costing nothing, so the 64-byte row segments of a block's loads and
// stores hold it.
//
// The design: narrow channel blocks fed by a staged ring over S.
// - A block owns W = 16 consecutive channels of one batch row, so B * C / W
//   blocks fill the card's 132 SMs (160 at B = 1, C = 2560).  Serving
//   prefills one request at a time, so B = 1 decides: there, in
//   launch/probe_rglru.py's A/B on that card (W = 8 and 32, 3 and 6
//   stages), W = 16 was the fastest and 4 stages tied with 6, the smaller
//   ring (PERF.md §6 has the batched reading too).
// - Its operands go through a ring of STAGES = 4 shared-memory stages, each
//   a tile of T = 1024 / W = 64 steps x W channels of log_a and of b.  One
//   producer warp keeps the ring full: by TMA (two 3-d boxes a tile, full
//   / empty mbarriers) where C % 4 == 0 and both operands are 16-byte
//   aligned, else by 4-byte cp.async copies into the same ring, each lane
//   arriving on the tile's full barrier when its copies land.
// - Two exp warps compute a = expf(log_a) of a tile into a third array of
//   the stage, off the recurrence's dependency chain.
// - One warp runs the recurrence, lane j on channel j, step by step in S
//   order, reading a and b from the stage G steps ahead of use and storing
//   h directly (W channels of one step a 4-byte store each), then frees
//   the stage.
// - Ragged tiles: TMA reads zero past the tensor's end, cp.async skips
//   those elements; no step past S is taken and no channel past C stored.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 1024;                // steps x channels of one stage
constexpr int W = 16;                     // channels of a block
constexpr int T = TILE / W;               // steps of a stage
constexpr int STAGES = 4;                 // stages of the ring
constexpr int EXP_WARPS = 2;
constexpr int EXP_THREADS = 32 * EXP_WARPS;
constexpr int THREADS = 32 * (EXP_WARPS + 2);  // + producer, recurrence
constexpr int NARR = 3;                   // arrays of a stage: la, b, a
constexpr int G = 16;                     // steps loaded ahead of use
constexpr uint32_t ARR = TILE * 4;        // bytes of one [T][W] array
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}
// TMA: one box of a 3-d tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}
// arrive on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// Ring position of tile k: stage s, and the parity of that stage's phase.
struct Ring {
  int s = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++s == stages) {
      s = 0;
      phase ^= 1u;
    }
  }
};

// Grid: one block per (batch row, W channels), channels fastest.  Block:
// warp 0 the producer, warps 1..EXP_WARPS the exp warps, the last warp the
// recurrence.  tm_a, tm_b: TMA maps of log_a and b [B, S, C] with boxes of
// W x T x 1 (tma != 0; else cp.async copies).  stages is always STAGES,
// passed as an argument: the code nvcc made with the constant in its
// place took 7% longer at [1, 2304, 2560] on an NVIDIA H100 80GB HBM3 at
// 700 W (PERF.md §6).  Each stage holds
// la, b, a [T][W]; after the stages, the full, ready and empty mbarriers
// of each stage.
__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_b,
                  const float* __restrict__ log_a,
                  const float* __restrict__ b, float* __restrict__ h,
                  int seq, int ch, int stages, int tma) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 127u) & ~127u;
  uint8_t* const sm = smem_raw + (base - smem_u32(smem_raw));
  // array `arr` of stage s: shared address and generic pointer
  auto arr_u32 = [&](int s, int arr) {
    return base + (uint32_t)(s * NARR + arr) * ARR;
  };
  auto arr_ptr = [&](int s, int arr) {
    return reinterpret_cast<float*>(sm + (size_t)(s * NARR + arr) * ARR);
  };
  const uint32_t bars = base + (uint32_t)(stages * NARR) * ARR;
  const uint32_t full = bars, ready = bars + 8 * stages,
                 empty = bars + 16 * stages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cblocks = (ch + W - 1) / W;
  const int n = blockIdx.x / cblocks;
  const int c0 = (blockIdx.x - n * cblocks) * W;
  const int ntiles = (seq + T - 1) / T;
  const long row = (long)n * seq * ch;   // offset of batch row n

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, tma ? 1u : 32u);
      mbar_init(ready + 8 * s, EXP_THREADS);
      mbar_init(empty + 8 * s, W);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // producer: tile k goes to stage k % stages once the recurrence is
    // done with tile k - stages
    if (tma && lane != 0) return;
    Ring r;
    for (int k = 0; k < ntiles; ++k, r.next(stages)) {
      if (k >= stages) mbar_wait(empty + 8 * r.s, r.phase ^ 1u);
      const uint32_t bar = full + 8 * r.s;
      if (tma) {
        mbar_arrive_tx(bar, 2 * ARR);
        tma_load(arr_u32(r.s, 0), tm_a, bar, c0, k * T, n);
        tma_load(arr_u32(r.s, 1), tm_b, bar, c0, k * T, n);
        continue;
      }
      const long off = row + (long)k * T * ch + c0;
      for (int i = lane; i < TILE; i += 32) {
        const int u = i / W, j = i % W;
        if (k * T + u < seq && c0 + j < ch) {
          const long e = off + (long)u * ch + j;
          cp_async4(arr_u32(r.s, 0) + 4 * i, log_a + e);
          cp_async4(arr_u32(r.s, 1) + 4 * i, b + e);
        }
      }
      cp_async_arrive(bar);
    }
    return;
  }

  if (warp <= EXP_WARPS) {
    // exp warps: a = expf(log_a) of each tile
    Ring r;
    for (int k = 0; k < ntiles; ++k, r.next(stages)) {
      mbar_wait(full + 8 * r.s, r.phase);
      const float* la = arr_ptr(r.s, 0);
      float* a = arr_ptr(r.s, 2);
      for (int i = tid - 32; i < TILE; i += EXP_THREADS) a[i] = expf(la[i]);
      mbar_arrive(ready + 8 * r.s);
    }
    return;
  }

  // the recurrence: lane j on channel c0 + j, step by step
  if (lane >= W) return;
  const bool live = c0 + lane < ch;
  float* hp = h + row + c0 + lane;
  float hv = 0.f;
  Ring r;
  for (int k = 0; k < ntiles; ++k, r.next(stages)) {
    // the full barrier too: b came by TMA, and its phase is complete
    mbar_wait(full + 8 * r.s, r.phase);
    mbar_wait(ready + 8 * r.s, r.phase);
    const float* a = arr_ptr(r.s, 2) + lane;
    const float* x = arr_ptr(r.s, 1) + lane;
    float* y = hp + (long)k * T * ch;
    const int steps = min(T, seq - k * T);
    if (steps == T) {
      // a full tile in groups of G steps, each group's operands loaded
      // before the steps of the group ahead of it run, so shared-memory
      // latency stays off the chain
      float av[G], xv[G];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        av[u] = a[u * W];
        xv[u] = x[u * W];
      }
#pragma unroll
      for (int g = 0; g < T; g += G) {
        float an[G], xn[G];
        if (g + G < T) {
#pragma unroll
          for (int u = 0; u < G; ++u) {
            an[u] = a[(g + G + u) * W];
            xn[u] = x[(g + G + u) * W];
          }
        }
#pragma unroll
        for (int u = 0; u < G; ++u) {
          hv = __fadd_rn(__fmul_rn(av[u], hv), xv[u]);
          if (live) y[(long)(g + u) * ch] = hv;
        }
        if (g + G < T) {
#pragma unroll
          for (int u = 0; u < G; ++u) {
            av[u] = an[u];
            xv[u] = xn[u];
          }
        }
      }
    } else {
      for (int u = 0; u < steps; ++u) {
        hv = __fadd_rn(__fmul_rn(a[u * W], hv), x[u * W]);
        if (live) y[(long)u * ch] = hv;
      }
    }
    mbar_arrive(empty + 8 * r.s);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query, so the library links no more than the CUDA runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// TMA map of an f32 tensor [batch, seq, ch] (row-major, 16-byte aligned,
// ch % 4 == 0) with boxes of W x T x 1, no swizzle; elements past the end
// of a dimension read as zero.
int encode(CUtensorMap* map, const void* ptr, long batch, long seq,
           long ch) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)ch, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)ch * 4,
                                 (cuuint64_t)seq * ch * 4};
  const cuuint32_t box[3] = {(cuuint32_t)W, (cuuint32_t)T, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of a launch: the stages and their barriers, and
// 128 bytes to align the first stage.
constexpr size_t SMEM_BYTES = 128 + (size_t)STAGES * NARR * ARR +
                              (size_t)STAGES * 8 * 3;

}  // namespace

// C interface: contiguous f32 device tensors log_a, b, h [batch, seq, ch];
// tma != 0 for TMA copies (ch % 4 == 0 and log_a, b 16-byte aligned; the
// binding's plan decides), else cp.async; the current CUDA stream.
// Returns cudaGetLastError() (or the error of the opt-in or of a tensor
// map); 1 (cudaErrorInvalidValue) for a length past the kernel's ints.
extern "C" int rglru_scan(const float* log_a, const float* b, float* h,
                          long batch, long seq, long ch, int tma,
                          void* stream) {
  if (seq > 0x7fffffffL || ch > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  if (batch * seq * ch == 0) return (int)cudaSuccess;
  // the shared-memory opt-in, once per device (the attribute persists;
  // setting it at every launch costs host time)
  static bool opted[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(rglru_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    opted[dev] = true;
  }
  CUtensorMap maps[2] = {};
  if (tma) {
    int e = encode(&maps[0], log_a, batch, seq, ch);
    if (e == (int)cudaSuccess) e = encode(&maps[1], b, batch, seq, ch);
    if (e != (int)cudaSuccess) return e;
  }
  const long blocks = batch * ((ch + W - 1) / W);
  rglru_scan_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES,
                      static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], log_a, b, h, (int)seq, (int)ch, STAGES, tma);
  return (int)cudaGetLastError();
}
