// RG-LRU linear recurrence h_t = exp(log_a_t) * h_{t-1} + b_t for Hopper
// (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan/kernel.py:64
// rglru_scan (its blocked decay-matrix _kernel).  The plain version is
// repro_torch/kernels/rglru_scan/ref.py lru_ref, the sequential
// recurrence; this kernel runs the same recurrence in the same order (expf,
// then one multiply and one add, each rounded: the library is built with
// -fmad=false and without fast math), so the two agree bit for bit.
//
// Layout: log_a, b, h [B, S, C] f32, contiguous.  Any S (the TPU kernel
// asks for S % 128 == 0; the serving path's prompts have any length).
//
// What bounds it on this card: it reads 8 bytes and writes 4 per element
// and does ~3 operations on them, so bytes bound it.  The design is one
// thread per (batch, channel), consecutive threads on consecutive channels
// so every load and store of a warp is coalesced; the loop over S is
// sequential, with the loads of 8 steps issued ahead of their use so that
// memory latency overlaps.  At B = 1, C = 2560 that is 2560 threads (80
// warps, under one a streaming multiprocessor): latency, not bandwidth,
// holds it there; a chunked-parallel scan over S is later work.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int AHEAD = 8;                  // steps whose loads go first

__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const float* __restrict__ log_a,
                  const float* __restrict__ b, float* __restrict__ h,
                  long batch, long seq, long ch) {
  const long idx = (long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= batch * ch) return;
  const long n = idx / ch;
  const long c = idx - n * ch;
  const long off = n * seq * ch + c;
  const float* la = log_a + off;
  const float* x = b + off;
  float* y = h + off;
  float hv = 0.f;
  long t = 0;
  for (; t + AHEAD <= seq; t += AHEAD) {
    float a[AHEAD], xb[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      a[u] = la[(t + u) * ch];
      xb[u] = x[(t + u) * ch];
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      hv = expf(a[u]) * hv + xb[u];
      y[(t + u) * ch] = hv;
    }
  }
  for (; t < seq; ++t) {
    hv = expf(la[t * ch]) * hv + x[t * ch];
    y[t * ch] = hv;
  }
}

}  // namespace

// C interface: contiguous f32 device tensors log_a, b, h [batch, seq, ch];
// the current CUDA stream; returns cudaGetLastError().
extern "C" int rglru_scan(const float* log_a, const float* b, float* h,
                          long batch, long seq, long ch, void* stream) {
  const long n = batch * ch;
  if (n > 0 && seq > 0) {
    const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    rglru_scan_kernel<<<blocks, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(log_a, b, h,
                                                             batch, seq, ch);
  }
  return (int)cudaGetLastError();
}
