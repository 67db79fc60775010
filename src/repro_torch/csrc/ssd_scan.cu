// Mamba2 SSD chunked scan for Hopper (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py:81
// ssd_scan (its _kernel).  The plain versions are repro_torch/kernels/
// ssd_scan/ref.py ssd_ref (the sequential recurrence) and repro_torch/
// models/ssm.py ssd_chunked (the chunked closed form the reference's model
// runs); the three agree to rounding.
//
// Function, per batch row and head h with A = -exp(a_log[h]):
//   state_t = exp(dt_t A) state_{t-1} + dt_t x_t B_t^T       [P, N]
//   y_t     = state_t C_t                                    [P]
// Layout: x, y [B, S, H, P]; dt [B, S, H]; b, c [B, S, N] (one group,
// shared by the heads); a_log [H]; initial state (optional; zero if
// absent) and final state [B, H, P, N]; all f32, contiguous.  Any S,
// N <= 128, any P.
//
// Chunked form, as the TPU kernel: for a chunk of Q steps with cs = the
// cumulative sum of dt A inside it,
//   y     = ((C B^T) . L) (dt x) + exp(cs) . (C state^T),
//           L[i, j] = exp(cs_i - cs_j) for i >= j, else 0
//   state = exp(cs_last) state + (dt x)^T (exp(cs_last - cs) . B)
// L is masked before the exp, so nothing above the diagonal overflows.  A
// ragged last chunk is staged with dt = 0 and x, B, C = 0 in its missing
// rows: their decay is exp(0) = 1 and their update 0, so the real rows and
// the final state are those of the unpadded sequence.
//
// What bounds it on this card: per (batch, head) and chunk the four
// products take 2 (Q^2 N + Q^2 P + 2 Q N P) operations, while the bytes
// moved are 4 (2 Q P + Q + 2 Q N / H) (x in, y out, dt, and B and C shared
// by the H heads), so operations bound it: at mamba2-2.7b's N = 128,
// P = 64, H = 80 and Q = 64 about 110 operations per byte, against the
// card's f32 ridge of 20.  (The function itself needs fewer operations,
// about 35,000 per step and head at the best chunk of 16 against this
// kernel's 57,344 at Q = 64: chip_smoke.py ssd_ops_per_step.)
// This first kernel runs them on the f32 CUDA cores from shared memory,
// which holds it well below the f32 peak (shared-memory loads, not FMAs,
// are its busiest pipe); tensor cores (mma.sync / wgmma) are later work.
//
// Design: one block of 8 warps per (batch, head, tile of PT = 64 columns
// of P), looping over the chunks in order (the TPU grid's sequential
// chunk axis) with the tile's [PT, N] state in shared memory.  Per chunk
// the block stages dt, C, B (rows padded to N + 1 floats, so lanes that
// walk rows hit distinct banks) and dt x in shared memory (about 130 KB
// at N = 128, above the default 48 KB, so the launcher opts in), then
//   1. M = (C B^T) . L: a warp owns 8 rows, a lane 2 columns;
//   2. y: a warp owns 8 rows, a lane 2 columns of the tile;
//   3. the state: a warp owns 8 columns of the tile, a lane 4 of N.
// Dot products use explicit fmaf (the library is built with -fmad=false,
// which forbids only the compiler's own contraction).

#include <cuda_runtime.h>

namespace {

constexpr int Q = 64;                     // steps per chunk
constexpr int PT = 64;                    // columns of P per block
constexpr int MAX_N = 128;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = Q / WARPS;  // phases 1 and 2
constexpr int COLS_PER_LANE = PT / 32;    // phase 2
constexpr int P_PER_WARP = PT / WARPS;    // phase 3
constexpr int N_PER_LANE = MAX_N / 32;    // phase 3

// Shared memory, in floats, for state size n.
__host__ __device__ constexpr long smem_floats(int n) {
  return 4L * Q                           // dts, cs, decay_in, decay_out
         + 2L * Q * (n + 1)               // C, B
         + (long)Q * PT                   // dt x
         + (long)Q * (Q + 1)              // M
         + (long)PT * (n + 1);            // state
}

__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ b, const float* __restrict__ c,
                const float* __restrict__ a_log,
                const float* __restrict__ init, float* __restrict__ y,
                float* __restrict__ fs, int seq, int heads, int hp, int n) {
  extern __shared__ float smem[];
  const int ns = n + 1;
  float* dts = smem;                      // dt of the chunk's steps
  float* cs = dts + Q;                    // cumulative dt A
  float* din = cs + Q;                    // exp(cs): decay into the chunk
  float* dout = din + Q;                  // exp(cs_last - cs): to its end
  float* Cs = dout + Q;                   // [Q][ns]
  float* Bs = Cs + Q * ns;                // [Q][ns]
  float* Xs = Bs + Q * ns;                // [Q][PT]  dt x
  float* M = Xs + Q * PT;                 // [Q][Q + 1]
  float* St = M + Q * (Q + 1);            // [PT][ns]

  const int tiles = (hp + PT - 1) / PT;
  const int h = blockIdx.x / tiles;
  const int p0 = (blockIdx.x - h * tiles) * PT;
  const long bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float A = -expf(a_log[h]);
  const long step = (long)heads * hp;     // x, y stride of one step
  const float* xb = x + bi * seq * step + (long)h * hp + p0;
  float* yb = y + bi * seq * step + (long)h * hp + p0;
  const float* dtb = dt + bi * seq * heads + h;
  const float* bb = b + bi * seq * n;
  const float* cb = c + bi * seq * n;

  const long f0 = ((bi * heads + h) * hp + p0) * (long)n;  // tile in fs
  for (int i = tid; i < PT * ns; i += THREADS) {
    const int p = i / ns, k = i - p * ns;
    St[i] = (init && k < n && p0 + p < hp) ? init[f0 + (long)p * n + k] : 0.f;
  }

  for (int t0 = 0; t0 < seq; t0 += Q) {
    const int q = min(Q, seq - t0);
    if (tid < Q) {
      const float d = tid < q ? dtb[(long)(t0 + tid) * heads] : 0.f;
      dts[tid] = d;
      cs[tid] = d * A;
    }
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < Q; ++i) cs[i] = run = run + cs[i];
    }
    for (int e = tid; e < Q * n; e += THREADS) {
      const int i = e / n, k = e - i * n;
      const bool in = i < q;
      Cs[i * ns + k] = in ? cb[(long)(t0 + i) * n + k] : 0.f;
      Bs[i * ns + k] = in ? bb[(long)(t0 + i) * n + k] : 0.f;
    }
    for (int e = tid; e < Q * PT; e += THREADS) {
      const int i = e / PT, p = e - i * PT;
      Xs[e] = (i < q && p0 + p < hp)
                  ? xb[(long)(t0 + i) * step + p] * dts[i] : 0.f;
    }
    __syncthreads();

    // 1. M = (C B^T) . L, and the chunk's decays
    if (tid < Q) {
      din[tid] = expf(cs[tid]);
      dout[tid] = expf(cs[Q - 1] - cs[tid]);
    }
    {
      const int i0 = warp * ROWS_PER_WARP;
      const bool upper = i0 + ROWS_PER_WARP - 1 >= 32;   // column lane + 32
      float acc0[ROWS_PER_WARP], acc1[ROWS_PER_WARP];
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) acc0[r] = acc1[r] = 0.f;
      for (int k = 0; k < n; ++k) {
        const float b0 = Bs[lane * ns + k];
        const float b1 = upper ? Bs[(lane + 32) * ns + k] : 0.f;
#pragma unroll
        for (int r = 0; r < ROWS_PER_WARP; ++r) {
          const float cv = Cs[(i0 + r) * ns + k];
          acc0[r] = fmaf(cv, b0, acc0[r]);
          acc1[r] = fmaf(cv, b1, acc1[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) {
        const int i = i0 + r;
        const int j0 = lane, j1 = lane + 32;
        M[i * (Q + 1) + j0] =
            j0 <= i ? acc0[r] * expf(cs[i] - cs[j0]) : 0.f;
        M[i * (Q + 1) + j1] =
            j1 <= i ? acc1[r] * expf(cs[i] - cs[j1]) : 0.f;
      }
    }
    __syncthreads();

    // 2. y = M (dt x) + exp(cs) . (C state^T)
    {
      float acc[ROWS_PER_WARP][COLS_PER_LANE];
      float off[ROWS_PER_WARP][COLS_PER_LANE];
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r)
#pragma unroll
        for (int u = 0; u < COLS_PER_LANE; ++u) acc[r][u] = off[r][u] = 0.f;
      const int last = warp * ROWS_PER_WARP + ROWS_PER_WARP - 1;
      for (int j = 0; j <= last; ++j) {
        float xv[COLS_PER_LANE];
#pragma unroll
        for (int u = 0; u < COLS_PER_LANE; ++u)
          xv[u] = Xs[j * PT + lane + 32 * u];
#pragma unroll
        for (int r = 0; r < ROWS_PER_WARP; ++r) {
          const float m = M[(warp * ROWS_PER_WARP + r) * (Q + 1) + j];
#pragma unroll
          for (int u = 0; u < COLS_PER_LANE; ++u)
            acc[r][u] = fmaf(m, xv[u], acc[r][u]);
        }
      }
      for (int k = 0; k < n; ++k) {
        float sv[COLS_PER_LANE];
#pragma unroll
        for (int u = 0; u < COLS_PER_LANE; ++u)
          sv[u] = St[(lane + 32 * u) * ns + k];
#pragma unroll
        for (int r = 0; r < ROWS_PER_WARP; ++r) {
          const float cv = Cs[(warp * ROWS_PER_WARP + r) * ns + k];
#pragma unroll
          for (int u = 0; u < COLS_PER_LANE; ++u)
            off[r][u] = fmaf(cv, sv[u], off[r][u]);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) {
        const int i = warp * ROWS_PER_WARP + r;
        if (i >= q) continue;
#pragma unroll
        for (int u = 0; u < COLS_PER_LANE; ++u) {
          const int p = lane + 32 * u;
          if (p0 + p < hp)
            yb[(long)(t0 + i) * step + p] = acc[r][u] + din[i] * off[r][u];
        }
      }
    }
    __syncthreads();

    // 3. state = exp(cs_last) state + (dt x)^T (exp(cs_last - cs) . B)
    {
      float acc[P_PER_WARP][N_PER_LANE];
#pragma unroll
      for (int k = 0; k < P_PER_WARP; ++k)
#pragma unroll
        for (int m = 0; m < N_PER_LANE; ++m) acc[k][m] = 0.f;
      for (int j = 0; j < Q; ++j) {
        const float w = dout[j];
        float bw[N_PER_LANE];
#pragma unroll
        for (int m = 0; m < N_PER_LANE; ++m) {
          const int k = lane + 32 * m;
          bw[m] = k < n ? Bs[j * ns + k] * w : 0.f;
        }
#pragma unroll
        for (int k = 0; k < P_PER_WARP; ++k) {
          const float xv = Xs[j * PT + warp + WARPS * k];
#pragma unroll
          for (int m = 0; m < N_PER_LANE; ++m)
            acc[k][m] = fmaf(xv, bw[m], acc[k][m]);
        }
      }
      const float decay = expf(cs[Q - 1]);
#pragma unroll
      for (int k = 0; k < P_PER_WARP; ++k) {
        const int p = warp + WARPS * k;
#pragma unroll
        for (int m = 0; m < N_PER_LANE; ++m) {
          const int kk = lane + 32 * m;
          if (kk < n) St[p * ns + kk] = acc[k][m] + decay * St[p * ns + kk];
        }
      }
    }
    __syncthreads();
  }

  float* fb = fs + f0;
  for (int e = tid; e < PT * n; e += THREADS) {
    const int p = e / n, k = e - p * n;
    if (p0 + p < hp) fb[(long)p * n + k] = St[p * ns + k];
  }
}

}  // namespace

// C interface: contiguous f32 device tensors x [batch, seq, heads, hp],
// dt [batch, seq, heads], b and c [batch, seq, n], a_log [heads], init
// [batch, heads, hp, n] or null (a zero initial state), outputs y like x
// and fs like init; the current CUDA stream.  Returns
// cudaGetLastError() (or the error of the shared-memory opt-in); 1
// (cudaErrorInvalidValue) for n outside 1..128.
extern "C" int ssd_scan(const float* x, const float* dt, const float* b,
                        const float* c, const float* a_log,
                        const float* init, float* y, float* fs, int batch,
                        int seq, int heads, int hp, int n, void* stream) {
  if (n <= 0 || n > MAX_N) return (int)cudaErrorInvalidValue;
  if ((long)batch * heads * hp == 0) return (int)cudaSuccess;
  const size_t smem = smem_floats(n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (hp + PT - 1) / PT;
  const dim3 grid((unsigned)(heads * tiles), (unsigned)batch);
  ssd_scan_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, dt, b, c, a_log, init, y, fs, seq, heads, hp, n);
  return (int)cudaGetLastError();
}
