// Mamba2 SSD scan for Hopper (sm_90a) as chunk-parallel stages with 3xTF32
// tensor-core products, bound with ctypes.
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
// Chunked form (Mamba2's SSD decomposition, arXiv:2405.21060 sec. 6): for
// chunk k of Q steps with cs = the cumulative sum of dt A inside it,
//   S_k   = (dt x)^T (exp(cs_last - cs) . B)                 [P, N]
//   s_k   = exp(cs_last) s_{k-1} + S_k,   s_{-1} = the initial state
//   y     = ((C B^T) . L) (dt x) + exp(cs) . (C s_{k-1}^T),
//           L[i, j] = exp(cs_i - cs_j) for i >= j, else 0
// L is masked before the exp, so nothing above the diagonal overflows.  A
// ragged last chunk is staged with dt = 0 and x, B, C = 0 in its missing
// rows: their decay is exp(0) = 1 and their update 0, so the real rows and
// the final state are those of the unpadded sequence.
//
// What bounds it on this card: the products.  At mamba2-2.7b's N = 128,
// P = 64, H = 80 a step and head takes about 35,000 f32 operations at the
// best chunk (chip_smoke.py ssd_ops_per_step) and moves about 4 (2 P + 1)
// bytes, far right of the f32 ridge (20 operations a byte).  The f32 CUDA
// cores need 0.085 ms for a 2048-token prefill (5.72 GFLOP at 67 TFLOP/s).
// The tensor cores are faster, but plain TF32 misses the scan's tolerance
// (1e-4 of max |y|) several times over.  So every product runs as 3xTF32:
// a = a_hi + a_lo, both TF32, and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi,
// three mma.sync m16n8k8 per tile step: 3 x 5.72 GFLOP at 495 TFLOP/s =
// 0.035 ms.
// mma.sync, not wgmma: wgmma takes TF32 operands only K-major from shared
// memory, and two of the four products contract over the time axis, along
// which the x and B tiles are MN-major; mma.sync fragments are loaded from
// padded shared memory in any layout (row strides chosen so a warp's
// fragment loads hit 32 distinct banks).  In practice the fragments, not
// the MMAs, set the pace: with the MMAs taken out stages b and d keep most
// of their time (splitting, scaling and loading the operands).
//
// Accuracy: exp(cs_i - cs_j) from a plain f32 cumulative sum of magnitude
// ~100 errs by a few ulp of cs (as ssd_chunked does), which alone costs
// several times the products' rounding; the sums are kept compensated
// (hi + lo, TwoSum), so the differences are exact to f32.
//
// Design: one C call launches the stages in order on the caller's stream,
// each parallel over chunks (the TPU grid's sequential chunk axis is left
// only to stage c, whose bytes bound it):
//   a. prep   (batch, chunk, row-tile pair): cs = cumsum(dt A) of a share
//             of the heads, a warp's scan per head (lane prefix sums, then
//             shuffles) over a dt tile staged by cp.async, written with dt
//             as [B, nc, H, {hi, lo, dt}, Q] rows; and C B^T [Q, Q] once
//             for all H heads (lower triangle, 16 x 8 tiles, K = N), the
//             block's row tiles mt and Q/16 - 1 - mt (equal work).
//   b. states (batch, chunk, head, 64 columns of P): S_k, K = the chunk's
//             steps; the factor dt exp(cs_last - cs) scales the x fragment.
//   c. pass   (4 elements of [B, H, P, N]): s_{k-1} over S_k in place,
//             chunk by chunk, the next chunk's load in flight, and the
//             final state.  Skipped for one chunk with no initial state:
//             stage b then writes the final state itself and stage d has no
//             C s term.
//   d. out    (batch, chunk, head, 64 columns of P): y.  L dt comes from
//             tables built per block (below a row tile's diagonal block
//             exp(cs_i - cs_i0) exp(cs_i0 - cs_j) dt_j, both factors <= 1;
//             inside it, masked before the exp), so no fragment needs an
//             exp; exp(cs) scales the C fragment.  K is permuted inside
//             each 8-step so a K-major fragment pair is one 64-bit load;
//             the slices of C B^T skip the rows above the diagonal.
// Stages b and d stream their operands in 32-row slices through a ring of
// three shared-memory stages with cp.async (16-byte copies, zero-filled
// past the edges, where rows and pointers allow; else 4-byte copies), so
// the next slice arrives while the current one is multiplied; 80 and 111 KB
// a block, two blocks an SM (a deeper ring for b, and blocks of two heads
// sharing the B, C and C B^T slices, each measured slower).  Loops stop at
// the chunk's real 16-row tiles.
// A sequence of at most 16 steps (a serving prompt) takes one kernel that
// does all four stages for its (batch, head, 64 columns of P), with no
// scratch: the host sets the time of such calls.
// Q = 128: at a 2048-token prefill that is 16 x 80 = 1280 blocks in stages
// b and d; the scratch states take 4 B ceil(S/Q) H P N bytes (42 MB
// there), written by b, read and written by c and read by d.  Q = 64 costs
// twice those bytes and measured slower at 2048 tokens; Q = 256 does not
// fit the prep's C and B tiles in shared memory, and stage d's
// accumulators would not fit two blocks an SM.  The cumulative sums and
// every exp stay in f32; the library keeps -fmad=false, so FMAs outside the
// MMAs are written out.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int Q = 128;                    // steps per chunk (64 also works)
constexpr int MAX_N = 128;
constexpr int PT = 64;                    // columns of P per block (b, d)
constexpr int KS = 32;                    // rows of a streamed slice
constexpr int NST = 3;                    // slices in the ring
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LDX = PT + 8;               // MN-major x slice rows (72)

// Row strides: a K-major operand (fragment element (g, t) at g ld + t)
// wants ld = 4 mod 8, an MN-major one (at t ld + g) ld = 8 mod 16.
__host__ __device__ constexpr int round8(int n) { return (n + 7) & ~7; }

constexpr int LDP = MAX_N + 4;            // prep's C and B rows, K-major
constexpr int LDB = MAX_N + 8;            // stage b's B rows, MN-major
constexpr int MT = Q / 16;                // row tiles of a chunk
constexpr int PAIRS = MT / 2;             // ... in pairs (mt, MT - 1 - mt)

// Shared memory, in floats, of each kernel.
constexpr int HG = 96;                    // heads of the prep's dt tile
constexpr long PREP_FLOATS = 2L * Q * LDP + (long)Q * (HG + 1) + HG;
constexpr long STATES_FLOATS = Q + (long)NST * KS * (LDX + LDB);
// Stage d permutes K inside each 8-step (fragment slots t and t + 4 take
// steps 2t and 2t + 1), so a K-major fragment pair is one 64-bit load:
// those rows want ld = 8 mod 32, the MN-major x rows ld = 4 mod 16.
constexpr int LDKO = KS + 8;              // C B^T, C and s slice rows (40)
constexpr int LDXO = PT + 4;              // x slice rows (68)
constexpr int LDGO = 24;                  // diagonal L tile rows
constexpr int OUT_B = KS * LDXO > PT * LDKO ? KS * LDXO : PT * LDKO;
constexpr int LDG = 20;                   // rows of a diagonal L tile
constexpr long OUT_FLOATS =
    4L * Q + MT * (Q + 16L * LDGO) + (long)NST * (Q * LDKO + OUT_B);

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy the [rows, COLS] tile at src (row stride lds) into shared memory at
// dst (row stride ldd) with cp.async; element (r, k) comes from src where
// r < rv and k < cv and is zero elsewhere.  VEC: 16-byte copies (cols, lds,
// ldd and the column offsets multiples of 4, src 16-byte aligned).
template <bool VEC, int COLS>
__device__ __forceinline__ void load_tile(float* dst, int ldd,
                                          const float* src, long lds,
                                          int rows, int rv, int cv) {
  constexpr int cols = COLS;
  if (VEC) {
    constexpr int cq = cols >> 2;
    for (int e = threadIdx.x; e < rows * cq; e += THREADS) {
      const int r = e / cq, k = (e - r * cq) << 2;
      const int nv = r < rv ? min(max(cv - k, 0), 4) : 0;
      const float* s = nv ? src + r * lds + k : src;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_u32(dst + r * ldd + k)),
                   "l"(s), "r"(nv * 4));
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += THREADS) {
      const int r = e / cols, k = e - r * cols;
      const bool v = r < rv && k < cv;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       smem_u32(dst + r * ldd + k)),
                   "l"(v ? src + r * lds + k : src), "r"(v ? 4 : 0));
    }
  }
}

// -- 3xTF32 on mma.sync m16n8k8 -----------------------------------------------
// Fragments (g = lane / 4, t = lane % 4): A [16 x 8] elements (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4); B [8 x 8] (k t, n g), (k t + 4,
// n g); C [16 x 8] (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).

struct FragA {
  unsigned hi[4], lo[4];
};
struct FragB {
  unsigned hi[2], lo[2];
};

// a = hi + lo: hi is a truncated to TF32, lo the rest (exact in f32),
// itself truncated to TF32, so a is held to about 2^-20 of itself.  Two
// ALU ops: the MMA reads only the 19 high bits of a TF32 operand, so a's
// own bits serve as hi.  Rounding hi (one more op) or cvt.rna.tf32 (a
// slower pipe) measured slower for an error that stays far inside the
// tolerance either way.
__device__ __forceinline__ void split(float a, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(a);
  lo = __float_as_uint(a - __uint_as_float(hi & 0xffffe000u));
}

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A 16 x 8 output tile of 3xTF32 sums: a b = a_lo b_hi + a_hi b_lo +
// a_hi b_hi, the two small products first, into their own accumulator.
// The tensor cores truncate their f32 sums; adding the small products into
// the large one measured several times the error with a slow decay.
struct Acc {
  float hi[4];                            // a_hi b_hi
  float lo[4];                            // the small products
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int k = 0; k < 4; ++k) hi[k] = lo[k] = 0.f;
  }
  __device__ __forceinline__ void add(const FragA& a, const FragB& b) {
    mma(lo, a.lo, b.hi);
    mma(lo, a.hi, b.lo);
    mma(hi, a.hi, b.hi);
  }
  __device__ __forceinline__ float get(int k) const { return hi[k] + lo[k]; }
};

// -- compensated sums: (hi, lo) holds hi + lo exactly -------------------------

__device__ __forceinline__ void dd_add(float& hi, float& lo, float bh,
                                       float bl) {
  const float s = hi + bh;
  const float v = s - hi;
  float e = (hi - (s - v)) + (bh - v);    // TwoSum: s + e = hi + bh
  e = e + (lo + bl);
  hi = s + e;
  lo = e - (hi - s);
}

// -- a. prep: cumulative sums and C B^T ---------------------------------------


template <bool VEC>
__global__ void __launch_bounds__(THREADS)
ssd_scan_prep_kernel(const float* __restrict__ dt,
                     const float* __restrict__ b,
                     const float* __restrict__ c,
                     const float* __restrict__ a_log,
                     float* __restrict__ csd, float* __restrict__ cb_out,
                     int seq, int heads, int n) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Cs = smem;                       // [Q][LDP]
  float* Bs = Cs + Q * LDP;               // [Q][LDP]
  float* Dt = Bs + Q * LDP;               // [Q][HG + 1]: dt of HG heads
  float* Al = Dt + Q * (HG + 1);          // [HG]: their a_log
  const int chunk = blockIdx.x, nc = gridDim.x;
  const long bi = blockIdx.y;
  const int z = blockIdx.z;               // row-tile pair, share of heads
  const int t0 = chunk * Q;
  const int rows = min(Q, seq - t0);
  const int rows16 = (rows + 15) & ~15;
  const int nk = round8(n);
  load_tile<VEC, MAX_N>(Cs, LDP, c + (bi * seq + t0) * n, n, rows16, rows,
                        n);
  load_tile<VEC, MAX_N>(Bs, LDP, b + (bi * seq + t0) * n, n, rows16, rows,
                        n);
  cp_commit();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // cs (compensated: hi + lo) and dt rows of this block's heads, HG at a
  // time: the dt tile staged in shared memory, then a warp's scan per
  // head, QL consecutive steps a lane
  constexpr int QL = Q / 32;
  const int hz = (heads + PAIRS - 1) / PAIRS;
  const int h1 = min(heads, (z + 1) * hz);
  for (int hg = z * hz; hg < h1; hg += HG) {
    const int nh = min(HG, h1 - hg);
    __syncthreads();
    load_tile<false, HG>(Dt, HG + 1, dt + (bi * seq + t0) * heads + hg,
                         heads, Q, rows, nh);
    load_tile<false, HG>(Al, HG, a_log + hg, 0, 1, 1, nh);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    for (int hh = warp; hh < nh; hh += WARPS) {
      const float A = -expf(Al[hh]);
      float d[QL], sh[QL], sl[QL];
      float rh = 0.f, rl = 0.f;
#pragma unroll
      for (int u = 0; u < QL; ++u) {
        d[u] = Dt[(lane * QL + u) * (HG + 1) + hh];
        dd_add(rh, rl, d[u] * A, 0.f);
        sh[u] = rh;
        sl[u] = rl;
      }
      float ih = rh, il = rl;             // inclusive scan over the lanes
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float vh = __shfl_up_sync(0xffffffffu, ih, off);
        const float vl = __shfl_up_sync(0xffffffffu, il, off);
        if (lane >= off) dd_add(ih, il, vh, vl);
      }
      float eh = __shfl_up_sync(0xffffffffu, ih, 1);
      float el = __shfl_up_sync(0xffffffffu, il, 1);
      if (lane == 0) eh = el = 0.f;
      float* row = csd + ((bi * nc + chunk) * heads + hg + hh) * 3L * Q +
                   lane * QL;
#pragma unroll
      for (int u = 0; u < QL; ++u) {
        float vh = eh, vl = el;
        dd_add(vh, vl, sh[u], sl[u]);
        row[u] = vh;
        row[Q + u] = vl;
        row[2 * Q + u] = d[u];
      }
    }
  }

  cp_wait<0>();
  __syncthreads();
  // C B^T, lower triangle: this block's row tiles z and MT - 1 - z (together
  // 2 MT + 2 column tiles of 8), four warps each, column tiles strided
  const int g = lane >> 2, tg = lane & 3;
  const int mt = warp < 4 ? z : MT - 1 - z;
  const int wq = warp & 3;
  const int i0 = mt * 16;
  if (i0 >= rows) return;
  const int ntiles = (i0 + 16) / 8;
  float* cb = cb_out + (bi * nc + chunk) * (long)Q * Q;
  constexpr int NV = MT / 2;              // column tiles a warp, at most
  Acc acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v].zero();
  for (int k0 = 0; k0 < nk; k0 += 8) {
    const float* cr = Cs + (i0 + g) * LDP + k0 + tg;
    const FragA a = frag_a(cr[0], cr[8 * LDP], cr[4], cr[8 * LDP + 4]);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int jt = wq + 4 * v;
      if (jt < ntiles) {
        const float* br = Bs + (jt * 8 + g) * LDP + k0 + tg;
        acc[v].add(a, frag_b(br[0], br[4]));
      }
    }
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int jt = wq + 4 * v;
    if (jt < ntiles) {
      float* o = cb + (long)(i0 + g) * Q + jt * 8 + 2 * tg;
      o[0] = acc[v].get(0);
      o[1] = acc[v].get(1);
      o[8 * Q] = acc[v].get(2);
      o[8 * Q + 1] = acc[v].get(3);
    }
  }
}

// -- b. chunk states ----------------------------------------------------------

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
ssd_scan_states_kernel(const float* __restrict__ x,
                       const float* __restrict__ csd,
                       const float* __restrict__ b, float* __restrict__ st,
                       int seq, int heads, int hp, int n) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nk = round8(n);
  constexpr int stage = KS * (LDX + LDB);
  float* f = smem;                        // dt exp(cs_last - cs)   [Q]
  float* ring = f + Q;                    // NST x {x [KS][LDX], B [KS][LDB]}
  const int ptiles = (hp + PT - 1) / PT;
  const int h = blockIdx.x / ptiles;
  const int p0 = (blockIdx.x - h * ptiles) * PT;
  const int chunk = blockIdx.y, nc = gridDim.y;
  const long bi = blockIdx.z;
  const int t0 = chunk * Q;
  const int rows = min(Q, seq - t0);
  const int pv = min(PT, hp - p0);
  const long step = (long)heads * hp;
  const float* xs = x + (bi * seq + t0) * step + (long)h * hp + p0;
  const float* bs = b + (bi * seq + t0) * n;
  const int slices = (rows + KS - 1) / KS;
  auto issue = [&](int s) {
    float* buf = ring + (s % NST) * stage;
    load_tile<VEC, PT>(buf, LDX, xs + (long)s * KS * step, step, KS,
                       rows - s * KS, pv);
    load_tile<VEC, MAX_N>(buf + KS * LDX, LDB, bs + (long)s * KS * n, n,
                          KS, rows - s * KS, n);
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < slices) issue(s);
    cp_commit();
  }
  const float* ch = csd + ((bi * nc + chunk) * heads + h) * 3L * Q;
  const float* cl = ch + Q;
  for (int t = threadIdx.x; t < Q; t += THREADS)
    f[t] = ch[2 * Q + t] *
           expf((ch[Q - 1] - ch[t]) + (cl[Q - 1] - cl[t]));

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int pw = (warp & 1) * 32;         // 2 row tiles of P
  const int nw = (warp >> 1) * 32;        // 4 column tiles of N
  bool mact[2], nact[4];
#pragma unroll
  for (int m = 0; m < 2; ++m) mact[m] = pw + m * 16 < pv;
#pragma unroll
  for (int u = 0; u < 4; ++u) nact[u] = nw + u * 8 < nk;
  Acc acc[2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[m][u].zero();

  for (int s = 0; s < slices; ++s) {
    cp_wait<NST - 2>();
    __syncthreads();
    if (s + NST - 1 < slices) issue(s + NST - 1);
    cp_commit();
    if (!mact[0]) continue;               // no rows for this warp
    const float* X = ring + (s % NST) * stage;
    const float* Bt = X + KS * LDX;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 8) {   // rows past the chunk are 0
      const float f0 = f[s * KS + kk + tg], f1 = f[s * KS + kk + tg + 4];
      FragB bf[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (!nact[u]) continue;           // past the row: not loaded
        const float* br = Bt + (kk + tg) * LDB + nw + u * 8 + g;
        bf[u] = frag_b(br[0], br[4 * LDB]);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (!mact[m]) continue;
        const float* xr = X + (kk + tg) * LDX + pw + m * 16 + g;
        const FragA a = frag_a(xr[0] * f0, xr[8] * f0, xr[4 * LDX] * f1,
                               xr[4 * LDX + 8] * f1);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (nact[u]) acc[m][u].add(a, bf[u]);
      }
    }
  }

  float* out = st + (((bi * nc + chunk) * heads + h) * (long)hp + p0) * n;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int col = nw + u * 8 + 2 * tg;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = pw + m * 16 + g + 8 * half;
        if (p >= pv) continue;
        float* o = out + (long)p * n + col;
        const float v0 = acc[m][u].get(2 * half);
        const float v1 = acc[m][u].get(2 * half + 1);
        if (n % 2 == 0 && col < n) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (col < n) o[0] = v0;
          if (col + 1 < n) o[1] = v1;
        }
      }
    }
  }
}

// -- c. state passing ---------------------------------------------------------

template <int V>                          // elements a thread: 4 or 1
__global__ void __launch_bounds__(THREADS)
ssd_scan_pass_kernel(const float* __restrict__ csd,
                     const float* __restrict__ init, float* __restrict__ st,
                     float* __restrict__ fs, int nc, int heads, int pn,
                     long total) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const long e = ((long)blockIdx.x * THREADS + threadIdx.x) * V;
  if (e >= total) return;
  const long bh = e / pn;
  const int k = (int)(e - bh * pn);
  const long bi = bh / heads;
  const int h = (int)(bh - bi * heads);
  const long cstride = (long)heads * pn / V;  // one chunk of st, in Vec
  Vec* sp = reinterpret_cast<Vec*>(st + (bi * nc * heads + h) * (long)pn + k);
  const float* dec = csd + (bi * nc * heads + h) * 3L * Q + Q - 1;
  float s[V];
  if (init) {
    const Vec v = *reinterpret_cast<const Vec*>(init + e);
#pragma unroll
    for (int u = 0; u < V; ++u) s[u] = reinterpret_cast<const float*>(&v)[u];
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) s[u] = 0.f;
  }
  Vec nxt = sp[0];
  for (int ch = 0; ch < nc; ++ch) {
    const Vec cur = nxt;
    if (ch + 1 < nc) nxt = sp[(ch + 1) * cstride];  // in flight meanwhile
    Vec out;
    const float* d = dec + (long)ch * heads * 3 * Q;
    const float a = expf(d[0] + d[Q]);
#pragma unroll
    for (int u = 0; u < V; ++u) {
      reinterpret_cast<float*>(&out)[u] = s[u];
      s[u] = a * s[u] + reinterpret_cast<const float*>(&cur)[u];
    }
    sp[ch * cstride] = out;
  }
  Vec out;
#pragma unroll
  for (int u = 0; u < V; ++u) reinterpret_cast<float*>(&out)[u] = s[u];
  *reinterpret_cast<Vec*>(fs + e) = out;
}

// -- d. chunk outputs ---------------------------------------------------------

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
ssd_scan_out_kernel(const float* __restrict__ x,
                    const float* __restrict__ csd,
                    const float* __restrict__ c,
                    const float* __restrict__ cbm,
                    const float* __restrict__ st, float* __restrict__ y,
                    int seq, int heads, int hp, int n) {
  // warp tiling: row-tile pairs (mt, MT - 1 - mt) balance the triangle
  constexpr int WPP = WARPS / PAIRS;
  constexpr int CW = PT / WPP, NT = CW / 8;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int stage = Q * LDKO + OUT_B;
  float* csh = smem;                      // cs, hi + lo    [Q], [Q]
  float* csl = csh + Q;
  float* din = csl + Q;                   // exp(cs)        [Q]
  float* rr = din + Q;                    // exp(cs_i - cs_i0)  [Q]
  float* ec = rr + Q;                     // [MT][Q]
  float* dg = ec + MT * Q;                // [MT][16][LDGO]
  float* ring = dg + MT * 16 * LDGO;      // NST x {A [Q][LDKO], B}
  const int ptiles = (hp + PT - 1) / PT;
  const int h = blockIdx.x / ptiles;
  const int p0 = (blockIdx.x - h * ptiles) * PT;
  const int chunk = blockIdx.y, nc = gridDim.y;
  const long bi = blockIdx.z;
  const int t0 = chunk * Q;
  const int rows = min(Q, seq - t0);
  const int rows16 = (rows + 15) & ~15;
  const int pv = min(PT, hp - p0);
  const long step = (long)heads * hp;
  const float* xs = x + (bi * seq + t0) * step + (long)h * hp + p0;
  const float* cbs = cbm + (bi * nc + chunk) * (long)Q * Q;
  const float* ccs = c + (bi * seq + t0) * n;
  const float* sts =
      st ? st + (((bi * nc + chunk) * heads + h) * (long)hp + p0) * n
         : nullptr;
  const int js = (rows + KS - 1) / KS;    // slices of (C B^T . L)(dt x)
  const int total = js + (st ? (n + KS - 1) / KS : 0);  // ... of C s^T
  auto issue = [&](int s) {
    float* buf = ring + (s % NST) * stage;
    if (s < js) {
      const int j0 = s * KS;
      // rows above the slice's first column lie above the diagonal
      load_tile<VEC, KS>(buf + j0 * LDKO, LDKO, cbs + (long)j0 * Q + j0, Q,
                         rows16 - j0, rows16 - j0, KS);
      load_tile<VEC, PT>(buf + Q * LDKO, LDXO, xs + (long)j0 * step, step,
                         KS, rows - j0, pv);
    } else {
      const int n0 = (s - js) * KS;
      load_tile<VEC, KS>(buf, LDKO, ccs + n0, n, rows16, rows, n - n0);
      load_tile<VEC, KS>(buf + Q * LDKO, LDKO, sts + n0, n, PT, pv, n - n0);
    }
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < total) issue(s);
    cp_commit();
  }
  // the decays as tables, so the fragments need no exp: with i0 the first
  // row of row i's 16-row tile, L[i, j] dt_j = rr[i] ec[mt][j] below the
  // tile (both factors <= 1: neither overflows) and dg[mt] inside it
  const float* cg = csd + ((bi * nc + chunk) * heads + h) * 3L * Q;
  for (int t = threadIdx.x; t < Q; t += THREADS) {
    csh[t] = cg[t];
    csl[t] = cg[Q + t];
  }
  __syncthreads();
  const float* dtg = cg + 2 * Q;
  auto decay = [&](int i, int j) {        // exp(cs_i - cs_j)
    return expf((csh[i] - csh[j]) + (csl[i] - csl[j]));
  };
  for (int t = threadIdx.x; t < Q; t += THREADS) {
    din[t] = expf(csh[t] + csl[t]);
    rr[t] = decay(t, t & ~15);
  }
  for (int e = threadIdx.x; e < MT * Q; e += THREADS) {
    const int mt = e / Q, j = e - mt * Q;
    if (16 * mt < rows && j < 16 * mt) ec[e] = decay(16 * mt, j) * dtg[j];
  }
  for (int e = threadIdx.x; e < MT * 256; e += THREADS) {
    const int mt = e >> 8, r = (e >> 4) & 15, k = e & 15;
    if (16 * mt >= rows) continue;
    const int i = 16 * mt + r, j = 16 * mt + k;
    dg[(16 * mt + r) * LDGO + k] = k <= r ? decay(i, j) * dtg[j] : 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int pair = warp / WPP;
  const int cw = (warp - pair * WPP) * CW;
  const int mts[2] = {pair, MT - 1 - pair};
  bool mact[2], nact[NT];
  float rra[2], rrb[2], dia[2], dib[2];   // per-row factors
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    mact[m] = mts[m] * 16 < rows;
    rra[m] = rr[mts[m] * 16 + g];
    rrb[m] = rr[mts[m] * 16 + g + 8];
    dia[m] = din[mts[m] * 16 + g];
    dib[m] = din[mts[m] * 16 + g + 8];
  }
#pragma unroll
  for (int u = 0; u < NT; ++u) nact[u] = cw + u * 8 < pv;
  // the last column of (C B^T . L) that the warp's active rows reach
  const int jmax = mact[1] ? mts[1] * 16 + 15 : mact[0] ? mts[0] * 16 + 15 : -1;
  Acc acc[2][NT];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int u = 0; u < NT; ++u) acc[m][u].zero();

  for (int s = 0; s < total; ++s) {
    cp_wait<NST - 2>();
    __syncthreads();
    if (s + NST - 1 < total) issue(s + NST - 1);
    cp_commit();
    const float* At = ring + (s % NST) * stage;
    const float* Bt = At + Q * LDKO;
    if (s < js) {
      // y += ((C B^T) . L . dt_j) (x)
#pragma unroll
      for (int kk = 0; kk < KS; kk += 8) {
        const int j0 = s * KS + kk;
        if (j0 > jmax) break;                 // past the warp's rows
        FragB bx[NT];
#pragma unroll
        for (int u = 0; u < NT; ++u) {
          const float* xr = Bt + (kk + 2 * tg) * LDXO + cw + u * 8 + g;
          bx[u] = frag_b(xr[0], xr[LDXO]);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int i0 = mts[m] * 16;
          if (!mact[m] || j0 > i0 + 15) continue;
          const float* ar = At + (i0 + g) * LDKO + kk + 2 * tg;
          const float2 c0 = *reinterpret_cast<const float2*>(ar);
          const float2 c1 = *reinterpret_cast<const float2*>(ar + 8 * LDKO);
          float2 w0, w1;                      // L dt at rows g, g + 8
          if (j0 < i0) {
            const float2 e =
                *reinterpret_cast<const float2*>(ec + mts[m] * Q + j0 + 2 * tg);
            w0 = make_float2(rra[m] * e.x, rra[m] * e.y);
            w1 = make_float2(rrb[m] * e.x, rrb[m] * e.y);
          } else {
            const float* d = dg + (i0 + g) * LDGO + j0 - i0 + 2 * tg;
            w0 = *reinterpret_cast<const float2*>(d);
            w1 = *reinterpret_cast<const float2*>(d + 8 * LDGO);
          }
          const FragA a = frag_a(c0.x * w0.x, c1.x * w1.x, c0.y * w0.y,
                                 c1.y * w1.y);
#pragma unroll
          for (int u = 0; u < NT; ++u)
            if (nact[u]) acc[m][u].add(a, bx[u]);
        }
      }
    } else if (mact[0]) {
      // y += exp(cs) . (C s^T)
#pragma unroll
      for (int kk = 0; kk < KS; kk += 8) {    // columns past N are 0
        FragB bs[NT];
#pragma unroll
        for (int u = 0; u < NT; ++u) {
          const float2 v = *reinterpret_cast<const float2*>(
              Bt + (cw + u * 8 + g) * LDKO + kk + 2 * tg);
          bs[u] = frag_b(v.x, v.y);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (!mact[m]) continue;
          const int ra = mts[m] * 16 + g;
          const float* ar = At + ra * LDKO + kk + 2 * tg;
          const float2 c0 = *reinterpret_cast<const float2*>(ar);
          const float2 c1 = *reinterpret_cast<const float2*>(ar + 8 * LDKO);
          const FragA a = frag_a(c0.x * dia[m], c1.x * dib[m],
                                 c0.y * dia[m], c1.y * dib[m]);
#pragma unroll
          for (int u = 0; u < NT; ++u)
            if (nact[u]) acc[m][u].add(a, bs[u]);
        }
      }
    }
  }

  float* yb = y + (bi * seq + t0) * step + (long)h * hp + p0;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    if (!mact[m]) continue;
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      const int col = cw + u * 8 + 2 * tg;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = mts[m] * 16 + g + 8 * half;
        if (i >= rows) continue;
        float* o = yb + i * step + col;
        const float v0 = acc[m][u].get(2 * half);
        const float v1 = acc[m][u].get(2 * half + 1);
        if (hp % 2 == 0 && col < pv) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (col < pv) o[0] = v0;
          if (col + 1 < pv) o[1] = v1;
        }
      }
    }
  }
}

// -- short prompts: every stage in one kernel ---------------------------------
// For seq <= SR (one row tile), per (batch, head, 64 columns of P): the
// head's cumulative sums, C B^T [SR, SR], y and the final state, written
// directly (no scratch, one launch: the host sets the time of such calls).

constexpr int SR = 16;
constexpr long SHORT_FLOATS =
    2L * SR * LDP + SR * LDX + (long)PT * LDP + 5 * 32 + 2 * SR * LDG;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
ssd_scan_short_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ b,
                      const float* __restrict__ c,
                      const float* __restrict__ a_log,
                      const float* __restrict__ init, float* __restrict__ y,
                      float* __restrict__ fs, int seq, int heads, int hp,
                      int n) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Cs = smem;                       // [SR][LDP]
  float* Bs = Cs + SR * LDP;              // [SR][LDP]
  float* Ss = Bs + SR * LDP;              // [PT][LDP]: the initial state
  float* Xs = Ss + PT * LDP;              // [SR][LDX]
  float* csh = Xs + SR * LDX;             // cs, hi + lo   [32], [32]
  float* csl = csh + 32;
  float* dtv = csl + 32;                  // dt            [32]
  float* f = dtv + 32;                    // dt exp(cs_last - cs)
  float* din = f + 32;                    // exp(cs)
  float* lg = din + 32;                   // [SR][LDG]: L dt, masked
  float* cbs = lg + SR * LDG;             // [SR][LDG]: C B^T
  const int ptiles = (hp + PT - 1) / PT;
  const int h = blockIdx.x / ptiles;
  const int p0 = (blockIdx.x - h * ptiles) * PT;
  const long bi = blockIdx.y;
  const int rows = seq;
  const int pv = min(PT, hp - p0);
  const long step = (long)heads * hp;
  const long f0 = ((bi * heads + h) * (long)hp + p0) * n;  // tile in fs
  load_tile<VEC, MAX_N>(Cs, LDP, c + bi * seq * n, n, SR, rows, n);
  load_tile<VEC, MAX_N>(Bs, LDP, b + bi * seq * n, n, SR, rows, n);
  load_tile<VEC, PT>(Xs, LDX, x + bi * seq * step + (long)h * hp + p0, step,
                     SR, rows, pv);
  if (init) load_tile<VEC, MAX_N>(Ss, LDP, init + f0, n, PT, pv, n);
  cp_commit();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  if (warp == 0) {                        // cs: one step a lane
    const float d = lane < rows ? dt[(bi * seq + lane) * heads + h] : 0.f;
    float ih = d * -expf(a_log[h]), il = 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float vh = __shfl_up_sync(0xffffffffu, ih, off);
      const float vl = __shfl_up_sync(0xffffffffu, il, off);
      if (lane >= off) dd_add(ih, il, vh, vl);
    }
    csh[lane] = ih;
    csl[lane] = il;
    dtv[lane] = d;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int t = threadIdx.x;
    f[t] = dtv[t] * expf((csh[SR - 1] - csh[t]) + (csl[SR - 1] - csl[t]));
    din[t] = expf(csh[t] + csl[t]);
  }
  {
    const int r = threadIdx.x >> 4, k = threadIdx.x & 15;  // SR x SR
    lg[r * LDG + k] =
        k <= r ? expf((csh[r] - csh[k]) + (csl[r] - csl[k])) * dtv[k] : 0.f;
  }
  cp_wait<0>();
  __syncthreads();
  const int nk = round8(n);
  if (warp < SR / 8) {                    // C B^T, a column tile a warp
    Acc acc;
    acc.zero();
    for (int k0 = 0; k0 < nk; k0 += 8) {
      const float* cr = Cs + g * LDP + k0 + tg;
      const float* br = Bs + (warp * 8 + g) * LDP + k0 + tg;
      acc.add(frag_a(cr[0], cr[8 * LDP], cr[4], cr[8 * LDP + 4]),
              frag_b(br[0], br[4]));
    }
    float* o = cbs + g * LDG + warp * 8 + 2 * tg;
    o[0] = acc.get(0);
    o[1] = acc.get(1);
    o[8 * LDG] = acc.get(2);
    o[8 * LDG + 1] = acc.get(3);
  }
  __syncthreads();

  // y: a column tile of P a warp
  if (warp * 8 < pv) {
    Acc acc;
    acc.zero();
    const int pc = warp * 8 + g;
#pragma unroll
    for (int j0 = 0; j0 < SR; j0 += 8) {  // ((C B^T) . L . dt_j) x
      const float* ar = cbs + g * LDG + j0 + tg;
      const float* lr = lg + g * LDG + j0 + tg;
      const float* xr = Xs + (j0 + tg) * LDX + pc;
      acc.add(frag_a(ar[0] * lr[0], ar[8 * LDG] * lr[8 * LDG], ar[4] * lr[4],
                     ar[8 * LDG + 4] * lr[8 * LDG + 4]),
              frag_b(xr[0], xr[4 * LDX]));
    }
    if (init) {                           // exp(cs) . (C s^T)
      const float da = din[g], db = din[g + 8];
      for (int k0 = 0; k0 < nk; k0 += 8) {
        const float* cr = Cs + g * LDP + k0 + tg;
        const float* sr = Ss + pc * LDP + k0 + tg;
        acc.add(frag_a(cr[0] * da, cr[8 * LDP] * db, cr[4] * da,
                       cr[8 * LDP + 4] * db),
                frag_b(sr[0], sr[4]));
      }
    }
    const int col = warp * 8 + 2 * tg;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = g + 8 * half;
      if (i >= rows) continue;
      float* o = y + (bi * seq + i) * step + (long)h * hp + p0 + col;
      if (col < pv) o[0] = acc.get(2 * half);
      if (col + 1 < pv) o[1] = acc.get(2 * half + 1);
    }
  }

  // the final state: exp(cs_last) s + (dt x)^T (exp(cs_last - cs) . B);
  // a row tile of P and 8 column tiles of N a warp
  const int pr = (warp & 3) * 16;
  if (pr >= pv) return;
  const float decay = expf(csh[SR - 1] + csl[SR - 1]);
  Acc acc[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) acc[v].zero();
#pragma unroll
  for (int k0 = 0; k0 < SR; k0 += 8) {
    const float f0 = f[k0 + tg], f1 = f[k0 + tg + 4];
    const float* xr = Xs + (k0 + tg) * LDX + pr + g;
    const FragA a = frag_a(xr[0] * f0, xr[8] * f0, xr[4 * LDX] * f1,
                           xr[4 * LDX + 8] * f1);
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int nc = (warp >> 2) * 64 + v * 8;
      if (nc >= nk) continue;
      const float* br = Bs + (k0 + tg) * LDP + nc + g;
      acc[v].add(a, frag_b(br[0], br[4 * LDP]));
    }
  }
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const int col = (warp >> 2) * 64 + v * 8 + 2 * tg;
#pragma unroll
    for (int half = 0; half < 4; ++half) {
      const int p = pr + g + 8 * (half >> 1), k = col + (half & 1);
      if (p >= pv || k >= n) continue;
      const float s0 = init ? decay * Ss[p * LDP + k] : 0.f;
      fs[f0 + (long)p * n + k] = s0 + acc[v].get(half);
    }
  }
}

// Opt in to each kernel's shared memory (above the default 48 KB) once
// per process, for the largest state size.
cudaError_t opt_in() {
  static cudaError_t done = cudaErrorNotReady;
  if (done != cudaErrorNotReady) return done;
  const int prep = (int)(PREP_FLOATS * sizeof(float));
  const int states = (int)(STATES_FLOATS * sizeof(float));
  const int out = (int)(OUT_FLOATS * sizeof(float));
  const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err = cudaSuccess;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_scan_prep_kernel<true>, a, prep);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_scan_prep_kernel<false>, a, prep);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_scan_states_kernel<true>, a, states);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_scan_states_kernel<false>, a, states);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_scan_out_kernel<true>, a, out);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_scan_out_kernel<false>, a, out);
  const int sh = (int)(SHORT_FLOATS * sizeof(float));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_scan_short_kernel<true>, a, sh);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_scan_short_kernel<false>, a, sh);
  done = err;
  return err;
}

template <bool VEC>
cudaError_t launch(const float* x, const float* dt, const float* b,
                   const float* c, const float* a_log, const float* init,
                   float* y, float* fs, float* scratch, int batch, int seq,
                   int heads, int hp, int n, cudaStream_t stream) {
  const int ptiles = (hp + PT - 1) / PT;
  if (seq <= SR) {
    ssd_scan_short_kernel<VEC>
        <<<dim3(heads * ptiles, batch), THREADS,
           SHORT_FLOATS * sizeof(float), stream>>>(
            x, dt, b, c, a_log, init, y, fs, seq, heads, hp, n);
    return cudaGetLastError();
  }
  const int nc = (seq + Q - 1) / Q;
  const bool direct = nc == 1 && init == nullptr;
  float* csd = scratch;                   // [batch, nc, heads, 3, Q]
  float* cb = csd + 3L * batch * nc * heads * Q;   // [batch, nc, Q, Q]
  float* st = cb + (long)batch * nc * Q * Q;       // [batch, nc, heads, hp, n]
  float* states = direct ? fs : st;       // one chunk: S_0 is the state
  ssd_scan_prep_kernel<VEC>
      <<<dim3(nc, batch, PAIRS), THREADS, PREP_FLOATS * sizeof(float),
         stream>>>(dt, b, c, a_log, csd, cb, seq, heads, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(heads * ptiles, nc, batch);
  ssd_scan_states_kernel<VEC>
      <<<grid, THREADS, STATES_FLOATS * sizeof(float), stream>>>(
          x, csd, b, states, seq, heads, hp, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (!direct) {
    const long total = (long)batch * heads * hp * n;
    if (VEC && (hp * n) % 4 == 0)          // 16-byte rows
      ssd_scan_pass_kernel<4>
          <<<(unsigned)((total / 4 + THREADS - 1) / THREADS), THREADS, 0,
             stream>>>(csd, init, st, fs, nc, heads, hp * n, total);
    else
      ssd_scan_pass_kernel<1>
          <<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0,
             stream>>>(csd, init, st, fs, nc, heads, hp * n, total);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  ssd_scan_out_kernel<VEC>
      <<<grid, THREADS, OUT_FLOATS * sizeof(float), stream>>>(
          x, csd, c, cb, direct ? nullptr : st, y, seq, heads, hp, n);
  return cudaGetLastError();
}

}  // namespace

// The chunk length Q, which sizes the caller's scratch, and the longest
// sequence that takes the one-launch path (which needs none).
extern "C" int ssd_scan_chunk() { return Q; }
extern "C" int ssd_scan_short_rows() { return SR; }

// C interface: contiguous f32 device tensors x [batch, seq, heads, hp],
// dt [batch, seq, heads], b and c [batch, seq, n], a_log [heads], init
// [batch, heads, hp, n] or null (a zero initial state), outputs y like x
// and fs like init; scratch of batch nc (3 heads Q + Q^2 + heads hp n)
// floats, nc = ceil(seq / Q) (the last term may be left out when nc = 1
// and init is null; none when seq <= ssd_scan_short_rows()); vec = 1 if
// every pointer is 16-byte aligned and hp and n are multiples of 4; the
// CUDA stream.  Launches the stages in order and returns the first CUDA
// error (or the error of the shared-memory opt-in); 1
// (cudaErrorInvalidValue) for n outside 1..128.
extern "C" int ssd_scan(const float* x, const float* dt, const float* b,
                        const float* c, const float* a_log,
                        const float* init, float* y, float* fs,
                        float* scratch, int batch, int seq, int heads,
                        int hp, int n, int vec, void* stream) {
  if (n <= 0 || n > MAX_N) return (int)cudaErrorInvalidValue;
  if ((long)batch * heads * hp == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t state_bytes = (size_t)batch * heads * hp * n * sizeof(float);
  if (seq == 0)
    return (int)(init ? cudaMemcpyAsync(fs, init, state_bytes,
                                        cudaMemcpyDeviceToDevice, s)
                      : cudaMemsetAsync(fs, 0, state_bytes, s));
  cudaError_t err = opt_in();
  if (err != cudaSuccess) return (int)err;
  err = vec ? launch<true>(x, dt, b, c, a_log, init, y, fs, scratch, batch,
                           seq, heads, hp, n, s)
            : launch<false>(x, dt, b, c, a_log, init, y, fs, scratch, batch,
                            seq, heads, hp, n, s);
  return (int)err;
}
