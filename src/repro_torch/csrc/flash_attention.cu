// Flash-attention forward (GQA, causal / local window, q_offset) for
// Hopper (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// kernel.py:93 flash_attention_fwd (its _kernel).  The plain version is
// repro_torch/kernels/flash_attention/ref.py attention_ref (full softmax
// in f32).
//
// Layout: q [B, K, G, Sq, hd], k/v [B, K, Skv, hd], out like q, in q's
// dtype.  Constants as the reference: scores are scaled by 1/sqrt(f32(hd))
// in f32, masked scores are -1e30, the result is acc / max(l, 1e-30).  The
// ragged ends of Sq and Skv are masked in the kernel; nothing is padded in
// device memory.  Two kernels, one per dtype:
//
// flash_fwd_kernel_bf16 -- every bf16 call (all of the serving path's).
// What bounds it: at the serving shapes (Sq = Skv in the thousands, hd
// 64-256) the QK and PV products, 4 hd operations per visible (query,
// key) pair, far outweigh the bytes (q, k, v, out each moved once), so
// the bf16 tensor-core rate bounds it.  Design: Q Kᵀ and P V run on the
// tensor cores as warpgroup MMAs (wgmma.mma_async m64nNk16, bf16 in, f32
// accumulate), which is what the reference's streaming attend_chunked
// does: bf16 q, k, v, P rounded to bf16 before the PV product, f32 sums.
// One consumer warpgroup (4 warps) owns 64 query rows of one (batch, KV
// head, query head); a block holds two of them when that still fills the
// SMs (else one), so up to 128 rows share each K/V tile, and the G heads
// of a KV head walk the same tiles (repeated KV is never built).  A
// producer warpgroup, its registers handed to the consumers (setmaxnreg),
// keeps the TMA loads in flight: Q once, then 64-key K/V tiles into a ring
// of two stages with full / empty mbarriers, the next tile loading while
// the current one is multiplied; no block barrier inside the loop.  TMA
// writes every tile in the 128-byte swizzled layout wgmma reads (K-major
// for Q and K, MN-major -- the transposed descriptor -- for V).  S = Q Kᵀ
// takes Q and K from shared memory; the online softmax runs on the f32 S
// fragment in registers (quad shuffles for row max and sum; the scale
// 1/sqrt(hd) applied in f32 inside the exponent, one FMA a score), and P,
// packed to bf16 in registers, is the A operand of O += P V.  Only tiles
// that cross the causal diagonal, the window's edge or the end of Skv are
// masked; tiles no row of a warpgroup can see are skipped.  Blocks start
// with the last query tiles, the longest causal rows, so the short ones
// fill the tail.  Head dims up to 256: instances at 64, 128 and 256,
// narrower widths zero-filled by TMA past the end of a row.  Operands TMA
// cannot describe (hd % 8 != 0, or rows not 16-byte aligned) are staged
// by the consumers with element loads instead.
//
// flash_fwd_kernel_f32 -- f32 calls, off the serving path (only the tests
// and chip_smoke.py's f32 cases call it).  Its tolerance against the plain
// version (atol 3e-5, rtol 1e-4) rules out bf16 and TF32 tensor cores, so
// it runs on the f32 CUDA cores: one block of 8 warps per 16 (query row,
// head) pairs of one (batch, KV head) slab, pairs taken row-major so the
// G heads of a KV head share every K/V tile; each warp owns 2 pairs, lane
// l head-dim elements l + 32 i (q scaled, and the f32 accumulator, in
// registers).  The block stages 32 keys of K and V at a time in shared
// memory and walks only the tiles its rows can see.  Per tile a lane forms
// partial dots of its elements with all 32 keys; a transposing butterfly
// (31 shuffles) leaves lane j with the score of key j; the online softmax
// uses warp shuffles, and the P V product broadcasts each probability with
// a shuffle.  Its inner loops read 4 bytes of shared memory for every two
// fused multiply-adds, so it stays below even the f32 peak.  Dot products
// use explicit fmaf (the library is built with -fmad=false, which forbids
// only the compiler's own contraction).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_HEAD_DIM = 256;
constexpr int MAX_DEVICES = 64;

// Opt in to ``smem`` bytes of dynamic shared memory for ``kern``, once per
// device (the attribute persists; setting it at every launch costs host
// time).
template <typename Kernel>
int opt_in_once(Kernel kern, size_t smem, bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (done[dev]) return (int)cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  done[dev] = true;
  return (int)cudaSuccess;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma)
// ---------------------------------------------------------------------------

constexpr int BM = 64;            // query rows of one warpgroup (wgmma M)
constexpr int BN = 64;            // keys of one K/V tile
constexpr int WG_THREADS = 128;
constexpr uint32_t ATOM = 128;    // bytes of one swizzled row (64 bf16)
constexpr uint32_t COLS = 64 * ATOM;  // one 64-column block of 64 rows
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor of a 128-byte-swizzled operand in shared memory:
// start address, leading and stride byte offsets (16-byte units), layout
// type 1 (128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// mbarrier in shared memory: init with an arrival count, arrive (with or
// without an expected count of TMA bytes), wait for a phase by parity
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
// make this thread's generic-proxy shared-memory writes visible to the
// async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// hand registers back to / take them from the SM's pool (a warpgroup)
template <uint32_t N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <uint32_t N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}
// named barrier `id` over `count` threads
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}
// keep the compiler from moving register accesses across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B K-major in shared
// memory (descriptors), D f32 in registers; D is overwritten when
// accumulate == 0.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32],
                                             uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A bf16 in registers, B MN-major
// (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]: A bf16 in registers, B MN-major
// (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 256] += A[64 x 16] B[16 x 256]: A bf16 in registers, B MN-major
// (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  wgmma_rs_n64(d, a, b);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  wgmma_rs_n128(d, a, b);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  wgmma_rs_n256(d, a, b);
}

// 2^x in one instruction; results below 2^-126 flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Stage rows [0, ROWS) x columns [0, HD) of a row-major bf16 matrix with
// row stride hd into shared memory at dst, in the layout a 128-byte
// swizzled TMA box gives: HD / 64 column blocks of [ROWS][64], the 16-byte
// chunk c of row r stored at chunk c ^ (r % 8); rows at or past n_rows and
// columns at or past hd are zero.  Element loads: the way for operands TMA
// cannot describe (hd % 8 != 0: rows not 16-byte aligned).
template <int ROWS, int HD, int NTHR>
__device__ __forceinline__ void stage_tile(uint32_t dst,
                                           const __nv_bfloat16* src,
                                           int n_rows, int hd, int tid) {
  constexpr int CPR = HD / 8;             // 16-byte chunks of a row
  static_assert((ROWS * CPR) % NTHR == 0, "chunks split evenly");
  const unsigned short* src16 = reinterpret_cast<const unsigned short*>(src);
#pragma unroll 4
  for (int i = 0; i < ROWS * CPR / NTHR; ++i) {
    const int c = tid + i * NTHR;
    const int row = c / CPR, ch = c % CPR, col = ch * 8;
    const uint32_t d = dst + (ch >> 3) * (ROWS * ATOM) + row * ATOM +
                       (uint32_t)(((ch & 7) ^ (row & 7)) << 4);
    const bool ok = row < n_rows;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long at = (long)row * hd + col + 2 * e;
      const uint32_t lo = ok && col + 2 * e < hd ? src16[at] : 0u;
      const uint32_t hi = ok && col + 2 * e + 1 < hd ? src16[at + 1] : 0u;
      w[e] = lo | (hi << 16);
    }
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(d), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                 : "memory");
  }
}

// The 64 query rows of one warpgroup: work item ``item`` of a slab is
// query tile n_rt - 1 - item / groups (the last, longest causal rows
// first) of head item % groups; lo, hi: the keys its rows can see.
struct Rows {
  bool live;
  int r0, g, first_pos, last_pos, lo, hi;
};

__device__ __forceinline__ Rows rows_of(int item, int groups, int sq,
                                        int skv, int causal, int window,
                                        int q_offset) {
  Rows r;
  const int n_rt = (sq + BM - 1) / BM;
  r.live = item < n_rt * groups;
  const int rt = r.live ? n_rt - 1 - item / groups : 0;
  r.g = r.live ? item % groups : 0;
  r.r0 = rt * BM;
  r.first_pos = r.r0 + q_offset;
  r.last_pos = min(r.r0 + BM, sq) - 1 + q_offset;
  r.lo = window > 0 ? max(0, r.first_pos - window + 1) : 0;
  r.hi = causal ? min(skv, r.last_pos + 1) : skv;
  if (!r.live || r.hi <= r.lo) {
    r.lo = skv;
    r.hi = 0;
  }
  return r;
}

// Grid: one block per (NWG work items, slab), slabs fastest, so every slab's
// longest rows start first.  Block: NWG consumer warpgroups, then one
// producer warpgroup whose first thread keeps the TMA loads of Q and of the
// two-stage K/V ring in flight (full / empty mbarriers per stage: no block
// barrier inside the loop, the consumers wait only for data); its other
// threads only give up their registers.  tm_q, tm_k, tm_v: TMA maps of q
// [B*K*G, Sq, hd], k and v [B*K, Skv, hd] with 64 x 64 boxes (vec != 0;
// else the consumers stage one tile at a time with element loads).
template <int HD, int NWG>
__global__ void __launch_bounds__((NWG + 1) * WG_THREADS, 1)
flash_fwd_kernel_bf16(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out, int slabs, int groups,
                      int sq, int skv, int hd, int causal, int window,
                      int q_offset, float scale, int vec) {
  static_assert(HD % 64 == 0 && HD <= MAX_HEAD_DIM, "HD: 64, 128 or 256");
  constexpr int NCONS = NWG * WG_THREADS;     // consumer threads
  constexpr uint32_t Q_BYTES = BM * HD * 2;   // one warpgroup's Q
  constexpr uint32_t KV_BYTES = BN * HD * 2;  // one K or V tile
  constexpr int NO = HD / 2;                  // O accumulator floats
  constexpr int NS = BN / 2;                  // S accumulator floats
  extern __shared__ uint8_t smem_raw[];
  // the swizzle repeats every 1024 bytes: align every operand to it
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + NWG * Q_BYTES;   // [2 stages][HD/64][BN][64]
  const uint32_t v_s = k_s + 2 * KV_BYTES;
  // mbarriers: full[2] (stage loaded), empty[2] (stage consumed), Q loaded
  const uint32_t full = v_s + 2 * KV_BYTES, empty = full + 16,
                 q_bar = full + 32;

  const int tid = threadIdx.x;
  const int wg = tid / WG_THREADS;
  const int wtid = tid % WG_THREADS;
  const int warp = wtid / 32, lane = tid % 32;
  const int slab = blockIdx.x % slabs;
  const int item0 = (blockIdx.x / slabs) * NWG;
  int blo = skv, bhi = 0;   // keys any warpgroup of the block can see
  uint32_t q_bytes = 0;     // Q bytes the block loads
#pragma unroll
  for (int w = 0; w < NWG; ++w) {
    const Rows other = rows_of(item0 + w, groups, sq, skv, causal, window,
                               q_offset);
    blo = min(blo, other.lo);
    bhi = max(bhi, other.hi);
    q_bytes += other.live ? Q_BYTES : 0u;
  }
  const int t_first = bhi > blo ? (blo / BN) * BN : 0;
  const int n_tiles = bhi > blo ? (bhi - t_first + BN - 1) / BN : 0;

  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    mbar_init(empty, NCONS);
    mbar_init(empty + 8, NCONS);
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // producer: tile it goes to stage it % 2 once the consumers are done
    // with tile it - 2
    if constexpr (NWG > 1) reg_dealloc<24>();
    if (vec && wtid == 0 && n_tiles > 0) {
      mbar_arrive_tx(q_bar, q_bytes);
#pragma unroll
      for (int w = 0; w < NWG; ++w) {
        const Rows other = rows_of(item0 + w, groups, sq, skv, causal,
                                   window, q_offset);
        if (!other.live) continue;
#pragma unroll
        for (int cb = 0; cb < HD / 64; ++cb)
          tma_load(q_s + w * Q_BYTES + cb * COLS, tm_q, q_bar, cb * 64,
                   other.r0, slab * groups + other.g);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const uint32_t st = (uint32_t)(it & 1);
        if (it >= 2)
          mbar_wait(empty + 8 * st, (uint32_t)((it >> 1) - 1) & 1u);
        const uint32_t bar = full + 8 * st;
        const int t0 = t_first + it * BN;
        mbar_arrive_tx(bar, 2 * KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < HD / 64; ++cb) {
          tma_load(k_s + st * KV_BYTES + cb * COLS, tm_k, bar, cb * 64, t0,
                   slab);
          tma_load(v_s + st * KV_BYTES + cb * COLS, tm_v, bar, cb * 64, t0,
                   slab);
        }
      }
    }
    return;
  }

  // consumers
  if constexpr (NWG > 1) reg_alloc<240>();
  const Rows rows = rows_of(item0 + wg, groups, sq, skv, causal, window,
                            q_offset);
  const long head_row = ((long)slab * groups + rows.g) * sq;
  const uint32_t q_wg = q_s + wg * Q_BYTES;
  if (n_tiles > 0) {
    if (vec)
      mbar_wait(q_bar, 0);
    else if (rows.live)
      stage_tile<BM, HD, WG_THREADS>(q_wg, q + (head_row + rows.r0) * hd,
                                     sq - rows.r0, hd, wtid);
  }

  // this thread's rows of the S and O fragments: row0 and row0 + 8 of the
  // warpgroup's 64; columns 8 j + cq and 8 j + cq + 1
  const int row0 = warp * 16 + lane / 4;
  const int pos0 = rows.first_pos + row0, pos1 = pos0 + 8;
  const int cq = 2 * (lane % 4);
  const float scale2 = scale * LOG2E;   // the scale in the log2 domain
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_first + it * BN;
    const uint32_t st = vec ? (uint32_t)(it & 1) : 0u;
    if (vec) {
      mbar_wait(full + 8 * st, (uint32_t)(it >> 1) & 1u);
    } else {
      // one stage, loaded by the consumers between two barriers of theirs
      named_sync(1, NCONS);
      stage_tile<BN, HD, NCONS>(k_s, k + ((long)slab * skv + t0) * hd,
                                skv - t0, hd, tid);
      stage_tile<BN, HD, NCONS>(v_s, v + ((long)slab * skv + t0) * hd,
                                skv - t0, hd, tid);
      fence_proxy_async();
      named_sync(1, NCONS);
    }

    if (t0 < rows.hi && t0 + BN > rows.lo) {   // uniform per warpgroup
      const uint32_t ks = k_s + st * KV_BYTES, vs = v_s + st * KV_BYTES;
      // S = Q Kᵀ: HD / 16 steps of k16; within a 64-column block the
      // descriptor advances 32 bytes a step
      float s[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * COLS + (kk % 4) * 32;
        wgmma_ss_n64(s, sw128_desc(q_wg + off, 0, 8 * ATOM),
                     sw128_desc(ks + off, 0, 8 * ATOM), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // mask the raw scores only where the tile crosses the diagonal, the
      // window's edge or the end of Skv
      const bool edge = t0 + BN > skv ||
                        (causal && t0 + BN - 1 > rows.first_pos) ||
                        (window > 0 && t0 <= rows.last_pos - window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int col = t0 + 8 * (i / 4) + cq + (i % 2);
          const int pos = (i % 4) < 2 ? pos0 : pos1;
          bool ok = col < skv;
          if (causal) ok = ok && col <= pos;
          if (window > 0) ok = ok && col > pos - window;
          if (!ok) s[i] = NEG_INF;
        }
      }
      // online softmax on the raw scores: the quad (4 lanes) holding a row
      // agrees on its max; the scale is applied in f32 inside the exponent,
      // p = 2^(s c - m c) with c = log2(e) / sqrt(hd), one FMA a score.  A
      // row that has seen no key yet (max -1e30) keeps p = 0.
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < NS / 4; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float c0 = ex2((m0 - mx0) * scale2);
      const float c1 = ex2((m1 - mx1) * scale2);
      const float b0 = mx0 == NEG_INF ? 0.f : mx0 * scale2;
      const float b1 = mx1 == NEG_INF ? 0.f : mx1 * scale2;
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < NS / 4; ++j) {
        s[4 * j] = ex2(fmaf(s[4 * j], scale2, -b0));
        s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], scale2, -b0));
        s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], scale2, -b1));
        s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], scale2, -b1));
        sum0 += s[4 * j] + s[4 * j + 1];
        sum1 += s[4 * j + 2] + s[4 * j + 3];
      }
      // l from the f32 probabilities (a partial sum per lane, summed over
      // the quad at the end), P V from the bf16 ones, as attend_chunked
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;
#pragma unroll
      for (int j = 0; j < NO / 4; ++j) {
        o[4 * j] *= c0;
        o[4 * j + 1] *= c0;
        o[4 * j + 2] *= c1;
        o[4 * j + 3] *= c1;
      }
      // the S fragment of keys 16 kk .. 16 kk + 15 is the A fragment of
      // the kk-th k16 step of P V
      uint32_t p[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        fence_regs(p[kk]);
      }

      // O += P V: V is MN-major (hd contiguous); a k16 step is 16 key
      // rows (2048 bytes), the 64-column blocks of hd are COLS apart
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs(o, p[kk], sw128_desc(vs + kk * 16 * ATOM, COLS, 8 * ATOM));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    }
    if (vec) mbar_arrive(empty + 8 * st);   // this thread is done with it
  }

  if (!rows.live) return;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int ra = rows.r0 + row0, rb = ra + 8;
  const bool pairs = (hd % 2) == 0;
#pragma unroll
  for (int j = 0; j < NO / 4; ++j) {
    const int col = 8 * j + cq;
    if (col >= hd) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? rb : ra;
      if (r >= sq) continue;
      const float inv = h ? inv1 : inv0;
      const float x = o[4 * j + 2 * h] * inv, y = o[4 * j + 2 * h + 1] * inv;
      __nv_bfloat16* dst = out + (head_row + r) * hd + col;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(x, y);
      } else {
        dst[0] = __float2bfloat16_rn(x);
        if (col + 1 < hd) dst[1] = __float2bfloat16_rn(y);
      }
    }
  }
}

template <int HD, int NWG>
int launch_bf16(const CUtensorMap* maps, const void* q, const void* k,
                const void* v, void* out, int slabs, int g, int sq, int skv,
                int hd, int causal, int window, int q_offset, float scale,
                int vec, cudaStream_t stream) {
  static bool opted[MAX_DEVICES] = {};
  constexpr size_t smem = (size_t)(NWG * BM + 4 * BN) * HD * 2 + 1024 + 40;
  auto kern = flash_fwd_kernel_bf16<HD, NWG>;
  const int err = opt_in_once(kern, smem, opted);
  if (err != (int)cudaSuccess) return err;
  const long items = (long)((sq + BM - 1) / BM) * g;
  const long blocks = (long)slabs * ((items + NWG - 1) / NWG);
  kern<<<(unsigned)blocks, (NWG + 1) * WG_THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), slabs, g, sq, skv, hd, causal,
      window, q_offset, scale, vec);
  return (int)cudaGetLastError();
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

// TMA map of a bf16 tensor [n, rows, hd] (row-major, 16-byte aligned, hd %
// 8 == 0), 64 x 64 boxes with the 128-byte swizzle; elements past the end
// of a dimension read as zero.
int encode_rows(CUtensorMap* map, const void* base, long n, long rows,
                int hd) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)rows,
                              (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)rows * hd * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)BN, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

// Two warpgroups a block when that still gives every SM a block, else one
// (more, smaller blocks: short prompts, continuation chunks).
template <int HD>
int dispatch_bf16(const void* q, const void* k, const void* v, void* out,
                  int slabs, int g, int sq, int skv, int hd, int causal,
                  int window, int q_offset, float scale, int vec,
                  cudaStream_t s) {
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  CUtensorMap maps[3] = {};
  if (vec) {
    int e = encode_rows(&maps[0], q, (long)slabs * g, sq, hd);
    if (e == (int)cudaSuccess && skv > 0) {
      e = encode_rows(&maps[1], k, slabs, skv, hd);
      if (e == (int)cudaSuccess) e = encode_rows(&maps[2], v, slabs, skv, hd);
    }
    if (e != (int)cudaSuccess) return e;
  }
  const long items = (long)((sq + BM - 1) / BM) * g;
  if ((long)slabs * ((items + 1) / 2) >= sms[dev])
    return launch_bf16<HD, 2>(maps, q, k, v, out, slabs, g, sq, skv, hd,
                              causal, window, q_offset, scale, vec, s);
  return launch_bf16<HD, 1>(maps, q, k, v, out, slabs, g, sq, skv, hd,
                            causal, window, q_offset, scale, vec, s);
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int TILE_KV = 32;               // keys per tile: one per lane
constexpr int WARPS = 8;
constexpr int PAIRS = 2;                  // (query row, head) pairs a warp
constexpr int PAIRS_PER_BLOCK = WARPS * PAIRS;
constexpr unsigned FULL = 0xffffffffu;

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
template <int HPL>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int groups, int sq, int skv, int hd, int causal,
                     int window, int q_offset, float scale) {
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
      qv[p][i] = (live[p] && e < hd) ? q[base[p] + e] * scale : 0.f;
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
      ks[idx] = idx < n ? k[src] : 0.f;
      vs[idx] = idx < n ? v[src] : 0.f;
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
      if (e < hd) out[base[p] + e] = acc[p][i] / den;
    }
  }
}

template <int HPL>
int launch_f32(const void* q, const void* k, const void* v, void* out, int b,
               int kh, int g, int sq, int skv, int hd, int causal, int window,
               int q_offset, float scale, cudaStream_t stream) {
  static bool opted[MAX_DEVICES] = {};
  const size_t smem = 2 * TILE_KV * (size_t)(32 * HPL) * sizeof(float);
  auto kern = flash_fwd_kernel_f32<HPL>;
  const int err = opt_in_once(kern, smem, opted);
  if (err != (int)cudaSuccess) return err;
  const long n_pairs = (long)sq * g;
  const dim3 grid((unsigned)((n_pairs + PAIRS_PER_BLOCK - 1) /
                             PAIRS_PER_BLOCK),
                  (unsigned)(b * kh));
  kern<<<grid, WARPS * 32, 2 * TILE_KV * (size_t)hd * sizeof(float),
         stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v), static_cast<float*>(out), g,
                   sq, skv, hd, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

int dispatch_f32(const void* q, const void* k, const void* v, void* out,
                 int b, int kh, int g, int sq, int skv, int hd, int causal,
                 int window, int q_offset, float scale, cudaStream_t s) {
  if (hd <= 32)
    return launch_f32<1>(q, k, v, out, b, kh, g, sq, skv, hd, causal, window,
                         q_offset, scale, s);
  if (hd <= 64)
    return launch_f32<2>(q, k, v, out, b, kh, g, sq, skv, hd, causal, window,
                         q_offset, scale, s);
  if (hd <= 128)
    return launch_f32<4>(q, k, v, out, b, kh, g, sq, skv, hd, causal, window,
                         q_offset, scale, s);
  return launch_f32<8>(q, k, v, out, b, kh, g, sq, skv, hd, causal, window,
                       q_offset, scale, s);
}

}  // namespace

// C interface: contiguous device tensors q [b, kh, g, sq, hd], k and v
// [b, kh, skv, hd], out like q; bf16 != 0 for bf16 operands (the
// tensor-core kernel), else f32 (the CUDA-core kernel); hd <= 256;
// window <= 0 for no window; scale = 1/sqrt(f32(hd)); vec != 0 when hd %
// 8 == 0 and every pointer is 16-byte aligned (bf16: TMA loads, else
// element loads); the current CUDA stream.  Returns cudaGetLastError() (or the
// error of the shared-memory opt-in); 1 (cudaErrorInvalidValue) for a bad
// hd.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int bf16, int b,
                                   int kh, int g, int sq, int skv, int hd,
                                   int causal, int window, int q_offset,
                                   float scale, int vec, void* stream) {
  if (hd <= 0 || hd > MAX_HEAD_DIM) return (int)cudaErrorInvalidValue;
  if ((long)b * kh * g * sq == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return dispatch_f32(q, k, v, out, b, kh, g, sq, skv, hd, causal, window,
                        q_offset, scale, s);
  const int slabs = b * kh;
  if (hd <= 64)
    return dispatch_bf16<64>(q, k, v, out, slabs, g, sq, skv, hd, causal,
                             window, q_offset, scale, vec, s);
  if (hd <= 128)
    return dispatch_bf16<128>(q, k, v, out, slabs, g, sq, skv, hd, causal,
                              window, q_offset, scale, vec, s);
  return dispatch_bf16<256>(q, k, v, out, slabs, g, sq, skv, hd, causal,
                            window, q_offset, scale, vec, s);
}
