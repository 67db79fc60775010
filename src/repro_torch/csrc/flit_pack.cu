// CXL.Mem-optimized flit packing (paper Fig 8/9) for Hopper (sm_90a),
// bound with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flit_pack/kernel.py:66
// pack_flits (its _kernel and _xor_reduce tree).  The plain version is
// repro_torch/kernels/flit_pack/ref.py pack_flits_ref; the output is exact
// int32, so the two agree bit for bit.
//
// Layout of one 256-byte flit (one int32 per byte):
//   [0, 240)   data: bytes 240 f + b of the flat line stream (0 past 64 N)
//   [240, 250) the HS-slot request header   (headers[f, 0..9])
//   [250, 254) Flit HDR and credit          (hdr_meta[f, 0..3])
//   254, 255   XOR fold of the even / odd bytes of [0, 254)
//
// What bounds it on this card: it moves each byte once and computes one XOR
// per byte, so device-memory bytes bound it.  The design is one warp per
// flit, 8 flits per block; lane j owns bytes j + 32 i (i = 0..7), so each
// of a warp's 8 stores covers 32 consecutive words, and the loads from the
// line stream are consecutive too.  Because 32 is even, every byte a lane
// owns has the lane's parity: each lane XORs its bytes below 254, and a
// shuffle butterfly over lane masks 2, 4, 8, 16 leaves every lane with the
// XOR of its parity class; lane 30 (even) writes the low checksum byte at
// 254 and lane 31 (odd) the high one at 255.  No shared memory, no
// reduction tree.

#include <cuda_runtime.h>

namespace {

// Layout constants; must match repro_torch/kernels/flit_pack/ref.py.
constexpr int FLIT_BYTES = 256;
constexpr int DATA_BYTES = 240;
constexpr int HS_BYTES = 10;
constexpr int META_BYTES = 4;
constexpr int LINE_BYTES = 64;
constexpr int BODY_BYTES = DATA_BYTES + HS_BYTES + META_BYTES;
constexpr int FLITS_PER_BLOCK = 8;

__global__ void flit_pack_kernel(const int* __restrict__ lines,
                                 const int* __restrict__ headers,
                                 const int* __restrict__ meta,
                                 int* __restrict__ out, long n_lines,
                                 long n_flits) {
  const long f = (long)blockIdx.x * FLITS_PER_BLOCK + (threadIdx.x >> 5);
  if (f >= n_flits) return;                   // whole warps leave together
  const int lane = threadIdx.x & 31;
  const long stream_end = n_lines * LINE_BYTES;
  int x = 0;
#pragma unroll
  for (int i = 0; i < FLIT_BYTES / 32; ++i) {
    const int b = lane + 32 * i;
    if (b >= BODY_BYTES) continue;            // the checksum bytes
    int v;
    if (b < DATA_BYTES) {
      const long src = f * DATA_BYTES + b;
      v = src < stream_end ? lines[src] : 0;
    } else if (b < DATA_BYTES + HS_BYTES) {
      v = headers[f * HS_BYTES + (b - DATA_BYTES)];
    } else {
      v = meta[f * META_BYTES + (b - DATA_BYTES - HS_BYTES)];
    }
    out[f * FLIT_BYTES + b] = v;
    x ^= v;
  }
#pragma unroll
  for (int mask = 2; mask < 32; mask <<= 1)
    x ^= __shfl_xor_sync(0xffffffffu, x, mask);
  if (lane >= 30) out[f * FLIT_BYTES + BODY_BYTES + (lane - 30)] = x;
}

}  // namespace

// C interface: contiguous int32 device tensors lines [n_lines, 64],
// headers [n_flits, 10], meta [n_flits, 4], out [n_flits, 256]; the current
// CUDA stream; returns cudaGetLastError().
extern "C" int flit_pack(const int* lines, const int* headers,
                         const int* meta, int* out, long n_lines,
                         long n_flits, void* stream) {
  if (n_flits > 0) {
    const unsigned blocks =
        (unsigned)((n_flits + FLITS_PER_BLOCK - 1) / FLITS_PER_BLOCK);
    flit_pack_kernel<<<blocks, 32 * FLITS_PER_BLOCK, 0,
                       (cudaStream_t)stream>>>(lines, headers, meta, out,
                                               n_lines, n_flits);
  }
  return (int)cudaGetLastError();
}
