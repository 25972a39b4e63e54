// K1: line-table build for Hopper (sm_90a).
//
// Replaces the TPU kernel volumeraytracer_tpu/kernels/line_table_pallas.py
// :_build_kernel (and its XLA prep _split_field).  It writes the line-major
// brick table of kernels/line_table.py:
//
//   table[b, z*8 + c, px*11 + py] = F[x0+px, y0+py, z0+z, c]
//
// rows 0-4 the bf16-rounded hi of [dx, dy, dz, opacity, absorption], rows
// 5-7 the bf16-rounded lo = bf16(v - hi) of dx, dy, dz; lanes 121..127 and
// points outside the field are 0.  Rounding is round-to-nearest-even, as
// torch's and JAX's float32 -> bfloat16 casts, so the table is bit-exact
// against the plain build.
//
// What bounds it on the H100: bytes.  It reads the packed field once (plus
// the shared halo planes, ~1.4x) and writes the 72x128 table, 2.9x the
// packed field (at 256^3: ~0.36 GB read, 0.80 GB written).  The relayout is
// a transpose: the source is contiguous along (z, c), the table along the
// lanes (px, py).  One block per brick stages the brick's 121 lines x
// (9 z x 5 channels) in shared memory with reads that run along (z, c), then
// writes the (72, 128) brick with consecutive threads on consecutive lanes,
// so both sides of device memory are coalesced.  The shared-memory line
// stride is odd (45 floats), so the lane-strided reads are free of bank
// conflicts.  The TPU kernel's column pipeline, y-window padding and MXU
// identity transpose served Mosaic's DMA rules and are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LBX = 10, LBY = 10, LBZ = 8;
constexpr int LPY = LBY + 1, LPZ = LBZ + 1;
constexpr int TCH = 8, NLO = 3, NCH = 4;
constexpr int LS = LPZ * TCH;           // 72 rows
constexpr int LL = 128;                 // lanes
constexpr int NLINES = 121;             // LPX * LPY live lanes
constexpr int SV = 5;                   // staged values per point: 4 channels + absorption
constexpr int SSTRIDE = LPZ * SV;       // 45 floats per line, odd
constexpr int THREADS = 256;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(THREADS)
line_table_build_kernel(const float* __restrict__ packed,
                        const float* __restrict__ absorb,
                        float* __restrict__ table,
                        int X, int Y, int Z, int nby, int nbz) {
  __shared__ float s[NLINES * SSTRIDE];
  const int b = blockIdx.x;
  const int bz = b % nbz;
  const int bxy = b / nbz;
  const int x0 = (bxy / nby) * LBX;
  const int y0 = (bxy % nby) * LBY;
  const int z0 = bz * LBZ;

  // stage: line-major, (z, c) fastest — runs of 36 contiguous source floats
  for (int i = threadIdx.x; i < NLINES * LPZ * NCH; i += THREADS) {
    const int line = i / (LPZ * NCH);
    const int k = i - line * (LPZ * NCH);
    const int z = k / NCH, c = k - z * NCH;
    const int x = x0 + line / LPY, y = y0 + line % LPY, zz = z0 + z;
    float v = 0.0f;
    if (x < X && y < Y && zz < Z)
      v = packed[(((int64_t)x * Y + y) * Z + zz) * NCH + c];
    s[line * SSTRIDE + z * SV + c] = v;
  }
  for (int i = threadIdx.x; i < NLINES * LPZ; i += THREADS) {
    const int line = i / LPZ, z = i - line * LPZ;
    const int x = x0 + line / LPY, y = y0 + line % LPY, zz = z0 + z;
    float v = 0.0f;
    if (absorb != nullptr && x < X && y < Y && zz < Z)
      v = absorb[((int64_t)x * Y + y) * Z + zz];
    s[line * SSTRIDE + z * SV + NCH] = v;
  }
  __syncthreads();

  // write: lanes fastest — one contiguous 36 KB brick
  float* out = table + (int64_t)b * LS * LL;
  for (int i = threadIdx.x; i < LS * LL; i += THREADS) {
    const int row = i / LL, lane = i - row * LL;
    float r = 0.0f;
    if (lane < NLINES) {
      const int z = row / TCH, c = row - z * TCH;
      const float v = s[lane * SSTRIDE + z * SV + (c < SV ? c : c - SV)];
      const float hi = bf16_round(v);
      r = c < SV ? hi : bf16_round(v - hi);
    }
    out[i] = r;
  }
}

static_assert(SV + NLO == TCH, "row layout: 5 hi rows then 3 lo rows");

}  // namespace

extern "C" int vrt_line_table_build(const void* packed, const void* absorb,
                                    void* table, int X, int Y, int Z,
                                    int nbx, int nby, int nbz, void* stream) {
  const int nb = nbx * nby * nbz;
  line_table_build_kernel<<<nb, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)packed, (const float*)absorb, (float*)table, X, Y, Z,
      nby, nbz);
  return (int)cudaGetLastError();
}
