// T1: the point table's build, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package builds the point table in
// volumeraytracer_tpu/kernels/march_pallas.py:_build_brick_table_jit
// (:133, build_brick_table :185), XLA over overlapping brick windows
// (_overlap_windows :111); eager torch runs the port's plain version
// (kernels/march_pallas.py:build_brick_table) op by op: a zero fill, a
// copy, two bf16 round trips and a cat, three unfolds, a reshape copy and a
// pad.  It writes the (NB, 8, 1408) point table:
//
//   table[b, c, (px*9 + py)*17 + pz] = row c of point (bx*8 + px,
//                                      by*8 + py, bz*16 + pz)
//
// with b = (bx*nby + by)*nbz + bz, rows 0-4 the bf16-rounded hi of [dx, dy,
// dz, opacity, absorption], rows 5-7 the bf16-rounded lo = bf16(v - hi) of
// dx, dy, dz; lanes 1377..1407 and points outside the field are 0.
// Rounding is round-to-nearest-even, as torch's and JAX's float32 ->
// bfloat16 casts, so the table equals the plain build bit for bit.
//
// What bounds it on the H100: bytes.  It reads the packed field once (the
// halo planes shared with the next bricks, 1377 / 1024 of the points, come
// mostly from L2: those bricks are neighbouring blocks) and writes the
// table, 2.8x the packed field (at 256^3: 0.268 GB read, 0.738 GB
// written).  The lane order keeps z fastest, as the packed field does, so
// there is no transpose, only records split into rows: a block a brick,
// each thread a point at a time with the block's threads on consecutive
// lanes.  A thread reads its point's float4 record (a warp reads two or
// three runs of 17 contiguous records) and writes its 8 rows, each store
// of a warp 128 contiguous bytes.  A thread issues the loads of all its
// points before its first store, so a block keeps PER records in flight
// per thread.  Threads stride over the lanes, so a block of any size (the
// host build's one thread) writes the whole brick.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BX = 8, BY = 8, BZ = 16;
constexpr int PY = BY + 1, PZ = BZ + 1;
constexpr int PV = (BX + 1) * PY * PZ;  // 1377 points
constexpr int PVP = 1408;               // lanes: PV padded to 11 x 128
constexpr int TCH = 8, SV = 5;          // rows: 5 hi, then 3 lo
#ifdef VRT_BLOCK_THREADS
constexpr int THREADS = VRT_BLOCK_THREADS;
#else
constexpr int THREADS = 128;
#endif
constexpr int PER = (PVP + THREADS - 1) / THREADS;  // lanes a thread: 11

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(THREADS)
point_table_build_kernel(const float4* __restrict__ packed,
                         const float* __restrict__ absorb,
                         float* __restrict__ table, int X, int Y, int Z,
                         int nby, int nbz) {
  const int b = blockIdx.x;
  const int bz = b % nbz;
  const int bxy = b / nbz;
  const int x0 = (bxy / nby) * BX, y0 = (bxy % nby) * BY, z0 = bz * BZ;

  // loads: every point of this thread first, 0 outside the field
  float4 rec[PER];
  float ab[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int lane = threadIdx.x + k * THREADS;
    rec[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    ab[k] = 0.0f;
    if (lane < PV) {
      const int px = lane / (PY * PZ), r = lane - px * (PY * PZ);
      const int py = r / PZ, pz = r - py * PZ;
      const int x = x0 + px, y = y0 + py, z = z0 + pz;
      if (x < X && y < Y && z < Z) {
        const int64_t i = ((int64_t)x * Y + y) * Z + z;
        rec[k] = __ldg(packed + i);
        if (absorb != nullptr) ab[k] = __ldg(absorb + i);
      }
    }
  }

  // stores: row c of lane l at out[c * PVP + l], lanes fastest
  float* out = table + (int64_t)b * (TCH * PVP);
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int lane = threadIdx.x + k * THREADS;
    if (lane >= PVP) break;
    const float v[SV] = {rec[k].x, rec[k].y, rec[k].z, rec[k].w, ab[k]};
#pragma unroll
    for (int c = 0; c < SV; ++c) {
      const float hi = bf16_round(v[c]);
      out[c * PVP + lane] = hi;
      if (c < TCH - SV) out[(SV + c) * PVP + lane] = bf16_round(v[c] - hi);
    }
  }
}

static_assert(PVP >= PV && PVP % 128 == 0, "lanes: the points padded to whole 128-lane rows");

}  // namespace

extern "C" int vrt_point_table_build(const void* packed, const void* absorb,
                                     void* table, int X, int Y, int Z,
                                     int nbx, int nby, int nbz, void* stream) {
  const int blocks = nbx * nby * nbz;
  point_table_build_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)packed, (const float*)absorb, (float*)table, X, Y, Z,
      nby, nbz);
  return (int)cudaGetLastError();
}
