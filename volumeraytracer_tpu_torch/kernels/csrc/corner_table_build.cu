// The corner-table build for Hopper (sm_90a): the capped K2's table.
//
// No TPU kernel of its own: it takes the place of the line-table build
// (K1, volumeraytracer_tpu/kernels/line_table_pallas.py:_build_kernel)
// for the capped K2 (march_lines_fwd.cu), which the scattered-ray
// compaction driver launches.  It writes kernels/line_table.py's
// CornerTable over the line bricks' padded point lattice
// (PX, PY, PZ) = (nbx*10 + 1, nby*10 + 1, nbz*8 + 1), z fastest:
//
//   points[x, y, z] = (dx_hi + dx_lo, dy_hi + dy_lo, dz_hi + dz_lo, op_hi)
//   absorb[x, y, z] = bf16(absorption)                  (when there is one)
//
// with hi = bf16(v) and lo = bf16(v - hi), rounded to nearest even as K1
// and the plain build round, and 0 at points outside the field.  Each sum
// is the float32 add that K2 makes when it loads a cell from the line table
// (-fmad=false keeps v - hi and hi + lo apart), so the capped K2 over this
// table computes the same floats as K2 over K1's.
//
// What bounds it on the H100: bytes.  It reads the packed field once
// (16 B a point) and the absorption grid, and writes 16 B a lattice point
// and 4 more with absorption (the bench's 256^3 index grid, a 254^3
// packed field: 0.262 GB read, 0.280 GB written, 0.162 ms at 3.35 TB/s;
// with absorption 0.328 and 0.350 GB).  One thread a lattice point,
// consecutive threads on consecutive z: the field and the records are
// both z-major, so every warp reads and writes whole 512-byte runs (one
// float4 a thread) except where a row of the lattice wraps.  It takes
// 0.185-0.195 ms at the bench shape, 0.83-0.87 of its bound, against K1's
// 0.42 (NVIDIA H100 80GB HBM3, 700 W; probes/probe_fwd.py, PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LBX = 10, LBY = 10, LBZ = 8;
constexpr int THREADS = 256;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// hi + lo of v, the value K2 reloads for channels 0-2
__device__ __forceinline__ float split_sum(float v) {
  const float hi = bf16_round(v);
  return hi + bf16_round(v - hi);
}

__global__ void __launch_bounds__(THREADS)
corner_table_build_kernel(const float4* __restrict__ packed,
                          const float* __restrict__ absorb,
                          float4* __restrict__ points,
                          float* __restrict__ absorb_out,
                          int X, int Y, int Z, int PY, int PZ, int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const int z = (int)(i % PZ);
  const int64_t xy = i / PZ;
  const int y = (int)(xy % PY), x = (int)(xy / PY);
  float4 r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float a = 0.0f;
  if (x < X && y < Y && z < Z) {
    const int64_t s = ((int64_t)x * Y + y) * Z + z;
    const float4 v = __ldg(packed + s);
    r = make_float4(split_sum(v.x), split_sum(v.y), split_sum(v.z), bf16_round(v.w));
    if (absorb != nullptr) a = bf16_round(__ldg(absorb + s));
  }
  points[i] = r;
  if (absorb_out != nullptr) absorb_out[i] = a;
}

}  // namespace

extern "C" int vrt_corner_table_build(const void* packed, const void* absorb,
                                      void* points, void* absorb_out,
                                      int X, int Y, int Z, int nbx, int nby,
                                      int nbz, void* stream) {
  const int PY = nby * LBY + 1, PZ = nbz * LBZ + 1;
  const int64_t total = (int64_t)(nbx * LBX + 1) * PY * PZ;
  corner_table_build_kernel<<<(unsigned)((total + THREADS - 1) / THREADS),
                              THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)packed, (const float*)absorb, (float4*)points,
      (float*)absorb_out, X, Y, Z, PY, PZ, total);
  return (int)cudaGetLastError();
}
