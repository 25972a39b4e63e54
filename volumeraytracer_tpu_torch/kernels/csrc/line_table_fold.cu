// K4: gradient fold of the line table, for Hopper (sm_90a).
//
// Replaces the TPU kernel volumeraytracer_tpu/kernels/line_table_pallas.py
// :_fold_kernel (and the XLA overlap-adds of _fold_line_grads_pallas_jit).
// It is the adjoint of K1's addressing: every packed-field point is stored by
// up to 8 bricks (its own, and the bricks below it in x, y and z, whose +1
// halo planes hold it), so its gradient is the sum of those table entries:
//
//   out[x, y, z, c] = ((T000 + T100) + (T010 + T110))
//                   + ((T001 + T101) + (T011 + T111))
//
// where Tabc is the entry of brick (bx - a, by - b, bz - c) at the local
// point that is (x, y, z) (px = 10 in a brick below in x, py = 10 in y,
// pz = 8 in z), and a term is absent where that brick or that halo is.  This
// is the order of kernels/line_table.py:fold_line_grads, which overlap-adds
// x, then y, then z, so the kernel is bit-exact against it.  Only the hi rows
// of channels 0-3 are read (rows z*8 + c, c < 4): the adjoint writes there.
//
// Each output point is written once, by the brick that holds it in its body
// (the last brick of an axis also owns the far face), so there are no
// atomics and the result is deterministic.
//
// What bounds it on the H100: bytes.  At 256^3 (21,632 bricks) it must read
// the 36 hi rows of each brick (0.38 GB) and write the 0.26 GB gradient: 0.19
// ms at 3.35 TB/s.  The first design staged a brick with one 4-byte load and
// a runtime division or two per float, and wrote each point as four scalar
// stores: 0.78 ms, 0.82 TB/s, bound by issuing that index arithmetic (a
// 545-instruction staging loop for 7 floats, 211 instructions a store).
// This design (NVIDIA H100 80GB HBM3, 700 W; PERF.md):
//   - The brick's own rows are 9 contiguous runs of 4 x 128 floats (rows
//     z*8 + 0..3), staged with 16-byte cp.async copies (no register staging);
//     the neighbours' halo planes (the x-below brick's lanes 108-123, the
//     z-below brick's z = 8 plane, the y-below brick's lanes px*11 + 10) go
//     the same way, 16 or 4 bytes a copy.  Every copy of a brick is issued
//     before any is waited for.
//   - A persistent grid (as many blocks as fit on the SMs) walks the bricks
//     through a ring of NSTAGE staged bricks: while one is written, the next
//     two are in flight.
//   - The write phase gives each thread one point and writes its 4 channels
//     as one float4; z is fastest, so a warp writes four runs of 128
//     contiguous bytes.  Interior bricks index over the compile-time extents
//     (10, 10, 8); the last brick of an axis (far face, crop) takes a masked
//     path over (11, 11, 9).  The staged planes are padded (z strides 516, 68
//     and 49 floats) so that the 8 z points of a warp read distinct banks.
// It takes 0.32 ms, 1.98 TB/s of the bytes its bound counts: 0.59 of the
// bound and 0.82 of what a copy_ of the same rows reaches (2.43 TB/s, read
// plus written), with 86 registers and no spills.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LBX = 10, LBY = 10, LBZ = 8;
constexpr int LPX = LBX + 1, LPY = LBY + 1, LPZ = LBZ + 1;
constexpr int TCH = 8, NCH = 4;
constexpr int LL = 128;                    // lanes
constexpr int PLANE = TCH * LL;            // floats between a brick's z planes
constexpr int BRICK = LPZ * PLANE;         // floats of a brick's (72, 128) block
constexpr int THREADS = 256;
constexpr int HALO0 = LBX * LPY / 4 * 4;   // 108: lane px = 10 (110) rounded down to 16 bytes

// One stage of shared memory (floats): the brick's own rows and the 7
// neighbours' halo planes.
//   body [z][c][lane]   z stride BODY_Z
//   hx   [z][c][16]     lanes 108..123 of the x-below brick, z stride HX_Z
//   hz   [c][lane]      z = 8 plane of the z-below brick
//   hxz  [c][16]        z = 8, lanes 108..123 of the (x, z)-below brick
//   hy   [z][c][12]     lanes px*11 + 10 of the y-below brick, z stride HY_Z
//   hyz  [c][12]        z = 8 of the (y, z)-below brick
//   hxy  [z][c]         lane 120 of the (x, y)-below brick
//   hxyz [c]            z = 8, lane 120 of the (x, y, z)-below brick
constexpr int BODY_Z = NCH * LL + 4, HX_Z = NCH * 16 + 4, HY_Z = NCH * 12 + 1;
constexpr int BODY = 0;
constexpr int HX = BODY + LPZ * BODY_Z;
constexpr int HZ = HX + LPZ * HX_Z;
constexpr int HXZ = HZ + NCH * LL;
constexpr int HY = HXZ + NCH * 16;
constexpr int HYZ = HY + LPZ * HY_Z;
constexpr int HXY = HYZ + NCH * 12;
constexpr int HXYZ = HXY + LPZ * NCH;
constexpr int STAGE = (HXYZ + NCH + 3) / 4 * 4;  // 6,364 floats = 25.5 KB
// Bricks in a block's ring, and blocks an SM (which caps the registers): 3
// at 2 (153 KB of shared memory an SM) ran 0.318 ms at the bench shape, a
// double buffer at 3 blocks 0.362, 3 at 3 0.328 and 4 at 2 0.331
// (probes/sweep_k4.py on the H100; PERF.md).
constexpr int NSTAGE = 3;
constexpr int MIN_BLOCKS = 2;
constexpr int SMEM_BYTES = NSTAGE * STAGE * (int)sizeof(float);
static_assert(HX % 4 == 0 && HZ % 4 == 0 && HXZ % 4 == 0 && BODY_Z % 4 == 0 && HX_Z % 4 == 0,
              "16-byte copy targets must be 16-byte aligned");

// copies of a stage: 16-byte (body, hx, hz, hxz) and 4-byte (hy, hyz, hxy, hxyz)
constexpr int N_BODY = LPZ * NCH * LL / 4, N_HX = LPZ * NCH * 4, N_HZ = NCH * LL / 4, N_HXZ = NCH * 4;
constexpr int N16 = N_BODY + N_HX + N_HZ + N_HXZ;
constexpr int N_HY = LPZ * NCH * LPX, N_HYZ = NCH * LPX, N_HXY = LPZ * NCH;
constexpr int N4 = N_HY + N_HYZ + N_HXY + NCH;

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

struct Brick {
  int bx, by, bz;
};

__device__ __forceinline__ Brick brick_of(int b, int nby, int nbz) {
  const int bxy = b / nbz;
  return {bxy / nby, bxy % nby, b % nbz};
}

// Issue every copy of brick b's rows and halos into the stage s.
__device__ __forceinline__ void stage(float* s, const float* __restrict__ g, int b, Brick k, int nby, int nbz) {
  const int t = threadIdx.x;
  const bool xm = k.bx > 0, ym = k.by > 0, zm = k.bz > 0;
  const float* own = g + (int64_t)b * BRICK;
  const int64_t dx = (int64_t)nby * nbz * BRICK, dy = (int64_t)nbz * BRICK;
#pragma unroll
  for (int j = 0; j < (N16 + THREADS - 1) / THREADS; ++j) {
    const int i = t + j * THREADS;
    if (i < N_BODY) {
      const int z = i >> 7, q = i & 127;  // q: 4-float chunk of the 4 rows of plane z
      cp16(s + BODY + z * BODY_Z + q * 4, own + z * PLANE + q * 4);
    } else if (i < N_BODY + N_HX) {
      const int r = (i - N_BODY) >> 2, q = i & 3;  // r = z*4 + c
      if (xm) cp16(s + HX + (r >> 2) * HX_Z + (r & 3) * 16 + q * 4, own - dx + (r >> 2) * PLANE + (r & 3) * LL + HALO0 + q * 4);
    } else if (i < N_BODY + N_HX + N_HZ) {
      const int q = i - (N_BODY + N_HX);
      if (zm) cp16(s + HZ + q * 4, own - BRICK + LBZ * PLANE + q * 4);
    } else if (i < N16) {
      const int q = i - (N_BODY + N_HX + N_HZ), c = q >> 2;
      if (xm && zm) cp16(s + HXZ + c * 16 + (q & 3) * 4, own - dx - BRICK + LBZ * PLANE + c * LL + HALO0 + (q & 3) * 4);
    }
  }
#pragma unroll
  for (int j = 0; j < (N4 + THREADS - 1) / THREADS; ++j) {
    const int i = t + j * THREADS;
    if (i < N_HY) {
      const int r = i / LPX, px = i - r * LPX;  // r = z*4 + c
      if (ym) cp4(s + HY + (r >> 2) * HY_Z + (r & 3) * 12 + px, own - dy + (r >> 2) * PLANE + (r & 3) * LL + px * LPY + LBY);
    } else if (i < N_HY + N_HYZ) {
      const int q = i - N_HY, c = q / LPX, px = q - c * LPX;
      if (ym && zm) cp4(s + HYZ + c * 12 + px, own - dy - BRICK + LBZ * PLANE + c * LL + px * LPY + LBY);
    } else if (i < N_HY + N_HYZ + N_HXY) {
      const int r = i - (N_HY + N_HYZ);
      if (xm && ym) cp4(s + HXY + r, own - dx - dy + (r >> 2) * PLANE + (r & 3) * LL + LBX * LPY + LBY);
    } else if (i < N4) {
      const int c = i - (N_HY + N_HYZ + N_HXY);
      if (xm && ym && zm) cp4(s + HXYZ + c, own - dx - dy - BRICK + LBZ * PLANE + c * LL + LBX * LPY + LBY);
    }
  }
}

// Write the points of the brick staged in s: (NX, NY, NZ) points from
// (x0, y0, z0), masked to (ox, oy, oz) where EDGE.
template <int NX, int NY, int NZ, bool EDGE>
__device__ __forceinline__ void write_points(const float* s, float4* __restrict__ out, int x0, int y0, int z0,
                                             int ox, int oy, int oz, bool xm, bool ym, bool zm, int Y, int Z) {
  constexpr int N = NX * NY * NZ;
#pragma unroll
  for (int j = 0; j < (N + THREADS - 1) / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    if (i >= N) break;
    const int qz = i % NZ, line = i / NZ, qy = line % NY, qx = line / NY;
    if (EDGE && (qx >= ox || qy >= oy || qz >= oz)) continue;
    const int lane = qx * LPY + qy;
    // halos that hold this point: the brick below exists and the point lies
    // on this brick's low face
    const bool hx = qx == 0 && xm, hy = qy == 0 && ym, hz = qz == 0 && zm;
    float v[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      float y0v = s[BODY + qz * BODY_Z + c * LL + lane];                 // T000
      if (hx) y0v = y0v + s[HX + qz * HX_Z + c * 16 + qy + LBX * LPY - HALO0];  // T100
      float zs0 = y0v;
      if (hy) {
        float y1v = s[HY + qz * HY_Z + c * 12 + qx];                     // T010
        if (hx) y1v = y1v + s[HXY + qz * NCH + c];                       // T110
        zs0 = y0v + y1v;
      }
      float r = zs0;
      if (hz) {
        float w0 = s[HZ + c * LL + lane];                                // T001
        if (hx) w0 = w0 + s[HXZ + c * 16 + qy + LBX * LPY - HALO0];          // T101
        float zs1 = w0;
        if (hy) {
          float w1 = s[HYZ + c * 12 + qx];                               // T011
          if (hx) w1 = w1 + s[HXYZ + c];                                 // T111
          zs1 = w0 + w1;
        }
        r = zs0 + zs1;
      }
      v[c] = r;
    }
    out[((int64_t)(x0 + qx) * Y + (y0 + qy)) * Z + (z0 + qz)] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
line_table_fold_kernel(const float* __restrict__ gtable, float4* __restrict__ out,
                       int X, int Y, int Z, int nbx, int nby, int nbz) {
  extern __shared__ __align__(16) float smem[];
  const int nb = nbx * nby * nbz;
  int b = blockIdx.x;
  if (b >= nb) return;
#pragma unroll
  for (int p = 0; p < NSTAGE - 1; ++p) {
    const int pb = b + p * gridDim.x;
    if (pb < nb) stage(smem + p * STAGE, gtable, pb, brick_of(pb, nby, nbz), nby, nbz);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int it = 0; b < nb; ++it, b += gridDim.x) {
    // the ring slot of the brick written last iteration takes the brick
    // NSTAGE - 1 ahead; then wait for this iteration's brick
    const int next = b + (NSTAGE - 1) * gridDim.x;
    if (next < nb) stage(smem + ((it + NSTAGE - 1) % NSTAGE) * STAGE, gtable, next, brick_of(next, nby, nbz), nby, nbz);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NSTAGE - 1) : "memory");
    __syncthreads();

    const float* s = smem + (it % NSTAGE) * STAGE;
    const Brick k = brick_of(b, nby, nbz);
    const int x0 = k.bx * LBX, y0 = k.by * LBY, z0 = k.bz * LBZ;
    const bool xm = k.bx > 0, ym = k.by > 0, zm = k.bz > 0;
    if (k.bx < nbx - 1 && k.by < nby - 1 && k.bz < nbz - 1) {
      write_points<LBX, LBY, LBZ, false>(s, out, x0, y0, z0, LBX, LBY, LBZ, xm, ym, zm, Y, Z);
    } else {
      // the last brick of an axis owns the far face, cropped to the field
      const int ox = min(k.bx == nbx - 1 ? LPX : LBX, X - x0);
      const int oy = min(k.by == nby - 1 ? LPY : LBY, Y - y0);
      const int oz = min(k.bz == nbz - 1 ? LPZ : LBZ, Z - z0);
      write_points<LPX, LPY, LPZ, true>(s, out, x0, y0, z0, ox, oy, oz, xm, ym, zm, Y, Z);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int vrt_line_table_fold(const void* gtable, void* out, int X, int Y,
                                   int Z, int nbx, int nby, int nbz,
                                   void* stream) {
  cudaError_t err = cudaFuncSetAttribute(line_table_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, line_table_fold_kernel, THREADS, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int nb = nbx * nby * nbz;
  const int grid = nb < per_sm * sms ? nb : per_sm * sms;
  if (grid > 0) {
    line_table_fold_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        (const float*)gtable, (float4*)out, X, Y, Z, nbx, nby, nbz);
  }
  return (int)cudaGetLastError();
}
