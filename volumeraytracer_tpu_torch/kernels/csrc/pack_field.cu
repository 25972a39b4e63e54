// P1 and P2: the field preprocessing (the packed-field build) and its
// adjoint, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package builds the packed field in
// volumeraytracer_tpu/ops/fields.py:build_packed_field (:124), plain jnp
// that XLA fuses into a few elementwise passes (ior_log :46, the stamp of
// _axis_diff :52-93, opacity_channel :96, a channels-last stack), and takes
// its VJP through the same fusion.  Eager torch runs the port's plain
// version (ops/fields.py) op by op: 54 slices of the log field, each
// scaled and added into an accumulator, then a stack copy, and autograd
// zero-fills a full-size tensor for every slice's backward.
//
// P1 (pack_field_fwd_kernel), for each voxel i of the (X-2, Y-2, Z-2)
// output and each axis a:
//
//   L      = logf(ior) * 0x420000
//   out_a  = (sum over (p, q) in {0,1,2}^2, p outer, of
//             S[p][q] * (L[i + 2 e_a + (p, q)_perp] - L[i + (p, q)_perp]))
//            / 207872                          (207872 = 812 * 256)
//   out_3  = opacity[i + 1] (the opacity channel, made by the wrapper), or
//            the transparent constant when there is no translucency
//
// with (p, q) on the axes other than a in ascending order, S the {14, 47,
// 162} stamp, the sum starting from 0 and each step one
// acc = acc + w * (hi - lo), as the plain version adds its taps.  The
// record is one float4 a voxel, so no stack copy follows.  logf (not
// __logf), -fmad=false and IEEE division keep every operation the plain
// version's.
//
// P2 (pack_field_bwd_kernel), the adjoint in gather form, one ior voxel j
// at a time, with no atomics:
//
//   G_a  = d_packed[..., a] / 207872            (channel 3 is ignored)
//   dL   = sum over a, (p, q) of S[p][q] * (G_a[j - 2 e_a - (p, q)_perp]
//                                           - G_a[j - (p, q)_perp])
//          (a term whose output index falls outside [0, N - 2) adds 0)
//   d_ior = dL * 0x420000 / ior                 (autograd's mul, then log)
//
// What bounds them on the H100: bytes.  P1 reads the ior (and the opacity
// grid, with a translucency) once and writes 16 B an output voxel; P2
// reads the 16 B cotangent record and the ior and writes the ior's
// gradient.  Each of the 54 neighbour values a voxel reads (of 26 distinct
// voxels of L in P1) would otherwise go to L2 or DRAM, and P1's logf would
// run 26 times a voxel.  So a block owns a tile of TY x TZ voxels in
// (y, z) and marches it along x over CX planes, keeping three planes of the
// (TY + 2) x (TZ + 2) halo tile in shared memory in a ring: P1 keeps L
// (each ior voxel gets its logf once a block, ~1.5 times in all with the
// halos), P2 keeps G's three channels.  Each step loads one new plane, so the device memory
// is read about once; a warp's 32 threads take 32 consecutive z, so the
// loads, the shared-memory reads (consecutive words, no bank conflicts)
// and P1's float4 stores are contiguous.  Offsets into the fields are 64
// bits wide (a 1024^3 packed field holds 2^32 floats).  Every tile loop
// steps by the block's thread count, so a host build with one thread a
// block (VRT_BLOCK_THREADS 1, the tests) runs each block whole.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TY = 8, TZ = 32;  // a block's tile in (y, z)
constexpr int CX = 16;          // the x planes a block marches
constexpr int PY = TY + 2, PZ = TZ + 2, PLANE = PY * PZ;
#ifdef VRT_BLOCK_THREADS
constexpr int THREADS = VRT_BLOCK_THREADS;
#else
constexpr int THREADS = TY * TZ;
#endif
constexpr float LOG_UNIT = 4325376.0f;  // 0x420000
constexpr float DIVISOR = 207872.0f;    // the 3-D stamp's weight 812 * 0x100

// The {14, 47, 162} stamp, S[p][q]: 162 at the centre, 47 on its edges,
// 14 at its corners.
__device__ __forceinline__ float stamp(int p, int q) {
  return p == 1 ? (q == 1 ? 162.0f : 47.0f) : (q == 1 ? 47.0f : 14.0f);
}

// L of ior plane xi over the tile's (y0, z0) corner and its +2 halo; 0
// outside the field (read only by outputs that the tile skips).
__device__ __forceinline__ void load_log_plane(float* dst, const float* __restrict__ ior, int xi, int y0,
                                               int z0, int Y, int Z) {
  const float* src = ior + (int64_t)xi * Y * Z;
  for (int i = threadIdx.x; i < PLANE; i += THREADS) {
    const int r = i / PZ, c = i - r * PZ;
    const int y = y0 + r, z = z0 + c;
    float v = 0.0f;
    if (y < Y && z < Z) v = logf(__ldg(src + (int64_t)y * Z + z)) * LOG_UNIT;
    dst[i] = v;
  }
}

__global__ void __launch_bounds__(THREADS)
pack_field_fwd_kernel(const float* __restrict__ ior, const float* __restrict__ opacity, float4* __restrict__ out,
                      int X, int Y, int Z, int tiles_y, int tiles_z, float transparent) {
  __shared__ float L[3][PLANE];
  const int OX = X - 2, OY = Y - 2, OZ = Z - 2;
  int b = blockIdx.x;
  const int z0 = (b % tiles_z) * TZ;
  b /= tiles_z;
  const int y0 = (b % tiles_y) * TY;
  const int x0 = (b / tiles_y) * CX;
  const int x1 = min(x0 + CX, OX);
  load_log_plane(L[x0 % 3], ior, x0, y0, z0, Y, Z);
  load_log_plane(L[(x0 + 1) % 3], ior, x0 + 1, y0, z0, Y, Z);
  for (int x = x0; x < x1; ++x) {
    __syncthreads();  // slot (x + 2) % 3 was plane x - 1, read by the last step
    load_log_plane(L[(x + 2) % 3], ior, x + 2, y0, z0, Y, Z);
    __syncthreads();
    const float* P[3] = {L[x % 3], L[(x + 1) % 3], L[(x + 2) % 3]};  // ior planes x, x + 1, x + 2
    for (int i = threadIdx.x; i < TY * TZ; i += THREADS) {
      const int ly = i / TZ, lz = i - ly * TZ;
      const int y = y0 + ly, z = z0 + lz;
      if (y >= OY || z >= OZ) continue;
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
#pragma unroll
      for (int p = 0; p < 3; ++p) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float w = stamp(p, q);
          // axis 0: (p, q) on (y, z); axis 1: on (x, z); axis 2: on (x, y)
          a0 = a0 + w * (P[2][(ly + p) * PZ + lz + q] - P[0][(ly + p) * PZ + lz + q]);
          a1 = a1 + w * (P[p][(ly + 2) * PZ + lz + q] - P[p][ly * PZ + lz + q]);
          a2 = a2 + w * (P[p][(ly + q) * PZ + lz + 2] - P[p][(ly + q) * PZ + lz]);
        }
      }
      const float op = opacity != nullptr ? __ldg(opacity + ((int64_t)(x + 1) * Y + y + 1) * Z + z + 1)
                                          : transparent;
      out[((int64_t)x * OY + y) * OZ + z] = make_float4(a0 / DIVISOR, a1 / DIVISOR, a2 / DIVISOR, op);
    }
  }
}

// G of output plane xo over the tile's (y0 - 2, z0 - 2) corner and its
// +2 halo, channel by channel; 0 outside the output grid.
__device__ __forceinline__ void load_grad_plane(float (*dst)[PLANE], const float4* __restrict__ g, int xo, int y0,
                                                int z0, int OX, int OY, int OZ) {
  for (int i = threadIdx.x; i < PLANE; i += THREADS) {
    const int r = i / PZ, c = i - r * PZ;
    const int y = y0 - 2 + r, z = z0 - 2 + c;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (xo >= 0 && xo < OX && y >= 0 && y < OY && z >= 0 && z < OZ) v = __ldg(g + ((int64_t)xo * OY + y) * OZ + z);
    dst[0][i] = v.x / DIVISOR;
    dst[1][i] = v.y / DIVISOR;
    dst[2][i] = v.z / DIVISOR;
  }
}

__global__ void __launch_bounds__(THREADS)
pack_field_bwd_kernel(const float* __restrict__ ior, const float4* __restrict__ g, float* __restrict__ d_ior,
                      int X, int Y, int Z, int tiles_y, int tiles_z) {
  __shared__ float G[3][3][PLANE];  // [slot][channel]
  const int OX = X - 2, OY = Y - 2, OZ = Z - 2;
  int b = blockIdx.x;
  const int z0 = (b % tiles_z) * TZ;
  b /= tiles_z;
  const int y0 = (b % tiles_y) * TY;
  const int x0 = (b / tiles_y) * CX;
  const int x1 = min(x0 + CX, X);
  // output plane xo lives in slot (xo + 3) % 3
  load_grad_plane(G[(x0 + 1) % 3], g, x0 - 2, y0, z0, OX, OY, OZ);
  load_grad_plane(G[(x0 + 2) % 3], g, x0 - 1, y0, z0, OX, OY, OZ);
  for (int x = x0; x < x1; ++x) {
    __syncthreads();  // slot x % 3 was plane x - 3, read by the last step
    load_grad_plane(G[x % 3], g, x, y0, z0, OX, OY, OZ);
    __syncthreads();
    const float(*Q[3])[PLANE] = {G[x % 3], G[(x + 2) % 3], G[(x + 1) % 3]};  // output planes x, x - 1, x - 2
    for (int i = threadIdx.x; i < TY * TZ; i += THREADS) {
      const int ly = i / TZ, lz = i - ly * TZ;
      const int y = y0 + ly, z = z0 + lz;
      if (y >= Y || z >= Z) continue;
      float d = 0.0f;
#pragma unroll
      for (int p = 0; p < 3; ++p) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float w = stamp(p, q);
          // the tile's row of output y - k is ly + 2 - k, its column of z - k is lz + 2 - k
          const int rp = ly + 2 - p, rq = ly + 2 - q, cq = lz + 2 - q;
          d = d + w * (Q[2][0][rp * PZ + cq] - Q[0][0][rp * PZ + cq]);
          d = d + w * (Q[p][1][ly * PZ + cq] - Q[p][1][(ly + 2) * PZ + cq]);
          d = d + w * (Q[p][2][rq * PZ + lz] - Q[p][2][rq * PZ + lz + 2]);
        }
      }
      const int64_t j = ((int64_t)x * Y + y) * Z + z;
      d_ior[j] = d * LOG_UNIT / __ldg(ior + j);
    }
  }
}

int blocks_for(int nx, int ny, int nz, int* tiles_y, int* tiles_z) {
  *tiles_y = (ny + TY - 1) / TY;
  *tiles_z = (nz + TZ - 1) / TZ;
  return ((nx + CX - 1) / CX) * *tiles_y * *tiles_z;
}

}  // namespace

// P1: ior (X, Y, Z) float32, the opacity grid (X, Y, Z) float32 or null,
// out (X - 2, Y - 2, Z - 2, 4) float32; X, Y, Z >= 3.
extern "C" int vrt_pack_field_fwd(const void* ior, const void* opacity, void* out, int X, int Y, int Z,
                                  float transparent, void* stream) {
  int tiles_y, tiles_z;
  const int blocks = blocks_for(X - 2, Y - 2, Z - 2, &tiles_y, &tiles_z);
  pack_field_fwd_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)ior, (const float*)opacity, (float4*)out, X, Y, Z, tiles_y, tiles_z, transparent);
  return (int)cudaGetLastError();
}

// P2: ior (X, Y, Z) float32, the cotangent (X - 2, Y - 2, Z - 2, 4)
// float32, 16-byte aligned, d_ior (X, Y, Z) float32.
extern "C" int vrt_pack_field_bwd(const void* ior, const void* d_packed, void* d_ior, int X, int Y, int Z,
                                  void* stream) {
  int tiles_y, tiles_z;
  const int blocks = blocks_for(X, Y, Z, &tiles_y, &tiles_z);
  pack_field_bwd_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)ior, (const float4*)d_packed, (float*)d_ior, X, Y, Z, tiles_y, tiles_z);
  return (int)cudaGetLastError();
}
