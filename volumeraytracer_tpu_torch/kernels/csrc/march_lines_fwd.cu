// K2: forward float march over the line table, for Hopper (sm_90a).
//
// Replaces the TPU kernel volumeraytracer_tpu/kernels/march_lines.py
// :_march_kernel_lines (step body :587-674).  One thread per ray, the shape
// of the reference's own CUDA kernel.  Each thread loops
//
//   while (alive && rem > 0 && 0 <= p < bound - 1):
//     cell = floor(p); brick and local cell from the cell (clipped as the
//       TPU kernel clips them)
//     br = max(br - absorb[cell], 0); stop if br < min_bright    (absorb only)
//     gather the 8 corners: lanes anchor + {0, 1, 11, 12}, rows z*8 + c for
//       z in {lz, lz+1}; channels 0-2 are hi + lo, opacity is hi alone
//     interp = sum over corners (product order, dz fastest) of w * corner
//     stop if interp[3] > 0 (opaque)
//     d += interp[0:3] * bend;  p += d * step / |d|^2;  rem -= 1
//
// and writes the end position and direction, the raw remaining budget, the
// alive flag and the brightness.  The arithmetic follows ops/march.py's
// plain march operation by operation; the build compiles with -fmad=false so
// that no multiply-add is contracted, and 1/|d|^2 is an IEEE division.
//
// What bounds it on the H100: the dependent chain of each step (57 table
// loads behind an address computed from the previous step's position, then
// ~80 floating-point operations), i.e. load latency, not bandwidth: rays
// sorted by brick make neighbouring threads read the same few 36 KB bricks,
// which stay in L1/L2.  The design keeps one ray per thread with no shared
// state, so occupancy hides the latency; rays that stop early leave their
// lanes idle, which the brick sort also limits, since neighbouring rays
// march alike.  The TPU kernel's window scheduler, dual-brick residency and
// one-hot MXU gathers served the TPU's lack of a fast dynamic gather and are
// not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LBX = 10, LBY = 10, LBZ = 8;
constexpr int LPY = LBY + 1;
constexpr int TCH = 8, LCH = 5, ABSORB_CH = 4;
constexpr int LS = 9 * TCH;   // 72
constexpr int LL = 128;
constexpr int THREADS = 128;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(THREADS)
march_lines_fwd_kernel(const float* __restrict__ table,
                       int nbx, int nby, int nbz, float xb, float yb, float zb,
                       const float* __restrict__ pos_in,
                       const float* __restrict__ dir_in,
                       const int* __restrict__ rem_in,
                       const int* __restrict__ alive_in,
                       const float* __restrict__ br_in,
                       float* __restrict__ pos_out, float* __restrict__ dir_out,
                       int* __restrict__ rem_out, int* __restrict__ alive_out,
                       float* __restrict__ br_out, int n,
                       float bendx, float bendy, float bendz,
                       float stepx, float stepy, float stepz,
                       float min_bright, int has_absorb) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float px = pos_in[3 * i], py = pos_in[3 * i + 1], pz = pos_in[3 * i + 2];
  float dx = dir_in[3 * i], dy = dir_in[3 * i + 1], dz = dir_in[3 * i + 2];
  int rem = rem_in[i];
  int alive = alive_in[i];
  float br = br_in[i];

  while (alive) {
    const bool inb = px >= 0.0f && px < xb && py >= 0.0f && py < yb &&
                     pz >= 0.0f && pz < zb;
    if (!inb || rem <= 0) { alive = 0; break; }

    const float fpx = floorf(px), fpy = floorf(py), fpz = floorf(pz);
    const int cbx = clampi((int)fpx / LBX, 0, nbx - 1);
    const int cby = clampi((int)fpy / LBY, 0, nby - 1);
    const int cbz = clampi((int)fpz / LBZ, 0, nbz - 1);
    const int lx = clampi((int)(fpx - (float)(cbx * LBX)), 0, LBX - 1);
    const int ly = clampi((int)(fpy - (float)(cby * LBY)), 0, LBY - 1);
    const int lz = clampi((int)(fpz - (float)(cbz * LBZ)), 0, LBZ - 1);
    const int64_t brick = ((int64_t)cbx * nby + cby) * nbz + cbz;
    const float* t = table + brick * (LS * LL) + (int64_t)(lz * TCH) * LL + lx * LPY + ly;

    if (has_absorb) {
      br = fmaxf(br - __ldg(t + ABSORB_CH * LL), 0.0f);
      if (br < min_bright) { alive = 0; break; }
    }

    const float fx = px - fpx, fy = py - fpy, fz = pz - fpz;
    const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
    const float w[8] = {gx * gy * gz, gx * gy * fz, gx * fy * gz, gx * fy * fz,
                        fx * gy * gz, fx * gy * fz, fx * fy * gz, fx * fy * fz};
    float in0 = 0.0f, in1 = 0.0f, in2 = 0.0f, in3 = 0.0f;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const int lane = ((o >> 2) & 1) * LPY + ((o >> 1) & 1);   // dx*11 + dy
      const float* c = t + (o & 1) * (TCH * LL) + lane;           // dz: next z point
      in0 = in0 + w[o] * (__ldg(c) + __ldg(c + LCH * LL));
      in1 = in1 + w[o] * (__ldg(c + LL) + __ldg(c + (LCH + 1) * LL));
      in2 = in2 + w[o] * (__ldg(c + 2 * LL) + __ldg(c + (LCH + 2) * LL));
      in3 = in3 + w[o] * __ldg(c + 3 * LL);
    }
    if (in3 > 0.0f) { alive = 0; break; }

    dx = dx + in0 * bendx;
    dy = dy + in1 * bendy;
    dz = dz + in2 * bendz;
    const float ilen = 1.0f / (dx * dx + dy * dy + dz * dz);
    px = px + dx * stepx * ilen;
    py = py + dy * stepy * ilen;
    pz = pz + dz * stepz * ilen;
    rem -= 1;
  }

  pos_out[3 * i] = px; pos_out[3 * i + 1] = py; pos_out[3 * i + 2] = pz;
  dir_out[3 * i] = dx; dir_out[3 * i + 1] = dy; dir_out[3 * i + 2] = dz;
  rem_out[i] = rem;
  alive_out[i] = alive;
  br_out[i] = br;
}

}  // namespace

extern "C" int vrt_march_lines_fwd(
    const void* table, int nbx, int nby, int nbz, int X, int Y, int Z,
    const void* pos_in, const void* dir_in, const void* rem_in,
    const void* alive_in, const void* br_in, void* pos_out, void* dir_out,
    void* rem_out, void* alive_out, void* br_out, int n, float bendx,
    float bendy, float bendz, float stepx, float stepy, float stepz,
    float min_bright, int has_absorb, void* stream) {
  if (n > 0) {
    march_lines_fwd_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                             (cudaStream_t)stream>>>(
        (const float*)table, nbx, nby, nbz, (float)(X - 1), (float)(Y - 1),
        (float)(Z - 1), (const float*)pos_in, (const float*)dir_in,
        (const int*)rem_in, (const int*)alive_in, (const float*)br_in,
        (float*)pos_out, (float*)dir_out, (int*)rem_out, (int*)alive_out,
        (float*)br_out, n, bendx, bendy, bendz, stepx, stepy, stepz,
        min_bright, has_absorb);
  }
  return (int)cudaGetLastError();
}
