// K2: forward float march over the line table, for Hopper (sm_90a).
//
// Replaces the TPU kernel volumeraytracer_tpu/kernels/march_lines.py
// :_march_kernel_lines (step body :587-674).  One thread per ray, the shape
// of the reference's own CUDA kernel.  Each thread loops
//
//   while (alive && rem > 0 && 0 <= p < bound - 1):
//     cell = floor(p); brick and local cell from the cell (clipped as the
//       TPU kernel clips them); base = the cell's table offset
//     if base changed: load the cell's 8 corners (lanes anchor + {0, 1, 11,
//       12}, rows z*8 + c for z in {lz, lz+1}; channels 0-2 as hi + lo,
//       the opacity as hi alone) and its absorption into registers
//     br = max(br - absorb, 0); stop if br < min_bright         (absorb only)
//     interp = sum over corners (product order, dz fastest) of w * corner
//     stop if interp[3] > 0 (opaque)
//     d += interp[0:3] * bend;  p += d * step / |d|^2;  rem -= 1
//
// and writes the end position and direction, the raw remaining budget, the
// alive flag and the brightness.  The arithmetic follows ops/march.py's
// plain march operation by operation; the build compiles with -fmad=false so
// that no multiply-add is contracted, and 1/|d|^2 is an IEEE division.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W; measured by
// chip_smoke.py and benchmarks/torch_probe_k2k3.py, see PERF.md).
// The first design loaded the 57 table values of a step (8 corners x (3 hi
// + 3 lo + opacity), and the absorption) again on every step, as scalar
// loads from rows 512 B apart.  The values repeat: a bench ray moves
// 0.032/n voxels a step and stays ~30 steps in a cell (30.05 counted at the
// bench shape), so the L1 served the same addresses step after step, and
// with the rays of a warp spread over z it served each of the 57 loads in
// ~10 sectors: 3.77 ms at the bench shape (256^3 lens, 362^2 rays, 511
// steps each).  This design keeps a cell's values in registers, keyed on
// the table offset the loads depend on (so the clamps cannot make them
// stale), and reloads them only when the ray enters another cell; the
// drivers sort the rays by cell, (z, x, y) within a line brick.  It runs in
// 0.52 ms, whatever the order (the brick-only order costs 1-2% more).
// What bounds it now is instruction issue: the step that stays in its cell
// is 196 SASS instructions (146 floating point, 12 conversions for the
// floors and the cell, the rest integer index math and the compare), and
// 67 M steps of them need ~0.39 ms at four warp instructions per cycle per
// SM at 1.98 GHz; the dependent chain of each step (floors, cell, weights,
// the IEEE division) and the reload block (88 instructions, 57 loads),
// which a warp runs whenever one of its rays changes cell, make up the
// rest.  Its bound, 120 float32 operations a step at 67 TFLOP/s, is
// 0.12 ms; -fmad=false, which the iteration counts need, leaves it half
// that float rate.  The TPU kernel's window scheduler, dual-brick residency
// and one-hot MXU gathers served the TPU's lack of a fast dynamic gather and
// are not carried over.

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

  // the cell's corners, loaded when the ray enters a cell and kept in
  // registers while it stays there: channels 0-2 as hi + lo, the opacity,
  // and the absorption.  Keyed on the table offset, which is all the loads
  // depend on, so the clamps below cannot make it stale.
  int64_t cur = -1;
  float c0[8], c1[8], c2[8], op[8];
  float absorb = 0.0f;

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
    const int64_t base = brick * (LS * LL) + (int64_t)(lz * TCH) * LL + lx * LPY + ly;
    if (base != cur) {
      const float* t = table + base;
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const int lane = ((o >> 2) & 1) * LPY + ((o >> 1) & 1);   // dx*11 + dy
        const float* c = t + (o & 1) * (TCH * LL) + lane;           // dz: next z point
        c0[o] = __ldg(c) + __ldg(c + LCH * LL);
        c1[o] = __ldg(c + LL) + __ldg(c + (LCH + 1) * LL);
        c2[o] = __ldg(c + 2 * LL) + __ldg(c + (LCH + 2) * LL);
        op[o] = __ldg(c + 3 * LL);
      }
      if (has_absorb) absorb = __ldg(t + ABSORB_CH * LL);
      cur = base;
    }

    if (has_absorb) {
      br = fmaxf(br - absorb, 0.0f);
      if (br < min_bright) { alive = 0; break; }
    }

    const float fx = px - fpx, fy = py - fpy, fz = pz - fpz;
    const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
    const float w[8] = {gx * gy * gz, gx * gy * fz, gx * fy * gz, gx * fy * fz,
                        fx * gy * gz, fx * gy * fz, fx * fy * gz, fx * fy * fz};
    float in0 = 0.0f, in1 = 0.0f, in2 = 0.0f, in3 = 0.0f;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      in0 = in0 + w[o] * c0[o];
      in1 = in1 + w[o] * c1[o];
      in2 = in2 + w[o] * c2[o];
      in3 = in3 + w[o] * op[o];
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
