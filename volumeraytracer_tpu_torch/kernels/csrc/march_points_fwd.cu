// K5: forward float march over the point table, for Hopper (sm_90a).
//
// Replaces the TPU kernel volumeraytracer_tpu/kernels/march_pallas.py
// :_march_kernel (step body :393-451).  It computes what K2
// (march_lines_fwd.cu) computes, over the other table layout: one thread per
// ray loops
//
//   while (alive && rem > 0 && 0 <= p < bound - 1):
//     cell = floor(p); brick of 8x8x16 cells and local cell from the cell
//       (clipped as the TPU kernel clips them); base = the cell's table offset
//     if base changed: load the cell's 8 corners (lanes anchor + {0, 1, 17,
//       18, 153, 154, 170, 171} of the brick's 9x9x17 point grid, one row of
//       1408 lanes per channel; channels 0-2 as hi + lo, the opacity as hi
//       alone) and its absorption into registers
//     br = max(br - absorb, 0); stop if br < min_bright          (absorb only)
//     interp = sum over corners (product order, dz fastest) of w * corner
//     stop if interp[3] > 0 (opaque)
//     d += interp[0:3] * bend;  p += d * step / |d|^2;  rem -= 1
//
// and writes the end position and direction, the raw remaining budget, the
// alive flag and the brightness.  The step's arithmetic is K2's, operation
// for operation, and the build compiles with -fmad=false; the point and the
// line table hold the same bf16 hi/lo values at the same field points, so
// K5's results equal K2's on the same rays.  Only the addressing differs:
//
//   brick  b = (cbx*nby + cby)*nbz + cbz,  cb = clamp(floor(p)/B, 0, nb-1)
//   anchor lid = (lx*9 + ly)*17 + lz;  row c of point q at b*8*1408 + c*1408 + q
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W, SM clock 1980
// MHz; measured by chip_smoke.py and volumeraytracer_tpu_torch/probes/
// probe_k4k6.py, see PERF.md).  The first design loaded the 57 table values
// of a step (8 corners x (3 hi + 3 lo + opacity), and the absorption) again
// on every step: a step loop of 275 SASS instructions, 0.71-0.72 ms at the
// bench shape (256^3 lens, 362^2 rays, 511 steps each).  Rays in the
// bench's order within a point brick read z-consecutive lanes, so the L1
// served those loads in few sectors, and what bounded it was issuing the
// step's instructions (4,096 warps x 511 steps x 275 is 0.58 G warp
// instructions, 0.55 ms at four a cycle on 132 SMs at 1.98 GHz), not load
// latency.  This design keeps a cell's values in registers, keyed on the
// table offset the loads depend on (so the clamps cannot make them stale),
// and reloads them only when the ray enters another cell (30.05 steps a
// cell counted at the bench shape).  The step that stays in its cell is 192
// instructions and the reload block 88 (its 57 loads); ptxas: 64 registers,
// no spills.  It runs in 0.52 ms, bound by instruction issue as K2 is (0.40
// G warp instructions need 0.38 ms at the issue rate; the dependent chain of
// each step and the reload blocks make up the rest).  Its bound, 120
// float32 operations a step at 67 TFLOP/s, is 0.12 ms; -fmad=false, which
// the iteration counts need, leaves it at most half that float rate.  Rays
// are sorted by point brick alone: a (brick, cell) order runs within 0.5% of
// it.  The TPU kernel's window scheduler, per-sublane brick residency,
// lane-rolled corner copies and one-hot MXU gathers served the TPU's lack
// of a fast dynamic gather and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BX = 8, BY = 8, BZ = 16;
constexpr int PY = BY + 1, PZ = BZ + 1;
constexpr int PVP = 1408;
constexpr int TCH = 8, LCH = 5, ABSORB_CH = 4;
constexpr int THREADS = 128;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(THREADS)
march_points_fwd_kernel(const float* __restrict__ table,
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
    const int cbx = clampi((int)fpx / BX, 0, nbx - 1);
    const int cby = clampi((int)fpy / BY, 0, nby - 1);
    const int cbz = clampi((int)fpz / BZ, 0, nbz - 1);
    const int lx = clampi((int)(fpx - (float)(cbx * BX)), 0, BX - 1);
    const int ly = clampi((int)(fpy - (float)(cby * BY)), 0, BY - 1);
    const int lz = clampi((int)(fpz - (float)(cbz * BZ)), 0, BZ - 1);
    const int64_t brick = ((int64_t)cbx * nby + cby) * nbz + cbz;
    const int64_t base = brick * (TCH * PVP) + (lx * PY + ly) * PZ + lz;
    if (base != cur) {
      const float* t = table + base;
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        // corner (dx, dy, dz) = (o>>2, o>>1, o) & 1: lane offset (dx*9 + dy)*17 + dz
        const float* c = t + (((o >> 2) & 1) * PY + ((o >> 1) & 1)) * PZ + (o & 1);
        c0[o] = __ldg(c) + __ldg(c + LCH * PVP);
        c1[o] = __ldg(c + PVP) + __ldg(c + (LCH + 1) * PVP);
        c2[o] = __ldg(c + 2 * PVP) + __ldg(c + (LCH + 2) * PVP);
        op[o] = __ldg(c + 3 * PVP);
      }
      if (has_absorb) absorb = __ldg(t + ABSORB_CH * PVP);
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

extern "C" int vrt_march_points_fwd(
    const void* table, int nbx, int nby, int nbz, int X, int Y, int Z,
    const void* pos_in, const void* dir_in, const void* rem_in,
    const void* alive_in, const void* br_in, void* pos_out, void* dir_out,
    void* rem_out, void* alive_out, void* br_out, int n, float bendx,
    float bendy, float bendz, float stepx, float stepy, float stepz,
    float min_bright, int has_absorb, void* stream) {
  if (n > 0) {
    march_points_fwd_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
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
