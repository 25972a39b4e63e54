// K6: reverse-replay adjoint of the forward float march over the point
// table, for Hopper (sm_90a).
//
// Replaces the TPU kernel volumeraytracer_tpu/kernels/march_bwd.py
// :_bwd_kernel (step body :302-387; equations :11-22).  It computes what K3
// (march_lines_bwd.cu) computes, over the other table layout.  The forward
// step is algebraically invertible:
//
//   forward:  u = v + bend*g(x);       x' = x + step*u/|u|^2
//   reverse:  x = x' - step*u/|u|^2;   v = u - bend*g(x)
//
// so no trajectory is saved.  One thread per ray starts from the end state
// (x', u) and its cotangents (xb, vb), and replays min(nexec, max_steps)
// steps backwards; per step:
//
//   ilen = 1/|u|^2;  x = x' - u*step*ilen;  corners of floor(x), clipped as
//     K5 clips them; C_o = hi + lo rows of channels 0-2; w_o, dw_o/dx
//   g = sum_o w_o C_o;  v = u - g*bend
//   t = sum_i step_i u_i xb_i
//   ub = vb + step*ilen*xb - 2u*ilen^2*t;   h = bend*ub
//   xb += sum_o (dw_o/dx) (C_o . h);  vb = ub
//   Cb_o += w_o*h   (into rows 0-2, lanes lid + {0, 1, 17, 18, 153, 154,
//                    170, 171} of the brick's (8, 1408) gradient block)
//
// and writes d_pos0 = xb, d_dir0 = vb, the reconstructed start position and
// the residual nexec - replayed (> 0 only when max_steps cut the replay).
// The arithmetic follows the TPU kernel's operand order, and the build
// compiles with -fmad=false, so the per-ray outputs equal the plain version's
// (kernels/march_pallas.py:_bwd_points_plain) bit for bit, and K3's on the
// same forward; the gradient table is summed with float atomics, in an order
// that changes from run to run.
//
// What bounds it on the H100: the dependent chain of each step (48 corner
// loads behind an address computed from the previous step, ~200 flops) and
// the atomics of the gradient table.  A ray spends ~10 steps in a cell, so
// the thread keeps its 24 corner gradients in registers while the cell stays
// the same and adds them to the table (24 atomics) only when the cell
// changes: the TPU kernel's per-window accumulators and the roll-fold of its
// flush (:151-175), done by addressing.  Rays are sorted by the point brick
// of their end position, so neighbouring threads read and add into the same
// few bricks, which stay in L1/L2.  The gradient table is zeroed by the
// wrapper (0.74 GB at 256^3).  The TPU kernel's window scheduler, VMEM brick
// residency, lane-rolled corner copies, one-hot MXU gather/scatter and bf16
// hi/lo split of the gradients (to survive the MXU) are not carried over: a
// float32 atomic needs no split.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BX = 8, BY = 8, BZ = 16;
constexpr int PY = BY + 1, PZ = BZ + 1;
constexpr int PVP = 1408;
constexpr int TCH = 8, LCH = 5;
constexpr int THREADS = 128;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// table offset of corner o (dz fastest, then dy, then dx), channel row c
__device__ __forceinline__ int corner_off(int o, int c) {
  return c * PVP + (((o >> 2) & 1) * PY + ((o >> 1) & 1)) * PZ + (o & 1);
}

__device__ __forceinline__ void flush(float* __restrict__ gtable, int64_t base,
                                      float (&acc)[24]) {
  if (base < 0) return;
#pragma unroll
  for (int o = 0; o < 8; ++o) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      atomicAdd(gtable + base + corner_off(o, c), acc[o * 3 + c]);
      acc[o * 3 + c] = 0.0f;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
march_points_bwd_kernel(const float* __restrict__ table, float* __restrict__ gtable,
                        int nbx, int nby, int nbz,
                        const float* __restrict__ pos_in,
                        const float* __restrict__ dir_in,
                        const int* __restrict__ nexec,
                        const float* __restrict__ dpos_in,
                        const float* __restrict__ ddir_in,
                        float* __restrict__ dpos_out, float* __restrict__ ddir_out,
                        float* __restrict__ recon_out, int* __restrict__ resid_out,
                        int n, int max_steps,
                        float ex, float ey, float ez,
                        float sx, float sy, float sz) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float px = pos_in[3 * i], py = pos_in[3 * i + 1], pz = pos_in[3 * i + 2];
  float vx = dir_in[3 * i], vy = dir_in[3 * i + 1], vz = dir_in[3 * i + 2];
  float ax = dpos_in[3 * i], ay = dpos_in[3 * i + 1], az = dpos_in[3 * i + 2];
  float bx = ddir_in[3 * i], by = ddir_in[3 * i + 1], bz = ddir_in[3 * i + 2];
  const int todo = nexec[i];
  const int steps = todo < max_steps ? todo : max_steps;

  float acc[24];
#pragma unroll
  for (int k = 0; k < 24; ++k) acc[k] = 0.0f;
  int64_t cur = -1;

  for (int k = 0; k < steps; ++k) {
    const float ilen = 1.0f / (vx * vx + vy * vy + vz * vz);
    const float cx = px - vx * sx * ilen;
    const float cy = py - vy * sy * ilen;
    const float cz = pz - vz * sz * ilen;
    const float fpx = floorf(cx), fpy = floorf(cy), fpz = floorf(cz);
    const int cbx = clampi((int)fpx / BX, 0, nbx - 1);
    const int cby = clampi((int)fpy / BY, 0, nby - 1);
    const int cbz = clampi((int)fpz / BZ, 0, nbz - 1);
    const int lx = clampi((int)(fpx - (float)(cbx * BX)), 0, BX - 1);
    const int ly = clampi((int)(fpy - (float)(cby * BY)), 0, BY - 1);
    const int lz = clampi((int)(fpz - (float)(cbz * BZ)), 0, BZ - 1);
    const int64_t brick = ((int64_t)cbx * nby + cby) * nbz + cbz;
    // the gradient table has the table's shape (GCH = TCH = 8 rows)
    const int64_t base = brick * (TCH * PVP) + (lx * PY + ly) * PZ + lz;
    if (base != cur) {
      flush(gtable, cur, acc);
      cur = base;
    }
    const float* t = table + base;

    const float fx = cx - fpx, fy = cy - fpy, fz = cz - fpz;
    const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
    const float w[8] = {gx * gy * gz, gx * gy * fz, gx * fy * gz, gx * fy * fz,
                        fx * gy * gz, fx * gy * fz, fx * fy * gz, fx * fy * fz};
    const float yz[4] = {gy * gz, gy * fz, fy * gz, fy * fz};
    const float xz[4] = {gx * gz, gx * fz, fx * gz, fx * fz};
    const float xy[4] = {gx * gy, gx * fy, fx * gy, fx * fy};
    const float dwx[8] = {-yz[0], -yz[1], -yz[2], -yz[3], yz[0], yz[1], yz[2], yz[3]};
    const float dwy[8] = {-xz[0], -xz[1], xz[0], xz[1], -xz[2], -xz[3], xz[2], xz[3]};
    const float dwz[8] = {-xy[0], xy[0], -xy[1], xy[1], -xy[2], xy[2], -xy[3], xy[3]};

    float chv[8][3];
    float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        chv[o][c] = __ldg(t + corner_off(o, c)) + __ldg(t + corner_off(o, LCH + c));
      g0 = g0 + w[o] * chv[o][0];
      g1 = g1 + w[o] * chv[o][1];
      g2 = g2 + w[o] * chv[o][2];
    }
    const float nvx = vx - g0 * ex;
    const float nvy = vy - g1 * ey;
    const float nvz = vz - g2 * ez;

    const float tt = sx * vx * ax + sy * vy * ay + sz * vz * az;
    const float il2 = ilen * ilen;
    const float ubx = bx + sx * ilen * ax - 2.0f * vx * il2 * tt;
    const float uby = by + sy * ilen * ay - 2.0f * vy * il2 * tt;
    const float ubz = bz + sz * ilen * az - 2.0f * vz * il2 * tt;
    const float h0 = ex * ubx, h1 = ey * uby, h2 = ez * ubz;

    float Gx = 0.0f, Gy = 0.0f, Gz = 0.0f;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const float m = chv[o][0] * h0 + chv[o][1] * h1 + chv[o][2] * h2;
      Gx = Gx + dwx[o] * m;
      Gy = Gy + dwy[o] * m;
      Gz = Gz + dwz[o] * m;
      acc[o * 3 + 0] = acc[o * 3 + 0] + w[o] * h0;
      acc[o * 3 + 1] = acc[o * 3 + 1] + w[o] * h1;
      acc[o * 3 + 2] = acc[o * 3 + 2] + w[o] * h2;
    }

    px = cx; py = cy; pz = cz;
    vx = nvx; vy = nvy; vz = nvz;
    ax = ax + Gx; ay = ay + Gy; az = az + Gz;
    bx = ubx; by = uby; bz = ubz;
  }
  flush(gtable, cur, acc);

  dpos_out[3 * i] = ax; dpos_out[3 * i + 1] = ay; dpos_out[3 * i + 2] = az;
  ddir_out[3 * i] = bx; ddir_out[3 * i + 1] = by; ddir_out[3 * i + 2] = bz;
  recon_out[3 * i] = px; recon_out[3 * i + 1] = py; recon_out[3 * i + 2] = pz;
  resid_out[i] = todo - steps;
}

}  // namespace

extern "C" int vrt_march_points_bwd(
    const void* table, void* gtable, int nbx, int nby, int nbz,
    const void* pos_in, const void* dir_in, const void* nexec,
    const void* dpos_in, const void* ddir_in, void* dpos_out, void* ddir_out,
    void* recon_out, void* resid_out, int n, int max_steps, float bendx,
    float bendy, float bendz, float stepx, float stepy, float stepz,
    void* stream) {
  if (n > 0) {
    march_points_bwd_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                              (cudaStream_t)stream>>>(
        (const float*)table, (float*)gtable, nbx, nby, nbz,
        (const float*)pos_in, (const float*)dir_in, (const int*)nexec,
        (const float*)dpos_in, (const float*)ddir_in, (float*)dpos_out,
        (float*)ddir_out, (float*)recon_out, (int*)resid_out, n, max_steps,
        bendx, bendy, bendz, stepx, stepy, stepz);
  }
  return (int)cudaGetLastError();
}
