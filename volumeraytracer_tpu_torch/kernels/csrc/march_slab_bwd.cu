// S2: the adjoint of S1's window (march_slab_fwd.cu), the brick path's
// window march, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package takes the gradient of a
// window of volumeraytracer_tpu/parallel/bricks.py:_window_fn (:212) by
// rematerialising its jax.checkpoint windows (:311-314), and the port's
// plain version (kernels/march_slab.py:slab_window_vjp_plain) runs
// autograd through the window's eager steps.  One thread a ray starts from
// the window's start state (x0, v0), its executed steps nexec = remaining
// at the start - remaining at the end (each executed step spends one; they
// are the window's first nexec steps, which S1 and the plain step take
// without a test failing), and the cotangents (xb, vb) of the end position
// and direction.  It recomputes the executed steps with S1's arithmetic
// (march_slab.cuh), keeps each step's (x, v) in a per-thread stash of
// STASH entries, and walks them back, K3's and R2's step adjoint:
//
//   l = x - offset;  w, dw/dl from l - floor(l);  g = sum_o w_o C_o
//   u = v + g * bend;  ilen = 1 / |u|^2         (as the forward computed)
//   t = sum_i step_i u_i xb_i
//   ub = vb + step * ilen * xb - 2 u ilen^2 t
//   e = bend * ub;  xb = xb + sum_o (dw_o/dl)(C_o[0:3] . e);  vb = ub
//   d slab[corner o][0:3] += w_o e
//
// and writes d x0 = xb, d v0 = vb.  A ray with no executed step (frozen,
// dead, or another brick's) passes its cotangents through.  A window
// longer than the stash is replayed in segments: a first pass keeps the
// state at every STASH-th step in `ckpt` (the wrapper's scratch, one (n, 6)
// row block a segment after the first), then each segment, the last
// first, is recomputed from its kept state into the stash and walked back.
// The corner gradients of the cell the walk is in stay in registers.
// When the walk crosses a face into a neighbour, the 4 corners the cells
// share keep their sums (moved to their new slots) and only the 4 left
// behind go to d slab, one float4 atomicAdd a corner; any other move
// flushes all 8 (K3's flush).  Channel 3, the opacity, which enters only
// through > 0, gets none.  The recomputed steps and the walk fetch corners
// as S1 does (march_slab.cuh:fetch_corners).  The gradient sums are float
// atomics, in an order that changes from run to run.  S2 adds into the d
// slab it is given: the brick path's differentiable march
// (parallel/bricks.py:_SlabMarch) zeroes one a train step and every
// window's S2 adds into it.
//
// What bounds it on the H100: bytes, the distinct corner voxels its
// executed steps read and the d slab records its atomics touch (read and
// written), and the ray state; the replay's chip_smoke.py SLAB_BWD_OPS an
// executed step (the recomputed step's 109 and its adjoint's 275) are the
// lesser bound at phase 20's size.  The stash lives in local memory: 24 B
// written and read back an executed step.

#include "march_slab.cuh"

namespace {

#ifdef VRT_BLOCK_THREADS
constexpr int THREADS = VRT_BLOCK_THREADS;
#else
constexpr int THREADS = 128;
#endif
// executed steps a segment holds in its per-thread stash (local memory)
constexpr int STASH = 32;

// a corner's gradient sums, channels 0-2
struct Grad3 {
  float x, y, z;
};

// Adds the sums of the corners in `mask` of cell (a0, a1, a2) into d slab.
__device__ __forceinline__ void flush(float4* __restrict__ g, int a0, int a1, int a2, int s1, int s2,
                                      unsigned mask, const Grad3 (&acc)[8]) {
  const long long cell = slab::flat(a0, a1, a2, s1, s2);
#pragma unroll
  for (int o = 0; o < 8; ++o)
    if (mask >> o & 1u) atomicAdd(g + cell + slab::corner(o, s1, s2), make_float4(acc[o].x, acc[o].y, acc[o].z, 0.0f));
}

__global__ void __launch_bounds__(THREADS)
march_slab_bwd_kernel(const float4* __restrict__ s, int s0, int s1, int s2, const float* __restrict__ consts,
                      const float* __restrict__ pos0, const float* __restrict__ dir0,
                      const long long* __restrict__ rem0, const long long* __restrict__ rem1,
                      const float* __restrict__ dpos, const float* __restrict__ ddir, float4* __restrict__ gslab,
                      float* __restrict__ ckpt, float* __restrict__ dpos0, float* __restrict__ ddir0, int n,
                      int k_steps) {
  // 64-bit, so that the rows 3 * i of the (n, 3) state and the scratch's
  // never overflow for any n < 2^31
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float ax = dpos[3 * i], ay = dpos[3 * i + 1], az = dpos[3 * i + 2];
  float bx = ddir[3 * i], by = ddir[3 * i + 1], bz = ddir[3 * i + 2];
  // the window's executed steps, at most its k_steps (a guard on the
  // scratch's size against inconsistent inputs)
  long long nexec = rem0[i] - rem1[i];
  nexec = nexec < k_steps ? nexec : k_steps;

  if (nexec > 0) {
    const slab::Consts k = slab::load_consts(consts);
    // the corners of one cell, and that cell on each axis: the recomputed
    // steps' and the walk's
    float4 c[8];
    int h0 = slab::NONE, h1 = 0, h2 = 0;
    // one recomputed step from (p, v): S1's arithmetic
    auto advance = [&](float& px, float& py, float& pz, float& vx, float& vy, float& vz) {
      const float lx = px - k.ox, ly = py - k.oy, lz = pz - k.oz;
      const float f0 = floorf(lx), f1 = floorf(ly), f2 = floorf(lz);
      int i0, i1, i2;
      slab::base_cell(f0, f1, f2, s0, s1, s2, i0, i1, i2);
      slab::fetch_corners(s, s1, s2, i0, i1, i2, h0, h1, h2, c);
      float w[8];
      slab::move(k, slab::sample(c, lx, ly, lz, f0, f1, f2, w), px, py, pz, vx, vy, vz);
    };
    const long long segs = (nexec + STASH - 1) / STASH;
    if (segs > 1) {
      float px = pos0[3 * i], py = pos0[3 * i + 1], pz = pos0[3 * i + 2];
      float vx = dir0[3 * i], vy = dir0[3 * i + 1], vz = dir0[3 * i + 2];
      for (long long seg = 1; seg < segs; ++seg) {
        for (int j = 0; j < STASH; ++j) advance(px, py, pz, vx, vy, vz);
        float* kept = ckpt + ((seg - 1) * n + i) * 6;
        kept[0] = px; kept[1] = py; kept[2] = pz; kept[3] = vx; kept[4] = vy; kept[5] = vz;
      }
    }

    float stash[STASH][6];
    // the corner gradients of cell (a0, a1, a2)
    Grad3 acc[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) acc[o] = {0.0f, 0.0f, 0.0f};
    int a0 = slab::NONE, a1 = 0, a2 = 0;
    for (long long seg = segs - 1; seg >= 0; --seg) {
      float px, py, pz, vx, vy, vz;
      if (seg == 0) {
        px = pos0[3 * i]; py = pos0[3 * i + 1]; pz = pos0[3 * i + 2];
        vx = dir0[3 * i]; vy = dir0[3 * i + 1]; vz = dir0[3 * i + 2];
      } else {
        const float* kept = ckpt + ((seg - 1) * n + i) * 6;
        px = kept[0]; py = kept[1]; pz = kept[2]; vx = kept[3]; vy = kept[4]; vz = kept[5];
      }
      const long long left = nexec - seg * STASH;
      const int m = left < STASH ? (int)left : STASH;
      for (int j = 0; j < m; ++j) {
        stash[j][0] = px; stash[j][1] = py; stash[j][2] = pz;
        stash[j][3] = vx; stash[j][4] = vy; stash[j][5] = vz;
        advance(px, py, pz, vx, vy, vz);
      }
      for (int j = m - 1; j >= 0; --j) {
        const float lx = stash[j][0] - k.ox, ly = stash[j][1] - k.oy, lz = stash[j][2] - k.oz;
        const float f0 = floorf(lx), f1 = floorf(ly), f2 = floorf(lz);
        int i0, i1, i2;
        slab::base_cell(f0, f1, f2, s0, s1, s2, i0, i1, i2);
        slab::fetch_corners(s, s1, s2, i0, i1, i2, h0, h1, h2, c);
        const int mv = slab::cell_move(a0, a1, a2, i0, i1, i2);
        if (mv != 0) {
          // the shared corners' sums move on, the others go to d slab
          const unsigned fresh = slab::fresh_corners(mv);
          if (a0 != slab::NONE) flush(gslab, a0, a1, a2, s1, s2, mv == slab::JUMP ? 0xFFu : 0xFFu ^ fresh, acc);
          slab::shift_face(acc, mv);
#pragma unroll
          for (int o = 0; o < 8; ++o)
            if (fresh >> o & 1u) acc[o] = {0.0f, 0.0f, 0.0f};
          a0 = i0; a1 = i1; a2 = i2;
        }
        const float fx = lx - f0, fy = ly - f1, fz = lz - f2;
        float w[8];
        const float4 g = slab::sample(c, lx, ly, lz, f0, f1, f2, w);
        const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
        const float yz[4] = {gy * gz, gy * fz, fy * gz, fy * fz};
        const float xz[4] = {gx * gz, gx * fz, fx * gz, fx * fz};
        const float xy[4] = {gx * gy, gx * fy, fx * gy, fx * fy};
        const float dwx[8] = {-yz[0], -yz[1], -yz[2], -yz[3], yz[0], yz[1], yz[2], yz[3]};
        const float dwy[8] = {-xz[0], -xz[1], xz[0], xz[1], -xz[2], -xz[3], xz[2], xz[3]};
        const float dwz[8] = {-xy[0], xy[0], -xy[1], xy[1], -xy[2], xy[2], -xy[3], xy[3]};
        const float ux = stash[j][3] + g.x * k.ex;
        const float uy = stash[j][4] + g.y * k.ey;
        const float uz = stash[j][5] + g.z * k.ez;
        const float ilen = 1.0f / (ux * ux + uy * uy + uz * uz);

        const float tt = k.sx * ux * ax + k.sy * uy * ay + k.sz * uz * az;
        const float il2 = ilen * ilen;
        const float ubx = bx + k.sx * ilen * ax - 2.0f * ux * il2 * tt;
        const float uby = by + k.sy * ilen * ay - 2.0f * uy * il2 * tt;
        const float ubz = bz + k.sz * ilen * az - 2.0f * uz * il2 * tt;
        const float e0 = k.ex * ubx, e1 = k.ey * uby, e2 = k.ez * ubz;
        float Gx = 0.0f, Gy = 0.0f, Gz = 0.0f;
#pragma unroll
        for (int o = 0; o < 8; ++o) {
          const float mo = c[o].x * e0 + c[o].y * e1 + c[o].z * e2;
          Gx = Gx + dwx[o] * mo;
          Gy = Gy + dwy[o] * mo;
          Gz = Gz + dwz[o] * mo;
          acc[o].x = acc[o].x + w[o] * e0;
          acc[o].y = acc[o].y + w[o] * e1;
          acc[o].z = acc[o].z + w[o] * e2;
        }
        ax = ax + Gx; ay = ay + Gy; az = az + Gz;
        bx = ubx; by = uby; bz = ubz;
      }
    }
    flush(gslab, a0, a1, a2, s1, s2, 0xFFu, acc);
  }

  dpos0[3 * i] = ax; dpos0[3 * i + 1] = ay; dpos0[3 * i + 2] = az;
  ddir0[3 * i] = bx; ddir0[3 * i + 1] = by; ddir0[3 * i + 2] = bz;
}

}  // namespace

// Launches S2 over n rays on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue before any launch for a slab of fewer than 2 cells
// on an axis.  The start state is S1's input (positions and directions
// (n, 3) float32, remaining (n,) int64), rem1 S1's remaining out, the
// cotangents (n, 3) float32, k_steps S1's; gslab the (s0, s1, s2, 4)
// float32 gradient that S2 adds into; ckpt (ceil(k_steps / STASH) - 1, n, 6) float32 scratch, null
// where k_steps <= STASH.
extern "C" int vrt_march_slab_bwd(const void* slab, int s0, int s1, int s2, const void* consts, const void* pos0,
                                  const void* dir0, const void* rem0, const void* rem1, const void* dpos,
                                  const void* ddir, void* gslab, void* ckpt, void* dpos0, void* ddir0, int n,
                                  int k_steps, void* stream) {
  if (s0 < 2 || s1 < 2 || s2 < 2) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + (long long)THREADS - 1) / THREADS);
    march_slab_bwd_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float4*)slab, s0, s1, s2, (const float*)consts, (const float*)pos0, (const float*)dir0,
        (const long long*)rem0, (const long long*)rem1, (const float*)dpos, (const float*)ddir, (float4*)gslab,
        (float*)ckpt, (float*)dpos0, (float*)ddir0, n, k_steps);
  }
  return (int)cudaGetLastError();
}

// The stash's length in executed steps, for the wrapper's scratch.
extern "C" int vrt_march_slab_stash() { return STASH; }
