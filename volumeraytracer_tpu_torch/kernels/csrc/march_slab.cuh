// The slab march's step, shared by S1 (march_slab_fwd.cu) and S2
// (march_slab_bwd.cu), so that S2's recomputed steps are S1's to the bit.
//
// The step is parallel/bricks.py:_slab_step on a CUDA 3-D slab: the slab
// (xs + 2, Y', Z', 4) float32 is brick `my`'s packed field, one float4
// record a voxel (channels 0-2 the bend, 3 the opacity), covering global x
// in [my*xs - 1, (my + 1)*xs + 1).  The constants come as one (4, 3)
// float32 array in device memory, read once a thread: the global packed
// bounds - 1, the slab's offset (my*xs - 1, 0, 0), bend and step.  Cell
// indices are 64-bit, so a slab of any size is addressed.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace slab {

struct Consts {
  float bx, by, bz;  // global packed bounds - 1
  float ox, oy, oz;  // global -> slab frame
  float ex, ey, ez;  // bend
  float sx, sy, sz;  // step
};

__device__ __forceinline__ Consts load_consts(const float* __restrict__ c) {
  return {c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], c[9], c[10], c[11]};
}

__device__ __forceinline__ long long clampll(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ops/interp.py:interp_linear's base cell of the floored slab-frame
// coordinates: converted to int64 and clamped to [0, s - 2] per axis, as a
// flat cell index
__device__ __forceinline__ long long base_cell(float f0, float f1, float f2, int s0, int s1, int s2) {
  const long long i0 = clampll((long long)f0, 0, s0 - 2);
  const long long i1 = clampll((long long)f1, 0, s1 - 2);
  const long long i2 = clampll((long long)f2, 0, s2 - 2);
  return (i0 * s1 + i1) * s2 + i2;
}

// the flat offset of corner o (product order, dz fastest) in an (., s1, s2) grid
__device__ __forceinline__ long long corner(int o, int s1, int s2) {
  return ((o >> 2) & 1) * (long long)s1 * s2 + ((o >> 1) & 1) * s2 + (o & 1);
}

// the corner weights in product order, each (w_x * w_y) * w_z
__device__ __forceinline__ void weights(float fx, float fy, float fz, float (&w)[8]) {
  const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
  w[0] = gx * gy * gz; w[1] = gx * gy * fz; w[2] = gx * fy * gz; w[3] = gx * fy * fz;
  w[4] = fx * gy * gz; w[5] = fx * gy * fz; w[6] = fx * fy * gz; w[7] = fx * fy * fz;
}

__device__ __forceinline__ void load_corners(const float4* __restrict__ s, long long base, int s1, int s2,
                                             float4 (&c)[8]) {
#pragma unroll
  for (int o = 0; o < 8; ++o) c[o] = __ldg(s + base + corner(o, s1, s2));
}

// The sample at slab-frame position l whose floor is f: the weights, and
// the four channels summed corner by corner in product order
// (ops/interp.py:_corner_sum)
__device__ __forceinline__ float4 sample(const float4 (&c)[8], float lx, float ly, float lz, float fx, float fy,
                                         float fz, float (&w)[8]) {
  weights(lx - fx, ly - fy, lz - fz, w);
  float4 r = make_float4(c[0].x * w[0], c[0].y * w[0], c[0].z * w[0], c[0].w * w[0]);
#pragma unroll
  for (int o = 1; o < 8; ++o) {
    r.x = r.x + c[o].x * w[o];
    r.y = r.y + c[o].y * w[o];
    r.z = r.z + c[o].z * w[o];
    r.w = r.w + c[o].w * w[o];
  }
  return r;
}

// An executed step from (p, v) with the sample g: u = v + g * bend,
// p' = p + (u * step) * (1 / |u|^2), |u|^2 summed x, y, z
__device__ __forceinline__ void move(const Consts& k, float4 g, float& px, float& py, float& pz, float& vx,
                                     float& vy, float& vz) {
  vx = vx + g.x * k.ex;
  vy = vy + g.y * k.ey;
  vz = vz + g.z * k.ez;
  const float ilen = 1.0f / (vx * vx + vy * vy + vz * vz);
  px = px + vx * k.sx * ilen;
  py = py + vy * k.sy * ilen;
  pz = pz + vz * k.sz * ilen;
}

}  // namespace slab
