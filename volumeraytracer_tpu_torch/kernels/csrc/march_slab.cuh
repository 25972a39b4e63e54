// The slab march's step, shared by S1 (march_slab_fwd.cu) and S2
// (march_slab_bwd.cu), so that S2's recomputed steps are S1's to the bit.
//
// The step is parallel/bricks.py:_slab_step on a CUDA 3-D slab: the slab
// (xs + 2, Y', Z', 4) float32 is brick `my`'s packed field, one float4
// record a voxel (channels 0-2 the bend, 3 the opacity), covering global x
// in [my*xs - 1, (my + 1)*xs + 1).  The constants come as one (4, 3)
// float32 array in device memory, read once a thread: the global packed
// bounds - 1, the slab's offset (my*xs - 1, 0, 0), bend and step.  A cell
// is held as its clamped index on each axis (a flat index +-1 can cross a
// row), and addressed with 64-bit flat indices, so a slab of any size is
// addressed.  A thread keeps the 8 corners of the cell it is in; when its
// ray crosses a face into a neighbour, the 4 corners the two cells share
// move to their new slots and only the other 4 are loaded
// (fetch_corners).

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
// coordinates: converted to int64 and clamped to [0, s - 2] per axis
__device__ __forceinline__ void base_cell(float f0, float f1, float f2, int s0, int s1, int s2, int& i0, int& i1,
                                          int& i2) {
  i0 = (int)clampll((long long)f0, 0, s0 - 2);
  i1 = (int)clampll((long long)f1, 0, s1 - 2);
  i2 = (int)clampll((long long)f2, 0, s2 - 2);
}

__device__ __forceinline__ long long flat(int i0, int i1, int i2, int s1, int s2) {
  return ((long long)i0 * s1 + i1) * s2 + i2;
}

// The held cell's index on each axis; h0 = NONE holds no cell (every cell
// is then at least 2 away on x)
constexpr int NONE = -2;
// cell_move's kind of a move to a cell that is not a face neighbour
constexpr int JUMP = 8;

// How the base cell moved from (h0, h1, h2) to (i0, i1, i2): 0 not at all;
// across one face, the axis's corner bit (4 x, 2 y, 1 z) signed as the
// move; JUMP otherwise (an edge or a corner crossed, a longer move, no
// cell held)
__device__ __forceinline__ int cell_move(int h0, int h1, int h2, int i0, int i1, int i2) {
  const int d0 = i0 - h0, d1 = i1 - h1, d2 = i2 - h2;
  if ((d0 | d1 | d2) == 0) return 0;
  if (d1 == 0 && d2 == 0 && (d0 == 1 || d0 == -1)) return 4 * d0;
  if (d0 == 0 && d2 == 0 && (d1 == 1 || d1 == -1)) return 2 * d1;
  if (d0 == 0 && d1 == 0 && (d2 == 1 || d2 == -1)) return d2;
  return JUMP;
}

// The corners of the cell that a move `mv` (cell_move's, nonzero) enters
// which the cell it leaves does not share, as a mask in product order:
// across +x the new corners 4-7, across -x 0-3, and so for y (bit 1) and
// z (bit 0); all 8 for a JUMP.
__device__ __forceinline__ unsigned fresh_corners(int mv) {
  switch (mv) {
    case 4: return 0xF0u;
    case -4: return 0x0Fu;
    case 2: return 0xCCu;
    case -2: return 0x33u;
    case 1: return 0xAAu;
    case -1: return 0x55u;
    default: return 0xFFu;
  }
}

// For a move `mv` (cell_move's, nonzero) from the cell whose corner values
// v holds (product order): moves the values of the corners that the new
// cell shares with the old to their new slots (across +x the old 4-7 are
// the new 0-3); the slots of fresh_corners(mv) keep stale values.
template <class T>
__device__ __forceinline__ void shift_face(T (&v)[8], int mv) {
  switch (mv) {
    case 4: v[0] = v[4]; v[1] = v[5]; v[2] = v[6]; v[3] = v[7]; break;
    case -4: v[4] = v[0]; v[5] = v[1]; v[6] = v[2]; v[7] = v[3]; break;
    case 2: v[0] = v[2]; v[1] = v[3]; v[4] = v[6]; v[5] = v[7]; break;
    case -2: v[2] = v[0]; v[3] = v[1]; v[6] = v[4]; v[7] = v[5]; break;
    case 1: v[0] = v[1]; v[2] = v[3]; v[4] = v[5]; v[6] = v[7]; break;
    case -1: v[1] = v[0]; v[3] = v[2]; v[5] = v[4]; v[7] = v[6]; break;
    default: break;
  }
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

// Makes c hold the corners of cell (i0, i1, i2) and (h0, h1, h2) that
// cell, where c held the corners of cell (h0, h1, h2): nothing is loaded
// for the same cell, the 4 corners not shared for a face neighbour, all 8
// otherwise.  The values are the slab's, whichever way they came.
__device__ __forceinline__ void fetch_corners(const float4* __restrict__ s, int s1, int s2, int i0, int i1, int i2,
                                              int& h0, int& h1, int& h2, float4 (&c)[8]) {
  const int mv = cell_move(h0, h1, h2, i0, i1, i2);
  if (mv == 0) return;
  const unsigned need = fresh_corners(mv);
  shift_face(c, mv);
  h0 = i0; h1 = i1; h2 = i2;
  const long long base = flat(i0, i1, i2, s1, s2);
#pragma unroll
  for (int o = 0; o < 8; ++o)
    if (need >> o & 1u) c[o] = __ldg(s + base + corner(o, s1, s2));
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
