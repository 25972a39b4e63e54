// T2: the point table's gradient fold, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package folds the point gradient table
// in volumeraytracer_tpu/kernels/march_bwd.py:fold_brickmajor_grads (:577),
// XLA over three overlap-adds (_overlap_add :551); eager torch runs the
// port's plain version (kernels/march_pallas.py:fold_brickmajor_grads) as
// three passes of a pad, a reshape and an in-place add.  It is the adjoint
// of T1's addressing: every packed-field point is stored by up to 8 bricks
// (its own, and the bricks below it in x, y and z, whose +1 halo planes px
// = 8, py = 8, pz = 16 hold it), so its gradient is the sum of those
// entries, rows 0-3 of the (NB, 8, 1408) table:
//
//   out[x, y, z, c] = ((T000 + T001) + (T010 + T011))
//                   + ((T100 + T101) + (T110 + T111))
//
// where Tabc is the entry of brick (bx - a, by - b, bz - c) at the local
// point that is (x, y, z).  This is the order of the plain fold, which
// overlap-adds z, then y, then x, each as body + halo: a halo that is
// absent adds nothing (the sum is the body's entry as it is, a -0.0
// included), and a body that is absent (the far face of an axis, the
// plain fold's pad) is +0.0 before its halo is added.  So the result
// equals the plain fold bit for bit, signs of zero included.  Only rows
// 0-3 and lanes < 1377 are read.
//
// Gather form, one thread an output point, z fastest, one float4 store a
// point, no atomics: the result is deterministic (K4's principle,
// csrc/line_table_fold.cu, with the point table's axis order z, y, x).  A
// block takes ZCH consecutive z of one (x, y) line, so a warp writes 512
// contiguous bytes and reads, per row, two runs of 16 contiguous lanes (a
// brick's body) and, on brick faces, the halo's run in the brick below.
//
// What bounds it on the H100: bytes.  At the bench's 254^3 packed field it
// must read rows 0-3 of the entries of 16,384 bricks whose point lies in
// the field (0.350 GB of the 0.361 GB of live lanes) and write the 0.262 GB
// gradient.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BX = 8, BY = 8, BZ = 16;
constexpr int PY = BY + 1, PZ = BZ + 1;
constexpr int PVP = 1408;               // lanes of a row
constexpr int TCH = 8;                  // rows of a brick
constexpr int BRICK = TCH * PVP;        // floats of a brick
#ifdef VRT_BLOCK_THREADS
constexpr int THREADS = VRT_BLOCK_THREADS;
#else
constexpr int THREADS = 256;
#endif
constexpr int ZCH = 256;                // z points a block

// A global coordinate g on an axis of bricks of B cells, N bricks: its body
// entry (brick n, local j) exists unless g = N*B, its halo entry (brick
// n - 1, local B) where j = 0 and n > 0.
struct Axis {
  int n, j;
  bool body, halo;
};

template <int B>
__device__ __forceinline__ Axis axis_of(int g, int N) {
  const int n = g / B, j = g - n * B;
  return {n, j, n < N, j == 0 && n > 0};
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// rows 0-3 of brick b at lane l
__device__ __forceinline__ float4 entry(const float* __restrict__ g, int64_t b, int l) {
  const float* p = g + b * BRICK + l;
  return make_float4(__ldg(p), __ldg(p + PVP), __ldg(p + 2 * PVP), __ldg(p + 3 * PVP));
}

// the z overlap-add at brick (bx, by), local (px, py)
__device__ __forceinline__ float4 zsum(const float* __restrict__ g, int bx, int by, int px, int py, Axis az,
                                       int nby, int nbz) {
  const int64_t col = ((int64_t)bx * nby + by) * nbz;
  const int l = (px * PY + py) * PZ;
  float4 v = az.body ? entry(g, col + az.n, l + az.j) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (az.halo) v = add4(v, entry(g, col + az.n - 1, l + BZ));
  return v;
}

// the y overlap-add of the z sums at x brick bx, local px
__device__ __forceinline__ float4 ysum(const float* __restrict__ g, int bx, int px, Axis ay, Axis az, int nby,
                                       int nbz) {
  float4 v = ay.body ? zsum(g, bx, ay.n, px, ay.j, az, nby, nbz) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (ay.halo) v = add4(v, zsum(g, bx, ay.n - 1, px, BY, az, nby, nbz));
  return v;
}

__global__ void __launch_bounds__(THREADS)
point_table_fold_kernel(const float* __restrict__ gtable, float4* __restrict__ out, int X, int Y, int Z, int nbx,
                        int nby, int nbz, int zchunks) {
  const int line = blockIdx.x / zchunks;
  const int zc = blockIdx.x - line * zchunks;
  const int x = line / Y, y = line - x * Y;
  const Axis ax = axis_of<BX>(x, nbx), ay = axis_of<BY>(y, nby);
  const int zend = min(Z, (zc + 1) * ZCH);
  float4* row = out + ((int64_t)x * Y + y) * Z;
  for (int z = zc * ZCH + threadIdx.x; z < zend; z += THREADS) {
    const Axis az = axis_of<BZ>(z, nbz);
    float4 v = ax.body ? ysum(gtable, ax.n, ax.j, ay, az, nby, nbz) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (ax.halo) v = add4(v, ysum(gtable, ax.n - 1, BX, ay, az, nby, nbz));
    row[z] = v;
  }
}

}  // namespace

extern "C" int vrt_point_table_fold(const void* gtable, void* out, int X, int Y, int Z, int nbx, int nby, int nbz,
                                    void* stream) {
  const int zchunks = (Z + ZCH - 1) / ZCH;
  const int blocks = X * Y * zchunks;
  point_table_fold_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)gtable, (float4*)out, X, Y, Z, nbx, nby, nbz, zchunks);
  return (int)cudaGetLastError();
}
