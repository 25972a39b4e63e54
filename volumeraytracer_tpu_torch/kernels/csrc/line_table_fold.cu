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
// Each output point is written once, by the block of the brick that holds it
// in its body (the last brick of an axis also owns the far face), so there
// are no atomics and the result is deterministic.
//
// What bounds it on the H100: bytes.  It reads half the table's rows (0.38 GB
// at 256^3) plus the neighbours' halo planes, and writes the 65.5 MB
// gradient; there are two adds per output.  One block per brick stages its
// brick's rows and the 7 neighbours' halo planes in shared memory with reads
// that run along the lanes, then writes the owned points channels-last, runs
// of 32 contiguous floats (8 z points x 4 channels), so both sides of device
// memory are coalesced.  The staged line stride is odd (37 floats), so the
// (z, c)-strided reads of the write phase are free of bank conflicts.  The
// TPU kernel's column DMA pipeline and MXU identity transpose served Mosaic's
// DMA rules and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LBX = 10, LBY = 10, LBZ = 8;
constexpr int LPX = LBX + 1, LPY = LBY + 1, LPZ = LBZ + 1;
constexpr int TCH = 8, NCH = 4;
constexpr int LS = LPZ * TCH;  // 72 rows
constexpr int LL = 128;        // lanes
constexpr int THREADS = 256;

// Shared staging: for each of the 8 source bricks (a, b, c) a dense block
// [lines][z][channel]; a line is (px, py) of the brick's live window, with
// an odd stride between lines.  Sizes: px count (a ? 1 : 11), py count
// (b ? 1 : 11), z count (c ? 1 : 9).
struct Src {
  int nx, ny, nz, stride, off;
};

__host__ __device__ constexpr int stride_of(int nz) { return nz * NCH + 1; }

__device__ __forceinline__ Src src_of(int o) {
  const int a = (o >> 2) & 1, b = (o >> 1) & 1, c = o & 1;
  Src s;
  s.nx = a ? 1 : LPX;
  s.ny = b ? 1 : LPY;
  s.nz = c ? 1 : LPZ;
  s.stride = stride_of(s.nz);
  // offsets: sources in order 0..7, each nx*ny lines of `stride` floats
  int off = 0;
  for (int k = 0; k < o; ++k) {
    const int ka = (k >> 2) & 1, kb = (k >> 1) & 1, kc = k & 1;
    off += (ka ? 1 : LPX) * (kb ? 1 : LPY) * stride_of(kc ? 1 : LPZ);
  }
  s.off = off;
  return s;
}

constexpr int staged_floats() {
  int total = 0;
  for (int k = 0; k < 8; ++k) {
    const int ka = (k >> 2) & 1, kb = (k >> 1) & 1, kc = k & 1;
    total += (ka ? 1 : LPX) * (kb ? 1 : LPY) * stride_of(kc ? 1 : LPZ);
  }
  return total;
}
constexpr int SMEM_FLOATS = staged_floats();  // 6,048 floats = 24.2 KB

// The staged entry of source brick o at the output point (qx, qy, qz): a
// brick below holds it at its single halo index.
__device__ __forceinline__ float staged(const float* s, int o, int qx, int qy,
                                        int qz, int ch) {
  const Src sr = src_of(o);
  const int ix = (o & 4) ? 0 : qx, iy = (o & 2) ? 0 : qy, iz = (o & 1) ? 0 : qz;
  return s[sr.off + (ix * sr.ny + iy) * sr.stride + iz * NCH + ch];
}

__global__ void __launch_bounds__(THREADS)
line_table_fold_kernel(const float* __restrict__ gtable, float* __restrict__ out,
                       int X, int Y, int Z, int nbx, int nby, int nbz) {
  __shared__ float s[SMEM_FLOATS];
  const int b = blockIdx.x;
  const int bz = b % nbz;
  const int bxy = b / nbz;
  const int bx = bxy / nby, by = bxy % nby;

  // stage: lanes fastest within each (z, channel) row of each source brick
  for (int o = 0; o < 8; ++o) {
    const int a = (o >> 2) & 1, bb = (o >> 1) & 1, c = o & 1;
    if (bx - a < 0 || by - bb < 0 || bz - c < 0) continue;
    const Src sr = src_of(o);
    const float* src = gtable + ((((int64_t)(bx - a) * nby + (by - bb)) * nbz + (bz - c)) * LS) * LL;
    const int px0 = a ? LBX : 0, py0 = bb ? LBY : 0, pz0 = c ? LBZ : 0;
    const int nlines = sr.nx * sr.ny;
    const int n = nlines * sr.nz * NCH;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int line = i % nlines, r = i / nlines;
      const int z = r / NCH, ch = r - z * NCH;
      const int ix = line / sr.ny, iy = line - ix * sr.ny;
      const int lane = (px0 + ix) * LPY + (py0 + iy);
      s[sr.off + line * sr.stride + z * NCH + ch] = src[(int64_t)((pz0 + z) * TCH + ch) * LL + lane];
    }
  }
  __syncthreads();

  // owned points: the brick's body, plus the far face of the last brick
  const int x0 = bx * LBX, y0 = by * LBY, z0 = bz * LBZ;
  const int ox = min(bx == nbx - 1 ? LPX : LBX, X - x0);
  const int oy = min(by == nby - 1 ? LPY : LBY, Y - y0);
  const int oz = min(bz == nbz - 1 ? LPZ : LBZ, Z - z0);
  if (ox <= 0 || oy <= 0 || oz <= 0) return;
  const int n = ox * oy * oz * NCH;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int ch = i % NCH;
    int r = i / NCH;
    const int qz = r % oz;
    r /= oz;
    const int qy = r % oy, qx = r / oy;
    // halos that hold this point: the brick below exists and the point lies
    // on this brick's low face
    const bool hx = qx == 0 && bx > 0, hy = qy == 0 && by > 0, hz = qz == 0 && bz > 0;
    float zs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (c == 1 && !hz) break;
      float ys[2] = {0.0f, 0.0f};
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        if (bb == 1 && !hy) break;
        float v = staged(s, bb << 1 | c, qx, qy, qz, ch);
        if (hx) v = v + staged(s, 4 | bb << 1 | c, qx, qy, qz, ch);
        ys[bb] = v;
      }
      zs[c] = hy ? ys[0] + ys[1] : ys[0];
    }
    const float v = hz ? zs[0] + zs[1] : zs[0];
    out[(((int64_t)(x0 + qx) * Y + (y0 + qy)) * Z + (z0 + qz)) * NCH + ch] = v;
  }
}

}  // namespace

extern "C" int vrt_line_table_fold(const void* gtable, void* out, int X, int Y,
                                   int Z, int nbx, int nby, int nbz,
                                   void* stream) {
  const int nb = nbx * nby * nbz;
  line_table_fold_kernel<<<nb, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)gtable, (float*)out, X, Y, Z, nbx, nby, nbz);
  return (int)cudaGetLastError();
}
