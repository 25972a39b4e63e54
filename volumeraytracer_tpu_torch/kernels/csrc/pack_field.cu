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
// version's, so P1 equals it bit for bit.
//
// P2 (pack_field_bwd_kernel), the adjoint in gather form, one ior voxel j
// at a time, with no atomics:
//
//   dL   = sum over a, (p, q) of S[p][q] * (G_a[j - 2 e_a - (p, q)_perp]
//                                           - G_a[j - (p, q)_perp]) / 207872
//          (G_a = d_packed[..., a]; channel 3 is ignored; a term whose
//          output index falls outside [0, N - 2) adds 0)
//   d_ior = dL * 0x420000 / ior                 (autograd's mul, then log)
//
// summed in another order than the plain version's (below), so within
// float32 rounding of it.
//
// What bounds them on the H100: bytes.  P1 reads the ior (and the opacity
// grid, with a translucency) once and writes 16 B an output voxel; P2
// reads the 16 B cotangent record and the ior and writes the ior's
// gradient.  P1's taps are also 81 separate float operations an output
// under -fmad=false, besides 1.2 logf and 3 divisions, so it runs near the
// card's issue rate as well.  The design:
//
// - A block owns a TY x TZ = 16 x 32 tile in (y, z) and marches it along x
//   over CX = 32 planes.  A thread computes two y rows of one z: a warp
//   owns two rows of the tile and its 32 lanes 32 consecutive z, so the
//   copies, the shared-memory reads (consecutive words, no bank conflicts)
//   and the stores are contiguous.  The x halo costs (CX + 2) / CX of the
//   planes, the y and z halo (18 x 34) / (16 x 32) = 1.2; longer chunks, up
//   to the whole x extent in one wave of blocks, ran slower on the H100
//   (probes/sweep_pack.py).
// - Copies stay in flight while a plane is computed: each thread copies
//   its elements of the halo tile (a warp a row of its 32-wide body, then
//   its two side columns) with cp.async into a ring of NS planes in shared
//   memory, the next plane's while the block computes this one.  P1
//   converts its own copies (logf) into a second ring, the log field, that
//   the whole block reads; P2 reads its ring of cotangent records as they
//   are.  One __syncthreads() a plane orders the rings.
// - The x direction is carried in registers.  P1 keeps its two rows' 4 x 3
//   (y, z) windows of planes x and x + 1 and reads plane x + 2's (12 words
//   for 2 outputs, not 2 x 54); three steps pass the windows round, so
//   none is copied.  P2 reads output plane o's window (4 x 3 records for 2
//   voxels) and folds it at once into what plane o gives voxels o, o + 1
//   and o + 2 (the stamp is symmetric: its rows 0 and 2 weigh a plane
//   alike), carrying two running sums a voxel; it divides each voxel's sum
//   by 207872 once, not each cotangent value.
// - A zero numerator (a uniform stretch of the field, a train step's
//   sparse cotangent) does not take the division routine's slow path
//   (div_rn).
//
// Offsets into the fields are 64 bits wide (a 1024^3 packed field holds
// 2^32 floats).  A thread's carried state is held per column it owns, and
// every tile loop steps by the block's thread count, so a host build with
// one thread a block (VRT_BLOCK_THREADS 1, the tests) runs each block
// whole; VRT_PACK_CX sets CX.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TY = 16, TZ = 32;  // a block's tile in (y, z)
constexpr int RY = 2;            // the y rows a thread computes in a tile column
#ifdef VRT_PACK_CX
constexpr int CX = VRT_PACK_CX;
#else
constexpr int CX = 32;  // the x planes a block marches (P1: outputs, P2: voxels)
#endif
constexpr int NS = 2;  // the planes in a kernel's ring of copies
constexpr int PY = TY + 2, PZ = TZ + 2, PLANE = PY * PZ;  // the tile with its halo
constexpr int BODY = PY * TZ;    // the halo tile's elements in its TZ-wide body
#ifdef VRT_BLOCK_THREADS
constexpr int THREADS = VRT_BLOCK_THREADS;
#else
constexpr int THREADS = TY / RY * TZ;
#endif
static_assert(TY % RY == 0 && (TY / RY * TZ) % THREADS == 0, "a thread owns whole columns of the tile");
constexpr int COLS = TY / RY * TZ / THREADS;            // the (row pair, z) columns a thread owns: 1 on the card
constexpr int LOADS = (PLANE + THREADS - 1) / THREADS;  // the halo tile's elements a thread copies: 3 on the card
constexpr int FULL = PLANE / THREADS;                   // of which every thread has the first FULL
constexpr float LOG_UNIT = 4325376.0f;  // 0x420000
constexpr float DIVISOR = 207872.0f;    // the 3-D stamp's weight 812 * 0x100

// The {14, 47, 162} stamp, S[p][q]: 162 at the centre, 47 on its edges,
// 14 at its corners.
__device__ __forceinline__ float stamp(int p, int q) {
  return p == 1 ? (q == 1 ? 162.0f : 47.0f) : (q == 1 ? 47.0f : 14.0f);
}

// Device-only helpers, which the host build (VRT_HOST_SHIM) defines as
// plain C++: `no_fold` returns x, which the optimizer cannot see through;
// the asynchronous copies from device memory into shared memory
// (cp.async), where `valid` false fills the destination with zeros and
// reads nothing, are plain copies there.
#ifndef VRT_HOST_SHIM
__device__ __forceinline__ float no_fold(float x) {
  asm("" : "+f"(x));
  return x;
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async16(float4* dst, const float4* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// wait until at most `pending` of this thread's committed groups are in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}
#endif

// a / b, rounded as IEEE division, with no branch around it: the division
// routine's range check sends a zero numerator to its slow path, so a zero
// over a finite nonzero b divides 1 instead (hidden from the optimizer,
// which would otherwise divide a, the same value wherever the quotient is
// used) and returns a * b, the exact quotient (a zero with the sign of
// a * b).
__device__ __forceinline__ float div_rn(float a, float b) {
  const bool zero = a == 0.0f && b != 0.0f && isfinite(b);
  const float q = no_fold(zero ? 1.0f : a) / b;
  return zero ? a * b : q;
}

// Element e of the halo tile: its row r and column c in [0, PZ), the body
// (c < TZ) first, TZ elements a row, then the two side columns TZ, TZ + 1.
__device__ __forceinline__ void halo_element(int e, int& r, int& c) {
  if (e < BODY) {
    r = e / TZ;
    c = e - r * TZ;
  } else {
    e -= BODY;
    r = e >> 1;
    c = TZ + (e & 1);
  }
}

__global__ void __launch_bounds__(THREADS)
pack_field_fwd_kernel(const float* __restrict__ ior, const float* __restrict__ opacity, float4* __restrict__ out,
                      int X, int Y, int Z, int tiles_y, int tiles_z, float transparent) {
  // the raw ior of the planes in flight, each element read back only by
  // the thread that copied it, and the log field of two planes, rings:
  // plane q in slot (q - x0) % NS and (q - x0) % 2
  __shared__ float R[NS][PLANE];
  __shared__ float L[2][PLANE];
  const int OY = Y - 2, OZ = Z - 2;
  int b = blockIdx.x;
  const int z0 = (b % tiles_z) * TZ;
  b /= tiles_z;
  const int y0 = (b % tiles_y) * TY;
  const int x0 = (b / tiles_y) * CX;
  const int last = min(x0 + CX, X - 2) + 1;  // the last ior plane the chunk's outputs read
  const int64_t YZ = (int64_t)Y * Z, OYZ = (int64_t)OY * OZ;

  // this thread's elements of a plane: their place in the ring (-1: none)
  // and in the ior plane, clamped into the field (a clamped element is
  // read only by outputs the tile skips)
  int dst[LOADS];
  int64_t src[LOADS];
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    const int e = threadIdx.x + k * THREADS;
    int r = 0, c = 0;
    if (e < PLANE) halo_element(e, r, c);
    dst[k] = e < PLANE ? r * PZ + c : -1;
    src[k] = (int64_t)min(y0 + r, Y - 1) * Z + min(z0 + c, Z - 1);
  }
  // plane q's copies, one group (empty past the chunk)
  auto issue = [&](int q) {
    if (q <= last) {
      const float* plane = ior + q * YZ;
      float* slot = R[unsigned(q - x0) % NS];
#pragma unroll
      for (int k = 0; k < LOADS; ++k)
        if (k < FULL || dst[k] >= 0) cp_async4(slot + dst[k], plane + src[k], true);
    }
    cp_async_commit();
  };
  // plane q from this thread's copies into the log ring, and plane q + NS's
  // copies issued into the slot it leaves; this thread's copies of plane q
  // have landed once all but the NS - 1 groups after its own have
  auto advance = [&](int q) {
    cp_async_wait<NS - 1>();
    const float* raw = R[unsigned(q - x0) % NS];
    float* slot = L[unsigned(q - x0) % 2];
#pragma unroll
    for (int k = 0; k < LOADS; ++k)
      if (k < FULL || dst[k] >= 0) slot[dst[k]] = logf(raw[dst[k]]) * LOG_UNIT;
    issue(q + NS);
  };

  // each column's two rows' 4 x 3 (y, z) window of a plane, taken from
  // the log ring
  using Window = float[COLS][RY + 2][3];
  auto window = [&](int q, Window& w) {
    const float* Lq = L[unsigned(q - x0) % 2];
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const int col = threadIdx.x + k * THREADS;
      const int ly = col / TZ * RY, lz = col % TZ;
#pragma unroll
      for (int r = 0; r < RY + 2; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) w[k][r][c] = Lq[(ly + r) * PZ + lz + c];
    }
  };
  // step p: plane p + 1 into the log ring, then the window of plane p into
  // `w2` and output plane p - 2 from `w0` (plane p - 2), `w1` (p - 1) and
  // `w2`.  Three steps pass the windows round, so no window is copied.
  // False past the chunk.
  auto step = [&](int p, Window& w0, Window& w1, Window& w2) {
    if (p > last) return false;
    if (p + 1 <= last) advance(p + 1);  // its slot held plane p - 1, read before the last sync
    window(p, w2);
    const int x = p - 2;
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const int col = threadIdx.x + k * THREADS;
      const int ly = col / TZ * RY, z = z0 + col % TZ;
      const float(*P[3])[3] = {w0[k], w1[k], w2[k]};  // ior planes x, x + 1, x + 2
#pragma unroll
      for (int i = 0; i < RY; ++i) {
        // every row is computed (a row past the field reads clamped values); only the field's are stored
        const int y = y0 + ly + i;
        const bool inside = y < OY && z < OZ;
        const float op = opacity != nullptr && inside ? __ldg(opacity + ((int64_t)(x + 1) * Y + y + 1) * Z + z + 1)
                                                      : transparent;
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
#pragma unroll
        for (int pp = 0; pp < 3; ++pp) {
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const float w = stamp(pp, q);
            // axis 0: (p, q) on (y, z); axis 1: on (x, z); axis 2: on (x, y)
            a0 = a0 + w * (P[2][i + pp][q] - P[0][i + pp][q]);
            a1 = a1 + w * (P[pp][i + 2][q] - P[pp][i][q]);
            a2 = a2 + w * (P[pp][i + q][2] - P[pp][i + q][0]);
          }
        }
        if (inside)
          out[x * OYZ + (int64_t)y * OZ + z] =
              make_float4(div_rn(a0, DIVISOR), div_rn(a1, DIVISOR), div_rn(a2, DIVISOR), op);
      }
    }
    __syncthreads();
    return true;
  };

  // planes x0 and x0 + 1 into the windows, plane x0 + 2 into the log ring
  Window wa, wb, wc;
#pragma unroll
  for (int q = 0; q < NS; ++q) issue(x0 + q);
  advance(x0);
  advance(x0 + 1);
  __syncthreads();
  window(x0, wa);
  window(x0 + 1, wb);
  __syncthreads();
  advance(x0 + 2);
  __syncthreads();
  for (int p = x0 + 2;; p += 3) {
    if (!step(p, wa, wb, wc) || !step(p + 1, wb, wc, wa) || !step(p + 2, wc, wa, wb)) break;
  }
}

__global__ void __launch_bounds__(THREADS)
pack_field_bwd_kernel(const float* __restrict__ ior, const float4* __restrict__ g, float* __restrict__ d_ior,
                      int X, int Y, int Z, int tiles_y, int tiles_z) {
  // the ring: the cotangent records of output plane o over the tile's rows
  // and columns from y0 - 2, z0 - 2 (zeros outside the output grid), and
  // the ior of voxel plane o over the tile, in slot (o - x0 + 2) % NS;
  // each ior value read back only by the thread that copied it
  __shared__ float4 G[NS][PLANE];
  __shared__ float IO[NS][TY * TZ];
  const int OX = X - 2, OY = Y - 2, OZ = Z - 2;
  int b = blockIdx.x;
  const int z0 = (b % tiles_z) * TZ;
  b /= tiles_z;
  const int y0 = (b % tiles_y) * TY;
  const int x0 = (b / tiles_y) * CX;
  const int x1 = min(x0 + CX, X);
  const int n = x1 - x0 + 2;  // the output planes x0 - 2 .. x1 - 1 its voxels read
  const int64_t OYZ = (int64_t)OY * OZ, YZ = (int64_t)Y * Z;

  // this thread's elements of a plane: their place in the ring (-1: none)
  // and in the output plane (-1: outside the output grid, a 0); the body
  // (z0 .. z0 + TZ - 1) is the ring's columns 2 .. TZ + 1, the side
  // columns (z0 - 2, z0 - 1) its columns 0 and 1
  int dst[LOADS];
  int64_t src[LOADS];
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    const int e = threadIdx.x + k * THREADS;
    int r = 0, c = 0;
    if (e < PLANE) halo_element(e, r, c);
    const int sc = c < TZ ? c + 2 : c - TZ;
    const int y = y0 - 2 + r, z = z0 - 2 + sc;
    dst[k] = e < PLANE ? r * PZ + sc : -1;
    src[k] = y >= 0 && y < OY && z >= 0 && z < OZ ? (int64_t)y * OZ + z : -1;
  }
  // the i-th output plane's copies and its voxel plane's ior, one group
  // (empty past the chunk)
  auto issue = [&](int i) {
    if (i < n) {
      const int o = x0 - 2 + i;
      const unsigned s = unsigned(i) % NS;
      const bool in = o >= 0 && o < OX;
      const float4* plane = g + (in ? o : 0) * OYZ;
#pragma unroll
      for (int k = 0; k < LOADS; ++k)
        if (k < FULL || dst[k] >= 0) {
          const bool valid = in && src[k] >= 0;
          cp_async16(&G[s][dst[k]], valid ? plane + src[k] : g, valid);
        }
      if (o >= x0) {
#pragma unroll
        for (int k = 0; k < COLS; ++k) {
          const int col = threadIdx.x + k * THREADS;
          const int ly = col / TZ * RY, lz = col % TZ;
#pragma unroll
          for (int j = 0; j < RY; ++j) {
            const int y = y0 + ly + j, z = z0 + lz;
            if (y < Y && z < Z) cp_async4(&IO[s][(ly + j) * TZ + lz], ior + o * YZ + (int64_t)y * Z + z, true);
          }
        }
      }
    }
    cp_async_commit();
  };

  // each column's two voxel rows: the running sums of voxels o and o + 1
  // (o + 2 starts at step o)
  float acc[COLS][RY][2] = {};
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) issue(i);
  for (int i = 0; i < n; ++i) {
    const int o = x0 - 2 + i;
    const unsigned s = unsigned(i) % NS;
    cp_async_wait<NS - 2>();  // this thread's copies of plane o have landed
    __syncthreads();          // and every thread's; every thread is done with plane o - 1
    issue(i + NS - 1);        // into plane o - 1's slot
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const int col = threadIdx.x + k * THREADS;
      const int ly = col / TZ * RY, lz = col % TZ;
      const int z = z0 + lz;
      // the window of output plane o: rows y0 + ly - 2 .. y0 + ly + 1,
      // columns z - 2 .. z; channels 0-2 in x, y, z
      float4 w[RY + 2][3];
#pragma unroll
      for (int r = 0; r < RY + 2; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) w[r][c] = G[s][(ly + r) * PZ + lz + c];
#pragma unroll
      for (int j = 0; j < RY; ++j) {
        // voxel row y = y0 + ly + j reads the window's rows j .. j + 2
        // (outputs y - 2 .. y).  Channel 0: c0, the sum of S[p][q] *
        // G_0[o][y - p][z - q], enters voxel o + 2 with + and voxel o with -
        const float c0 = 14.0f * (((w[j][0].x + w[j][2].x) + w[j + 2][0].x) + w[j + 2][2].x) +
                         47.0f * (((w[j][1].x + w[j + 1][0].x) + w[j + 1][2].x) + w[j + 2][1].x) +
                         162.0f * w[j + 1][1].x;
        // channel 1: e_q = G_1[o][y - 2][z - q] - G_1[o][y][z - q] (e1 the
        // middle one, s1 the sum of the outer two), weighed by the stamp's
        // row p = voxel - o: 14, 47, 14 (a) for voxels o and o + 2; 47,
        // 162, 47 (bb) for voxel o + 1; channel 2 alike over y
        const float e1 = w[j][1].y - w[j + 2][1].y;
        const float s1 = (w[j][0].y - w[j + 2][0].y) + (w[j][2].y - w[j + 2][2].y);
        const float e2 = w[j + 1][0].z - w[j + 1][2].z;
        const float s2 = (w[j + 2][0].z - w[j + 2][2].z) + (w[j][0].z - w[j][2].z);
        const float a = (14.0f * s1 + 47.0f * e1) + (14.0f * s2 + 47.0f * e2);
        const float bb = (47.0f * s1 + 162.0f * e1) + (47.0f * s2 + 162.0f * e2);
        const float done = acc[k][j][0] + (a - c0);  // voxel o, complete
        acc[k][j][0] = acc[k][j][1] + bb;
        acc[k][j][1] = a + c0;
        const int y = y0 + ly + j;
        if (o >= x0 && y < Y && z < Z)
          d_ior[o * YZ + (int64_t)y * Z + z] = div_rn(div_rn(done, DIVISOR) * LOG_UNIT, IO[s][(ly + j) * TZ + lz]);
      }
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
