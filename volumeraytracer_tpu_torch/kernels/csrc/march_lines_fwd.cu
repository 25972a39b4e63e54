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
//
// The body is a template on RECORD and CAPPED, instantiated three times:
// march_lines_fwd (the march above), march_lines_fwd_capped (CAPPED: at
// most max_steps steps a launch, the pause of the TPU kernel's max_windows
// cap, which the scattered-ray compaction driver launches once a phase and
// resumes from the state it wrote) and march_lines_fwd_path (RECORD),
// which replaces the TPU kernel's record_path branch
// (march_lines.py:722-771).  The cap is its own instantiation so that the
// uncapped loop, which is bound by issuing its instructions, carries no
// step counter.  All three run the same step (the lambda `step`), so a
// march paused and resumed over several capped launches ends where one
// uncapped launch ends, bit for bit.  The recorder also writes its ray's path into row path_row[i] of a
// (N, path_stride, 3) buffer, of whose rows the first path_len are the
// path: the start position, its position after each executed step, then
// its end position up to the last row, the JAX driver's (N, budget + 1, 3)
// contract (march_lines.py:920-931, _unscramble_path :1058-1097).  One
// thread owns one ray, so the path needs no snapshot buffer and no
// unscramble, and writing at the input row spares the driver a gather of
// the whole path.  The stores add nothing to the march's arithmetic, so
// its end state is the unrecorded instantiation's bit for bit, and the
// no-path K2 is compiled without them.
//
// What bounds the recorder is the path's bytes, 806.7 MB at the bench
// shape (its bound, 0.26 ms at 3.35 TB/s).  Stored as they come, 12 B a
// step a thread, a warp's 32 stores of a step land 6 KB apart, one partly
// written sector each: ~4.5 ms against K2's 0.53 (probes/probe_path.py,
// PERF.md); the same per-thread loop storing into a step-major buffer, a
// warp's stores of a step contiguous, took 0.60 ms, but putting that
// buffer in ray order costs a transpose of the whole path (~1.2 ms with
// torch).  So the recorder stages PK entries of each ray in shared memory
// and its warp writes them together, ray by ray: a ray's PK entries are
// 12*PK contiguous bytes of its row, which the 32 lanes store as
// consecutive words.  That needs every lane of the warp at the writes, so
// the recorder's loop runs while any ray of the warp is alive (a ray that
// has stopped waits), and the back-fill is written the same way.  Longer
// runs write faster (PK = 8, 16, 24: 1.34, 1.02, 0.88 ms), and runs that
// start and end on 32-byte sectors faster again: the start is staged as
// the first entry and the driver pads each row to a multiple of 8 rows
// (96 B), so with PK a multiple of 8 every full run covers whole sectors
// (0.97 ms unpadded at PK = 24).  PK = 24 takes 37 KB of shared memory a
// block; 30 is the most that fits the 48 KB a block may have statically.

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

// entries (start and steps) of each ray the recorder stages before its
// warp writes them, a multiple of 8 (see above), and a lane's staging row
// in floats (odd, so that the lanes' rows start in different banks)
constexpr int PK = 24;
constexpr int SROW = 3 * PK + 1;
constexpr unsigned FULL = 0xffffffffu;

// The recorder's warp writes `count` consecutive path rows of each of its
// 32 rays (rows `path_stride` apart, the first `path_len` of each kept):
// ray r's row `row` from row `first` on (each lane passes its own
// ray's values), taking the words from the ray's staging row `wstage[r]`
// (REPEAT: its first three words, the end position, over and over).  Lane
// l stores words l, l + 32, ... of each ray's run, so that a warp's store
// covers 128 contiguous bytes.  Every lane of the warp must call it.
template <bool REPEAT>
__device__ __forceinline__ void warp_write_rows(float* __restrict__ path, const float* wstage, int64_t row,
                                                int path_len, int path_stride, int first, int count) {
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < 32; ++r) {
    const int f = __shfl_sync(FULL, first, r);
    const int c = min(__shfl_sync(FULL, count, r), path_len - f);
    float* dst = path + (__shfl_sync(FULL, row, r) * path_stride + f) * 3;
    const float* src = wstage + r * SROW;
    for (int w = lane; w < 3 * c; w += 32) dst[w] = src[REPEAT ? w % 3 : w];
  }
}

template <bool RECORD, bool CAPPED = false>
__device__ __forceinline__ void
march_lines_body(const float* __restrict__ table,
                 int nbx, int nby, int nbz, float xb, float yb, float zb,
                 const float* __restrict__ pos_in,
                 const float* __restrict__ dir_in,
                 const int* __restrict__ rem_in,
                 const int* __restrict__ alive_in,
                 const float* __restrict__ br_in,
                 float* __restrict__ pos_out, float* __restrict__ dir_out,
                 int* __restrict__ rem_out, int* __restrict__ alive_out,
                 float* __restrict__ br_out,
                 float* __restrict__ path, const int64_t* __restrict__ path_row,
                 int path_len, int path_stride, int n,
                 float bendx, float bendy, float bendz,
                 float stepx, float stepy, float stepz,
                 float min_bright, int has_absorb, int max_steps = 0) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  // the recorder keeps every lane of its warp for the warp's writes; a lane
  // past the last ray marches nothing
  if (!RECORD && i >= n) return;
  const bool valid = i < n;
  float px = 0.0f, py = 0.0f, pz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  int rem = 0, alive = 0;
  float br = 0.0f;
  if (valid) {
    px = pos_in[3 * i]; py = pos_in[3 * i + 1]; pz = pos_in[3 * i + 2];
    dx = dir_in[3 * i]; dy = dir_in[3 * i + 1]; dz = dir_in[3 * i + 2];
    rem = rem_in[i];
    alive = alive_in[i];
    br = br_in[i];
  }

  // the cell's corners, loaded when the ray enters a cell and kept in
  // registers while it stays there: channels 0-2 as hi + lo, the opacity,
  // and the absorption.  Keyed on the table offset, which is all the loads
  // depend on, so the clamps below cannot make it stale.
  int64_t cur = -1;
  float c0[8], c1[8], c2[8], op[8];
  float absorb = 0.0f;

  // one step; false where the march stops the ray (state unchanged)
  auto step = [&]() -> bool {
    const bool inb = px >= 0.0f && px < xb && py >= 0.0f && py < yb &&
                     pz >= 0.0f && pz < zb;
    if (!inb || rem <= 0) return false;

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
      if (br < min_bright) return false;
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
    if (in3 > 0.0f) return false;

    dx = dx + in0 * bendx;
    dy = dy + in1 * bendy;
    dz = dz + in2 * bendz;
    const float ilen = 1.0f / (dx * dx + dy * dy + dz * dz);
    px = px + dx * stepx * ilen;
    py = py + dy * stepy * ilen;
    pz = pz + dz * stepz * ilen;
    rem -= 1;
    return true;
  };

  if constexpr (CAPPED) {
    // at most max_steps steps in this launch; a ray still alive then keeps
    // its state for the next launch
    for (int s = 0; alive && s < max_steps; ++s) alive = step();
  } else if constexpr (!RECORD) {
    while (alive) alive = step();
  } else {
    // the ray's path row, the next row to write, and its staged positions;
    // the start is the first of them, so that every full run begins at a
    // multiple of PK rows
    __shared__ float stage[THREADS][SROW];
    float* mine = stage[threadIdx.x];
    const int64_t row = valid ? path_row[i] : 0;
    int next = valid ? 0 : path_len, staged = valid ? 1 : 0;
    mine[0] = px; mine[1] = py; mine[2] = pz;
    const float* wstage = stage[threadIdx.x & ~31];
    auto flush = [&]() {
      __syncwarp();
      warp_write_rows<false>(path, wstage, row, path_len, path_stride, next, staged);
      next += staged;
      staged = 0;
      __syncwarp();
    };
    // e: the entries (start and steps) a ray alive so far has staged
    for (int e = 2; __any_sync(FULL, alive); ++e) {
      if (alive) {
        alive = step();
        if (alive) {
          mine[3 * staged] = px; mine[3 * staged + 1] = py; mine[3 * staged + 2] = pz;
          ++staged;
        }
      }
      if (e % PK == 0) flush();
    }
    flush();
    // back-fill: the end position after the last executed step
    mine[0] = px; mine[1] = py; mine[2] = pz;
    __syncwarp();
    warp_write_rows<true>(path, wstage, row, path_len, path_stride, next, path_len - next);
  }

  if (!valid) return;
  pos_out[3 * i] = px; pos_out[3 * i + 1] = py; pos_out[3 * i + 2] = pz;
  dir_out[3 * i] = dx; dir_out[3 * i + 1] = dy; dir_out[3 * i + 2] = dz;
  rem_out[i] = rem;
  alive_out[i] = alive;
  br_out[i] = br;
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
  march_lines_body<false>(table, nbx, nby, nbz, xb, yb, zb, pos_in, dir_in,
                          rem_in, alive_in, br_in, pos_out, dir_out, rem_out,
                          alive_out, br_out, nullptr, nullptr, 0, 0, n, bendx,
                          bendy, bendz, stepx, stepy, stepz, min_bright,
                          has_absorb);
}

__global__ void __launch_bounds__(THREADS)
march_lines_fwd_capped_kernel(const float* __restrict__ table,
                              int nbx, int nby, int nbz, float xb, float yb,
                              float zb, const float* __restrict__ pos_in,
                              const float* __restrict__ dir_in,
                              const int* __restrict__ rem_in,
                              const int* __restrict__ alive_in,
                              const float* __restrict__ br_in,
                              float* __restrict__ pos_out,
                              float* __restrict__ dir_out,
                              int* __restrict__ rem_out,
                              int* __restrict__ alive_out,
                              float* __restrict__ br_out, int max_steps, int n,
                              float bendx, float bendy, float bendz,
                              float stepx, float stepy, float stepz,
                              float min_bright, int has_absorb) {
  march_lines_body<false, true>(table, nbx, nby, nbz, xb, yb, zb, pos_in,
                                dir_in, rem_in, alive_in, br_in, pos_out,
                                dir_out, rem_out, alive_out, br_out, nullptr,
                                nullptr, 0, 0, n, bendx, bendy, bendz, stepx,
                                stepy, stepz, min_bright, has_absorb,
                                max_steps);
}

__global__ void __launch_bounds__(THREADS)
march_lines_fwd_path_kernel(const float* __restrict__ table,
                            int nbx, int nby, int nbz, float xb, float yb,
                            float zb, const float* __restrict__ pos_in,
                            const float* __restrict__ dir_in,
                            const int* __restrict__ rem_in,
                            const int* __restrict__ alive_in,
                            const float* __restrict__ br_in,
                            float* __restrict__ pos_out,
                            float* __restrict__ dir_out,
                            int* __restrict__ rem_out,
                            int* __restrict__ alive_out,
                            float* __restrict__ br_out,
                            float* __restrict__ path,
                            const int64_t* __restrict__ path_row, int path_len,
                            int path_stride, int n, float bendx, float bendy,
                            float bendz, float stepx, float stepy, float stepz,
                            float min_bright, int has_absorb) {
  march_lines_body<true>(table, nbx, nby, nbz, xb, yb, zb, pos_in, dir_in,
                         rem_in, alive_in, br_in, pos_out, dir_out, rem_out,
                         alive_out, br_out, path, path_row, path_len,
                         path_stride, n, bendx, bendy, bendz, stepx, stepy,
                         stepz, min_bright, has_absorb);
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

extern "C" int vrt_march_lines_fwd_capped(
    const void* table, int nbx, int nby, int nbz, int X, int Y, int Z,
    const void* pos_in, const void* dir_in, const void* rem_in,
    const void* alive_in, const void* br_in, void* pos_out, void* dir_out,
    void* rem_out, void* alive_out, void* br_out, int max_steps, int n,
    float bendx, float bendy, float bendz, float stepx, float stepy,
    float stepz, float min_bright, int has_absorb, void* stream) {
  if (n > 0) {
    march_lines_fwd_capped_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                                    (cudaStream_t)stream>>>(
        (const float*)table, nbx, nby, nbz, (float)(X - 1), (float)(Y - 1),
        (float)(Z - 1), (const float*)pos_in, (const float*)dir_in,
        (const int*)rem_in, (const int*)alive_in, (const float*)br_in,
        (float*)pos_out, (float*)dir_out, (int*)rem_out, (int*)alive_out,
        (float*)br_out, max_steps, n, bendx, bendy, bendz, stepx, stepy,
        stepz, min_bright, has_absorb);
  }
  return (int)cudaGetLastError();
}

extern "C" int vrt_march_lines_fwd_path(
    const void* table, int nbx, int nby, int nbz, int X, int Y, int Z,
    const void* pos_in, const void* dir_in, const void* rem_in,
    const void* alive_in, const void* br_in, void* pos_out, void* dir_out,
    void* rem_out, void* alive_out, void* br_out, void* path,
    const void* path_row, int path_len, int path_stride, int n, float bendx,
    float bendy, float bendz, float stepx, float stepy, float stepz,
    float min_bright, int has_absorb, void* stream) {
  if (n > 0) {
    march_lines_fwd_path_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                                  (cudaStream_t)stream>>>(
        (const float*)table, nbx, nby, nbz, (float)(X - 1), (float)(Y - 1),
        (float)(Z - 1), (const float*)pos_in, (const float*)dir_in,
        (const int*)rem_in, (const int*)alive_in, (const float*)br_in,
        (float*)pos_out, (float*)dir_out, (int*)rem_out, (int*)alive_out,
        (float*)br_out, (float*)path, (const int64_t*)path_row, path_len,
        path_stride, n, bendx, bendy, bendz, stepx, stepy, stepz, min_bright,
        has_absorb);
  }
  return (int)cudaGetLastError();
}
