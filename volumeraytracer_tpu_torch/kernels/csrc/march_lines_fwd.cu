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
// (march_lines.py:722-771).  All three run the same step (the lambda
// `step`) on the same floats, so a march paused and resumed over several
// capped launches ends where one uncapped launch ends, bit for bit.
//
// The capped K2 reads the corner table (kernels/line_table.py:CornerTable,
// built by corner_table_build.cu) in place of the line table.  Its
// workload is the scattered rays (bench.py:64-76: 131,072 rays uniform in
// [4, 252]^3), 0.008 rays a cell: no two lanes of a warp share a cell, and
// with a ray entering a cell about every 30 steps some lane of a warp
// reloads at about two steps in three while the warp waits for it.  Over
// the line table a reload is 57 scalar loads from 7 channel rows 512 B
// apart, each its own 32-byte sector, from a 0.80 GB table that the 50 MB
// L2 does not hold: 2.13 ms over the whole scattered march (budget 512,
// 65.07 M steps) against K2's 0.53 on the coherent bundle, of which a
// variant whose reload reads one fixed cell (probes/probe_fwd.py) takes
// 0.73, so the reload's memory traffic cost 1.4 ms.  Over the corner table
// a reload is 8 16-byte loads, one record a corner, the two z-corners of
// each (x, y) adjacent: at most 8 sectors from a 0.28 GB table.  It runs
// in 0.66-0.67 ms, the fixed-cell variant in 0.61, so what bounds it now
// is instruction issue, as K2 (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
// The address is the lattice point of the same clamped brick and local
// cell, so the clamps pick the same corners, and the cell-resident
// registers and the step are K2's: its end state equals K2's over the line
// table bit for bit.  The cap is its own instantiation so that the
// uncapped loop, which is bound by issuing its instructions, carries no
// step counter.
//
// The recorder also writes its ray's path into row path_row[i] of a
// (N, path_stride, 3) buffer, of whose rows the first path_len are the
// path: the start position, its position after each executed step, then
// its end position up to the last row, the JAX driver's (N, budget + 1, 3)
// contract (march_lines.py:920-931, _unscramble_path :1058-1097), each
// plus path_offset (the scene's +1 voxel, so that no pass over the path
// adds it afterwards; -0.0 when there is none, which leaves every float as
// it is).  One thread owns one ray, so the path needs no unscramble, and
// writing at the input row spares the driver a gather of the whole path.
// The stores add nothing to the march's arithmetic, so its end state is
// the unrecorded instantiation's bit for bit.  The recorder's bound is the
// path's bytes, 806.7 MB at the bench shape (0.26 ms at 3.35 TB/s), under
// a march that takes K2's 0.53 ms of instruction issue, so the stores have
// to cost few instructions and cover whole sectors: each lane stages PK entries of
// its ray in shared memory (the start as the first, so that every full run
// begins at a multiple of PK rows; the driver pads each row to a multiple
// of 8 rows, 96 B) and writes the 12*PK contiguous bytes of the run to its
// row itself, with one bulk asynchronous copy
// (cp.async.bulk.global.shared::cta), 16-byte aligned and a multiple of
// 16 bytes long because PK is a multiple of 8.  A lane waits for a
// buffer's last copy to have read it before it stages into it again.  One
// buffer a lane (NBUF) is faster than two that let the march go on while a
// copy drains: the staging memory sets how many blocks an SM holds (26.6
// KB a block at PK = 16 against 51.2 with two), and more warps hide the
// wait and the march's own latencies better.  No lane waits
// for its warp: a ray that stops writes its back-fill (bulk copies of a
// buffer of end positions, plain stores for the last rows of a row that no
// full run covers) and leaves.  The design before it staged 24 entries and
// let the warp write them ray by ray: 32 rounds of shuffles, shared-memory
// reads and stores every 24 steps (81 SASS instructions a round, ~110 a
// step), the loop running while any ray of the warp was
// alive, 0.88-0.91 ms.  In turns (probes/probe_fwd.py --sweep; NVIDIA H100
// 80GB HBM3, 700 W; PERF.md), two buffers of PK = 8, 16, 24 entries took
// 0.74, 0.69-0.71, 0.78-0.79 ms and one buffer 0.71-0.72, 0.67-0.68,
// 0.67-0.69 (K2 0.52-0.53): fewer copies against fewer blocks an SM.

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

// entries (start and steps) of each ray that the recorder stages before a
// bulk copy writes them, a multiple of 8 (see above); staging buffers a
// lane; a run's floats; a lane's staging row in floats: its buffers and 4
// floats of padding, so that the lanes' rows start 4 banks apart (16-byte
// alignment allows no fewer)
constexpr int PK = 16;
constexpr int NBUF = 1;
constexpr int RUN = 3 * PK;
constexpr int SROW = NBUF * RUN + 4;
constexpr int PATH_SMEM = THREADS * SROW * (int)sizeof(float);
static_assert(PK % 8 == 0, "a full run must cover whole 16-byte units and start on one");

// one bulk asynchronous copy of `bytes` from this thread's shared memory
// to device memory, after its own stores to the source, in a group of its
// own
__device__ __forceinline__ void bulk_store(float* dst, const float* src, int bytes) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"((unsigned)__cvta_generic_to_shared(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// wait until at most N of this thread's bulk copies have their source
// still to read
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(N) : "memory");
}

template <bool RECORD, bool CAPPED = false>
__device__ __forceinline__ void
march_lines_body(const float* __restrict__ table,
                 const float* __restrict__ corner_absorb,
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
                 int path_len, int path_stride, float path_offset, int n,
                 float bendx, float bendy, float bendz,
                 float stepx, float stepy, float stepz,
                 float min_bright, int has_absorb, int max_steps = 0) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float px = pos_in[3 * i], py = pos_in[3 * i + 1], pz = pos_in[3 * i + 2];
  float dx = dir_in[3 * i], dy = dir_in[3 * i + 1], dz = dir_in[3 * i + 2];
  int rem = rem_in[i], alive = alive_in[i];
  float br = br_in[i];

  // the capped K2's corner lattice: points along z, and along y and z
  const int pz_pts = nbz * LBZ + 1;
  const int64_t pyz_pts = (int64_t)(nby * LBY + 1) * pz_pts;

  // the cell's corners, loaded when the ray enters a cell and kept in
  // registers while it stays there: channels 0-2 as hi + lo, the opacity,
  // and the absorption.  Keyed on the table offset (the lattice point for
  // the corner table), which is all the loads depend on, so the clamps
  // below cannot make it stale.
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
    if constexpr (CAPPED) {
      const int64_t pt = (int64_t)(cbx * LBX + lx) * pyz_pts + (int64_t)(cby * LBY + ly) * pz_pts +
                         (cbz * LBZ + lz);
      if (pt != cur) {
        const float4* r = reinterpret_cast<const float4*>(table) + pt;
#pragma unroll
        for (int o = 0; o < 8; ++o) {
          // dx: next x point, dy: next y point, dz: the next record
          const float4 v = __ldg(r + ((o >> 2) & 1) * pyz_pts + ((o >> 1) & 1) * pz_pts + (o & 1));
          c0[o] = v.x; c1[o] = v.y; c2[o] = v.z; op[o] = v.w;
        }
        if (has_absorb) absorb = __ldg(corner_absorb + pt);
        cur = pt;
      }
    } else {
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
    // this lane's staging buffers of PK entries, its path row, the row
    // that the next full run starts at, the buffer being filled and its
    // entries; the start is the first entry
    extern __shared__ __align__(16) float stage_mem[];
    float* const mine = stage_mem + threadIdx.x * SROW;
    float* const out = path + path_row[i] * (int64_t)path_stride * 3;
    int next = 0, buf = 0, staged = 0;
    auto put = [&](float x, float y, float z) {
      float* e = mine + buf * RUN + 3 * staged;
      e[0] = x + path_offset; e[1] = y + path_offset; e[2] = z + path_offset;
      if (++staged == PK) {
        bulk_store(out + 3 * next, mine + buf * RUN, RUN * 4);
        next += PK;
        staged = 0;
        buf = (buf + 1) % NBUF;
        bulk_wait_read<NBUF - 1>();   // the next buffer's last copy has read it
      }
    };
    put(px, py, pz);
    while (alive) {
      alive = step();
      if (alive) put(px, py, pz);
    }

    // back-fill rows next + staged .. path_len - 1 with the end position:
    // the full runs that fit by bulk copies (the current buffer filled up
    // with it, then a buffer of nothing else), the rest by plain stores
    const float ex = px + path_offset, ey = py + path_offset, ez = pz + path_offset;
    const int full_end = next + (path_len - next) / PK * PK;
    float* const cur_buf = mine + buf * RUN;
    if (next < full_end) {
      for (int k = staged; k < PK; ++k) {
        cur_buf[3 * k] = ex; cur_buf[3 * k + 1] = ey; cur_buf[3 * k + 2] = ez;
      }
      bulk_store(out + 3 * next, cur_buf, RUN * 4);
      next += PK;
      staged = 0;
      if (next < full_end) {
        float* const ends = mine + (buf + 1) % NBUF * RUN;
        bulk_wait_read<NBUF - 1>();
        for (int k = 0; k < PK; ++k) {
          ends[3 * k] = ex; ends[3 * k + 1] = ey; ends[3 * k + 2] = ez;
        }
        for (; next < full_end; next += PK) bulk_store(out + 3 * next, ends, RUN * 4);
      }
    }
    // the last rows, fewer than PK: the staged entries, then the end
    for (int k = 0; next + k < path_len; ++k) {
      float* r = out + 3 * (next + k);
      if (k < staged) {
        r[0] = cur_buf[3 * k]; r[1] = cur_buf[3 * k + 1]; r[2] = cur_buf[3 * k + 2];
      } else {
        r[0] = ex; r[1] = ey; r[2] = ez;
      }
    }
    bulk_wait_read<0>();   // the shared memory stays until every copy has read it
  }

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
  march_lines_body<false>(table, nullptr, nbx, nby, nbz, xb, yb, zb, pos_in,
                          dir_in, rem_in, alive_in, br_in, pos_out, dir_out,
                          rem_out, alive_out, br_out, nullptr, nullptr, 0, 0,
                          0.0f, n, bendx, bendy, bendz, stepx, stepy, stepz,
                          min_bright, has_absorb);
}

__global__ void __launch_bounds__(THREADS)
march_lines_fwd_capped_kernel(const float4* __restrict__ corners,
                              const float* __restrict__ corner_absorb,
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
  march_lines_body<false, true>(reinterpret_cast<const float*>(corners),
                                corner_absorb, nbx, nby, nbz, xb, yb, zb,
                                pos_in, dir_in, rem_in, alive_in, br_in,
                                pos_out, dir_out, rem_out, alive_out, br_out,
                                nullptr, nullptr, 0, 0, 0.0f, n, bendx, bendy,
                                bendz, stepx, stepy, stepz, min_bright,
                                has_absorb, max_steps);
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
                            int path_stride, float path_offset, int n,
                            float bendx, float bendy, float bendz,
                            float stepx, float stepy, float stepz,
                            float min_bright, int has_absorb) {
  march_lines_body<true>(table, nullptr, nbx, nby, nbz, xb, yb, zb, pos_in,
                         dir_in, rem_in, alive_in, br_in, pos_out, dir_out,
                         rem_out, alive_out, br_out, path, path_row, path_len,
                         path_stride, path_offset, n, bendx, bendy, bendz,
                         stepx, stepy, stepz, min_bright, has_absorb);
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
    const void* corners, const void* corner_absorb, int nbx, int nby, int nbz,
    int X, int Y, int Z, const void* pos_in, const void* dir_in,
    const void* rem_in, const void* alive_in, const void* br_in, void* pos_out,
    void* dir_out, void* rem_out, void* alive_out, void* br_out, int max_steps,
    int n, float bendx, float bendy, float bendz, float stepx, float stepy,
    float stepz, float min_bright, int has_absorb, void* stream) {
  if (n > 0) {
    march_lines_fwd_capped_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                                    (cudaStream_t)stream>>>(
        (const float4*)corners, (const float*)corner_absorb, nbx, nby, nbz,
        (float)(X - 1), (float)(Y - 1), (float)(Z - 1), (const float*)pos_in,
        (const float*)dir_in, (const int*)rem_in, (const int*)alive_in,
        (const float*)br_in, (float*)pos_out, (float*)dir_out, (int*)rem_out,
        (int*)alive_out, (float*)br_out, max_steps, n, bendx, bendy, bendz,
        stepx, stepy, stepz, min_bright, has_absorb);
  }
  return (int)cudaGetLastError();
}

extern "C" int vrt_march_lines_fwd_path(
    const void* table, int nbx, int nby, int nbz, int X, int Y, int Z,
    const void* pos_in, const void* dir_in, const void* rem_in,
    const void* alive_in, const void* br_in, void* pos_out, void* dir_out,
    void* rem_out, void* alive_out, void* br_out, void* path,
    const void* path_row, int path_len, int path_stride, float path_offset,
    int n, float bendx, float bendy, float bendz, float stepx, float stepy,
    float stepz, float min_bright, int has_absorb, void* stream) {
  if (n > 0) {
    // the staging buffers are dynamic shared memory; above 48 KB a block
    // (two buffers of PK >= 16) they need the opt-in
    if constexpr (PATH_SMEM > 48 * 1024) {
      const cudaError_t rc = cudaFuncSetAttribute(
          march_lines_fwd_path_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PATH_SMEM);
      if (rc != cudaSuccess) return (int)rc;
    }
    march_lines_fwd_path_kernel<<<(n + THREADS - 1) / THREADS, THREADS,
                                  PATH_SMEM, (cudaStream_t)stream>>>(
        (const float*)table, nbx, nby, nbz, (float)(X - 1), (float)(Y - 1),
        (float)(Z - 1), (const float*)pos_in, (const float*)dir_in,
        (const int*)rem_in, (const int*)alive_in, (const float*)br_in,
        (float*)pos_out, (float*)dir_out, (int*)rem_out, (int*)alive_out,
        (float*)br_out, (float*)path, (const int64_t*)path_row, path_len,
        path_stride, path_offset, n, bendx, bendy, bendz, stepx, stepy, stepz,
        min_bright, has_absorb);
  }
  return (int)cudaGetLastError();
}
