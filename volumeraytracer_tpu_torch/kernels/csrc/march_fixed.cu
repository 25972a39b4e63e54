// F1: the fixed-point (uint32 16.16) march over the packed field, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs this march as one XLA
// while_loop of fori_loop chunks over volumeraytracer_tpu/ops/march.py
// :_fixed_step (:65), called from march_fixed (:286), which XLA compiles
// into one loop.  Eager torch has nothing like it: the plain march
// (ops/march.py:_fixed_step) launches one kernel for each elementwise or
// gather op of every step.  One thread per ray, the shape of the
// reference's own kernel (trace_ray_function, cuda_volume_raytracer.cu
// :317-374) and of K2.  Each thread takes the start direction times
// 0x10000 (the driver's prescale, a power of two, so exact) and loops
//
//   while (rem > 0 && (p >> 16) < bound - 1 on every axis):
//     br -= min(br, 0xFFFFFFFF - tr[p >> 16]); stop if br < min_bright
//                                                      (translucency only)
//     interp = sum over corners (product order, dz fastest) of
//              w * packed[(p >> 16) + corner], w from (p & 0xFFFF) / 0x10000
//     stop if interp[3] > 0 (opaque)
//     d += interp[0:3] * invscale
//     p += (uint32) rint(d * invscale * (0x42000000 / |d|^2));  rem -= 1
//
// and writes what the driver's TraceResult holds: the end position plus
// pos_offset modulo 2^32 (int64 holding the uint32; the scene's +1 voxel,
// so that no pass adds it afterwards), the direction over 0x10000, the
// iterations budget - rem (a ray leaves the loop only by stopping, so
// this is the plain march's budget - (alive ? 0 : rem)) and the
// brightness.  Every operation follows ops/march.py's plain fixed march
// in its order: the build compiles with -fmad=false, the division is IEEE
// (no fast math), and each step is converted with one round-to-nearest-
// even conversion to int64 (cvt.rni.s64.f32), which gives what torch's
// torch.round (half to even) followed by .to(torch.int64) (cvt.rzi, which
// saturates, NaN to 0) gives for every float, NaN and overflow included,
// so F1 equals the plain march bit for bit on the card.
//
// What bounds it on the H100: the loop's length is the data's, and each
// step is 104 float32 operations (chip_smoke.py's MARCH_FIXED_OPS: the 3
// scalings of the weights, 3 subtractions, 16 weight products, 60
// multiplies and adds of the corner sums, the opacity compare, 6 for the
// bend, 5 for |d|^2, the division, 6 multiplies and 3 roundings of the
// step; the integer bounds test, absorption and conversions left out) on
// values that stay in registers while the ray stays in its cell, so the
// bound is operations, not bytes.  The design keeps the cell's 8 corners
// (one float4 of the packed field each) in registers and loads them only
// when the ray enters another cell, as K2 does; it reads the packed field
// directly, with no brick table, since a 16.16 position gives its cell
// with shifts.  Under -fmad=false such a march is bound by issuing its
// instructions (K2: 196 a step at 74-79% of the issue rate), so the step
// spends none that decide no bit.  A loop over cells holds the loads and
// an inner loop the steps within a cell: with the loads under a test of
// the cell inside one loop, the compiler predicates the 8 loads and their
// addresses into every step, branch hint or not.  The cell's flat
// index is 32-bit when the field has fewer than 2^31 float4s (the Idx
// template, picked by the launch from the shape; the wide instantiations
// keep 64-bit ones); the fractions are scaled by 2^-16 (exact, as the
// division by 0x10000); the step's rounding and conversion are the one
// instruction above.  Its time beside its bound is in PERF.md.
//
// The body is a template on RECORD as well, as K2's is: march_fixed (the
// march above) and march_fixed_path (RECORD), the JAX package's
// _run_scan(record_path=True) (ops/march.py:232-241), which also writes
// its ray's path into row i of a (N, path_stride, 3) int64 buffer: the
// start position, its position after each executed step, then its end
// position up to the row's end, each plus pos_offset modulo 2^32.  The
// stores add nothing to the march's arithmetic, so its end state is the
// unrecorded instantiation's bit for bit.  The path is the bound: at the
// bench (131,044 rays, 513 entries of 24 bytes) 1.613 GB, 0.48 ms at 3.35
// TB/s, above the march's 0.10 ms of operations.  A thread storing its
// own row entry by entry (3 int64 stores a step into rows 12.3 KB apart:
// 7.1 ms) leaves each 32-byte sector to be written in pieces by separate
// instructions.  So each lane stages PK entries of its ray in
// shared memory (the start as the first, so that every run begins at a
// multiple of PK entries) and writes the 24*PK contiguous bytes of a full
// run to its row with one bulk asynchronous copy
// (cp.async.bulk.global.shared::cta), 16-byte aligned and a multiple of 16
// bytes long because PK is even.  The driver pads each row to a multiple
// of 16 entries (FIXED_PATH_ALIGN), so that rows start on 128-byte lines
// and runs cover whole sectors (rows padded only to an even length took
// 0.98 ms against 0.72), and returns the [:, :path_len] view; the kernel
// takes any even row length.  The march's runs all fall inside the path,
// and the back-fill (the rest of the last staged run, then runs of the end
// position) goes through the same copies, its last run shorter.  An entry
// holds three uint32 values in int64s whose high words are 0, so a lane
// zeroes its staging's high words once and stores only the low ones.  A
// lane waits for a buffer's last copy to have read it before it stages
// into it again, and for all of its copies before it leaves.  In turns on
// the card (probes/probe_fixed.py --sweep; NVIDIA H100 80GB HBM3, 700 W;
// PERF.md), one buffer of PK = 8, 16, 24, 32 entries took 0.86, 0.72,
// 0.76, 0.75 ms and two of PK = 8, 16 0.77, 0.79: one buffer of 16 (51.2
// KB a block, past the 48 KB opt-in, 4 blocks an SM) balances the copies'
// count against the warps an SM holds.  It runs at 0.68 of its bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
// 0x42000000, exact in float32
constexpr float STEP_CONST = 1107296256.0f;
constexpr float FIX_ONE = 65536.0f;
// 2^-16: a product by it is the division by 0x10000, exactly
constexpr float FIX_SCALE = 1.0f / 65536.0f;

// entries (start and steps) of each ray that the recorder stages before a
// bulk copy writes them, even (see above); staging buffers a lane; a run's
// 32-bit words (3 int64 an entry); a lane's staging row in words: its
// buffers and 4 words of padding, so that the lanes' rows start 4 banks
// apart (16-byte alignment allows no fewer)
constexpr int PK = 16;
constexpr int NBUF = 1;
constexpr int RUN = 6 * PK;
constexpr int SROW = NBUF * RUN + 4;
constexpr int PATH_SMEM = THREADS * SROW * (int)sizeof(uint32_t);
static_assert(PK % 2 == 0, "a full run must cover whole 16-byte units and start on one");

// one bulk asynchronous copy of `bytes` from this thread's shared memory
// to device memory, after its own stores to the source, in a group of its
// own
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
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

// the low 32 bits of round-half-even(x) as int64, saturating, NaN to 0:
// torch.round(x).to(torch.int64) on the card, in one conversion
__device__ __forceinline__ uint32_t round_low32(float x) {
  return (uint32_t)__float2ll_rn(x);
}

// ops/interp.py:interp_fixed of the (IX, IY, IZ) field f at the 16.16
// position (x, y, z), as the JAX package reads it: each corner by its flat
// row index wrapped to int32, read from the end below 0 and as NaN outside
// [-rows, rows) (past the far face of axis 0), the weights and the corner
// sum in product order
__device__ __forceinline__ float sample_fixed(const float* __restrict__ f, int IX, int IY, int IZ,
                                              uint32_t x, uint32_t y, uint32_t z) {
  const long long rows = (long long)IX * IY * IZ, sx = (long long)IY * IZ, sy = IZ;
  const long long base = (long long)(x >> 16) * sx + (long long)(y >> 16) * sy + (long long)(z >> 16);
  const float fx = (float)(x & 0xFFFFu) * FIX_SCALE;
  const float fy = (float)(y & 0xFFFFu) * FIX_SCALE;
  const float fz = (float)(z & 0xFFFFu) * FIX_SCALE;
  const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
  const float w[8] = {gx * gy * gz, gx * gy * fz, gx * fy * gz, gx * fy * fz,
                      fx * gy * gz, fx * gy * fz, fx * fy * gz, fx * fy * fz};
  float acc = 0.0f;
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    const long long idx = base + ((o >> 2) & 1) * sx + ((o >> 1) & 1) * sy + (o & 1);
    const long long wrapped = (int32_t)(uint32_t)(unsigned long long)idx;
    const float v = wrapped >= -rows && wrapped < rows ? __ldg(f + (wrapped < 0 ? wrapped + rows : wrapped))
                                                       : __int_as_float(0x7FC00000);
    acc = o == 0 ? v * w[0] : acc + v * w[o];
  }
  return acc;
}

template <typename Idx, bool RECORD>
__device__ __forceinline__ void
march_fixed_body(const float4* __restrict__ packed, int X, int Y, int Z,
                 const long long* __restrict__ tr, const float* __restrict__ ior,
                 int IX, int IY, int IZ, uint32_t start_shift,
                 const long long* __restrict__ pos_in,
                 const float* __restrict__ dir_in,
                 long long* __restrict__ pos_out, float* __restrict__ dir_out,
                 long long* __restrict__ iter_out, long long* __restrict__ br_out,
                 long long* __restrict__ path, int path_stride,
                 uint32_t pos_offset, int n, uint32_t budget, float invx,
                 float invy, float invz, uint32_t min_bright) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  // the low 32 bits (the driver's & 0xFFFFFFFF) less start_shift: the
  // scene's −1 voxel into the packed frame, or 0
  uint32_t px = (uint32_t)pos_in[3 * i] - start_shift;
  uint32_t py = (uint32_t)pos_in[3 * i + 1] - start_shift;
  uint32_t pz = (uint32_t)pos_in[3 * i + 2] - start_shift;
  float dx = dir_in[3 * i], dy = dir_in[3 * i + 1], dz = dir_in[3 * i + 2];
  if (ior != nullptr) {
    // the scene's |v| = n: n sampled half a voxel above the start
    const float nv = sample_fixed(ior, IX, IY, IZ, px + 0x8000u, py + 0x8000u, pz + 0x8000u);
    dx = dx * nv; dy = dy * nv; dz = dz * nv;
  }
  dx = dx * FIX_ONE; dy = dy * FIX_ONE; dz = dz * FIX_ONE;
  // the reference consumes one budget slot for the start path entry
  uint32_t rem = budget - 1u;
  uint32_t br = 0xFFFFFFFFu;

  const uint32_t xb = (uint32_t)(X - 1), yb = (uint32_t)(Y - 1), zb = (uint32_t)(Z - 1);
  const Idx sx = (Idx)Y * (Idx)Z, sy = (Idx)Z;
  const bool absorb = tr != nullptr;
  // the corners of the ray's cell, kept in registers while it stays there
  float4 c[8];

  // the flat index of the cell at the ray's position, or -1 where the march
  // stops the ray there (out of bounds, or no budget left)
  auto cell = [&]() -> Idx {
    const uint32_t cx = px >> 16, cy = py >> 16, cz = pz >> 16;
    if (rem == 0u || cx >= xb || cy >= yb || cz >= zb) return -1;
    return (Idx)cx * sx + (Idx)cy * sy + (Idx)cz;
  };

  // one step from cell `base`, whose corners are in c; false where the
  // march stops the ray (state unchanged)
  auto step = [&](Idx base) -> bool {
    if (absorb) {
      const uint32_t room = 0xFFFFFFFFu - (uint32_t)__ldg(tr + base);
      br -= br < room ? br : room;
      if (br < min_bright) return false;
    }

    const float fx = (float)(px & 0xFFFFu) * FIX_SCALE;
    const float fy = (float)(py & 0xFFFFu) * FIX_SCALE;
    const float fz = (float)(pz & 0xFFFFu) * FIX_SCALE;
    const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
    const float w[8] = {gx * gy * gz, gx * gy * fz, gx * fy * gz, gx * fy * fz,
                        fx * gy * gz, fx * gy * fz, fx * fy * gz, fx * fy * fz};
    float in0 = c[0].x * w[0], in1 = c[0].y * w[0], in2 = c[0].z * w[0], in3 = c[0].w * w[0];
#pragma unroll
    for (int o = 1; o < 8; ++o) {
      in0 = in0 + c[o].x * w[o];
      in1 = in1 + c[o].y * w[o];
      in2 = in2 + c[o].z * w[o];
      in3 = in3 + c[o].w * w[o];
    }
    if (in3 > 0.0f) return false;

    dx = dx + in0 * invx;
    dy = dy + in1 * invy;
    dz = dz + in2 * invz;
    const float ilen = STEP_CONST / (dx * dx + dy * dy + dz * dz);
    // the low 32 bits of the int64 step: the uint32 wrap of the JAX package
    px += round_low32(dx * invx * ilen);
    py += round_low32(dy * invy * ilen);
    pz += round_low32(dz * invz * ilen);
    rem -= 1u;
    return true;
  };

  // the march over cells: a ray loads its cell's corners once as it enters
  // the cell (the outer loop), then steps while it stays there (the inner
  // loop, which holds no load of the packed field, so none is predicated
  // into its steps); `visit` runs after each executed step
  auto march = [&](auto visit) {
    for (Idx base = cell(); base >= 0;) {
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        c[o] = __ldg(packed + base + ((o >> 2) & 1) * sx + ((o >> 1) & 1) * sy + (o & 1));
      }
      const Idx here = base;
      do {
        if (!step(here)) return;
        visit();
        base = cell();
      } while (base == here);
    }
  };

  if constexpr (!RECORD) {
    march([] {});
  } else {
    // this lane's staging buffers of PK entries (uint32 words, each int64
    // a low and a high word), its path row, the entry that the next run
    // starts at, the buffer being filled and its entries; the start is
    // the first entry
    extern __shared__ __align__(16) uint32_t stage_mem[];
    uint32_t* const mine = stage_mem + threadIdx.x * SROW;
    long long* const out = path + (long long)i * path_stride * 3;
    for (int k = 1; k < NBUF * RUN; k += 2) mine[k] = 0u;
    int next = 0, buf = 0, staged = 0;
    auto put = [&](uint32_t x, uint32_t y, uint32_t z) {
      uint32_t* e = mine + buf * RUN + 6 * staged;
      e[0] = x + pos_offset; e[2] = y + pos_offset; e[4] = z + pos_offset;
      if (++staged == PK) {
        bulk_store(out + 3 * next, mine + buf * RUN, RUN * 4);
        next += PK;
        staged = 0;
        buf = (buf + 1) % NBUF;
        bulk_wait_read<NBUF - 1>();   // the next buffer's last copy has read it
      }
    };
    put(px, py, pz);
    march([&] { put(px, py, pz); });

    // back-fill entries next + staged .. path_stride - 1 with the end
    // position: the current buffer filled up with it, then a buffer of
    // nothing else, by runs of PK entries and a shorter last run (an even
    // number of entries, since the row's length and PK are even)
    const uint32_t ex = px + pos_offset, ey = py + pos_offset, ez = pz + pos_offset;
    if (next < path_stride) {
      uint32_t* const cur_buf = mine + buf * RUN;
      for (int k = staged; k < PK; ++k) {
        cur_buf[6 * k] = ex; cur_buf[6 * k + 2] = ey; cur_buf[6 * k + 4] = ez;
      }
      bulk_store(out + 3 * next, cur_buf, 24 * min(PK, path_stride - next));
      next += PK;
      if (next < path_stride) {
        uint32_t* const ends = mine + (buf + 1) % NBUF * RUN;
        bulk_wait_read<NBUF - 1>();
        for (int k = 0; k < PK; ++k) {
          ends[6 * k] = ex; ends[6 * k + 2] = ey; ends[6 * k + 4] = ez;
        }
        for (; next < path_stride; next += PK) {
          bulk_store(out + 3 * next, ends, 24 * min(PK, path_stride - next));
        }
      }
    }
    bulk_wait_read<0>();   // the shared memory stays until every copy has read it
  }

  pos_out[3 * i] = px + pos_offset;
  pos_out[3 * i + 1] = py + pos_offset;
  pos_out[3 * i + 2] = pz + pos_offset;
  dir_out[3 * i] = dx * FIX_SCALE;
  dir_out[3 * i + 1] = dy * FIX_SCALE;
  dir_out[3 * i + 2] = dz * FIX_SCALE;
  iter_out[i] = (long long)budget - (long long)rem;
  br_out[i] = br;
}

#define MARCH_FIXED_PARAMS                                                               \
  const float4 *__restrict__ packed, int X, int Y, int Z,                                \
      const long long *__restrict__ tr, const float *__restrict__ ior, int IX, int IY,   \
      int IZ, uint32_t start_shift, const long long *__restrict__ pos_in,                \
      const float *__restrict__ dir_in, long long *__restrict__ pos_out,                 \
      float *__restrict__ dir_out, long long *__restrict__ iter_out,                     \
      long long *__restrict__ br_out, long long *__restrict__ path, int path_stride,     \
      uint32_t pos_offset, int n, uint32_t budget, float invx, float invy, float invz,  \
      uint32_t min_bright
#define MARCH_FIXED_ARGS                                                                 \
  packed, X, Y, Z, tr, ior, IX, IY, IZ, start_shift, pos_in, dir_in, pos_out, dir_out,   \
      iter_out, br_out, path, path_stride, pos_offset, n, budget, invx, invy, invz,      \
      min_bright

// the four instantiations: the plain and the recording march, each with
// 32-bit cell indices and with 64-bit ones (march_fixed_wide) for fields
// of 2^31 float4s or more
__global__ void __launch_bounds__(THREADS) march_fixed_kernel(MARCH_FIXED_PARAMS) {
  march_fixed_body<int32_t, false>(MARCH_FIXED_ARGS);
}
__global__ void __launch_bounds__(THREADS) march_fixed_path_kernel(MARCH_FIXED_PARAMS) {
  march_fixed_body<int32_t, true>(MARCH_FIXED_ARGS);
}
__global__ void __launch_bounds__(THREADS) march_fixed_wide_kernel(MARCH_FIXED_PARAMS) {
  march_fixed_body<int64_t, false>(MARCH_FIXED_ARGS);
}
__global__ void __launch_bounds__(THREADS) march_fixed_path_wide_kernel(MARCH_FIXED_PARAMS) {
  march_fixed_body<int64_t, true>(MARCH_FIXED_ARGS);
}

typedef void (*march_fixed_fn)(MARCH_FIXED_PARAMS);

int launch(march_fixed_fn kernel, int smem, const void* packed, int X, int Y, int Z,
           const void* tr, const void* ior, int IX, int IY, int IZ, unsigned start_shift,
           const void* pos_in, const void* dir_in, void* pos_out, void* dir_out, void* iter_out,
           void* br_out, void* path, int path_stride, unsigned pos_offset, int n,
           unsigned budget, float invx, float invy, float invz, unsigned min_bright,
           void* stream) {
  if (n > 0) {
    // the staging buffers are dynamic shared memory; above 48 KB a block
    // they need the opt-in
    if (smem > 48 * 1024) {
      const cudaError_t rc =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (rc != cudaSuccess) return (int)rc;
    }
    kernel<<<(n + THREADS - 1) / THREADS, THREADS, smem, (cudaStream_t)stream>>>(
        (const float4*)packed, X, Y, Z, (const long long*)tr, (const float*)ior, IX, IY, IZ,
        start_shift, (const long long*)pos_in, (const float*)dir_in, (long long*)pos_out,
        (float*)dir_out, (long long*)iter_out, (long long*)br_out, (long long*)path,
        path_stride, pos_offset, n, budget, invx, invy, invz, min_bright);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue before it when a path row's length is odd (a run
// of an odd number of entries is no whole number of 16-byte units).  The
// 32-bit instantiations serve fields of fewer than 2^31 float4s.
extern "C" int vrt_march_fixed(
    const void* packed, int X, int Y, int Z, const void* tr, const void* ior, int IX, int IY,
    int IZ, unsigned start_shift, const void* pos_in, const void* dir_in, void* pos_out,
    void* dir_out, void* iter_out, void* br_out, unsigned pos_offset, int n, unsigned budget,
    float invx, float invy, float invz, unsigned min_bright, void* stream) {
  const bool narrow = (long long)X * Y * Z < (1LL << 31);
  return launch(narrow ? march_fixed_kernel : march_fixed_wide_kernel, 0, packed, X, Y, Z, tr,
                ior, IX, IY, IZ, start_shift, pos_in, dir_in, pos_out, dir_out, iter_out, br_out,
                nullptr, 0, pos_offset, n, budget, invx, invy, invz, min_bright, stream);
}

extern "C" int vrt_march_fixed_path(
    const void* packed, int X, int Y, int Z, const void* tr, const void* ior, int IX, int IY,
    int IZ, unsigned start_shift, const void* pos_in, const void* dir_in, void* pos_out,
    void* dir_out, void* iter_out, void* br_out, void* path, int path_stride,
    unsigned pos_offset, int n, unsigned budget, float invx, float invy, float invz,
    unsigned min_bright, void* stream) {
  if (path_stride <= 0 || path_stride % 2 != 0) return (int)cudaErrorInvalidValue;
  const bool narrow = (long long)X * Y * Z < (1LL << 31);
  return launch(narrow ? march_fixed_path_kernel : march_fixed_path_wide_kernel, PATH_SMEM,
                packed, X, Y, Z, tr, ior, IX, IY, IZ, start_shift, pos_in, dir_in, pos_out,
                dir_out, iter_out, br_out, path, path_stride, pos_offset, n, budget, invx, invy,
                invz, min_bright, stream);
}
