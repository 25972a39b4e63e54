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
// :317-374) and of K2.  Each thread loops
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
// and writes the end position (int64 holding the uint32), the working
// direction, the raw remaining budget, the alive flag and the brightness.
// With a path it writes the start position, each executed step's position
// and then the end position up to the path's length.  Every operation
// follows ops/march.py's plain fixed march in its order: the build
// compiles with -fmad=false, the division is IEEE (no fast math), rintf
// rounds half to even as torch.round does, and the float-to-int64
// conversion is the one torch's .to(torch.int64) compiles to, so F1
// equals the plain march bit for bit on the card.
//
// What bounds it on the H100: the loop's length is the data's, and each
// step is 104 float32 operations (chip_smoke.py's MARCH_FIXED_OPS: the 3
// divisions of the weights, 3 subtractions, 16 weight products, 60
// multiplies and adds of the corner sums, the opacity compare, 6 for the
// bend, 5 for |d|^2, the division, 6 multiplies and 3 roundings of the
// step; the integer bounds test, absorption and conversions left out) on
// values that stay in registers while the ray stays in its cell, so the
// bound is operations, not bytes.  The design keeps the cell's 8 corners
// (one float4 of the packed field each) in registers, keyed on the cell's
// flat index, and reloads them only when the ray enters another cell, as
// K2 does; it reads the packed field directly, with no brick table, since
// a 16.16 position gives its cell with shifts.  Its time beside its bound
// is in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
// 0x42000000, exact in float32
constexpr float STEP_CONST = 1107296256.0f;
constexpr float FIX_ONE = 65536.0f;

__global__ void __launch_bounds__(THREADS)
march_fixed_kernel(const float4* __restrict__ packed, int X, int Y, int Z,
                   const long long* __restrict__ tr,
                   const long long* __restrict__ pos_in,
                   const float* __restrict__ dir_in,
                   long long* __restrict__ pos_out, float* __restrict__ dir_out,
                   long long* __restrict__ rem_out, int* __restrict__ alive_out,
                   long long* __restrict__ br_out, long long* __restrict__ path,
                   long long path_len, int n, unsigned budget, float invx,
                   float invy, float invz, unsigned min_bright) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t px = (uint32_t)pos_in[3 * i];
  uint32_t py = (uint32_t)pos_in[3 * i + 1];
  uint32_t pz = (uint32_t)pos_in[3 * i + 2];
  float dx = dir_in[3 * i], dy = dir_in[3 * i + 1], dz = dir_in[3 * i + 2];
  // the reference consumes one budget slot for the start path entry
  uint32_t rem = budget - 1u;
  uint32_t br = 0xFFFFFFFFu;
  int alive = 1;

  long long* rec = path == nullptr ? nullptr : path + (long long)i * path_len * 3;
  long long k = 0;
  if (rec != nullptr) {
    rec[0] = px; rec[1] = py; rec[2] = pz;
  }

  const uint32_t xb = (uint32_t)(X - 1), yb = (uint32_t)(Y - 1), zb = (uint32_t)(Z - 1);
  const int64_t sx = (int64_t)Y * Z, sy = Z;
  // the cell's corners, loaded when the ray enters a cell and kept in
  // registers while it stays there, keyed on the cell's flat index
  int64_t cur = -1;
  float4 c[8];

  while (alive) {
    const uint32_t cx = px >> 16, cy = py >> 16, cz = pz >> 16;
    if (rem == 0u || cx >= xb || cy >= yb || cz >= zb) { alive = 0; break; }
    const int64_t base = (int64_t)cx * sx + (int64_t)cy * sy + cz;

    if (tr != nullptr) {
      const uint32_t room = 0xFFFFFFFFu - (uint32_t)__ldg(tr + base);
      br -= br < room ? br : room;
      if (br < min_bright) { alive = 0; break; }
    }

    if (base != cur) {
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        c[o] = __ldg(packed + base + ((o >> 2) & 1) * sx + ((o >> 1) & 1) * sy + (o & 1));
      }
      cur = base;
    }

    const float fx = (float)(px & 0xFFFFu) / FIX_ONE;
    const float fy = (float)(py & 0xFFFFu) / FIX_ONE;
    const float fz = (float)(pz & 0xFFFFu) / FIX_ONE;
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
    if (in3 > 0.0f) { alive = 0; break; }

    dx = dx + in0 * invx;
    dy = dy + in1 * invy;
    dz = dz + in2 * invz;
    const float ilen = STEP_CONST / (dx * dx + dy * dy + dz * dz);
    // the low 32 bits of the int64 step: the uint32 wrap of the JAX package
    px += (uint32_t)(long long)rintf(dx * invx * ilen);
    py += (uint32_t)(long long)rintf(dy * invy * ilen);
    pz += (uint32_t)(long long)rintf(dz * invz * ilen);
    rem -= 1u;
    if (rec != nullptr) {
      ++k;
      rec[3 * k] = px; rec[3 * k + 1] = py; rec[3 * k + 2] = pz;
    }
  }

  if (rec != nullptr) {
    for (long long j = k + 1; j < path_len; ++j) {
      rec[3 * j] = px; rec[3 * j + 1] = py; rec[3 * j + 2] = pz;
    }
  }
  pos_out[3 * i] = px; pos_out[3 * i + 1] = py; pos_out[3 * i + 2] = pz;
  dir_out[3 * i] = dx; dir_out[3 * i + 1] = dy; dir_out[3 * i + 2] = dz;
  rem_out[i] = rem;
  alive_out[i] = alive;
  br_out[i] = br;
}

}  // namespace

extern "C" int vrt_march_fixed(
    const void* packed, int X, int Y, int Z, const void* tr, const void* pos_in,
    const void* dir_in, void* pos_out, void* dir_out, void* rem_out,
    void* alive_out, void* br_out, void* path, long long path_len, int n,
    unsigned budget, float invx, float invy, float invz, unsigned min_bright,
    void* stream) {
  if (n > 0) {
    march_fixed_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                         (cudaStream_t)stream>>>(
        (const float4*)packed, X, Y, Z, (const long long*)tr,
        (const long long*)pos_in, (const float*)dir_in, (long long*)pos_out,
        (float*)dir_out, (long long*)rem_out, (int*)alive_out,
        (long long*)br_out, (long long*)path, path_len, n, budget, invx, invy,
        invz, min_bright);
  }
  return (int)cudaGetLastError();
}
