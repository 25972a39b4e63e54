// R1: the camera's accumulating march, the emission/absorption render, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs this march as a lax.scan
// of jax.checkpoint chunks over volumeraytracer_tpu/models/camera.py
// :_march_accumulate (:229; _march_with_transmittance :304 is the same
// loop without the emission), which XLA compiles into one loop.  Eager
// torch has nothing like it: the plain march (models/camera.py
// :_march_accumulate over ops/march.py:_float_step) launches each op of
// every step, with two interp_linear gathers a step and a host sync a
// chunk.  One thread per ray, over the float32 packed field (no brick
// table), in F1's form.  Each thread loops, while its ray is alive and
// has budget, over
//
//   stop unless 0 <= x and floor(x) < bound - 1 on every axis
//   interp = sum over corners (product order, dz fastest) of
//            w * packed[floor(x) + corner], w from x - floor(x)
//   stop if interp[3] > 0 (opaque)
//   u = v + interp[0:3] * bend;  x' = x + u * step * (1 / |u|^2)
//   d = x' - x;  ds = |d| (0 where |d|^2 = 0);  mid = 0.5 * (x' + x)
//   dtau = sigma(mid) * ds                                  (with sigma)
//   rad_c += exp(-tau) * w_seg * e_c(mid),  w_seg = -expm1(-dtau) with
//            sigma, ds without                            (with emission)
//   tau += dtau;  x = x', v = u
//
// (ops/march.py:_float_step with no translucency and the opaque test
// interp[3] > 0, then _march_accumulate's `one`), and writes the end
// position (packed frame), direction, iterations (budget - remaining: a
// ray leaves the loop only by stopping), tau and its channels of the
// (N, C) radiance.  sigma (SX, SY, SZ) and the emission (EX, EY, EZ, C)
// are sampled at mid with their own shapes, as ops/interp.py
// :interp_linear samples them: the base corner floor(mid) clamped to
// [0, s - 2] per axis, the weights from mid - floor(mid), unclamped.  A
// scalar field is the driver's (2, 2, 2) grid.  Every operation follows
// the plain march in its order (-fmad=false, IEEE division and square
// root), so the end state equals the plain version's bit for bit on the
// card; tau and the radiance also go through expf and expm1f, which
// chip_smoke.py holds against torch's exp and expm1 on the card.
//
// Channels: NC, at most 4, is a template parameter, so a ray's radiance
// lives in registers.  A larger C runs in groups of at most 4 channels,
// one launch a group (c0, the group's first channel): the march does not
// depend on the emission, so every group's launch walks the same path
// and writes the same end state, position, direction, iterations and tau.
//
// What bounds it on the H100: the loop's length is the data's, and each
// step is 225 float32 operations with sigma and 3 channels
// (chip_smoke.py's render_ops counts them from this file) on values that
// stay in registers while the ray's cells stay the same, so the bound is
// operations.  The design keeps three caches in registers: the 8 float4
// corners of the ray's packed cell (keyed by its flat index), the 8
// corners of sigma and the 8 x NC of the emission around the segment's
// midpoint (each keyed by the clamped base cell in its own grid; a scalar
// field's never changes).  A loop over cells holds every load, around a
// step loop that loads nothing (PR 14's finding for F1: loads under a test
// inside one loop are predicated into every step): the step loop leaves
// when the ray enters another packed cell, or when the step it has just
// proposed (x', u, mid) has its midpoint in another cell of sigma or of
// the emission; the outer loop then loads what changed and commits that
// step without computing it again.  Cell indices are 32-bit (the driver
// checks that each field has fewer than 2^31 cells); a load's address is
// 64-bit.  Its time beside its bound is in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// the corner weights in product order (dz fastest), each (w_x * w_y) * w_z
__device__ __forceinline__ void weights(float fx, float fy, float fz, float (&w)[8]) {
  const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
  w[0] = gx * gy * gz; w[1] = gx * gy * fz; w[2] = gx * fy * gz; w[3] = gx * fy * fz;
  w[4] = fx * gy * gz; w[5] = fx * gy * fz; w[6] = fx * fy * gz; w[7] = fx * fy * fz;
}

// interp_linear's base cell in an (S0, S1, S2) grid: floor(p) converted
// (saturating, NaN to 0, as torch's cast on the card) and clamped to
// [0, s - 2] per axis, as a flat cell index
__device__ __forceinline__ int base_cell(float f0, float f1, float f2, int s0, int s1, int s2) {
  const int i0 = clampi(__float2int_rz(f0), 0, s0 - 2);
  const int i1 = clampi(__float2int_rz(f1), 0, s1 - 2);
  const int i2 = clampi(__float2int_rz(f2), 0, s2 - 2);
  return (i0 * s1 + i1) * s2 + i2;
}

// the flat cell offset of corner o in an (., s1, s2) grid
__device__ __forceinline__ int corner_cells(int o, int s1, int s2) {
  return ((o >> 2) & 1) * s1 * s2 + ((o >> 1) & 1) * s2 + (o & 1);
}

template <int NC, bool SIGMA>
__global__ void __launch_bounds__(THREADS)
render_fwd_kernel(const float4* __restrict__ packed, int X, int Y, int Z,
                  const float* __restrict__ sigma, int SX, int SY, int SZ,
                  const float* __restrict__ em, int EX, int EY, int EZ, int C, int c0,
                  const float* __restrict__ pos_in, const float* __restrict__ dir_in,
                  float* __restrict__ pos_out, float* __restrict__ dir_out,
                  long long* __restrict__ iter_out, float* __restrict__ tau_out,
                  float* __restrict__ rad_out, int n, int budget, float bx, float by,
                  float bz, float sx, float sy, float sz) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float px = pos_in[3 * i], py = pos_in[3 * i + 1], pz = pos_in[3 * i + 2];
  float vx = dir_in[3 * i], vy = dir_in[3 * i + 1], vz = dir_in[3 * i + 2];
  // the reference consumes one budget slot for the start path entry
  int rem = budget - 1;
  float tau = 0.0f;
  float rad[NC > 0 ? NC : 1];
#pragma unroll
  for (int c = 0; c < NC; ++c) rad[c] = 0.0f;

  const float xb = (float)(X - 1), yb = (float)(Y - 1), zb = (float)(Z - 1);
  // the caches: the packed cell's corners, sigma's and the emission's
  // corners around the midpoint, each with the cell it holds (-1: none)
  float4 c[8];
  int pk = -1;
  float sc[8];
  int sk = -1;
  float ec[8][NC > 0 ? NC : 1];
  int ek = -1;
  // the proposed step: the new position and direction, the segment's
  // length and midpoint, the midpoint's cells in sigma's and the
  // emission's grids
  float nx, ny, nz, nvx, nvy, nvz, ds, mx, my, mz;
  int sb = 0, eb = 0;

  // the flat index of the packed cell at x, or -1 where the march stops
  // the ray there (no budget left, or out of bounds)
  auto cell = [&]() -> int {
    if (rem <= 0) return -1;
    const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
    if (!(px >= 0.0f && py >= 0.0f && pz >= 0.0f && fx < xb && fy < yb && fz < zb)) return -1;
    return ((int)fx * Y + (int)fy) * Z + (int)fz;
  };

  // propose one step from the packed cell in c: false where the ray is
  // opaque there (the state unchanged)
  auto propose = [&]() -> bool {
    const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
    float w[8];
    weights(px - fx, py - fy, pz - fz, w);
    float in0 = c[0].x * w[0], in1 = c[0].y * w[0], in2 = c[0].z * w[0], in3 = c[0].w * w[0];
#pragma unroll
    for (int o = 1; o < 8; ++o) {
      in0 = in0 + c[o].x * w[o];
      in1 = in1 + c[o].y * w[o];
      in2 = in2 + c[o].z * w[o];
      in3 = in3 + c[o].w * w[o];
    }
    if (in3 > 0.0f) return false;
    nvx = vx + in0 * bx;
    nvy = vy + in1 * by;
    nvz = vz + in2 * bz;
    const float ilen = 1.0f / (nvx * nvx + nvy * nvy + nvz * nvz);
    nx = px + nvx * sx * ilen;
    ny = py + nvy * sy * ilen;
    nz = pz + nvz * sz * ilen;
    const float dx = nx - px, dy = ny - py, dz = nz - pz;
    const float ds2 = dx * dx + dy * dy + dz * dz;
    ds = ds2 > 0.0f ? sqrtf(ds2) : 0.0f;
    mx = 0.5f * (nx + px);
    my = 0.5f * (ny + py);
    mz = 0.5f * (nz + pz);
    if (SIGMA || NC > 0) {
      const float f0 = floorf(mx), f1 = floorf(my), f2 = floorf(mz);
      if (SIGMA) sb = base_cell(f0, f1, f2, SX, SY, SZ);
      if (NC > 0) eb = base_cell(f0, f1, f2, EX, EY, EZ);
    }
    return true;
  };

  // the midpoint's corners, where its cells changed
  auto load_mid = [&]() {
    if (SIGMA && sb != sk) {
      sk = sb;
#pragma unroll
      for (int o = 0; o < 8; ++o) sc[o] = __ldg(sigma + sk + corner_cells(o, SY, SZ));
    }
    if (NC > 0 && eb != ek) {
      ek = eb;
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const float* e = em + (long long)(ek + corner_cells(o, EY, EZ)) * C + c0;
#pragma unroll
        for (int ch = 0; ch < NC; ++ch) ec[o][ch] = __ldg(e + ch);
      }
    }
  };

  // take the proposed step and accumulate its segment
  auto commit = [&]() {
    px = nx; py = ny; pz = nz;
    vx = nvx; vy = nvy; vz = nvz;
    rem -= 1;
    if (SIGMA || NC > 0) {
      const float f0 = floorf(mx), f1 = floorf(my), f2 = floorf(mz);
      float w[8];
      weights(mx - f0, my - f1, mz - f2, w);
      float dtau = 0.0f;
      if (SIGMA) {
        float s = sc[0] * w[0];
#pragma unroll
        for (int o = 1; o < 8; ++o) s = s + sc[o] * w[o];
        dtau = s * ds;
      }
      if (NC > 0) {
        const float t_prev = expf(-tau);
        const float wseg = SIGMA ? -expm1f(-dtau) : ds;
        const float tw = t_prev * wseg;
#pragma unroll
        for (int ch = 0; ch < NC; ++ch) {
          float e = ec[0][ch] * w[0];
#pragma unroll
          for (int o = 1; o < 8; ++o) e = e + ec[o][ch] * w[o];
          rad[ch] = rad[ch] + tw * e;
        }
      }
      if (SIGMA) tau = tau + dtau;
    }
  };

  // the march over cells: the outer loop loads (the packed cell's corners
  // as the ray enters it, the midpoint's where a proposed step needs
  // them) and the inner loop steps with no load; `have`: a step was
  // proposed and waits for its midpoint's corners
  bool have = false, stopped = false;
  for (;;) {
    if (!have) {
      const int base = cell();
      if (base < 0) break;
      if (base != pk) {
        pk = base;
#pragma unroll
        for (int o = 0; o < 8; ++o) c[o] = __ldg(packed + pk + corner_cells(o, Y, Z));
      }
      if (!propose()) break;
    }
    load_mid();
    have = false;
    commit();
    for (;;) {
      if (cell() != pk) break;
      if (!propose()) { stopped = true; break; }
      if ((SIGMA && sb != sk) || (NC > 0 && eb != ek)) { have = true; break; }
      commit();
    }
    if (stopped) break;
  }

  pos_out[3 * i] = px; pos_out[3 * i + 1] = py; pos_out[3 * i + 2] = pz;
  dir_out[3 * i] = vx; dir_out[3 * i + 1] = vy; dir_out[3 * i + 2] = vz;
  iter_out[i] = (long long)budget - (long long)rem;
  tau_out[i] = tau;
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) rad_out[(long long)i * C + c0 + ch] = rad[ch];
}

#define RENDER_FWD_ARGS                                                                   \
  (const float4*)packed, X, Y, Z, (const float*)sigma, SX, SY, SZ, (const float*)em, EX, \
      EY, EZ, C, c0, (const float*)pos_in, (const float*)dir_in, (float*)pos_out,        \
      (float*)dir_out, (long long*)iter_out, (float*)tau_out, (float*)rad_out, n, budget, \
      bx, by, bz, sx, sy, sz

template <int NC, bool SIGMA>
int launch(const void* packed, int X, int Y, int Z, const void* sigma, int SX, int SY, int SZ,
           const void* em, int EX, int EY, int EZ, int C, int c0, const void* pos_in,
           const void* dir_in, void* pos_out, void* dir_out, void* iter_out, void* tau_out,
           void* rad_out, int n, int budget, float bx, float by, float bz, float sx, float sy,
           float sz, void* stream) {
  if (n > 0) {
    render_fwd_kernel<NC, SIGMA><<<(n + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
        RENDER_FWD_ARGS);
  }
  return (int)cudaGetLastError();
}

template <bool SIGMA>
int launch_nc(int nc, const void* packed, int X, int Y, int Z, const void* sigma, int SX, int SY,
              int SZ, const void* em, int EX, int EY, int EZ, int C, int c0, const void* pos_in,
              const void* dir_in, void* pos_out, void* dir_out, void* iter_out, void* tau_out,
              void* rad_out, int n, int budget, float bx, float by, float bz, float sx, float sy,
              float sz, void* stream) {
  switch (nc) {
    case 0: return launch<0, SIGMA>(packed, X, Y, Z, sigma, SX, SY, SZ, em, EX, EY, EZ, C, c0, pos_in, dir_in, pos_out, dir_out, iter_out, tau_out, rad_out, n, budget, bx, by, bz, sx, sy, sz, stream);
    case 1: return launch<1, SIGMA>(packed, X, Y, Z, sigma, SX, SY, SZ, em, EX, EY, EZ, C, c0, pos_in, dir_in, pos_out, dir_out, iter_out, tau_out, rad_out, n, budget, bx, by, bz, sx, sy, sz, stream);
    case 2: return launch<2, SIGMA>(packed, X, Y, Z, sigma, SX, SY, SZ, em, EX, EY, EZ, C, c0, pos_in, dir_in, pos_out, dir_out, iter_out, tau_out, rad_out, n, budget, bx, by, bz, sx, sy, sz, stream);
    case 3: return launch<3, SIGMA>(packed, X, Y, Z, sigma, SX, SY, SZ, em, EX, EY, EZ, C, c0, pos_in, dir_in, pos_out, dir_out, iter_out, tau_out, rad_out, n, budget, bx, by, bz, sx, sy, sz, stream);
    case 4: return launch<4, SIGMA>(packed, X, Y, Z, sigma, SX, SY, SZ, em, EX, EY, EZ, C, c0, pos_in, dir_in, pos_out, dir_out, iter_out, tau_out, rad_out, n, budget, bx, by, bz, sx, sy, sz, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the instantiation for (sigma given, nc channels from c0 of the
// emission's C; nc = 0 without emission) and returns cudaGetLastError(),
// or cudaErrorInvalidValue before any launch for nc outside [0, 4] or
// beyond C.
extern "C" int vrt_render_fwd(
    const void* packed, int X, int Y, int Z, const void* sigma, int SX, int SY, int SZ,
    const void* em, int EX, int EY, int EZ, int C, int c0, int nc, const void* pos_in,
    const void* dir_in, void* pos_out, void* dir_out, void* iter_out, void* tau_out,
    void* rad_out, int n, int budget, float bx, float by, float bz, float sx, float sy, float sz,
    void* stream) {
  if (nc < 0 || nc > 4 || (nc > 0 && (em == nullptr || c0 < 0 || c0 + nc > C)))
    return (int)cudaErrorInvalidValue;
  if (sigma != nullptr)
    return launch_nc<true>(nc, packed, X, Y, Z, sigma, SX, SY, SZ, em, EX, EY, EZ, C, c0, pos_in,
                           dir_in, pos_out, dir_out, iter_out, tau_out, rad_out, n, budget, bx, by,
                           bz, sx, sy, sz, stream);
  return launch_nc<false>(nc, packed, X, Y, Z, sigma, SX, SY, SZ, em, EX, EY, EZ, C, c0, pos_in,
                          dir_in, pos_out, dir_out, iter_out, tau_out, rad_out, n, budget, bx, by,
                          bz, sx, sy, sz, stream);
}
