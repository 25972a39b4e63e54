// R2: the reverse-replay adjoint of R1, the camera's accumulating march,
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package differentiates the lax.scan
// of jax.checkpoint chunks of volumeraytracer_tpu/models/camera.py
// :_march_accumulate (:229) by recomputing each chunk in the backward, and
// eager torch's autograd over the plain march (models/camera.py
// :_march_accumulate in checkpointed chunks) does the same op by op.  The
// scheme is K3's (csrc/march_lines_bwd.cu): the march step is invertible,
//
//   forward:  u = v + bend*g(x);       x' = x + step*u/|u|^2
//   reverse:  x = x' - step*u/|u|^2;   v = u - bend*g(x)
//
// so no trajectory is stored, with one exception: the last step replayed
// (the march's first) takes the ray's start position, which the driver
// passes, in place of its reconstruction.  A camera's rays start together,
// often on cell faces (chip_smoke.py's camera at (0.5, 127, 127) in the
// packed frame), where a reconstruction a rounding away lies in the
// neighbouring cell and bends with that cell's gradient (tests/
// test_torch_render_kernel.py holds d pos0 against a float64 march).
// One thread per ray (ray order[t] for thread t: the wrapper's tile order,
// kernels/render.py:render_order) starts from R1's end
// state (x', u, tau) and the cotangents of the end position and direction
// (xb, vb), of tau (tb: the transmittance's -T * Tbar, and the image's
// background term through T_end) and of the radiance (rb_c, one a channel,
// the same at every step since the radiance is a sum), and replays
// min(nexec, budget) steps backwards.  Per step, from (x, x') it
// recomputes the segment as R1 computed it (d = x' - x, ds, mid = 0.5 *
// (x' + x), s = sigma(mid), dtau = s * ds, tau before = tau - dtau, T =
// exp(-tau before), w = -expm1(-dtau) with sigma and ds without,
// tw = T * w) and, with q = sum_c rb_c e_c(mid), takes the adjoints
//
//   Tb = q * w;  wb = q * T;  tb' = tb - T * Tb          (tau before)
//   dtaub = tb + wb * exp(-dtau);  sb = dtaub * ds;  dsb = dtaub * s
//                                        (without sigma: dsb = wb, no sb)
//   midb = sb * grad sigma(mid) + tw * grad q(mid)
//   db = dsb * d / ds (0 where |d|^2 = 0)
//   xb' = xb + 0.5 * midb + db   (all that reaches x'), then K3's step:
//   t = sum_i step_i u_i xb'_i;  ub = vb + step*ilen*xb' - 2u*ilen^2*t
//   h = bend*ub;  xb = xb' + sum_o (dw_o/dx)(C_o . h) + 0.5 * midb - db
//   vb = ub;  tb = tb'
//
// and scatters: d packed channels 0-2 += w_o(x) * h at the corners of x;
// d sigma += W_o(mid) * sb and d emission[., c] += W_o(mid) * tw * rb_c at
// mid's corners (each field's own shape and clamp, as R1 samples it).
// The emission enters the step only through P_o = sum_c rb_c E_o,c, the
// corners projected on the ray's radiance cotangent, and its gradient only
// through sum W_o * tw, multiplied by rb_c when it is added to the field:
// so R2 takes any number of channels in one launch, and its step does not
// grow with them.  The opacity channel gets no gradient (termination is
// straight-through, as in K3 and as the JAX package's where gives it).
// It writes d pos0 = xb and d dir0 = vb.  The arithmetic follows the plain
// version (kernels/render.py:render_replay_plain) in its order, and the
// build compiles with -fmad=false, so the per-ray outputs equal the plain
// replay's bit for bit where expf and expm1f equal torch's exp and expm1
// on the card; the field gradients are summed with float atomics, in an
// order that changes from run to run.
//
// What bounds it on the H100: each replayed step is 525 float32
// operations with sigma and an emission (chip_smoke.py's render_bwd_ops
// counts them from this file), so operations, ahead of the fields read
// and their gradients written once (the wrapper zeroes them: 0.26 GB of
// packed gradient and 0.26 GB of the sigma-and-emission record at 256^3).
// What held the first design back was the count of global atomic
// instructions: a camera's ray at speed 0.5 enters another cell at nearly
// every step (K3's rays stay ~30), so one thread's caches flushed ~24
// atomic instructions a step, ~100 G a second at the L2.  This design
// combines a warp's gradients on chip before any global atomic:
//
// * Rays in tiles: the wrapper orders the rays by start cell, then by a
//   Morton code of their direction, so a warp holds an 8 x 4 tile of a
//   camera's pixels, whose rays share cells.
// * Aligned replay: the warp replays forward step s = M - 1 - j in
//   iteration j (M: its largest step count); a lane joins once s is below
//   its own count.  Each lane replays its own steps in its own order, so
//   d pos0 and d dir0 are unchanged to the bit.
// * Registers hold each field's corners, and shared memory each lane's
//   sums of their gradients, while the ray stays in a cell (the sums in
//   shared memory leave the record's instantiation three blocks of 128
//   threads an SM with no spills).  Where sigma and the emission share a
//   grid and C <= 3, the wrapper interleaves them into one record (sigma,
//   e_0, e_1, e_2), so one cache of 8 float4 corners serves both and a
//   corner's gradients are one float4.
// * Grouped flushes: when lanes leave cells, the warp groups the lanes
//   that leave the same cell (__match_any_sync), sums each group's rows
//   where they lie, one lane a corner and a quarter of the warp, and sends
//   each corner's sum with one float4 global atomic.
//
// sigma or an emission alone, or on other grids, or with C > 3, keeps its
// own register cache and flushes it with global atomics (a float4 a corner
// for an emission of 3 or 4 channels, whose gradient the wrapper allocates
// in rows of 4; float2s for 2 channels); a scalar field's (2, 2, 2) grid
// never changes cell, so all of a ray's steps add to it with one flush.
// The host build (tests) defines VRT_BLOCK_THREADS as 1, so that a shim
// that runs one thread at a time runs this source: a warp's grouping then
// holds one lane.  A build that defines VRT_COUNT_ATOMICS (the render
// probe's, the host tests') counts R2's global atomic instructions, read
// with vrt_render_bwd_atomics.  Its time beside its bound is in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifdef VRT_BLOCK_THREADS
constexpr int THREADS = VRT_BLOCK_THREADS;
#else
constexpr int THREADS = 128;
#endif
constexpr int LANES = THREADS < 32 ? THREADS : 32;
constexpr int WARPS = (THREADS + LANES - 1) / LANES;
constexpr unsigned FULL = LANES == 32 ? 0xffffffffu : (1u << LANES) - 1u;

// the counting build's global atomic instructions since the last read
#ifdef VRT_COUNT_ATOMICS
__device__ unsigned long long vrt_bwd_atomics;
#define COUNT_ATOMICS(k) atomicAdd(&vrt_bwd_atomics, (unsigned long long)(k))
#else
#define COUNT_ATOMICS(k) ((void)0)
#endif

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// interp_linear's base cell in an (S0, S1, S2) grid (see render_fwd.cu)
__device__ __forceinline__ int base_cell(float f0, float f1, float f2, int s0, int s1, int s2) {
  const int i0 = clampi(__float2int_rz(f0), 0, s0 - 2);
  const int i1 = clampi(__float2int_rz(f1), 0, s1 - 2);
  const int i2 = clampi(__float2int_rz(f2), 0, s2 - 2);
  return (i0 * s1 + i1) * s2 + i2;
}

__device__ __forceinline__ int corner_cells(int o, int s1, int s2) {
  return ((o >> 2) & 1) * s1 * s2 + ((o >> 1) & 1) * s2 + (o & 1);
}

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x = a.x + b.x; a.y = a.y + b.y; a.z = a.z + b.z; a.w = a.w + b.w;
}

// the corner weights (product order, dz fastest) and their derivatives
// along x, y and z, as K3 takes them
struct Weights {
  float w[8], dx[8], dy[8], dz[8];
};

__device__ __forceinline__ void weights(float fx, float fy, float fz, Weights& k) {
  const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
  k.w[0] = gx * gy * gz; k.w[1] = gx * gy * fz; k.w[2] = gx * fy * gz; k.w[3] = gx * fy * fz;
  k.w[4] = fx * gy * gz; k.w[5] = fx * gy * fz; k.w[6] = fx * fy * gz; k.w[7] = fx * fy * fz;
  const float yz[4] = {gy * gz, gy * fz, fy * gz, fy * fz};
  const float xz[4] = {gx * gz, gx * fz, fx * gz, fx * fz};
  const float xy[4] = {gx * gy, gx * fy, fx * gy, fx * fy};
  const float dx[8] = {-yz[0], -yz[1], -yz[2], -yz[3], yz[0], yz[1], yz[2], yz[3]};
  const float dy[8] = {-xz[0], -xz[1], xz[0], xz[1], -xz[2], -xz[3], xz[2], xz[3]};
  const float dz[8] = {-xy[0], xy[0], -xy[1], xy[1], -xy[2], xy[2], -xy[3], xy[3]};
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    k.dx[o] = dx[o]; k.dy[o] = dy[o]; k.dz[o] = dz[o];
  }
}

// sum_o a[o] * v[o] in corner order
__device__ __forceinline__ float dot8(const float (&a)[8], const float (&v)[8]) {
  float s = a[0] * v[0];
#pragma unroll
  for (int o = 1; o < 8; ++o) s = s + a[o] * v[o];
  return s;
}

template <bool SIGMA, bool EM, bool REC>
__global__ void __launch_bounds__(THREADS)
render_bwd_kernel(const float* __restrict__ packed, int X, int Y, int Z,
                  const float* __restrict__ sigma, int SX, int SY, int SZ,
                  const float* __restrict__ em, int EX, int EY, int EZ, int C, int GC,
                  const float4* __restrict__ rec, float4* __restrict__ g_rec,
                  const int* __restrict__ order,
                  const float* __restrict__ pos0, const float* __restrict__ end_pos,
                  const float* __restrict__ end_dir, const int* __restrict__ nexec, const float* __restrict__ tau_end,
                  const float* __restrict__ d_pos, const float* __restrict__ d_dir,
                  const float* __restrict__ d_tau, const float* __restrict__ d_rad,
                  float* __restrict__ g_packed, float* __restrict__ g_sigma,
                  float* __restrict__ g_em, float* __restrict__ dpos0,
                  float* __restrict__ ddir0, int n, float ex,
                  float ey, float ez, float sx, float sy, float sz) {
  const int tid = threadIdx.x;
  const int lane = tid % LANES, warp = tid / LANES;
  // Shared memory: each lane's gradient accumulators, which are also the
  // rows its flushes stage (the packed cell's corners, channels 0-2;
  // sigma's and the emission's sums, W_o * sbar and W_o * tw, in lanes 0
  // and 1 of the midpoint cell's corners, made the record's rows (sigma,
  // e_0, e_1, e_2) in place when they flush), each warp's corner-major
  // with a row of LANES + 1 float4s (lane l's corner o at (o, l): no two of
  // 8 lanes reading one lane's corners, or writing one corner, share a
  // bank).  Each lane zeroes its own rows.
  constexpr int NA = SIGMA || EM ? 2 : 1;
  __shared__ float4 acc_s[WARPS * NA * 8 * (LANES + 1)];
  float4* const acc_p = acc_s + warp * NA * 8 * (LANES + 1) + lane;
  float4* const acc_r = acc_p + 8 * (LANES + 1);
#pragma unroll
  for (int o = 0; o < NA * 8; ++o) acc_p[o * (LANES + 1)] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  const bool valid = blockIdx.x * THREADS + tid < n;
  const int i = valid ? order[blockIdx.x * THREADS + tid] : 0;
  const int steps = valid ? nexec[i] : 0;
  float px = end_pos[3 * i], py = end_pos[3 * i + 1], pz = end_pos[3 * i + 2];
  float ux = end_dir[3 * i], uy = end_dir[3 * i + 1], uz = end_dir[3 * i + 2];
  float ax = d_pos[3 * i], ay = d_pos[3 * i + 1], az = d_pos[3 * i + 2];
  float bx = d_dir[3 * i], by = d_dir[3 * i + 1], bz = d_dir[3 * i + 2];
  float tau = SIGMA ? tau_end[i] : 0.0f;
  float tb = SIGMA ? d_tau[i] : 0.0f;
  const float* const rb = EM ? d_rad + (long long)i * C : nullptr;
  // the radiance cotangent as the record's lanes 1-3 take it
  float rr[3] = {0.0f, 0.0f, 0.0f};
  if (REC) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) rr[ch] = ch < C ? __ldg(rb + ch) : 0.0f;
  }

  // the caches: the packed cell's channels 0-2 and their gradients;
  // sigma's corners and gradients around the midpoint; the emission's
  // projected corners and sums of W_o * tw; each with its cell (-1: none).
  // With the record sigma's cache holds the record's cell (sk) for both.
  float chv[8][3];
  int pk = -1;
  float sc[8];
  int sk = -1;
  float pe[8];
  int ek = -1;
  // the reconstructed step: x, 1/|u|^2, the segment and its midpoint's
  // floor, and the cells of x and of the midpoint
  float cx, cy, cz, ilen, dx, dy, dz, ds2, ds, mx, my, mz, m0, m1, m2;
  int pb = 0, sb = 0, eb = 0;

  // reconstruct the next step: x, or the start for the march's first step
  auto recon = [&](bool first) {
    ilen = 1.0f / (ux * ux + uy * uy + uz * uz);
    if (first) {
      cx = pos0[3 * i]; cy = pos0[3 * i + 1]; cz = pos0[3 * i + 2];
    } else {
      cx = px - ux * sx * ilen;
      cy = py - uy * sy * ilen;
      cz = pz - uz * sz * ilen;
    }
    pb = base_cell(floorf(cx), floorf(cy), floorf(cz), X, Y, Z);
    dx = px - cx; dy = py - cy; dz = pz - cz;
    ds2 = dx * dx + dy * dy + dz * dz;
    ds = ds2 > 0.0f ? sqrtf(ds2) : 0.0f;
    mx = 0.5f * (px + cx);
    my = 0.5f * (py + cy);
    mz = 0.5f * (pz + cz);
    m0 = floorf(mx); m1 = floorf(my); m2 = floorf(mz);
    if (SIGMA) sb = base_cell(m0, m1, m2, SX, SY, SZ);
    if (EM && !REC) eb = base_cell(m0, m1, m2, EX, EY, EZ);
  };

  // the warp's grouped flush of field f (0: packed, 1: the record): the
  // lanes with `need` leave cell `c` with their 8 corner rows in `rows`
  // (this lane's row of corner 0); the rows of the lanes that leave one
  // cell are summed and sent with one global atomic a corner, corner o by
  // lanes o, o + 8, o + 16 and o + 24 (each the group's lanes of one
  // quarter of the warp, then combined by shuffles), and the leaving
  // lanes' rows zeroed.  All lanes of the warp call it together.
  auto group_flush = [&](bool need, int c, int f, float4* rows) {
    constexpr int PARTS = LANES / 8 > 0 ? LANES / 8 : 1;
    float4* const g = f ? g_rec : reinterpret_cast<float4*>(g_packed);
    const int s1 = f ? SY : Y, s2 = f ? SZ : Z;
    const unsigned peers = __match_any_sync(FULL, need ? c : -1);
    unsigned leaders = __ballot_sync(FULL, need && __ffs(peers) - 1 == lane);
    __syncwarp(FULL);
    const float4* const stage = rows - lane;
    while (leaders) {
      const int l = __ffs(leaders) - 1;
      leaders &= leaders - 1;
      const unsigned grp = __shfl_sync(FULL, peers, l);
      const int cell = __shfl_sync(FULL, c, l);
      const int q = PARTS > 1 ? lane / 8 : 0;
      for (int o = lane % 8; o < 8; o += LANES < 8 ? LANES : 8) {
        unsigned m = PARTS > 1 ? grp & (0xffu << (8 * q)) : grp;
        float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        while (m) {
          const int a = __ffs(m) - 1;
          m &= m - 1;
          add4(sum, stage[o * (LANES + 1) + a]);
        }
        for (int off = 8; off < LANES; off <<= 1) {
          sum.x = sum.x + __shfl_xor_sync(FULL, sum.x, off);
          sum.y = sum.y + __shfl_xor_sync(FULL, sum.y, off);
          sum.z = sum.z + __shfl_xor_sync(FULL, sum.z, off);
          sum.w = sum.w + __shfl_xor_sync(FULL, sum.w, off);
        }
        if (q == 0) atomicAdd(g + (cell + corner_cells(o, s1, s2)), sum);
      }
      if (lane == 0) COUNT_ATOMICS(8);
      __syncwarp(FULL);
    }
    if (need) {
#pragma unroll
      for (int o = 0; o < 8; ++o) rows[o * (LANES + 1)] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };

  // the record's rows from this lane's sums, in place, for a flush
  auto record_rows = [&]() {
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const float4 a = acc_r[o * (LANES + 1)];
      acc_r[o * (LANES + 1)] = make_float4(a.x, a.y * rr[0], a.y * rr[1], a.y * rr[2]);
    }
  };

  // sigma's and the emission's own caches (no record): this lane's global
  // atomics, as the first design sent them
  auto flush_sigma = [&]() {
    if (!SIGMA || REC || sk < 0) return;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      atomicAdd(g_sigma + sk + corner_cells(o, SY, SZ), acc_r[o * (LANES + 1)].x);
      acc_r[o * (LANES + 1)].x = 0.0f;
    }
    COUNT_ATOMICS(8);
  };
  // a corner's channels in vector atomics where the gradient's rows are
  // 4 or 2 floats (GC: the driver pads 3 channels to 4), one at a time
  // otherwise
  auto flush_em = [&]() {
    if (!EM || REC || ek < 0) return;
    float r[4];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) r[ch] = ch < C && GC <= 4 ? __ldg(rb + ch) : 0.0f;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const long long row = (long long)(ek + corner_cells(o, EY, EZ)) * GC;
      const float ge = acc_r[o * (LANES + 1)].y;
      acc_r[o * (LANES + 1)].y = 0.0f;
      if (GC == 4) {
        atomicAdd(reinterpret_cast<float4*>(g_em + row),
                  make_float4(ge * r[0], ge * r[1], ge * r[2], ge * r[3]));
      } else if (GC == 2) {
        atomicAdd(reinterpret_cast<float2*>(g_em + row), make_float2(ge * r[0], ge * r[1]));
      } else {
        for (int ch = 0; ch < C; ++ch) atomicAdd(g_em + row + ch, ge * __ldg(rb + ch));
      }
    }
    COUNT_ATOMICS(GC == 4 || GC == 2 ? 8 : 8 * C);
  };

  // load the cells the reconstructed step entered (their caches flushed)
  auto load_packed = [&]() {
    pk = pb;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const float* t = packed + (long long)(pk + corner_cells(o, Y, Z)) * 4;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) chv[o][ch] = __ldg(t + ch);
    }
  };
  auto load_record = [&]() {
    sk = sb;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const float4 r = __ldg(rec + sk + corner_cells(o, SY, SZ));
      sc[o] = r.x;
      float p = rr[0] * r.y;
      if (C > 1) p = p + rr[1] * r.z;
      if (C > 2) p = p + rr[2] * r.w;
      pe[o] = p;
    }
  };
  auto reload_own = [&]() {
    if (SIGMA && !REC && sb != sk) {
      flush_sigma();
      sk = sb;
#pragma unroll
      for (int o = 0; o < 8; ++o) sc[o] = __ldg(sigma + sk + corner_cells(o, SY, SZ));
    }
    if (EM && !REC && eb != ek) {
      flush_em();
      ek = eb;
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const float* e = em + (long long)(ek + corner_cells(o, EY, EZ)) * C;
        float p = __ldg(rb) * __ldg(e);
        for (int ch = 1; ch < C; ++ch) p = p + __ldg(rb + ch) * __ldg(e + ch);
        pe[o] = p;
      }
    }
  };

  // replay the reconstructed step, its caches loaded
  auto replay = [&]() {
    // x's weights, computed again for the step's adjoint below rather
    // than held over the segment's (the same values: fewer registers)
    const float fx = cx - floorf(cx), fy = cy - floorf(cy), fz = cz - floorf(cz);
    float g0, g1, g2;
    {
      Weights k;
      weights(fx, fy, fz, k);
      g0 = k.w[0] * chv[0][0]; g1 = k.w[0] * chv[0][1]; g2 = k.w[0] * chv[0][2];
#pragma unroll
      for (int o = 1; o < 8; ++o) {
        g0 = g0 + k.w[o] * chv[o][0];
        g1 = g1 + k.w[o] * chv[o][1];
        g2 = g2 + k.w[o] * chv[o][2];
      }
    }
    const float nvx = ux - g0 * ex;
    const float nvy = uy - g1 * ey;
    const float nvz = uz - g2 * ez;

    // the segment's adjoints: what reaches x' (hx + dbx) and x (hx - dbx)
    float hx = 0.0f, hy = 0.0f, hz = 0.0f, dbx = 0.0f, dby = 0.0f, dbz = 0.0f;
    float tau_b = tau;
    if (SIGMA || EM) {
      Weights m;
      weights(mx - m0, my - m1, mz - m2, m);
      float s = 0.0f, dtau = 0.0f;
      if (SIGMA) {
        s = dot8(sc, m.w);
        dtau = s * ds;
      }
      tau_b = tau - dtau;
      const float t_prev = expf(-tau_b);
      const float wseg = SIGMA ? -expm1f(-dtau) : ds;
      const float tw = t_prev * wseg;
      float q = 0.0f;
      if (EM) q = dot8(pe, m.w);
      const float wb = q * t_prev;
      float dsb = wb, sbar = 0.0f;
      float mbx = 0.0f, mby = 0.0f, mbz = 0.0f;
      if (SIGMA) {
        const float tbar = q * wseg;
        const float dtaub = tb + wb * expf(-dtau);
        tb = tb - t_prev * tbar;
        sbar = dtaub * ds;
        dsb = dtaub * s;
        mbx = sbar * dot8(m.dx, sc);
        mby = sbar * dot8(m.dy, sc);
        mbz = sbar * dot8(m.dz, sc);
      }
      if (EM) {
        mbx = mbx + tw * dot8(m.dx, pe);
        mby = mby + tw * dot8(m.dy, pe);
        mbz = mbz + tw * dot8(m.dz, pe);
      }
      // the midpoint corners' sums, sigma's and the emission's, together
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        float2* const a = reinterpret_cast<float2*>(acc_r + o * (LANES + 1));
        float2 v = *a;
        if (SIGMA) v.x = v.x + m.w[o] * sbar;
        if (EM) v.y = v.y + m.w[o] * tw;
        *a = v;
      }
      if (ds2 > 0.0f) {
        dbx = dsb * dx / ds;
        dby = dsb * dy / ds;
        dbz = dsb * dz / ds;
      }
      hx = 0.5f * mbx; hy = 0.5f * mby; hz = 0.5f * mbz;
    }
    const float axt = ax + hx + dbx;
    const float ayt = ay + hy + dby;
    const float azt = az + hz + dbz;

    // K3's step with xb' = (axt, ayt, azt)
    const float tt = sx * ux * axt + sy * uy * ayt + sz * uz * azt;
    const float il2 = ilen * ilen;
    const float ubx = bx + sx * ilen * axt - 2.0f * ux * il2 * tt;
    const float uby = by + sy * ilen * ayt - 2.0f * uy * il2 * tt;
    const float ubz = bz + sz * ilen * azt - 2.0f * uz * il2 * tt;
    const float h0 = ex * ubx, h1 = ey * uby, h2 = ez * ubz;
    Weights k;
    weights(fx, fy, fz, k);
    float Gx = 0.0f, Gy = 0.0f, Gz = 0.0f;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const float mo = chv[o][0] * h0 + chv[o][1] * h1 + chv[o][2] * h2;
      Gx = Gx + k.dx[o] * mo;
      Gy = Gy + k.dy[o] * mo;
      Gz = Gz + k.dz[o] * mo;
      float4 a = acc_p[o * (LANES + 1)];
      a.x = a.x + k.w[o] * h0;
      a.y = a.y + k.w[o] * h1;
      a.z = a.z + k.w[o] * h2;
      acc_p[o * (LANES + 1)] = a;
    }

    ax = axt + Gx + (hx - dbx);
    ay = ayt + Gy + (hy - dby);
    az = azt + Gz + (hz - dbz);
    bx = ubx; by = uby; bz = ubz;
    px = cx; py = cy; pz = cz;
    ux = nvx; uy = nvy; uz = nvz;
    tau = tau_b;
  };

  // the aligned replay: lane t replays from iteration M - steps of the
  // warp's M
  const int M = __reduce_max_sync(FULL, steps);
  const int j0 = M - steps;
  for (int j = 0; j < M; ++j) {
    const bool active = j >= j0;
    if (active) recon(j == M - 1);
    const bool np = active && pb != pk;
    if (__any_sync(FULL, np)) {
      group_flush(np && pk >= 0, pk, 0, acc_p);
      if (np) load_packed();
    }
    if (REC) {
      const bool nr = active && sb != sk;
      if (__any_sync(FULL, nr)) {
        if (nr && sk >= 0) record_rows();
        group_flush(nr && sk >= 0, sk, 1, acc_r);
        if (nr) load_record();
      }
    } else if (active) {
      reload_own();
    }
    if (active) replay();
  }
  // the caches' last cells
  group_flush(pk >= 0, pk, 0, acc_p);
  if (REC) {
    if (sk >= 0) record_rows();
    group_flush(sk >= 0, sk, 1, acc_r);
  } else {
    flush_sigma();
    flush_em();
  }

  if (valid) {
    dpos0[3 * i] = ax; dpos0[3 * i + 1] = ay; dpos0[3 * i + 2] = az;
    ddir0[3 * i] = bx; ddir0[3 * i + 1] = by; ddir0[3 * i + 2] = bz;
  }
}

#define RENDER_BWD_ARGS                                                                        \
  (const float*)packed, X, Y, Z, (const float*)sigma, SX, SY, SZ, (const float*)em, EX, EY,    \
      EZ, C, GC, (const float4*)rec, (float4*)g_rec, (const int*)order, (const float*)pos0,     \
      (const float*)end_pos, (const float*)end_dir, (const int*)nexec, (const float*)tau_end,   \
      (const float*)d_pos, (const float*)d_dir, (const float*)d_tau, (const float*)d_rad,       \
      (float*)g_packed, (float*)g_sigma, (float*)g_em, (float*)dpos0, (float*)ddir0, n, ex, ey, \
      ez, sx, sy, sz

#define RENDER_BWD_PARAMS                                                                       \
  const void *packed, int X, int Y, int Z, const void *sigma, int SX, int SY, int SZ,           \
      const void *em, int EX, int EY, int EZ, int C, int GC, const void *rec, void *g_rec,      \
      const void *order, const void *pos0, const void *end_pos, const void *end_dir,            \
      const void *nexec, const void *tau_end, const void *d_pos, const void *d_dir,             \
      const void *d_tau, const void *d_rad, void *g_packed, void *g_sigma, void *g_em,          \
      void *dpos0, void *ddir0, int n, float ex, float ey, float ez, float sx, float sy, float sz

template <bool SIGMA, bool EM, bool REC>
int launch(RENDER_BWD_PARAMS, void* stream) {
  if (n > 0) {
    render_bwd_kernel<SIGMA, EM, REC><<<(n + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
        RENDER_BWD_ARGS);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the instantiation for (sigma given, emission given, the
// record given) and returns cudaGetLastError(), or cudaErrorInvalidValue
// before any launch when an emission comes with no channel or its
// gradient's row length GC is not 4 for 3 or 4 channels and C otherwise,
// or when the record comes without sigma and an emission of 1-3 channels
// on its grid.  `order` is a permutation of the n rays (thread t replays
// ray order[t]); `rec` the (SX, SY, SZ, 4) record (sigma, e_0 .. e_{C-1},
// zeros) or null, with its gradient `g_rec` in the same layout (g_sigma
// and g_em are then unused).  The packed gradient, the record and a row
// length of 4 or 2 need 16- and 8-byte aligned buffers.
extern "C" int vrt_render_bwd(RENDER_BWD_PARAMS, void* stream) {
  if (em != nullptr && (C < 1 || GC != (C == 3 || C == 4 ? 4 : C))) return (int)cudaErrorInvalidValue;
  if (rec != nullptr) {
    if (sigma == nullptr || em == nullptr || g_rec == nullptr || C > 3 || EX != SX || EY != SY || EZ != SZ)
      return (int)cudaErrorInvalidValue;
    return launch<true, true, true>(RENDER_BWD_ARGS, stream);
  }
  if (sigma != nullptr) {
    if (em != nullptr) return launch<true, true, false>(RENDER_BWD_ARGS, stream);
    return launch<true, false, false>(RENDER_BWD_ARGS, stream);
  }
  if (em != nullptr) return launch<false, true, false>(RENDER_BWD_ARGS, stream);
  return launch<false, false, false>(RENDER_BWD_ARGS, stream);
}

#ifdef VRT_COUNT_ATOMICS
// The counting build's: the global atomic instructions of R2's launches
// since the last call into *out, and the count zeroed.
extern "C" int vrt_render_bwd_atomics(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, vrt_bwd_atomics, sizeof(*out));
  const unsigned long long zero = 0;
  cudaMemcpyToSymbol(vrt_bwd_atomics, &zero, sizeof(zero));
  return (int)cudaGetLastError();
}
#endif
