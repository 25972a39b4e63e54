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
// One thread per ray starts from R1's end
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
// packed gradient and 0.26 GB of 3-channel emission, in rows of 4, at
// 256^3).  What holds it back in practice is the atomics: a camera's ray
// at speed 0.5 enters another cell at nearly every step (K3's rays stay
// ~30), so the caches flush nearly every step.
// The design is K3's, in F1's form: registers hold the packed cell's
// corners (channels 0-2) and their 24 gradients, sigma's 8 corners and 8
// gradients around the midpoint, and the emission's 8 projected corners
// P_o and 8 sums of W_o * tw; each cache is flushed with float atomics
// (one float4 a corner for the packed gradient, whose opacity lane adds
// 0, and for an emission of 3 or 4 channels, whose gradient the driver
// allocates in rows of 4; float2s for 2 channels) and reloaded when the
// replay enters another cell of its field (a scalar
// field's (2, 2, 2) grid never changes cell, so all of a ray's steps add
// to it with one flush, not 8 atomics a step).  A loop over cells holds
// every load and flush, around a step loop that has neither: the step loop
// leaves when the step it has reconstructed lies in another cell of any
// field, and the outer loop replays that step after the reload without
// reconstructing it again.  Its time beside its bound is in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

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

template <bool SIGMA, bool EM>
__global__ void __launch_bounds__(THREADS)
render_bwd_kernel(const float* __restrict__ packed, int X, int Y, int Z,
                  const float* __restrict__ sigma, int SX, int SY, int SZ,
                  const float* __restrict__ em, int EX, int EY, int EZ, int C, int GC,
                  const float* __restrict__ pos0, const float* __restrict__ end_pos,
                  const float* __restrict__ end_dir, const int* __restrict__ nexec, const float* __restrict__ tau_end,
                  const float* __restrict__ d_pos, const float* __restrict__ d_dir,
                  const float* __restrict__ d_tau, const float* __restrict__ d_rad,
                  float* __restrict__ g_packed, float* __restrict__ g_sigma,
                  float* __restrict__ g_em, float* __restrict__ dpos0,
                  float* __restrict__ ddir0, int n, float ex, float ey, float ez, float sx,
                  float sy, float sz) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float px = end_pos[3 * i], py = end_pos[3 * i + 1], pz = end_pos[3 * i + 2];
  float ux = end_dir[3 * i], uy = end_dir[3 * i + 1], uz = end_dir[3 * i + 2];
  float ax = d_pos[3 * i], ay = d_pos[3 * i + 1], az = d_pos[3 * i + 2];
  float bx = d_dir[3 * i], by = d_dir[3 * i + 1], bz = d_dir[3 * i + 2];
  float tau = SIGMA ? tau_end[i] : 0.0f;
  float tb = SIGMA ? d_tau[i] : 0.0f;
  const float* const rb = EM ? d_rad + (long long)i * C : nullptr;
  const int steps = nexec[i];

  // the caches: the packed cell's channels 0-2 and their gradients;
  // sigma's corners and gradients around the midpoint; the emission's
  // projected corners and sums of W_o * tw; each with its cell (-1: none)
  float chv[8][3], gp[24];
  int pk = -1;
  float sc[8], gs[8];
  int sk = -1;
  float pe[8], ge[8];
  int ek = -1;
  // the reconstructed step: x, 1/|u|^2, the segment and its midpoint's
  // floor, and the cells of x and of the midpoint
  float cx, cy, cz, ilen, dx, dy, dz, ds2, ds, mx, my, mz, m0, m1, m2;
  int pb = 0, sb = 0, eb = 0;

  // reconstruct step `k` (counted from the end): x, or the start for the
  // march's first step
  auto recon = [&](int k) {
    ilen = 1.0f / (ux * ux + uy * uy + uz * uz);
    if (k == steps - 1) {
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
    if (EM) eb = base_cell(m0, m1, m2, EX, EY, EZ);
  };

  // a corner's channels 0-2 and the opacity's 0 in one vector atomic
  auto flush_packed = [&]() {
    if (pk < 0) return;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      atomicAdd(reinterpret_cast<float4*>(g_packed) + (pk + corner_cells(o, Y, Z)),
                make_float4(gp[o * 3], gp[o * 3 + 1], gp[o * 3 + 2], 0.0f));
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) gp[o * 3 + ch] = 0.0f;
    }
  };
  auto flush_sigma = [&]() {
    if (!SIGMA || sk < 0) return;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      atomicAdd(g_sigma + sk + corner_cells(o, SY, SZ), gs[o]);
      gs[o] = 0.0f;
    }
  };
  // a corner's channels in vector atomics where the gradient's rows are
  // 4 or 2 floats (GC: the driver pads 3 channels to 4), one at a time
  // otherwise
  auto flush_em = [&]() {
    if (!EM || ek < 0) return;
    float r[4];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) r[ch] = ch < C && GC <= 4 ? __ldg(rb + ch) : 0.0f;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const long long row = (long long)(ek + corner_cells(o, EY, EZ)) * GC;
      if (GC == 4) {
        atomicAdd(reinterpret_cast<float4*>(g_em + row),
                  make_float4(ge[o] * r[0], ge[o] * r[1], ge[o] * r[2], ge[o] * r[3]));
      } else if (GC == 2) {
        atomicAdd(reinterpret_cast<float2*>(g_em + row), make_float2(ge[o] * r[0], ge[o] * r[1]));
      } else {
        for (int ch = 0; ch < C; ++ch) atomicAdd(g_em + row + ch, ge[o] * __ldg(rb + ch));
      }
      ge[o] = 0.0f;
    }
  };

  // flush the caches whose cell the reconstructed step left, and load
  // the cells it entered
  auto reload = [&]() {
    if (pb != pk) {
      flush_packed();
      pk = pb;
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const float* t = packed + (long long)(pk + corner_cells(o, Y, Z)) * 4;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) chv[o][ch] = __ldg(t + ch);
      }
    }
    if (SIGMA && sb != sk) {
      flush_sigma();
      sk = sb;
#pragma unroll
      for (int o = 0; o < 8; ++o) sc[o] = __ldg(sigma + sk + corner_cells(o, SY, SZ));
    }
    if (EM && eb != ek) {
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
    Weights k;
    weights(cx - floorf(cx), cy - floorf(cy), cz - floorf(cz), k);
    float g0 = k.w[0] * chv[0][0], g1 = k.w[0] * chv[0][1], g2 = k.w[0] * chv[0][2];
#pragma unroll
    for (int o = 1; o < 8; ++o) {
      g0 = g0 + k.w[o] * chv[o][0];
      g1 = g1 + k.w[o] * chv[o][1];
      g2 = g2 + k.w[o] * chv[o][2];
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
      float dsb = wb;
      float mbx = 0.0f, mby = 0.0f, mbz = 0.0f;
      if (SIGMA) {
        const float tbar = q * wseg;
        const float dtaub = tb + wb * expf(-dtau);
        tb = tb - t_prev * tbar;
        const float sbar = dtaub * ds;
        dsb = dtaub * s;
        mbx = sbar * dot8(m.dx, sc);
        mby = sbar * dot8(m.dy, sc);
        mbz = sbar * dot8(m.dz, sc);
#pragma unroll
        for (int o = 0; o < 8; ++o) gs[o] = gs[o] + m.w[o] * sbar;
      }
      if (EM) {
        mbx = mbx + tw * dot8(m.dx, pe);
        mby = mby + tw * dot8(m.dy, pe);
        mbz = mbz + tw * dot8(m.dz, pe);
#pragma unroll
        for (int o = 0; o < 8; ++o) ge[o] = ge[o] + m.w[o] * tw;
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
    float Gx = 0.0f, Gy = 0.0f, Gz = 0.0f;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const float mo = chv[o][0] * h0 + chv[o][1] * h1 + chv[o][2] * h2;
      Gx = Gx + k.dx[o] * mo;
      Gy = Gy + k.dy[o] * mo;
      Gz = Gz + k.dz[o] * mo;
      gp[o * 3 + 0] = gp[o * 3 + 0] + k.w[o] * h0;
      gp[o * 3 + 1] = gp[o * 3 + 1] + k.w[o] * h1;
      gp[o * 3 + 2] = gp[o * 3 + 2] + k.w[o] * h2;
    }

    ax = axt + Gx + (hx - dbx);
    ay = ayt + Gy + (hy - dby);
    az = azt + Gz + (hz - dbz);
    bx = ubx; by = uby; bz = ubz;
    px = cx; py = cy; pz = cz;
    ux = nvx; uy = nvy; uz = nvz;
    tau = tau_b;
  };

#pragma unroll
  for (int j = 0; j < 24; ++j) gp[j] = 0.0f;
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    gs[o] = 0.0f;
    ge[o] = 0.0f;
  }

  // the replay over cells: the outer loop flushes and loads, the inner
  // loop replays with neither; `have`: a reconstructed step waits for
  // its cells' loads
  int done = 0;
  bool have = false;
  while (done < steps) {
    if (!have) recon(done);
    reload();
    have = false;
    replay();
    ++done;
    while (done < steps) {
      recon(done);
      if (pb != pk || (SIGMA && sb != sk) || (EM && eb != ek)) { have = true; break; }
      replay();
      ++done;
    }
  }
  flush_packed();
  flush_sigma();
  flush_em();

  dpos0[3 * i] = ax; dpos0[3 * i + 1] = ay; dpos0[3 * i + 2] = az;
  ddir0[3 * i] = bx; ddir0[3 * i + 1] = by; ddir0[3 * i + 2] = bz;
}

#define RENDER_BWD_ARGS                                                                     \
  (const float*)packed, X, Y, Z, (const float*)sigma, SX, SY, SZ, (const float*)em, EX, EY, \
      EZ, C, GC, (const float*)pos0, (const float*)end_pos, (const float*)end_dir, (const int*)nexec,               \
      (const float*)tau_end, (const float*)d_pos, (const float*)d_dir, (const float*)d_tau,  \
      (const float*)d_rad, (float*)g_packed, (float*)g_sigma, (float*)g_em, (float*)dpos0,   \
      (float*)ddir0, n, ex, ey, ez, sx, sy, sz

template <bool SIGMA, bool EM>
int launch(const void* packed, int X, int Y, int Z, const void* sigma, int SX, int SY, int SZ,
           const void* em, int EX, int EY, int EZ, int C, int GC, const void* pos0,
           const void* end_pos, const void* end_dir, const void* nexec, const void* tau_end, const void* d_pos,
           const void* d_dir, const void* d_tau, const void* d_rad, void* g_packed,
           void* g_sigma, void* g_em, void* dpos0, void* ddir0, int n, float ex, float ey,
           float ez, float sx, float sy, float sz, void* stream) {
  if (n > 0) {
    render_bwd_kernel<SIGMA, EM><<<(n + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
        RENDER_BWD_ARGS);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the instantiation for (sigma given, emission given) and returns
// cudaGetLastError(), or cudaErrorInvalidValue before any launch when an
// emission comes with no channel or its gradient's row length GC is not
// 4 for 3 or 4 channels and C otherwise.  The packed gradient and a row
// length of 4 or 2 need 16- and 8-byte aligned buffers.
extern "C" int vrt_render_bwd(
    const void* packed, int X, int Y, int Z, const void* sigma, int SX, int SY, int SZ,
    const void* em, int EX, int EY, int EZ, int C, int GC, const void* pos0, const void* end_pos,
    const void* end_dir,
    const void* nexec, const void* tau_end, const void* d_pos, const void* d_dir,
    const void* d_tau, const void* d_rad, void* g_packed, void* g_sigma, void* g_em, void* dpos0,
    void* ddir0, int n, float ex, float ey, float ez, float sx, float sy, float sz, void* stream) {
  if (em != nullptr && (C < 1 || GC != (C == 3 || C == 4 ? 4 : C))) return (int)cudaErrorInvalidValue;
  if (sigma != nullptr) {
    if (em != nullptr)
      return launch<true, true>(packed, X, Y, Z, sigma, SX, SY, SZ, em, EX, EY, EZ, C, GC, pos0, end_pos, end_dir, nexec, tau_end, d_pos, d_dir, d_tau, d_rad, g_packed, g_sigma, g_em, dpos0, ddir0, n, ex, ey, ez, sx, sy, sz, stream);
    return launch<true, false>(packed, X, Y, Z, sigma, SX, SY, SZ, em, EX, EY, EZ, C, GC, pos0, end_pos, end_dir, nexec, tau_end, d_pos, d_dir, d_tau, d_rad, g_packed, g_sigma, g_em, dpos0, ddir0, n, ex, ey, ez, sx, sy, sz, stream);
  }
  if (em != nullptr)
    return launch<false, true>(packed, X, Y, Z, sigma, SX, SY, SZ, em, EX, EY, EZ, C, GC, pos0, end_pos, end_dir, nexec, tau_end, d_pos, d_dir, d_tau, d_rad, g_packed, g_sigma, g_em, dpos0, ddir0, n, ex, ey, ez, sx, sy, sz, stream);
  return launch<false, false>(packed, X, Y, Z, sigma, SX, SY, SZ, em, EX, EY, EZ, C, GC, pos0, end_pos, end_dir, nexec, tau_end, d_pos, d_dir, d_tau, d_rad, g_packed, g_sigma, g_em, dpos0, ddir0, n, ex, ey, ez, sx, sy, sz, stream);
}
