// N1 and N2: the |v| = n start sample of a float trace and its adjoint, for
// Hopper (sm_90a).
//
// They replace no Pallas kernel: the JAX package takes the sample in jnp
// (volumeraytracer_tpu/parallel/shard.py:endpoint_render, models/camera.py,
// models/scene.py: p = pos - 0.5; dirs' = dirs * n(p); p' = p - 0.5, n
// interpolated by ops/interp.py:interp_linear), which XLA fuses, and
// differentiates it through that fusion.  Eager torch ran the port's plain
// version (ops/interp.py:interp_linear over gather_corners) as ~56 small
// launches, three host-to-card copies of index lists (each a wait for the
// stream) and, for the gradient, an accumulating index_put_ that sorts the
// 8 corner indices of every ray and sums each run of equal indices
// serially: 124 ms for a 1024^2 camera whose rays all start on one voxel.
//
// N1 (start_sample_fwd_kernel), one thread a ray: p = pos - 0.5, its floor
// f, the base corner clamp(f, 0, s - 2) per axis (the field's shape and
// strides are arguments), the weights from the unclamped fraction p - f,
// each the product taken from axis 0 up, and the corner sum in
// itertools.product order (ops/interp.py:_weights_product, _corner_sum);
// it writes p' = p - 0.5 and dirs' = dirs * n.  The build compiles with
// -fmad=false, so the result equals the plain version bit for bit.
//
// N2 (start_sample_bwd_kernel), one thread a ray, with the ray's
// cotangents gp (of p') and gd (of dirs'): s = gd . dirs (in x, y, z
// order); corner o's voxel receives w_o * s; d dirs = gd * n and d pos =
// gp + s * dn/dp, each only where the wrapper passes its output.  A warp
// whose 32 rays share one base voxel (__match_any_sync) sums each corner's
// contributions by shuffles and sends one float atomic a corner; in any
// other warp each ray sends its own 8.  The same kernel so serves a camera
// (every ray on one voxel: 8 atomics a warp; 8 a ray, all on 8 addresses,
// took 2.3-3.2 ms on the H100 at 1024^2 rays against 0.09-0.10),
// coherent rays (~4 neighbours a voxel: grouping those too saved ~0.01 ms
// of 0.077 there) and scattered ones (8 atomics a ray).  The sums are
// float32, in an order that changes from run to run.
// A build with VRT_COUNT_ATOMICS counts the atomics (vrt_start_sample_
// atomics reads and zeroes the count).
//
// What bounds them on the H100: bytes.  N1 reads 24 bytes of ray and 8
// corners a ray and writes 24; N2 reads the ray, its cotangent and the
// corners and adds into a d ior that the wrapper zeroes.  At 1024^2 rays
// through 256^3: N1 ~50 MB, N2 ~100 MB with the 64 MB d ior (~15 and ~30
// us).  Addresses are 64-bit, so any field the card holds is taken.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifdef VRT_BLOCK_THREADS
constexpr int THREADS = VRT_BLOCK_THREADS;
#else
constexpr int THREADS = 256;
#endif
constexpr int LANES = THREADS < 32 ? THREADS : 32;
constexpr unsigned FULL = LANES == 32 ? 0xffffffffu : (1u << LANES) - 1u;

#ifdef VRT_COUNT_ATOMICS
__device__ unsigned long long vrt_start_sample_atomic_count;
#define COUNT_ATOMICS(k) atomicAdd(&vrt_start_sample_atomic_count, (unsigned long long)(k))
#else
#define COUNT_ATOMICS(k) ((void)0)
#endif

// The field's shape and strides (in floats).
struct Field {
  int s[3];
  long long st[3];
};

// A ray's sample point: p = pos - 0.5, the fraction p - floor(p) a axis,
// and the base corner's offset, clamped to [0, s - 2] a axis.
struct Sample {
  float p[3], fr[3];
  long long base;
};

__device__ __forceinline__ Sample locate(const float* pos, long long i, const Field& f) {
  Sample c;
  c.base = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float p = pos[3 * i + a] - 0.5f;
    const float fl = floorf(p);
    long long b = (long long)fl;  // torch's float to int64 cast
    b = b < 0 ? 0 : b;
    b = b < f.s[a] - 2 ? b : f.s[a] - 2;
    c.p[a] = p;
    c.fr[a] = p - fl;
    c.base += b * f.st[a];
  }
  return c;
}

// Corner o's offset from the base: bits (axis 0, 1, 2) = (o >> 2, o >> 1, o) & 1.
__device__ __forceinline__ long long corner(int o, const Field& f) {
  return ((o >> 2) & 1) * f.st[0] + ((o >> 1) & 1) * f.st[1] + (o & 1) * f.st[2];
}

// The per-axis factors 1 - fr (bit 0) and fr (bit 1), and the 8 weights,
// each the product from axis 0 up.
__device__ __forceinline__ void weights(const float* fr, float (*wa)[2], float* w) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    wa[a][0] = 1.0f - fr[a];
    wa[a][1] = fr[a];
  }
#pragma unroll
  for (int o = 0; o < 8; ++o) w[o] = wa[0][(o >> 2) & 1] * wa[1][(o >> 1) & 1] * wa[2][o & 1];
}

__global__ void __launch_bounds__(THREADS)
    start_sample_fwd_kernel(const float* __restrict__ ior, Field f, const float* __restrict__ pos,
                            const float* __restrict__ dir, float* __restrict__ pos_out,
                            float* __restrict__ dir_out, long long n) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const Sample c = locate(pos, i, f);
  float wa[3][2], w[8];
  weights(c.fr, wa, w);
  float v = __ldg(ior + c.base) * w[0];
#pragma unroll
  for (int o = 1; o < 8; ++o) v = v + __ldg(ior + c.base + corner(o, f)) * w[o];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    pos_out[3 * i + a] = c.p[a] - 0.5f;
    dir_out[3 * i + a] = dir[3 * i + a] * v;
  }
}

// gp (or null), gd: the cotangents of p' and dirs'; g_ior: the field's
// gradient, added into; dpos, ddir (or null): the rays' gradients, written.
__global__ void __launch_bounds__(THREADS)
    start_sample_bwd_kernel(const float* __restrict__ ior, Field f, const float* __restrict__ pos,
                            const float* __restrict__ dir, const float* __restrict__ gp,
                            const float* __restrict__ gd, float* __restrict__ g_ior, float* __restrict__ dpos,
                            float* __restrict__ ddir, long long n) {
  const int lane = threadIdx.x % LANES;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool valid = i < n;

  Sample c{};
  float wa[3][2] = {}, w[8] = {}, g[3] = {0.0f, 0.0f, 0.0f}, s = 0.0f;
  if (valid) {
    c = locate(pos, i, f);
    weights(c.fr, wa, w);
#pragma unroll
    for (int a = 0; a < 3; ++a) g[a] = gd[3 * i + a];
    s = g[0] * dir[3 * i] + g[1] * dir[3 * i + 1] + g[2] * dir[3 * i + 2];
  }

  // d ior: one atomic a corner for a warp of rays on one base voxel (the
  // mask is FULL in every lane or in none), else 8 a ray
  if (__match_any_sync(FULL, valid ? c.base : -1) == FULL && valid) {
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      float v = w[o] * s;
      for (int off = LANES / 2; off > 0; off >>= 1) v = v + __shfl_xor_sync(FULL, v, off);
      if (lane == 0) atomicAdd(g_ior + c.base + corner(o, f), v);
    }
    if (lane == 0) COUNT_ATOMICS(8);
  } else if (valid) {
#pragma unroll
    for (int o = 0; o < 8; ++o) atomicAdd(g_ior + c.base + corner(o, f), w[o] * s);
    COUNT_ATOMICS(8);
  }

  if (!valid || (dpos == nullptr && ddir == nullptr)) return;
  float cv[8];
#pragma unroll
  for (int o = 0; o < 8; ++o) cv[o] = __ldg(ior + c.base + corner(o, f));
  if (ddir != nullptr) {
    float v = cv[0] * w[0];
#pragma unroll
    for (int o = 1; o < 8; ++o) v = v + cv[o] * w[o];
#pragma unroll
    for (int a = 0; a < 3; ++a) ddir[3 * i + a] = g[a] * v;
  }
  if (dpos != nullptr) {
    // dn/dfr_a = sum_o c_o * (+1 or -1 by bit a) * the other two factors
    float dfr[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const int b0 = (o >> 2) & 1, b1 = (o >> 1) & 1, b2 = o & 1;
      const float sg0 = b0 ? cv[o] : -cv[o], sg1 = b1 ? cv[o] : -cv[o], sg2 = b2 ? cv[o] : -cv[o];
      dfr[0] = dfr[0] + sg0 * (wa[1][b1] * wa[2][b2]);
      dfr[1] = dfr[1] + sg1 * (wa[0][b0] * wa[2][b2]);
      dfr[2] = dfr[2] + sg2 * (wa[0][b0] * wa[1][b1]);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) dpos[3 * i + a] = (gp != nullptr ? gp[3 * i + a] : 0.0f) + s * dfr[a];
  }
}

#define START_FIELD_PARAMS const void *ior, int X, int Y, int Z, long long sx, long long sy, long long sz

Field field(int X, int Y, int Z, long long sx, long long sy, long long sz) {
  Field f;
  f.s[0] = X; f.s[1] = Y; f.s[2] = Z;
  f.st[0] = sx; f.st[1] = sy; f.st[2] = sz;
  return f;
}

int blocks(long long n) { return (int)((n + THREADS - 1) / THREADS); }

}  // namespace

// N1: p' and dirs' of n rays (pos, dir: (n, 3) float32) through the
// (X, Y, Z) float32 field `ior` of strides (sx, sy, sz) floats, each axis
// of 2 voxels or more.  Returns cudaGetLastError(), or cudaErrorInvalidValue
// before any launch for an axis under 2 voxels or more than 2^31 - 1
// blocks.
extern "C" int vrt_start_sample_fwd(START_FIELD_PARAMS, const void* pos, const void* dir, void* pos_out,
                                    void* dir_out, long long n, void* stream) {
  if (X < 2 || Y < 2 || Z < 2 || (n + THREADS - 1) / THREADS > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    start_sample_fwd_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)ior, field(X, Y, Z, sx, sy, sz), (const float*)pos, (const float*)dir, (float*)pos_out,
        (float*)dir_out, n);
  }
  return (int)cudaGetLastError();
}

// N2: adds the field's gradient into g_ior (the field's shape, row-major)
// and writes d pos and d dir where they are not null, under the
// cotangents gp (or null: zero) and gd of N1's outputs.  Returns as N1.
extern "C" int vrt_start_sample_bwd(START_FIELD_PARAMS, const void* pos, const void* dir, const void* gp,
                                    const void* gd, void* g_ior, void* dpos, void* ddir, long long n, void* stream) {
  if (X < 2 || Y < 2 || Z < 2 || (n + THREADS - 1) / THREADS > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    start_sample_bwd_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)ior, field(X, Y, Z, sx, sy, sz), (const float*)pos, (const float*)dir, (const float*)gp,
        (const float*)gd, (float*)g_ior, (float*)dpos, (float*)ddir, n);
  }
  return (int)cudaGetLastError();
}

#ifdef VRT_COUNT_ATOMICS
// The counting build's: the float atomics N2's launches issued into the
// field's gradient since the last call, into *out, and the count zeroed.
extern "C" int vrt_start_sample_atomics(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, vrt_start_sample_atomic_count, sizeof(*out));
  const unsigned long long zero = 0;
  cudaMemcpyToSymbol(vrt_start_sample_atomic_count, &zero, sizeof(zero));
  return (int)cudaGetLastError();
}
#endif
