// C1: a pinhole camera's rays, made on the card, for Hopper (sm_90a).
//
// It replaces no Pallas kernel: the JAX package builds a camera's rays in
// float64 numpy on the host (volumeraytracer_tpu/models/camera.py:
// PinholeCamera.rays) and the port's CPU route still does
// (models/camera.py).  On the card that build took ~150 ms at 1024^2
// pixels (a meshgrid, six (H, W, 3) float64 temporaries, a norm and a
// division), then two pageable copies of 12.6 MB, each a wait for the
// stream.
//
// camera_rays_kernel, one thread a pixel i = v * W + u, writes the
// origin (float32, as numpy's cast rounds it) and the direction
// normalize(fwd + (fov * uu) * right + (fov * aspect * vv) * up) * speed,
// rounded to float32 once at the end.  The host passes the camera's basis
// as numpy computes it (fwd normalised, right = normalize(fwd x up),
// up' = right x fwd) and fov * aspect as one double, the product numpy
// takes first.  The per-pixel arithmetic repeats numpy's in double
// precision, in its order, one rounding an operation (the build compiles
// with -fmad=false; double division and sqrt are IEEE on the card):
//   uu = ((u + 0.5) / W) * 2 - 1, vv the same with v and H;
//   d_c = (fwd_c + (fov * uu) * right_c) + (fov_aspect * vv) * up_c;
//   |d| = sqrt((d_0 d_0 + d_1 d_1) + d_2 d_2), numpy's add.reduce order;
//   d_c = (d_c / |d|) * speed.
// So the result equals the CPU route bit for bit.
//
// What bounds it on the H100: bytes.  It reads nothing and writes 24 bytes
// a pixel: 25.2 MB at 1024^2, ~7.5 us at 3.35 TB/s.  Its ~40 double
// operations a pixel (3 divisions, a square root) take under that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifdef VRT_BLOCK_THREADS
constexpr int THREADS = VRT_BLOCK_THREADS;
#else
constexpr int THREADS = 256;
#endif

// The camera's constants, as the host computed them.
struct Camera {
  double fwd[3], right[3], up[3];
  double fov, fov_aspect, speed;
  float origin[3];
  int width, height;
};

__global__ void __launch_bounds__(THREADS)
    camera_rays_kernel(Camera c, float* __restrict__ pos, float* __restrict__ dir, long long n) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const long long v = i / c.width;
  const long long u = i - v * c.width;
  const double uu = ((double)u + 0.5) / (double)c.width * 2.0 - 1.0;
  const double vv = ((double)v + 0.5) / (double)c.height * 2.0 - 1.0;
  const double su = c.fov * uu, sv = c.fov_aspect * vv;
  double d[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) d[a] = (c.fwd[a] + su * c.right[a]) + sv * c.up[a];
  const double norm = sqrt((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    pos[3 * i + a] = c.origin[a];
    dir[3 * i + a] = (float)(d[a] / norm * c.speed);
  }
}

}  // namespace

// C1: writes the width x height camera's (n, 3) float32 positions and
// directions, pixels row-major (v, u), on `stream`.  Returns
// cudaErrorInvalidValue for a width or height under 1 or a grid the card
// cannot launch, else cudaGetLastError().
extern "C" int vrt_camera_rays(double fx, double fy, double fz, double rx, double ry, double rz, double ux, double uy,
                               double uz, double fov, double fov_aspect, double speed, float ox, float oy, float oz,
                               int width, int height, void* pos, void* dir, void* stream) {
  const long long n = (long long)width * height;
  if (width < 1 || height < 1 || (n + THREADS - 1) / THREADS > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Camera c{{fx, fy, fz}, {rx, ry, rz}, {ux, uy, uz}, fov, fov_aspect, speed, {ox, oy, oz}, width, height};
  camera_rays_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, (cudaStream_t)stream>>>(
      c, (float*)pos, (float*)dir, n);
  return (int)cudaGetLastError();
}
