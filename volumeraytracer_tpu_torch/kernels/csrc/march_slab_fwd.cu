// S1: the brick path's window march over one brick's slab, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs a window of the
// brick-sharded march as an XLA loop, volumeraytracer_tpu/parallel/
// bricks.py:_window_fn (:212), a fori_loop of k_steps _slab_step (:147)
// inside the traces' while_loop (:272, :555) and the train step's lax.scan
// of jax.checkpoint windows (:311-314).  Eager torch would launch the ~40
// ops of every step (the port's plain version, kernels/march_slab.py
// :slab_window_plain).  One thread a ray, over the float4 slab as it is
// (march_slab.cuh), in F1's and R1's form.  Each thread runs the window's
// k_steps steps of _slab_step on its ray:
//
//   owned = floor(x) in [my*xs, (my+1)*xs), -inf / +inf at the edge bricks
//   inb   = 0 <= x and floor(x) < bounds - 1 on every axis (global bounds)
//   cond  = alive and owned and remaining > 0 and inb
//   l     = x - (my*xs - 1, 0, 0);  g = interp_linear(slab, l)  (base
//           floor(l) clamped to [0, s - 2], weights unclamped)
//   ok    = cond and not g[3] > 0
//   where ok: remaining -= 1, v = v + g[0:3]*bend, x = x + (v*step)*(1/|v|^2)
//   where owned: alive = ok
//
// and writes the end position, direction, remaining budget (int64) and
// alive (bool), the dtypes of parallel/bricks.py:BrickState.  Only the
// owner may kill a ray, and a ray stops being movable for good within the
// window in two ways, where the thread leaves the loop with the state the
// remaining steps would leave unchanged: an owned ray that fails cond or
// is opaque is dead (alive false, and it stays owned since it does not
// move); a ray that is not owned (at the start, or once it crossed into
// another brick) is frozen, alive as it was.  Every operation follows the
// plain step in its order (-fmad=false, IEEE division), so the end state
// equals slab_window_plain's bit for bit on the card.
//
// What bounds it on the H100: bytes, the distinct corner voxels a window
// reads (16 B each, chip_smoke.py's _p20_cells) and the ray state, 33
// bytes in and out a ray; its SLAB_OPS float32 operations a step are the
// lesser bound at phase 20's size.  Scattered rays read the slab at random, so a
// corner costs about one DRAM access, and a ray changes cell every ~2
// steps, mostly across a face.  So each thread keeps its cell's 8 corners
// in registers (march_slab.cuh:fetch_corners): the same cell loads none,
// a face neighbour the 4 it does not share, an edge, corner or longer
// move all 8.  The loop's length is the data's: rays that other bricks
// own leave at once.

#include "march_slab.cuh"

namespace {

#ifdef VRT_BLOCK_THREADS
constexpr int THREADS = VRT_BLOCK_THREADS;
#else
constexpr int THREADS = 128;
#endif

__global__ void __launch_bounds__(THREADS)
march_slab_fwd_kernel(const float4* __restrict__ s, int s0, int s1, int s2, const float* __restrict__ consts,
                      const float* __restrict__ pos_in, const float* __restrict__ dir_in,
                      const long long* __restrict__ rem_in, const bool* __restrict__ alive_in,
                      float* __restrict__ pos_out, float* __restrict__ dir_out, long long* __restrict__ rem_out,
                      bool* __restrict__ alive_out, int n, int my, int num, int xs, int k_steps) {
  // 64-bit, so that the rows 3 * i of the (n, 3) state never overflow for
  // any n < 2^31
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float px = pos_in[3 * i], py = pos_in[3 * i + 1], pz = pos_in[3 * i + 2];
  float vx = dir_in[3 * i], vy = dir_in[3 * i + 1], vz = dir_in[3 * i + 2];
  long long rem = rem_in[i];
  bool alive = alive_in[i];
  const slab::Consts k = slab::load_consts(consts);
  const float lo = my == 0 ? -INFINITY : (float)(my * xs);
  const float hi = my == num - 1 ? INFINITY : (float)((my + 1) * xs);
  // the corners of the cell the ray is in, and that cell on each axis
  float4 c[8];
  int h0 = slab::NONE, h1 = 0, h2 = 0;

  for (int step = 0; step < k_steps; ++step) {
    const float fx = floorf(px);
    if (!(fx >= lo && fx < hi)) break;  // another brick's ray: frozen
    const bool inb = px >= 0.0f && py >= 0.0f && pz >= 0.0f && fx < k.bx && floorf(py) < k.by && floorf(pz) < k.bz;
    if (!(alive && rem > 0 && inb)) {
      alive = false;
      break;
    }
    const float lx = px - k.ox, ly = py - k.oy, lz = pz - k.oz;
    const float f0 = floorf(lx), f1 = floorf(ly), f2 = floorf(lz);
    int i0, i1, i2;
    slab::base_cell(f0, f1, f2, s0, s1, s2, i0, i1, i2);
    slab::fetch_corners(s, s1, s2, i0, i1, i2, h0, h1, h2, c);
    float w[8];
    const float4 g = slab::sample(c, lx, ly, lz, f0, f1, f2, w);
    if (g.w > 0.0f) {  // opaque
      alive = false;
      break;
    }
    rem -= 1;
    slab::move(k, g, px, py, pz, vx, vy, vz);
  }

  pos_out[3 * i] = px; pos_out[3 * i + 1] = py; pos_out[3 * i + 2] = pz;
  dir_out[3 * i] = vx; dir_out[3 * i + 1] = vy; dir_out[3 * i + 2] = vz;
  rem_out[i] = rem;
  alive_out[i] = alive;
}

}  // namespace

// Launches S1 over n rays on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue before any launch for a slab of fewer than 2 cells
// on an axis or a brick outside [0, num).  `consts` is the (4, 3) float32
// array of march_slab.cuh; the state in and out is (n, 3) float32
// positions and directions, (n,) int64 remaining budgets and (n,) bool.
extern "C" int vrt_march_slab_fwd(const void* slab, int s0, int s1, int s2, const void* consts, const void* pos_in,
                                  const void* dir_in, const void* rem_in, const void* alive_in, void* pos_out,
                                  void* dir_out, void* rem_out, void* alive_out, int n, int my, int num, int xs,
                                  int k_steps, void* stream) {
  if (s0 < 2 || s1 < 2 || s2 < 2 || my < 0 || my >= num) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + (long long)THREADS - 1) / THREADS);
    march_slab_fwd_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float4*)slab, s0, s1, s2, (const float*)consts, (const float*)pos_in, (const float*)dir_in,
        (const long long*)rem_in, (const bool*)alive_in, (float*)pos_out, (float*)dir_out, (long long*)rem_out,
        (bool*)alive_out, n, my, num, xs, k_steps);
  }
  return (int)cudaGetLastError();
}
