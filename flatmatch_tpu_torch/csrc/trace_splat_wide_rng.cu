// Photon megakernel of the default render: counter-hash draws, emission,
// max_depth axis-aligned bounces, and the dithered 7-bit deposit splat into
// an exact int32 texel accumulator, in one launch per photon batch.
//
// Replaces the TPU kernel flatmatch_tpu/engines/photon_pallas_wide.py
// trace_splat_wide_rng(i8=True) (:1002, body _make_kernel :105-733). It
// computes what that kernel computes; the layout is new:
//   - one thread per photon; the in-batch photon index p takes the place of
//     the TPU kernel's rgid/gid. Draws and dither keys depend only on p, the
//     batch seed and the draw column, so the block shape changes no result;
//   - each block stages the [13, N] scene table in shared memory (dynamic
//     above 48 KB) as per-rect records (stage_scene, trace_wide.cuh); a
//     rect test reads two warp-uniform 16-byte broadcasts. A table past a
//     block's shared memory is read from device memory instead
//     (launch_table, trace_wide.cuh);
//   - deposits go by atomicAdd into an int32 [T, 3] accumulator in device
//     memory instead of the TPU's int8 one-hot MXU binning. Integer sums do
//     not depend on order, so two runs are bit-identical.
// The trace itself is trace_wide.cuh (kDiff = false), shared with the
// differentiable forward and the replay backward.
//
// What bounds it on an H100: the instruction rate of the rect loop (about
// 22 instructions, two of them 16-byte shared-memory broadcasts, per
// photon, rect and traced bounce, over all N rects every bounce), then the
// per-bounce sampling and the atomics (up to 3 * max_depth deposits per
// photon; zero deposits are skipped). PERF.md has its times per batch at
// 27 rects (mini), where emission, bounces and atomics weigh as much as
// the loop, and at 432 (the 4x4 tiling), where the loop takes nearly all.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (see
// flatmatch_tpu_torch/utils/cuda_build.py).
#include "trace_wide.cuh"

namespace {

// kSmem: the scene table in shared memory, else read from device memory
// (launch_table, trace_wide.cuh)
template <bool kSmem>
__global__ void __launch_bounds__(kThreads, kSmem ? kSmemMinBlocks : 1)
trace_splat_kernel(const float* __restrict__ scene,
                   const float* __restrict__ em, const Params P,
                   int* __restrict__ acc) {
  extern __shared__ __align__(16) float smem[];  // the staged scene
  const Rects<kSmem> rects = stage_scene<kSmem>(smem, scene, em, P);

  const int pi = blockIdx.x * blockDim.x + threadIdx.x;
  // photons at or past n_valid are dead from the start and deposit exactly
  // 0 (floor(0 * inv_s + dither) == 0), so they are not traced
  if (pi >= P.n_valid) return;
  const uint32_t p = static_cast<uint32_t>(pi);
  trace_photon<false>(rects, nullptr, P, HashDraw{p, P.seed},
                      [&](int d, int btex, float cr, float cg, float cb,
                          int) {
                        splat_i8(acc, P, P.inv_s, p, d, btex, cr, cg, cb);
                      });
}

}  // namespace

// C entry point, loaded with ctypes. Launches one batch on `stream` and
// returns the CUDA error code of the launch (0 on success). `acc` must be
// zeroed by the caller.
extern "C" int fm_trace_splat_wide_rng_i8(
    const float* scene, const float* em, int* acc, int n_rects, int g0,
    int g1, int g2, int seed, int n_valid, int max_depth, int num_texels,
    float eps, float two_pi, float rr, float mirror_z, float tint_z,
    float tint_r, float tint_g, float tint_b, float albedo, float inv_s,
    void* stream) {
  if (n_valid <= 0) return 0;
  const Params P = make_params(n_rects, g0, g1, g2, seed, n_valid,
                               max_depth, num_texels, eps, two_pi, rr,
                               mirror_z, tint_z, tint_r, tint_g, tint_b,
                               albedo, inv_s);
  return launch_table(trace_splat_kernel<true>, trace_splat_kernel<false>,
                      sizeof(float) * table_floats(n_rects), 0, 0,
                      blocks_for(n_valid), kThreads,
                      static_cast<cudaStream_t>(stream), scene, em, P, acc);
}
