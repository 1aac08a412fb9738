// Forward kernel of the differentiable render: the production photon trace
// with a per-slot albedo, splatting its deposits inside the kernel, one
// launch per batch. Two tiers and two draw sources, one kernel template:
//   - kF32 = false: dithered 7-bit deposits on a grid set at run time into
//     an exact int32 texel accumulator (`fit` at `--splat inkernel_i8` or
//     `fused_i8`). With the counter hash (HashDraw) it replaces the TPU
//     kernel flatmatch_tpu/engines/photon_pallas_wide.py
//     trace_splat_wide_diff_rng(i8=True) (:1252, pallas_call :1306; body
//     _make_kernel :105-733 with diff=True, rng=True, fuse_h, i8); with
//     threefry uniforms passed in (UniformDraw, `fit --no-device-rng`) it
//     replaces trace_splat_wide_diff(i8=True) (:1168, pallas_call :1232);
//   - kF32 = true: bf16 colors summed in f32 (`fit --splat inkernel` or
//     `fused`), trace_splat_wide_diff_rng(i8=False) and
//     trace_splat_wide_diff(i8=False): splat_f32 (trace_wide.cuh) in int64
//     fixed point at a run-time 2^k, then one conversion to the f32 [T, 3]
//     increment.
// The uniforms-in instances read the batch's [U, B] transposed uniforms, as
// trace_splat_wide.cu does; their dither keys are the counter-hash
// instances' (photon p * 3D + 3d + ch).
// What differs from trace_splat_wide_rng.cu and trace_splat_wide.cu, and
// how:
//   - the albedo of a diffuse hit is albedo_aa[j] of the winning rect slot
//     j (:290-292, :373-379, :494). Each block stages that [N] row in
//     shared memory beside the staged scene (both stay in device
//     memory when they do not fit: launch_table, trace_wide.cuh), and the
//     shared trace (trace_wide.cuh, kDiff = true) tracks j;
//   - the grid is a run-time scalar that covers the deposit bound at the
//     current power and albedo: the inverse grid step inv_s of the 7-bit
//     tier (:518-523, the caller's scale_pair), or the f32 tier's
//     (to_fixed, from_fixed) = (2^k, 2^-k) from the stream bound times the
//     same correction (ops/splat.fixed_point_scale). The kernel reads it
//     from a small device tensor, so a training step needs no host round
//     trip to launch it.
// At power <= 1 and albedo <= 1 the grid is the production one and every
// per-slot albedo equals the scalar one, so the 7-bit accumulator equals
// the production kernel's bit for bit (trace_splat_wide_rng.cu, or
// trace_splat_wide.cu's fm_trace_splat_wide_i8 for the same uniforms), and
// the f32 increment equals trace_splat_wide.cu's
// fm_trace_splat_wide_rng_f32 (or fm_trace_splat_wide_f32) bit for bit.
//
// What bounds it on an H100: the same as the production kernels, the
// instruction rate of the rect loop (about 22 instructions per photon,
// rect and traced bounce; the winning column is kept in any case), and the
// albedo row one shared load per diffuse bounce. The
// f32 tier adds up to 3D int64 atomics per photon, and the zeroing and
// conversion of the [T, 3] int64 accumulator; the uniforms-in instances
// read 4 * (4 + 3D) bytes per photon (14.7 MB per 131072-photon batch).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (see
// flatmatch_tpu_torch/utils/cuda_build.py).
#include <type_traits>

#include "trace_wide.cuh"

namespace {

// grid: inv_s (kF32 = false) or {to_fixed, from_fixed}; acc: int* or the
// unsigned view of the int64 accumulator; u_t and batch are read only by
// the UniformDraw instances; kSmem: the table and albedo row in shared
// memory, else read from device memory
template <class Draw, bool kF32, bool kSmem>
__global__ void __launch_bounds__(kThreads, kSmem ? kSmemMinBlocks : 1)
trace_splat_diff_kernel(const float* __restrict__ scene,
                        const float* __restrict__ albedo,
                        const float* __restrict__ em,
                        const float* __restrict__ u_t, int batch,
                        const float* __restrict__ grid, const Params P,
                        void* acc) {
  extern __shared__ __align__(16) float smem[];
  const float* alb = albedo;
  if constexpr (kSmem) {
    alb = smem + table_floats(P.n_rects);                  // [N]
    stage(smem + table_floats(P.n_rects), albedo, P.n_rects);
  }
  // the staged scene; its barrier also covers the albedo row
  const Rects<kSmem> rects = stage_scene<kSmem>(smem, scene, em, P);

  const int pi = blockIdx.x * blockDim.x + threadIdx.x;
  // dead photons deposit exactly 0 and are not traced
  if (pi >= P.n_valid) return;
  const uint32_t p = static_cast<uint32_t>(pi);
  const Draw draws = [&] {
    if constexpr (std::is_same_v<Draw, HashDraw>) {
      return HashDraw{p, P.seed};
    } else {
      return UniformDraw{u_t, batch, pi};
    }
  }();
  const float g = *grid;
  trace_photon<true>(
      rects, alb, P, draws,
      [&](int d, int btex, float cr, float cg, float cb, int) {
        if constexpr (kF32) {
          splat_f32(static_cast<unsigned long long*>(acc), P, g, btex, cr,
                    cg, cb);
        } else {
          splat_i8(static_cast<int*>(acc), P, g, p, d, btex, cr, cg, cb);
        }
      });
}

template <class Draw, bool kF32>
int launch_diff(const float* scene, const float* albedo, const float* em,
                const float* u_t, int batch, const float* grid, void* acc,
                const Params& P, cudaStream_t s) {
  if (P.n_valid <= 0) return 0;
  return launch_table(
      trace_splat_diff_kernel<Draw, kF32, true>,
      trace_splat_diff_kernel<Draw, kF32, false>,
      sizeof(float) * (table_floats(P.n_rects) + P.n_rects), 0, 0,
      blocks_for(P.n_valid), kThreads, s, scene, albedo, em, u_t, batch, grid,
      P, acc);
}

// The f32 tier: zero the int64 scratch, trace and splat, convert to `out`
// at the 2^-k that `fixed + 1` points to.
template <class Draw>
int run_f32(const float* scene, const float* albedo, const float* em,
            const float* u_t, int batch, const float* fixed, long long* acc,
            float* out, const Params& P, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = 3 * P.num_texels;
  if (n <= 0) return 0;
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(long long) * n, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = launch_diff<Draw, true>(scene, albedo, em, u_t, batch,
                                         fixed, acc, P, s);
  if (rc != 0) return rc;
  return launch_fixed_to_f32(acc, n, fixed + 1, 0.0f, out, s);
}

}  // namespace

// C entry points, loaded with ctypes. Each launches one batch on `stream`
// and returns the CUDA error code (0 on success).
//
// 7-bit tier: `acc` (int32 [num_texels, 3]) must be zeroed by the caller;
// `inv_s` points to one float on the device.
extern "C" int fm_trace_splat_wide_diff_rng_i8(
    const float* scene, const float* albedo, const float* em,
    const float* inv_s, int* acc, int n_rects, int g0, int g1, int g2,
    int seed, int n_valid, int max_depth, int num_texels, float eps,
    float two_pi, float rr, float mirror_z, float tint_z, float tint_r,
    float tint_g, float tint_b, float albedo_const, void* stream) {
  const Params P = make_params(n_rects, g0, g1, g2, seed, n_valid,
                               max_depth, num_texels, eps, two_pi, rr,
                               mirror_z, tint_z, tint_r, tint_g, tint_b,
                               albedo_const, 0.0f);
  return launch_diff<HashDraw, false>(scene, albedo, em, nullptr, 0, inv_s,
                                      acc, P,
                                      static_cast<cudaStream_t>(stream));
}

// f32 tier: `fixed` points to {2^k, 2^-k} on the device; `acc` (int64
// [num_texels, 3] scratch) is zeroed here; `out` gets the f32
// [num_texels, 3] increment.
extern "C" int fm_trace_splat_wide_diff_rng_f32(
    const float* scene, const float* albedo, const float* em,
    const float* fixed, long long* acc, float* out, int n_rects, int g0,
    int g1, int g2, int seed, int n_valid, int max_depth, int num_texels,
    float eps, float two_pi, float rr, float mirror_z, float tint_z,
    float tint_r, float tint_g, float tint_b, float albedo_const,
    void* stream) {
  const Params P = make_params(n_rects, g0, g1, g2, seed, n_valid,
                               max_depth, num_texels, eps, two_pi, rr,
                               mirror_z, tint_z, tint_r, tint_g, tint_b,
                               albedo_const, 0.0f);
  return run_f32<HashDraw>(scene, albedo, em, nullptr, 0, fixed, acc, out,
                           P, stream);
}

// The uniforms-in tiers (`fit --no-device-rng`): as above, the draws read
// from `u_t`, the [4 + 3 * max_depth, batch] f32 transpose of the batch's
// uniforms; the seed is unused.
extern "C" int fm_trace_splat_wide_diff_i8(
    const float* scene, const float* albedo, const float* em,
    const float* u_t, const float* inv_s, int* acc, int batch, int n_rects,
    int g0, int g1, int g2, int seed, int n_valid, int max_depth,
    int num_texels, float eps, float two_pi, float rr, float mirror_z,
    float tint_z, float tint_r, float tint_g, float tint_b,
    float albedo_const, void* stream) {
  const Params P = make_params(n_rects, g0, g1, g2, seed, n_valid,
                               max_depth, num_texels, eps, two_pi, rr,
                               mirror_z, tint_z, tint_r, tint_g, tint_b,
                               albedo_const, 0.0f);
  return launch_diff<UniformDraw, false>(scene, albedo, em, u_t, batch,
                                         inv_s, acc, P,
                                         static_cast<cudaStream_t>(stream));
}

extern "C" int fm_trace_splat_wide_diff_f32(
    const float* scene, const float* albedo, const float* em,
    const float* u_t, const float* fixed, long long* acc, float* out,
    int batch, int n_rects, int g0, int g1, int g2, int seed, int n_valid,
    int max_depth, int num_texels, float eps, float two_pi, float rr,
    float mirror_z, float tint_z, float tint_r, float tint_g, float tint_b,
    float albedo_const, void* stream) {
  const Params P = make_params(n_rects, g0, g1, g2, seed, n_valid,
                               max_depth, num_texels, eps, two_pi, rr,
                               mirror_z, tint_z, tint_r, tint_g, tint_b,
                               albedo_const, 0.0f);
  return run_f32<UniformDraw>(scene, albedo, em, u_t, batch, fixed, acc, out,
                              P, stream);
}
