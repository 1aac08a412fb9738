// In-kernel splat tiers beside the default render: the production photon
// trace with its deposits splatted inside the kernel, one launch per batch,
// for the routes the default kernel (trace_splat_wide_rng.cu) does not run:
//   - fm_trace_splat_wide_rng_f32: counter-hash draws, bf16 colors summed in
//     f32 (`--splat inkernel`). Replaces flatmatch_tpu/engines/
//     photon_pallas_wide.py trace_splat_wide_rng(i8=False) (:1002);
//   - fm_trace_splat_wide_i8: threefry uniforms passed in, the dithered
//     7-bit grid (`--no-device-rng` at the default `inkernel_i8`). Replaces
//     trace_splat_wide(i8=True) (:937);
//   - fm_trace_splat_wide_f32: threefry uniforms, bf16 colors summed in f32
//     (`--no-device-rng --splat inkernel`). Replaces
//     trace_splat_wide(i8=False).
// The body is _make_kernel (:105-733) with fuse_h: the trace is
// trace_wide.cuh (kDiff = false), the draws HashDraw or UniformDraw (on the
// wrapper's transposed [U, B] copy of the uniforms), and each live deposit
// goes to splat_i8 (the int32 accumulator of the default kernel, its dither
// keyed by photon p * 3D + 3d + ch, :524-545) or splat_f32.
//
// The f32 sum is the TPU kernel's f32 MXU accumulation done exactly: every
// bf16 color becomes an int64 at 2^k (k from ops/splat.fixed_point_scale of
// the config's stream bound, the stream route's k) and is added by 64-bit
// atomicAdd; the entry point then converts each texel once to the f32
// [T, 3] increment that the engine adds to its lightmap, as JAX adds
// `lm + trace_splat_wide(...)` (:1681). These are the integers that
// trace_deposits_wide(_rng) + fused_splat add for the same batch, so on the
// card the two routes give the same bits, and two runs give the same bits.
//
// What bounds them on an H100: the rect loop, as in the default kernel
// (about 22 instructions per photon, rect and traced bounce); the i8
// threefry kernel adds the uniforms read, 4 * (4 + 3D) bytes per photon
// (14.7 MB per 131072-photon batch, 4 us at 3.35 TB/s); the f32 kernels add
// up to 3D int64 atomics per photon in L2 and the [T, 3] int64 zeroing and
// conversion.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (see
// flatmatch_tpu_torch/utils/cuda_build.py).
#include <type_traits>

#include "trace_wide.cuh"

namespace {

// acc is int* (kF32 = false) or the unsigned view of the int64 accumulator;
// kSmem: the scene table in shared memory, else read from device memory
// (launch_table, trace_wide.cuh)
template <class Draw, bool kF32, bool kSmem>
__global__ void __launch_bounds__(kThreads, kSmem ? kSmemMinBlocks : 1)
trace_splat_wide_kernel(const float* __restrict__ scene,
                        const float* __restrict__ em,
                        const float* __restrict__ u_t, int batch,
                        float to_fixed, const Params P, void* acc) {
  extern __shared__ __align__(16) float smem[];  // the staged scene
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
  trace_photon<false>(
      rects, nullptr, P, draws,
      [&](int d, int btex, float cr, float cg, float cb, int) {
        if constexpr (kF32) {
          splat_f32(static_cast<unsigned long long*>(acc), P, to_fixed, btex,
                    cr, cg, cb);
        } else {
          splat_i8(static_cast<int*>(acc), P, P.inv_s, p, d, btex, cr, cg,
                   cb);
        }
      });
}

template <class Draw, bool kF32>
int launch_trace(const float* scene, const float* em, const float* u_t,
                 int batch, float to_fixed, const Params& P, void* acc,
                 cudaStream_t s) {
  if (P.n_valid <= 0) return 0;
  return launch_table(trace_splat_wide_kernel<Draw, kF32, true>,
                      trace_splat_wide_kernel<Draw, kF32, false>,
                      sizeof(float) * table_floats(P.n_rects), 0, 0,
                      blocks_for(P.n_valid), kThreads, s, scene, em, u_t,
                      batch, to_fixed, P, acc);
}

// The f32 tiers: zero the int64 scratch, trace and splat, convert to `out`.
template <class Draw>
int run_f32(const float* scene, const float* em, const float* u_t, int batch,
            long long* acc, float* out, const Params& P, float to_fixed,
            float from_fixed, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = 3 * P.num_texels;
  if (n <= 0) return 0;
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(long long) * n, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = launch_trace<Draw, true>(scene, em, u_t, batch, to_fixed, P,
                                          acc, s);
  if (rc != 0) return rc;
  return launch_fixed_to_f32(acc, n, nullptr, from_fixed, out, s);
}

}  // namespace

// C entry points, loaded with ctypes. Each traces one batch on `stream` and
// returns the CUDA error code (0 on success). The f32 ones zero `acc`
// (int64 [num_texels, 3] scratch) and write the f32 [num_texels, 3]
// increment `out`; to_fixed = 2^k, from_fixed = 2^-k. The i8 one adds into
// `acc` (int32 [num_texels, 3]), which the caller zeroes. `u_t` is the
// [4 + 3 * max_depth, batch] f32 transpose of the batch's uniforms; the
// seed is unused where the draws are passed in.
extern "C" int fm_trace_splat_wide_rng_f32(
    const float* scene, const float* em, long long* acc, float* out,
    int n_rects, int g0, int g1, int g2, int seed, int n_valid, int max_depth,
    int num_texels, float eps, float two_pi, float rr, float mirror_z,
    float tint_z, float tint_r, float tint_g, float tint_b, float albedo,
    float to_fixed, float from_fixed, void* stream) {
  const Params P = make_params(n_rects, g0, g1, g2, seed, n_valid, max_depth,
                               num_texels, eps, two_pi, rr, mirror_z, tint_z,
                               tint_r, tint_g, tint_b, albedo, 0.0f);
  return run_f32<HashDraw>(scene, em, nullptr, 0, acc, out, P, to_fixed,
                           from_fixed, stream);
}

extern "C" int fm_trace_splat_wide_i8(
    const float* scene, const float* em, const float* u_t, int* acc,
    int batch, int n_rects, int g0, int g1, int g2, int seed, int n_valid,
    int max_depth, int num_texels, float eps, float two_pi, float rr,
    float mirror_z, float tint_z, float tint_r, float tint_g, float tint_b,
    float albedo, float inv_s, void* stream) {
  const Params P = make_params(n_rects, g0, g1, g2, seed, n_valid, max_depth,
                               num_texels, eps, two_pi, rr, mirror_z, tint_z,
                               tint_r, tint_g, tint_b, albedo, inv_s);
  return launch_trace<UniformDraw, false>(
      scene, em, u_t, batch, 0.0f, P, acc, static_cast<cudaStream_t>(stream));
}

extern "C" int fm_trace_splat_wide_f32(
    const float* scene, const float* em, const float* u_t, long long* acc,
    float* out, int batch, int n_rects, int g0, int g1, int g2, int seed,
    int n_valid, int max_depth, int num_texels, float eps, float two_pi,
    float rr, float mirror_z, float tint_z, float tint_r, float tint_g,
    float tint_b, float albedo, float to_fixed, float from_fixed,
    void* stream) {
  const Params P = make_params(n_rects, g0, g1, g2, seed, n_valid, max_depth,
                               num_texels, eps, two_pi, rr, mirror_z, tint_z,
                               tint_r, tint_g, tint_b, albedo, 0.0f);
  return run_f32<UniformDraw>(scene, em, u_t, batch, acc, out, P, to_fixed,
                              from_fixed, stream);
}
