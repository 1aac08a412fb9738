// Stream trace: the photon trace of the production kernel writing every
// bounce's deposit to a stream (texel id, rgb) instead of splatting it, one
// launch per photon batch. A separate splat (splat_stream.cu) sums the
// stream into the lightmap.
//
// Replaces two TPU kernels of flatmatch_tpu/engines/photon_pallas_wide.py
// (body _make_kernel :105-733, stream writes :630-636):
//   - trace_deposits_wide_rng (:741): the counter-hash draws (HashDraw);
//   - trace_deposits_wide (:804): the draws read from a [B, U] f32 uniforms
//     tensor (UniformDraw, trace_wide.cuh). The wrapper
//     (engines/photon_wide.py) hands the kernel a transposed [U, B] copy.
// Both write the JAX package's stream order: photon p = b * TB + w at
// bounce d goes to row (b * D + d) * TB + w, TB the stream block (the TPU
// kernel's photon block, S * 128). The 7-bit stream splat keys its dither by
// the row, so this order makes it agree with the JAX package bit for bit.
// Dead photons (p >= n_valid), the bounce that misses and every bounce after
// it write id 0 and color 0, as the TPU kernel's alive mask does; the kernel
// writes those zeros itself, so the stream needs no separate fill.
//
// The trace is trace_wide.cuh (kDiff = false), the production kernel's, so
// the same photon gives the same bits in both. What bounds it on an H100:
// the rect loop, as in trace_splat_wide_rng.cu, then the stream's 16 bytes
// per row (R = B * D rows) written and, with uniforms, 4 * U bytes per
// photon read: about 17 MB written and 15 MB read per 131072-photon batch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (see
// flatmatch_tpu_torch/utils/cuda_build.py).
#include "trace_wide.cuh"

namespace {

template <bool kUniforms>
__global__ void __launch_bounds__(kThreads)
trace_deposits_kernel(const float* __restrict__ scene,
                      const float* __restrict__ em,
                      const float* __restrict__ u_t, const Params P,
                      int batch, int block, int* __restrict__ idx,
                      float* __restrict__ col) {
  extern __shared__ float s_scene[];  // [F_AA][N]
  stage(s_scene, scene, F_AA * P.n_rects);
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= batch) return;
  const int D = P.max_depth;
  // row of bounce 0; bounce d is `block` rows further on per d
  const size_t row0 =
      static_cast<size_t>(p / block) * D * block + p % block;
  int done = 0;
  auto deposit = [&](int d, int btex, float cr, float cg, float cb, int) {
    const size_t row = row0 + static_cast<size_t>(d) * block;
    idx[row] = btex;
    col[3 * row] = cr;
    col[3 * row + 1] = cg;
    col[3 * row + 2] = cb;
    done = d + 1;
  };
  if (p < P.n_valid) {
    if constexpr (kUniforms) {
      trace_photon<false>(s_scene, nullptr, em, P, UniformDraw{u_t, batch, p},
                          deposit);
    } else {
      trace_photon<false>(s_scene, nullptr, em, P,
                          HashDraw{static_cast<uint32_t>(p), P.seed},
                          deposit);
    }
  }
  for (int d = done; d < D; ++d) {
    const size_t row = row0 + static_cast<size_t>(d) * block;
    idx[row] = 0;
    col[3 * row] = 0.0f;
    col[3 * row + 1] = 0.0f;
    col[3 * row + 2] = 0.0f;
  }
}

template <bool kUniforms>
int launch_stream(const float* scene, const float* em, const float* u_t,
                  int* idx, float* col, int batch, int block, int n_rects,
                  int g0, int g1, int g2, int seed, int n_valid, int max_depth,
                  int num_texels, float eps, float two_pi, float rr,
                  float mirror_z, float tint_z, float tint_r, float tint_g,
                  float tint_b, float albedo, void* stream) {
  if (batch <= 0) return 0;
  const Params P = make_params(n_rects, g0, g1, g2, seed, n_valid, max_depth,
                               num_texels, eps, two_pi, rr, mirror_z, tint_z,
                               tint_r, tint_g, tint_b, albedo, 0.0f);
  const size_t smem = sizeof(float) * F_AA * static_cast<size_t>(n_rects);
  cudaError_t err = cudaFuncSetAttribute(
      trace_deposits_kernel<kUniforms>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (batch + kThreads - 1) / kThreads;
  trace_deposits_kernel<kUniforms>
      <<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          scene, em, u_t, P, batch, block, idx, col);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, loaded with ctypes. Each launches one batch of `batch`
// photons on `stream` and returns the CUDA error code of the launch (0 on
// success). idx [batch * max_depth] int32 and col [batch * max_depth, 3] f32
// are written in full; `block` must divide `batch`.
extern "C" int fm_trace_deposits_wide_rng(
    const float* scene, const float* em, int* idx, float* col, int batch,
    int block, int n_rects, int g0, int g1, int g2, int seed, int n_valid,
    int max_depth, int num_texels, float eps, float two_pi, float rr,
    float mirror_z, float tint_z, float tint_r, float tint_g, float tint_b,
    float albedo, void* stream) {
  return launch_stream<false>(scene, em, nullptr, idx, col, batch, block,
                              n_rects, g0, g1, g2, seed, n_valid, max_depth,
                              num_texels, eps, two_pi, rr, mirror_z, tint_z,
                              tint_r, tint_g, tint_b, albedo, stream);
}

// `u_t` is the [U, batch] f32 transpose of the batch's uniforms.
extern "C" int fm_trace_deposits_wide(
    const float* scene, const float* em, const float* u_t, int* idx,
    float* col, int batch, int block, int n_rects, int g0, int g1, int g2,
    int seed, int n_valid, int max_depth, int num_texels, float eps,
    float two_pi, float rr, float mirror_z, float tint_z, float tint_r,
    float tint_g, float tint_b, float albedo, void* stream) {
  return launch_stream<true>(scene, em, u_t, idx, col, batch, block, n_rects,
                             g0, g1, g2, seed, n_valid, max_depth, num_texels,
                             eps, two_pi, rr, mirror_z, tint_z, tint_r,
                             tint_g, tint_b, albedo, stream);
}
