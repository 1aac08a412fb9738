// Forward kernel of the differentiable render: the production photon trace
// with a per-slot albedo, splatting dithered 7-bit deposits on a grid set
// at run time into an exact int32 texel accumulator, one launch per batch.
//
// Replaces the TPU kernel flatmatch_tpu/engines/photon_pallas_wide.py
// trace_splat_wide_diff_rng(i8=True) (:1252, pallas_call :1306; body
// _make_kernel :105-733 with diff=True, rng=True, fuse_h, i8). What differs
// from trace_splat_wide_rng.cu, and how:
//   - the albedo of a diffuse hit is albedo_aa[j] of the winning rect slot
//     j (:290-292, :373-379, :494). Each block stages that [N] row in
//     shared memory beside the [13, N] scene table, and the shared trace
//     (trace_wide.cuh, kDiff = true) tracks j;
//   - the inverse grid step inv_s is a run-time scalar (:518-523): the
//     caller's scale_pair covers the deposit bound at the current power
//     and albedo. The kernel reads it from a one-float device tensor, so
//     a training step needs no host round trip to launch it.
// At power <= 1 and albedo <= 1, inv_s is the production constant and every
// per-slot albedo equals the scalar one, so the accumulator equals the
// production kernel's bit for bit.
//
// What bounds it on an H100: the same as the production kernel, the
// instruction rate of the rect loop (about 30 instructions per photon,
// rect and traced bounce); slot tracking adds one register move per
// winning rect, and the albedo row one shared load per diffuse bounce.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (see
// flatmatch_tpu_torch/utils/cuda_build.py).
#include "trace_wide.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
trace_splat_diff_kernel(const float* __restrict__ scene,
                        const float* __restrict__ albedo,
                        const float* __restrict__ em,
                        const float* __restrict__ inv_s_ptr, const Params P,
                        int* __restrict__ acc) {
  extern __shared__ float smem[];
  float* s_scene = smem;                      // [F_AA][N]
  float* s_alb = smem + F_AA * P.n_rects;     // [N]
  stage(s_scene, scene, F_AA * P.n_rects);
  stage(s_alb, albedo, P.n_rects);
  __syncthreads();

  const int pi = blockIdx.x * blockDim.x + threadIdx.x;
  // dead photons deposit exactly 0 and are not traced
  if (pi >= P.n_valid) return;
  const uint32_t p = static_cast<uint32_t>(pi);
  const float inv_s = *inv_s_ptr;
  trace_photon<true>(s_scene, s_alb, em, P, p,
                     [&](int d, int btex, float cr, float cg, float cb,
                         int) {
                       splat_i8(acc, P, inv_s, p, d, btex, cr, cg, cb);
                     });
}

}  // namespace

// C entry point, loaded with ctypes. Launches one batch on `stream` and
// returns the CUDA error code of the launch (0 on success). `acc` must be
// zeroed by the caller; `inv_s` points to one float on the device.
extern "C" int fm_trace_splat_wide_diff_rng_i8(
    const float* scene, const float* albedo, const float* em,
    const float* inv_s, int* acc, int n_rects, int g0, int g1, int g2,
    int seed, int n_valid, int max_depth, int num_texels, float eps,
    float two_pi, float rr, float mirror_z, float tint_z, float tint_r,
    float tint_g, float tint_b, float albedo_const, void* stream) {
  if (n_valid <= 0) return 0;
  const Params P = make_params(n_rects, g0, g1, g2, seed, n_valid,
                               max_depth, num_texels, eps, two_pi, rr,
                               mirror_z, tint_z, tint_r, tint_g, tint_b,
                               albedo_const, 0.0f);
  const size_t smem =
      sizeof(float) * (F_AA + 1) * static_cast<size_t>(n_rects);
  cudaError_t err = cudaFuncSetAttribute(
      trace_splat_diff_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_valid + kThreads - 1) / kThreads;
  trace_splat_diff_kernel<<<blocks, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      scene, albedo, em, inv_s, P, acc);
  return static_cast<int>(cudaGetLastError());
}
