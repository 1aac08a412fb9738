// Stream trace: the photon trace of the production kernel writing every
// bounce's deposit to a stream (texel id, rgb) instead of splatting it, one
// launch per photon batch. A separate splat (splat_stream.cu) sums the
// stream into the lightmap.
//
// Replaces three TPU kernels of flatmatch_tpu/engines/photon_pallas_wide.py
// (body _make_kernel :105-733, stream writes :630-636):
//   - trace_deposits_wide_rng (:741): the counter-hash draws (HashDraw);
//   - trace_deposits_wide (:804): the draws read from a [B, U] f32 uniforms
//     tensor (UniformDraw, trace_wide.cuh), whose transposed [U, B] copy
//     the kernel reads (the wrapper in engines/photon_wide.py makes it, or
//     ops/threefry draws that layout directly);
//   - trace_deposits_wide_diff (:1070): the uniforms-in trace of the
//     differentiable tier (kDiff = true: the per-slot albedo of the winning
//     rect at a diffuse hit, staged beside the table), which also writes
//     the diffuse-hit slot of every row (-1 at a mirror bounce, a miss or
//     a dead photon). The diff renderer's `scatter`, `bucket` and
//     `bucket_exact` tiers run it in both passes.
// All write the JAX package's stream order: photon p = b * TB + w at
// bounce d goes to row (b * D + d) * TB + w, TB the stream block (the TPU
// kernel's photon block, S * 128). The 7-bit stream splat keys its dither by
// the row, so this order makes it agree with the JAX package bit for bit.
// Dead photons (p >= n_valid), the bounce that misses and every bounce after
// it write id 0 and color 0, as the TPU kernel's alive mask does; the kernel
// writes those zeros itself, so the stream needs no separate fill.
//
// The trace is trace_wide.cuh, the production kernel's (kDiff = false) or
// the diff forward's (kDiff = true), so the same photon gives the same bits
// in each pair. What bounds it on an H100: the rect loop, as in
// trace_splat_wide_rng.cu, then the stream's 16 bytes per row (20 with the
// slot; R = B * D rows) written and, with uniforms, 4 * U bytes per photon
// read: about 17-21 MB written and 15 MB read per 131072-photon batch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (see
// flatmatch_tpu_torch/utils/cuda_build.py).
#include "trace_wide.cuh"

namespace {

// kSmem: the scene table (and albedo row) in shared memory, else read from
// device memory (launch_table, trace_wide.cuh). `albedo` and `ridx` are
// read and written only when kDiff.
template <bool kUniforms, bool kDiff, bool kSmem>
__global__ void __launch_bounds__(kThreads, kSmem ? kSmemMinBlocks : 1)
trace_deposits_kernel(const float* __restrict__ scene,
                      const float* __restrict__ albedo,
                      const float* __restrict__ em,
                      const float* __restrict__ u_t, const Params P,
                      int batch, int block, int* __restrict__ idx,
                      float* __restrict__ col, int* __restrict__ ridx) {
  extern __shared__ __align__(16) float smem[];
  const float* alb = albedo;
  if constexpr (kSmem && kDiff) {
    alb = smem + table_floats(P.n_rects);           // [N]
    stage(smem + table_floats(P.n_rects), albedo, P.n_rects);
  }
  // the staged scene; its barrier also covers the albedo row
  const Rects<kSmem> rects = stage_scene<kSmem>(smem, scene, em, P);

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= batch) return;
  const int D = P.max_depth;
  // row of bounce 0; bounce d is `block` rows further on per d
  const size_t row0 =
      static_cast<size_t>(p / block) * D * block + p % block;
  int done = 0;
  auto deposit = [&](int d, int btex, float cr, float cg, float cb,
                     int slot) {
    const size_t row = row0 + static_cast<size_t>(d) * block;
    idx[row] = btex;
    col[3 * row] = cr;
    col[3 * row + 1] = cg;
    col[3 * row + 2] = cb;
    if constexpr (kDiff) ridx[row] = slot;
    done = d + 1;
  };
  if (p < P.n_valid) {
    if constexpr (kUniforms) {
      trace_photon<kDiff>(rects, alb, P, UniformDraw{u_t, batch, p},
                          deposit);
    } else {
      trace_photon<kDiff>(rects, alb, P,
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
    if constexpr (kDiff) ridx[row] = -1;
  }
}

template <bool kUniforms, bool kDiff>
int launch_stream(const float* scene, const float* albedo, const float* em,
                  const float* u_t, int* idx, float* col, int* ridx,
                  int batch, int block, int n_rects, int g0, int g1, int g2,
                  int seed, int n_valid, int max_depth, int num_texels,
                  float eps, float two_pi, float rr, float mirror_z,
                  float tint_z, float tint_r, float tint_g, float tint_b,
                  float albedo_const, void* stream) {
  if (batch <= 0) return 0;
  const Params P = make_params(n_rects, g0, g1, g2, seed, n_valid, max_depth,
                               num_texels, eps, two_pi, rr, mirror_z, tint_z,
                               tint_r, tint_g, tint_b, albedo_const, 0.0f);
  const size_t floats = table_floats(n_rects) + (kDiff ? n_rects : 0);
  return launch_table(trace_deposits_kernel<kUniforms, kDiff, true>,
                      trace_deposits_kernel<kUniforms, kDiff, false>,
                      sizeof(float) * floats, 0, 0,
                      blocks_for(batch), kThreads,
                      static_cast<cudaStream_t>(stream), scene, albedo, em,
                      u_t, P, batch, block, idx, col, ridx);
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
  return launch_stream<false, false>(
      scene, nullptr, em, nullptr, idx, col, nullptr, batch, block, n_rects,
      g0, g1, g2, seed, n_valid, max_depth, num_texels, eps, two_pi, rr,
      mirror_z, tint_z, tint_r, tint_g, tint_b, albedo, stream);
}

// `u_t` is the [U, batch] f32 transpose of the batch's uniforms.
extern "C" int fm_trace_deposits_wide(
    const float* scene, const float* em, const float* u_t, int* idx,
    float* col, int batch, int block, int n_rects, int g0, int g1, int g2,
    int seed, int n_valid, int max_depth, int num_texels, float eps,
    float two_pi, float rr, float mirror_z, float tint_z, float tint_r,
    float tint_g, float tint_b, float albedo, void* stream) {
  return launch_stream<true, false>(
      scene, nullptr, em, u_t, idx, col, nullptr, batch, block, n_rects, g0,
      g1, g2, seed, n_valid, max_depth, num_texels, eps, two_pi, rr,
      mirror_z, tint_z, tint_r, tint_g, tint_b, albedo, stream);
}

// The diff stream: `albedo` is the [n_rects] per-slot albedo, `u_t` the
// [U, batch] uniforms; ridx [batch * max_depth] int32 gets each row's
// diffuse-hit slot (-1 where there is none).
extern "C" int fm_trace_deposits_wide_diff(
    const float* scene, const float* albedo, const float* em,
    const float* u_t, int* idx, float* col, int* ridx, int batch, int block,
    int n_rects, int g0, int g1, int g2, int seed, int n_valid,
    int max_depth, int num_texels, float eps, float two_pi, float rr,
    float mirror_z, float tint_z, float tint_r, float tint_g, float tint_b,
    float albedo_const, void* stream) {
  return launch_stream<true, true>(
      scene, albedo, em, u_t, idx, col, ridx, batch, block, n_rects, g0, g1,
      g2, seed, n_valid, max_depth, num_texels, eps, two_pi, rr, mirror_z,
      tint_z, tint_r, tint_g, tint_b, albedo_const, stream);
}
