// Ambient occlusion with the rays made in the kernel: for every level-0
// texel t of wall w and every direction k of the wall's rotated geosphere
// table, the ray starts at center[t] + dir[w][k] * 1e-5 and runs along
// dir[w][k]; its nearest front-face distance (sky on a miss) times the
// direction's weight fac[k] (its z in the surface frame) is summed over k.
//
// Replaces the TPU kernel flatmatch_tpu/engines/ao_pallas.py _ao_fused
// (:412, kernel _make_fused_kernel :329), the AO default. It computes what
// that kernel computes; the layout is new:
//   - the TPU grid (texel block, 128-direction block) wrote per-k partials
//     that XLA summed. Here one block of 128 threads takes one texel at a
//     time (grid-stride over texels); thread j takes directions j, j+128,
//     ... and adds its products in that order, then the block adds the 128
//     partials in a fixed shared-memory tree. No float atomics, so two runs
//     are bit-identical, and the plain version (engines/ao.py
//     ao_fused_plain) adds in the same order.
//   - directions are padded to a multiple of 128 with copies of direction
//     0 at weight 0, which add exactly +0.0 (distances are finite and
//     positive), as the TPU kernel's padding does (ao_pallas.py:459-470).
//   - the origin is center + dir * 1e-5, the product rounded before the
//     sum (-fmad=false), as the TPU kernel and the plain version compute it.
//
// What bounds it on an H100: the instruction rate of the rect loop (about
// 20 f32 operations per ray and rect, all N rects for every ray). Bytes
// are tiny: the table, the centers, the direction rows and one float out
// per texel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (see
// flatmatch_tpu_torch/utils/cuda_build.py).
#include "aa_nearest.cuh"

namespace {

constexpr int kAoThreads = 128;  // directions per pass, one per thread

// kSmem: the scene table in shared memory, else read from device memory
// (launch_table, trace_wide.cuh)
template <bool kSmem>
__global__ void __launch_bounds__(kAoThreads)
ao_fused_kernel(const float* __restrict__ scene,
                const float* __restrict__ centers,
                const int* __restrict__ wall_ids,
                const float* __restrict__ dirs, const float* __restrict__ fac,
                float* __restrict__ sums, int N, int g0, int g1, int g2,
                int T, int k_pad, float sky) {
  extern __shared__ float s_scene[];  // [F_AA][N]
  __shared__ float red[kAoThreads];
  const float* tab = scene;
  if constexpr (kSmem) {
    stage(s_scene, scene, F_AA * N);
    __syncthreads();
    tab = s_scene;
  }
  const int j = threadIdx.x;
  for (int t = blockIdx.x; t < T; t += gridDim.x) {
    const float cx = centers[3 * t];
    const float cy = centers[3 * t + 1];
    const float cz = centers[3 * t + 2];
    // the wall's direction rows [3][k_pad]
    const float* d = dirs + static_cast<size_t>(wall_ids[t]) * 3 * k_pad;
    float acc = 0.0f;
    for (int k = j; k < k_pad; k += kAoThreads) {
      const float dx = d[k], dy = d[k_pad + k], dz = d[2 * k_pad + k];
      int unused;
      const float best = aa_nearest_hit<false>(
          tab, N, g0, g1, g2, cx + dx * 1e-5f, cy + dy * 1e-5f,
          cz + dz * 1e-5f, dx, dy, dz, unused);
      const float dist = best < kHitBelow ? best : sky;
      acc = acc + dist * fac[k];
    }
    red[j] = acc;
    __syncthreads();
    for (int w = kAoThreads / 2; w > 0; w >>= 1) {
      if (j < w) red[j] = red[j] + red[j + w];
      __syncthreads();
    }
    if (j == 0) sums[t] = red[0];
    __syncthreads();  // red is rewritten for the next texel
  }
}

}  // namespace

// C entry point, loaded with ctypes. centers [T, 3] f32, wall_ids [T]
// int32, dirs [walls, 3, k_pad] f32 (k_pad a multiple of 128), fac [k_pad]
// f32, sums [T] f32. Launches on `stream` and returns the CUDA error code
// of the launch (0 on success).
extern "C" int fm_ao_fused(const float* scene, const float* centers,
                           const int* wall_ids, const float* dirs,
                           const float* fac, float* sums, int n_rects, int g0,
                           int g1, int g2, int n_texels, int k_pad, float sky,
                           void* stream) {
  if (n_texels <= 0) return 0;
  if (k_pad % kAoThreads != 0) return static_cast<int>(cudaErrorInvalidValue);
  // the block's static reduction buffer counts against the same limit
  return launch_table(ao_fused_kernel<true>, ao_fused_kernel<false>,
                      sizeof(float) * F_AA * static_cast<size_t>(n_rects),
                      0, sizeof(float) * kAoThreads, capped_blocks(n_texels, 1),
                      kAoThreads, static_cast<cudaStream_t>(stream), scene,
                      centers, wall_ids, dirs, fac, sums, n_rects, g0, g1, g2,
                      n_texels, k_pad, sky);
}
