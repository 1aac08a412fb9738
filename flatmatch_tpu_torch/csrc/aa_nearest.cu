// Nearest-hit queries for rays read from device memory: one thread per
// ray, the rect loop of aa_nearest.cuh over the scene table staged in
// shared memory (read from device memory when it does not fit).
//
// Replaces two TPU kernels:
//   - flatmatch_tpu/ops/aa_query.py aa_nearest (:127, kernel :39): the
//     nearest front-face distance (kMiss = 1e30 on a miss) and the hit
//     texel id (-1 on a miss). The radiosity form factors use it.
//   - flatmatch_tpu/engines/ao_pallas.py nearest_distances (:111, kernel
//     :42): the nearest distance, `sky` on a miss. The chunked AO
//     (--ao-chunked) uses it.
// The TPU kernels lay rays out as [S, 128] component tiles and keep the
// table in SMEM; here a ray is a thread, [R, 3] origins and directions are
// read as they are (12 bytes each, neighbouring threads on neighbouring
// rays), and every rect read in the loop is a warp-uniform shared-memory
// broadcast.
//
// What bounds it on an H100: the instruction rate of the rect loop (about
// 20 f32 operations per ray and rect, over all N rects for every ray); the
// bytes (24 in and 4 or 8 out per ray) are far below that at N >= 10.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (see
// flatmatch_tpu_torch/utils/cuda_build.py).
#include "aa_nearest.cuh"

namespace {

// kSmem: the scene table in shared memory, else read from device memory
// (launch_table, trace_wide.cuh)
template <bool kTex, bool kSmem>
__global__ void __launch_bounds__(kThreads)
nearest_kernel(const float* __restrict__ scene,
               const float* __restrict__ origins,
               const float* __restrict__ dirs, float* __restrict__ dist,
               int* __restrict__ tex, int N, int g0, int g1, int g2, int R,
               float sky) {
  extern __shared__ float s_scene[];  // [F_AA][N]
  const float* tab = scene;
  if constexpr (kSmem) {
    stage(s_scene, scene, F_AA * N);
    __syncthreads();
    tab = s_scene;
  }
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < R; i += stride) {
    const size_t r = 3 * static_cast<size_t>(i);
    int btex;
    const float best = aa_nearest_hit<kTex>(
        tab, N, g0, g1, g2, origins[r], origins[r + 1], origins[r + 2],
        dirs[r], dirs[r + 1], dirs[r + 2], btex);
    const bool hit = best < kHitBelow;
    if (kTex) {
      dist[i] = best;
      tex[i] = hit ? btex : -1;
    } else {
      dist[i] = hit ? best : sky;
    }
  }
}

template <bool kTex>
int launch_nearest(const float* scene, const float* origins,
                   const float* dirs, float* dist, int* tex, int N, int g0,
                   int g1, int g2, int R, float sky, void* stream) {
  if (R <= 0) return 0;
  return launch_table(nearest_kernel<kTex, true>, nearest_kernel<kTex, false>,
                      sizeof(float) * F_AA * static_cast<size_t>(N), 0, 0,
                      capped_blocks(R, kThreads), kThreads,
                      static_cast<cudaStream_t>(stream), scene, origins, dirs,
                      dist, tex, N, g0, g1, g2, R, sky);
}

}  // namespace

// C entry points, loaded with ctypes. Each launches on `stream` and returns
// the CUDA error code of the launch (0 on success). origins and dirs are
// [R, 3] float32; dist is [R] float32, tex [R] int32.
extern "C" int fm_aa_nearest(const float* scene, const float* origins,
                             const float* dirs, float* dist, int* tex,
                             int n_rects, int g0, int g1, int g2, int n_rays,
                             void* stream) {
  return launch_nearest<true>(scene, origins, dirs, dist, tex, n_rects, g0,
                              g1, g2, n_rays, 0.0f, stream);
}

extern "C" int fm_nearest_distances(const float* scene, const float* origins,
                                    const float* dirs, float* dist,
                                    int n_rects, int g0, int g1, int g2,
                                    int n_rays, float sky, void* stream) {
  return launch_nearest<false>(scene, origins, dirs, dist, nullptr, n_rects,
                               g0, g1, g2, n_rays, sky, stream);
}
