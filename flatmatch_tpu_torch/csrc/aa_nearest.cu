// Nearest-hit queries for rays read from device memory: one thread per
// ray, the axis-aligned rect loop of the photon trace (trace_wide.cuh
// nearest_rect) over the scene's rects.
//
// Replaces two TPU kernels:
//   - flatmatch_tpu/ops/aa_query.py aa_nearest (:127, kernel :39): the
//     nearest front-face distance (kMiss = 1e30 on a miss) and the hit
//     texel id (-1 on a miss). The radiosity form factors use it.
//   - flatmatch_tpu/engines/ao_pallas.py nearest_distances (:111, kernel
//     :42): the nearest distance, `sky` on a miss. The chunked AO
//     (--ao-chunked) uses it.
// The TPU kernels lay rays out as [S, 128] component tiles and keep the
// table in SMEM; here a ray is a thread, and [R, 3] origins and directions
// are read as they are (12 bytes each, neighbouring threads on
// neighbouring rays).
//
// What bounds it on an H100: the instructions of the rect loop, every ray
// over all N rects (about 19 a rect test, chip_smoke.AA_RECT_TEST_
// INSTRUCTIONS); the bytes (24 in and 4 or 8 out a ray) are below that
// from about ten rects. The design, the photon trace's: each block stages
// the [13, N] table once as per-rect records (stage_aa_rects), two 16-byte
// broadcasts a rect test where the rows take eight scalar loads; the loop
// keeps only the running minimum and its column, with selects, unrolled
// (AaRects::kUnroll), and aa_nearest's texel id comes once, after the loop,
// from the winner's u and v recomputed from the same floats (winner_texel);
// the grid strides over the rays with at most 32,768 blocks
// (capped_blocks), so each block stages the table once. Tables past a
// block's shared memory take the device-memory instance (launch_table),
// which reads the rows where they lie.
//
// Every output bit is what a rect-at-a-time loop over the [13, N] rows
// gives when it works out the texel whenever the minimum improves: the
// same floats in the same order, ties to the first column, the compare
// chain false on NaN (1/0 = inf and 0 * inf = NaN occur on geosphere
// directions).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (see
// flatmatch_tpu_torch/utils/cuda_build.py).
#include "trace_wide.cuh"

namespace {

// kSmem: the scene table in shared memory as records, else read from
// device memory (launch_table)
template <bool kTex, bool kSmem>
__global__ void __launch_bounds__(kThreads)
nearest_kernel(const float* __restrict__ scene,
               const float* __restrict__ origins,
               const float* __restrict__ dirs, float* __restrict__ dist,
               int* __restrict__ tex, int N, int g0, int g1, int g2, int R,
               float sky) {
  extern __shared__ __align__(16) float smem[];
  const AaRects<kSmem> rects = stage_aa_rects<kSmem>(smem, scene, N);
  if constexpr (kSmem) __syncthreads();
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < R; i += stride) {
    const size_t r = 3 * static_cast<size_t>(i);
    const float pos[3] = {origins[r], origins[r + 1], origins[r + 2]};
    const float dr[3] = {dirs[r], dirs[r + 1], dirs[r + 2]};
    int bj;
    const float best = nearest_rect(rects, g0, g1, g2, pos, dr, bj);
    const bool hit = best < kHitBelow;
    if constexpr (kTex) {
      dist[i] = best;
      float bsign;
      tex[i] = hit ? winner_texel(rects, bj, axis_of(bj, g0, g1), best, pos,
                                  dr, bsign)
                   : -1;
    } else {
      dist[i] = hit ? best : sky;
    }
  }
}

// the table's bytes in shared memory; no other buffer
inline size_t table_bytes(int N) {
  return sizeof(float) * F_AA * static_cast<size_t>(N);
}

template <bool kTex>
int launch_nearest(const float* scene, const float* origins,
                   const float* dirs, float* dist, int* tex, int N, int g0,
                   int g1, int g2, int R, float sky, void* stream) {
  if (R <= 0) return 0;
  return launch_table(nearest_kernel<kTex, true>, nearest_kernel<kTex, false>,
                      table_bytes(N), 0, 0, capped_blocks(R, kThreads),
                      kThreads,
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

// What fm_aa_nearest (tex = 1) or fm_nearest_distances (tex = 0) launches
// for n_rects rects on the current device (table_plan): in_smem, shared
// bytes, registers, blocks per SM. No launch, no stream. Returns the CUDA
// error code.
extern "C" int fm_nearest_plan(int tex, int n_rects, int* in_smem,
                               int* shared_bytes, int* registers,
                               int* blocks_per_sm) {
  return tex ? table_plan(nearest_kernel<true, true>,
                          nearest_kernel<true, false>, table_bytes(n_rects),
                          0, 0, kThreads, in_smem, shared_bytes, registers,
                          blocks_per_sm)
             : table_plan(nearest_kernel<false, true>,
                          nearest_kernel<false, false>, table_bytes(n_rects),
                          0, 0, kThreads, in_smem, shared_bytes, registers,
                          blocks_per_sm);
}
