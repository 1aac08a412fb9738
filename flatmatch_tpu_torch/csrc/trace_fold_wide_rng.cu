// Backward kernel of the differentiable render: replays one batch's photon
// trajectories and folds the lightmap cotangent g into per-slot albedo
// cotangents and the batch's <g, lightmap> total, without a deposit stream.
//
// Replaces the TPU kernel flatmatch_tpu/engines/photon_pallas_wide.py
// trace_fold_wide_rng (:1394, pallas_call :1428; body _make_kernel :105-733
// with diff=True, rng=True, fold=True; fold docs :138-157, body :588-629
// and :652-685). Per photon p and live bounce d it computes
//   w(p, d) = <bf16(g)[texel(p, d)], deposit color(p, d)>   (channels r, g, b)
//   S(p, k) = sum_{d >= k} w(p, d)                           (inclusive suffix)
// and returns da[j] = sum of S(p, k) over the diffuse hits (p, k) on rect
// slot j, and w_sum = sum_p S(p, 0), both undivided, as the TPU kernel does.
//
// Design:
//   - the trace is trace_wide.cuh (kDiff = true), so the trajectories and
//     colors are the forward kernel's; a photon that misses stops, and its
//     later bounces keep w = 0 and slot -1, which is what the TPU kernel's
//     zero colors give;
//   - g is gathered straight from device memory (the [T, 3] cotangent stays
//     in L2) and rounded to bf16 on load, the fold's one rounding, in place
//     of the TPU's one-hot MXU gather of a bf16 copy;
//   - w and the slot of each bounce go to shared memory ([D][256] floats and
//     ints), where each thread then forms its suffix sums in place;
//   - the fit must be exactly reproducible, so no float atomic touches da
//     or w_sum. Each warp sums its (slot, S) pairs bounce by bounce into its
//     own [N] row in shared memory: lanes holding the same slot
//     (__match_any_sync) are added by the lowest of them in lane order.
//     The block adds its 8 warp rows in order into a per-block partial,
//     [N + 1, blocks] with w_sum's block total in row N, and a second small
//     kernel adds each row over the blocks in a fixed order (one warp per
//     row, lane-strided, then a shuffle tree). The order of every sum is
//     fixed, so two runs give the same bits.
//
// What bounds it on an H100: the replayed trace, as in the forward kernel
// (the instruction rate of the rect loop). The gather reads 12 bytes per
// live deposit from L2, and the per-warp slot sums cost at most 32 shared
// reads per warp and bounce; both are small beside the rect loop.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (see
// flatmatch_tpu_torch/utils/cuda_build.py).
#include <cuda_bf16.h>

#include "trace_wide.cuh"

namespace {

constexpr int kWarps = kThreads / 32;

// round to bf16 (nearest even) and widen back: torch's .to(bfloat16)
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(kThreads)
trace_fold_kernel(const float* __restrict__ scene,
                  const float* __restrict__ albedo,
                  const float* __restrict__ em, const float* __restrict__ g,
                  const Params P, float* __restrict__ part) {
  const int N = P.n_rects;
  const int D = P.max_depth;
  const int t = threadIdx.x;
  extern __shared__ float smem[];
  float* s_scene = smem;                       // [F_AA][N]
  float* s_alb = s_scene + F_AA * N;           // [N]
  float* s_acc = s_alb + N;                    // [kWarps][N] per-warp sums
  float* s_w = s_acc + kWarps * N;             // [D][kThreads]: w, then S
  int* s_slot = reinterpret_cast<int*>(s_w + D * kThreads);  // [D][kThreads]
  stage(s_scene, scene, F_AA * N);
  stage(s_alb, albedo, N);
  for (int i = t; i < kWarps * N; i += kThreads) s_acc[i] = 0.0f;
  for (int d = 0; d < D; ++d) {
    s_w[d * kThreads + t] = 0.0f;
    s_slot[d * kThreads + t] = -1;
  }
  __syncthreads();

  const int pi = blockIdx.x * kThreads + t;
  if (pi < P.n_valid) {
    const uint32_t p = static_cast<uint32_t>(pi);
    trace_photon<true>(
        s_scene, s_alb, em, P, HashDraw{p, P.seed},
        [&](int d, int btex, float cr, float cg, float cb, int slot) {
          float w = 0.0f;
          if (static_cast<unsigned>(btex) <
              static_cast<unsigned>(P.num_texels)) {
            const float* gt = g + 3 * btex;
            // the channel order of photon_pallas_wide.py:622-626
            w = bf16_round(gt[0]) * cr + bf16_round(gt[1]) * cg +
                bf16_round(gt[2]) * cb;
          }
          s_w[d * kThreads + t] = w;
          s_slot[d * kThreads + t] = slot;
        });
    // inclusive suffix sums over bounces (photon_pallas_wide.py:656-660)
    float run = 0.0f;
    for (int d = D - 1; d >= 0; --d) {
      run = run + s_w[d * kThreads + t];
      s_w[d * kThreads + t] = run;
    }
  }
  __syncthreads();

  // per-warp slot sums, bounce by bounce, in lane order within a slot
  const int lane = t & 31;
  const int warp = t >> 5;
  float* acc = s_acc + warp * N;
  for (int d = 0; d < D; ++d) {
    const int slot = s_slot[d * kThreads + t];
    const unsigned peers = __match_any_sync(0xffffffffu, slot);
    if (slot >= 0 && lane == __ffs(peers) - 1) {
      float sum = 0.0f;
      for (unsigned m = peers; m; m &= m - 1) {
        sum = sum + s_w[d * kThreads + (warp << 5) + __ffs(m) - 1];
      }
      acc[slot] = acc[slot] + sum;
    }
    __syncwarp();
  }
  __syncthreads();

  const int nb = gridDim.x;
  for (int n = t; n < N; n += kThreads) {
    float sum = 0.0f;
    for (int w = 0; w < kWarps; ++w) sum = sum + s_acc[w * N + n];
    part[n * nb + blockIdx.x] = sum;
  }
  // the block's w_sum: a fixed tree over S(p, 0), row 0 of s_w
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (t < stride) s_w[t] = s_w[t] + s_w[t + stride];
    __syncthreads();
  }
  if (t == 0) part[N * nb + blockIdx.x] = s_w[0];
}

// out[r] = sum over blocks b of part[r * nb + b], for the N + 1 rows: one
// warp per row, lane-strided sums, then a shuffle tree; fixed order.
__global__ void __launch_bounds__(kThreads)
fold_sum_kernel(const float* __restrict__ part, int rows, int nb,
                float* __restrict__ out) {
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  float sum = 0.0f;
  for (int b = lane; b < nb; b += 32) sum = sum + part[r * nb + b];
  for (int off = 16; off > 0; off >>= 1) {
    sum = sum + __shfl_down_sync(0xffffffffu, sum, off);
  }
  if (lane == 0) out[r] = sum;
}

// Bytes of dynamic shared memory the fold kernel needs (the wrapper in
// engines/photon_wide.py checks the same sum against the card's limit).
size_t fold_smem(int n_rects, int max_depth) {
  return sizeof(float) * ((F_AA + 1 + kWarps) * static_cast<size_t>(n_rects) +
                          2 * static_cast<size_t>(max_depth) * kThreads);
}

}  // namespace

// C entry point, loaded with ctypes. Replays one batch on `stream`: `part`
// is scratch of (n_rects + 1) * ceil(n_valid / 256) floats, `out` receives
// the n_rects slot sums and then w_sum. Returns the CUDA error code of the
// launches (0 on success).
extern "C" int fm_trace_fold_wide_rng(
    const float* scene, const float* albedo, const float* em,
    const float* g, float* part, float* out, int n_rects, int g0, int g1,
    int g2, int seed, int n_valid, int max_depth, int num_texels, float eps,
    float two_pi, float rr, float mirror_z, float tint_z, float tint_r,
    float tint_g, float tint_b, float albedo_const, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = n_rects + 1;
  const int nb = n_valid > 0 ? (n_valid + kThreads - 1) / kThreads : 0;
  if (nb > 0) {
    const Params P = make_params(n_rects, g0, g1, g2, seed, n_valid,
                                 max_depth, num_texels, eps, two_pi, rr,
                                 mirror_z, tint_z, tint_r, tint_g, tint_b,
                                 albedo_const, 0.0f);
    const size_t smem = fold_smem(n_rects, max_depth);
    cudaError_t err = cudaFuncSetAttribute(
        trace_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    trace_fold_kernel<<<nb, kThreads, smem, st>>>(scene, albedo, em, g, P,
                                                  part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // with no live photon every row sums to 0
  fold_sum_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      part, rows, nb, out);
  return static_cast<int>(cudaGetLastError());
}
