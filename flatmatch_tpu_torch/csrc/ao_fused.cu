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
//     partials in a fixed halving tree, red[j] + red[j + w] for w = 64,
//     32, ..., 1: the two steps across warps in shared memory, the five
//     within warp 0 by __shfl_down_sync, the same pairs in the same operand
//     order. No float atomics, so two runs are bit-identical, and the plain
//     version (engines/ao.py ao_fused_plain) adds in the same order.
//   - directions are padded to a multiple of 128 with copies of direction
//     0 at weight 0, which add exactly +0.0 (distances are finite and
//     positive), as the TPU kernel's padding does (ao_pallas.py:459-470).
//     They are traced: at 481 directions of 512 the fourth pass of warp 3
//     runs for its lane 96 anyway, and a branch that skipped the others
//     measured slower on an H100 (PERF.md).
//   - the origin is center + dir * 1e-5, the product rounded before the
//     sum (-fmad=false), as the TPU kernel and the plain version compute it.
//
// What bounds it on an H100: the instructions of the rect loop, all N rects
// for every ray (about 19 a rect test, chip_smoke.AA_RECT_TEST_
// INSTRUCTIONS). Bytes are tiny: the table, the centers, the direction rows
// and one float out per texel. The rect loop is the photon trace's
// (trace_wide.cuh nearest_rect) over the table's per-rect records, staged
// once a block (stage_aa_rects), on at most 32,768 blocks (capped_blocks);
// tables past a block's shared memory take the device-memory instance
// (launch_table).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (see
// flatmatch_tpu_torch/utils/cuda_build.py).
#include "trace_wide.cuh"

namespace {

constexpr int kAoThreads = 128;  // directions per pass, one per thread

// kSmem: the scene table in shared memory as records, else read from
// device memory (launch_table)
template <bool kSmem>
__global__ void __launch_bounds__(kAoThreads)
ao_fused_kernel(const float* __restrict__ scene,
                const float* __restrict__ centers,
                const int* __restrict__ wall_ids,
                const float* __restrict__ dirs, const float* __restrict__ fac,
                float* __restrict__ sums, int N, int g0, int g1, int g2,
                int T, int k_pad, float sky) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kAoThreads];
  const AaRects<kSmem> rects = stage_aa_rects<kSmem>(smem, scene, N);
  if constexpr (kSmem) __syncthreads();
  const int j = threadIdx.x;
  for (int t = blockIdx.x; t < T; t += gridDim.x) {
    const float cx = centers[3 * t];
    const float cy = centers[3 * t + 1];
    const float cz = centers[3 * t + 2];
    // the wall's direction rows [3][k_pad]
    const float* d = dirs + static_cast<size_t>(wall_ids[t]) * 3 * k_pad;
    float acc = 0.0f;
    for (int k = j; k < k_pad; k += kAoThreads) {
      const float dr[3] = {d[k], d[k_pad + k], d[2 * k_pad + k]};
      const float pos[3] = {cx + dr[0] * 1e-5f, cy + dr[1] * 1e-5f,
                            cz + dr[2] * 1e-5f};
      int bj;
      const float best = nearest_rect(rects, g0, g1, g2, pos, dr, bj);
      const float dist = best < kHitBelow ? best : sky;
      acc = acc + dist * fac[k];
    }
    red[j] = acc;
    __syncthreads();
    if (j < 64) red[j] = red[j] + red[j + 64];
    __syncthreads();
    if (j < 32) {
      float v = red[j] + red[j + 32];
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) {
        v = v + __shfl_down_sync(0xffffffffu, v, w);
      }
      if (j == 0) sums[t] = v;
    }
    __syncthreads();  // red is rewritten for the next texel
  }
}

// the table's bytes in shared memory, and the block's static reduction
// buffer, which counts against the same limit
inline size_t table_bytes(int N) {
  return sizeof(float) * F_AA * static_cast<size_t>(N);
}
constexpr size_t kRedBytes = sizeof(float) * kAoThreads;

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
  return launch_table(ao_fused_kernel<true>, ao_fused_kernel<false>,
                      table_bytes(n_rects), 0, kRedBytes,
                      capped_blocks(n_texels, 1), kAoThreads, static_cast<cudaStream_t>(stream), scene,
                      centers, wall_ids, dirs, fac, sums, n_rects, g0, g1, g2,
                      n_texels, k_pad, sky);
}

// What fm_ao_fused launches for n_rects rects on the current device
// (table_plan): in_smem, shared bytes, registers, blocks per SM. No launch,
// no stream. Returns the CUDA error code.
extern "C" int fm_ao_fused_plan(int n_rects, int* in_smem, int* shared_bytes,
                                int* registers, int* blocks_per_sm) {
  return table_plan(ao_fused_kernel<true>, ao_fused_kernel<false>,
                    table_bytes(n_rects), 0, kRedBytes, kAoThreads, in_smem,
                    shared_bytes, registers, blocks_per_sm);
}
