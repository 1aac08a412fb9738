// Stream splats: sum a deposit stream (texel id [R] int32, color [R, 3]
// f32) into a [T, 3] f32 lightmap increment, one thread per stream row.
//
// Replaces the TPU kernels of flatmatch_tpu/ops/splat_pallas.py, whose
// one-hot MXU contraction it does not copy; it computes what they compute:
//   - fused_splat_i8 (:145, kernel :105): each color quantized to the 7-bit
//     grid, clip(floor(c * inv_s + dither01(row * 3 + ch)), 0, 127), summed
//     exactly into an int32 accumulator by integer atomicAdd, then de-scaled
//     once (acc * scale). Integer sums do not depend on order, so the
//     result equals the JAX package's bit for bit;
//   - fused_splat (:219, kernel :73): each color rounded to bf16 once
//     (round to nearest even, as astype(bfloat16)), summed in f32. With
//     kBf16 = false the colors stay f32: the `scatter` and `bucket_exact`
//     modes of engines/photon_pallas_wide._splat (:1541, ops/splat.py:88).
// The f32 sum is deterministic, with no float atomics: each color becomes a
// 64-bit fixed-point integer at a power-of-two scale 2^k chosen by the
// wrapper (ops/splat.py) so that no texel's sum can pass 2^62, the integers
// are summed by 64-bit atomicAdd, and each texel is converted to f32 once.
// Integer addition does not depend on order, so two runs give the same bits
// (add_fixed and fixed_to_f32_kernel, trace_wide.cuh). At the engine's k
// (37 for 131072-photon batches of 8 bounces and colors up to 18) every
// color above 2^-14 converts exactly, so the sum is the
// exact sum rounded once to f32: closer to it than any f32 order.
// Ids outside [0, T) are skipped, as the JAX one-hot drops them; zero
// colors are skipped.
//
// What bounds them on an H100: the atomics. The bytes are R * 16 read and
// T * 3 * (4 or 8) of accumulator, a few microseconds at 3.35 TB/s per
// 131072-photon batch; the up to 3R atomics land in L2 and serialize on the
// texels that many deposits share. Privatizing the accumulator in shared
// memory would cut that contention on small scenes and is left for a later
// change.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (see
// flatmatch_tpu_torch/utils/cuda_build.py).
#include "trace_wide.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
fused_splat_i8_kernel(const int* __restrict__ idx,
                      const float* __restrict__ col, int rows, int num_texels,
                      float inv_s, int* __restrict__ acc) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int t = idx[r];
  if (static_cast<unsigned>(t) >= static_cast<unsigned>(num_texels)) return;
  // dither01 keys row * 3 + ch, in int32 wrap arithmetic
  const uint32_t key = static_cast<uint32_t>(r) * 3u;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const int q = quant(col[3 * static_cast<size_t>(r) + ch], inv_s,
                        key + static_cast<uint32_t>(ch));
    if (q) atomicAdd(acc + 3 * t + ch, q);
  }
}

__global__ void __launch_bounds__(kThreads)
descale_kernel(const int* __restrict__ acc, int n, float scale,
               float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = static_cast<float>(acc[i]) * scale;
}

// add_fixed (trace_wide.cuh) is the per-color sum the in-kernel f32 splat
// (splat_f32) shares, so both add the same integers for the same deposit.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
fused_splat_kernel(const int* __restrict__ idx, const float* __restrict__ col,
                   int rows, int num_texels, float to_fixed,
                   unsigned long long* __restrict__ acc) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int t = idx[r];
  if (static_cast<unsigned>(t) >= static_cast<unsigned>(num_texels)) return;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    add_fixed<kBf16>(acc + 3 * t + ch, col[3 * static_cast<size_t>(r) + ch],
                     to_fixed);
}

}  // namespace

// C entry points, loaded with ctypes. Each zeroes its accumulator, splats
// `rows` rows and writes the f32 [num_texels, 3] increment `out` on
// `stream`, and returns the CUDA error code (0 on success).
//
// acc: int32 [num_texels, 3] scratch; out = acc * scale.
extern "C" int fm_fused_splat_i8(const int* idx, const float* col, int* acc,
                                 float* out, int rows, int num_texels,
                                 float inv_s, float scale, void* stream) {
  if (num_texels <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = 3 * num_texels;
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(int) * n, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows > 0) {
    fused_splat_i8_kernel<<<blocks_for(rows), kThreads, 0, s>>>(
        idx, col, rows, num_texels, inv_s, acc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  descale_kernel<<<blocks_for(n), kThreads, 0, s>>>(acc, n, scale, out);
  return static_cast<int>(cudaGetLastError());
}

// acc: int64 [num_texels, 3] scratch; colors are rounded to bf16 first when
// round_bf16 != 0; to_fixed = 2^k, from_fixed = 2^-k.
extern "C" int fm_fused_splat(const int* idx, const float* col,
                              long long* acc, float* out, int rows,
                              int num_texels, int round_bf16, float to_fixed,
                              float from_fixed, void* stream) {
  if (num_texels <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = 3 * num_texels;
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(long long) * n, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows > 0) {
    auto* a = reinterpret_cast<unsigned long long*>(acc);
    if (round_bf16) {
      fused_splat_kernel<true><<<blocks_for(rows), kThreads, 0, s>>>(
          idx, col, rows, num_texels, to_fixed, a);
    } else {
      fused_splat_kernel<false><<<blocks_for(rows), kThreads, 0, s>>>(
          idx, col, rows, num_texels, to_fixed, a);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return launch_fixed_to_f32(acc, n, nullptr, from_fixed, out, s);
}
