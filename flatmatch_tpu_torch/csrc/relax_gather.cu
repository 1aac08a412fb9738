// The radiosity relaxation's gather: for every row r of the form-factor id
// table [rows, rays] int32,
//   dest[r] = sum_j src[ids[r, j]]   (an id of -1, a ray that escaped,
//                                     adds zero),
// over the arena src [total, 3] f32, handed in as a float4 copy
// [total + 1, 4] whose row `total` is zero (ops/relax_gather.py builds it).
//
// It replaces no TPU kernel: the JAX package gathers in XLA
// (flatmatch_tpu/engines/radiosity.py _gather_chunk, :176). The port's
// plain version (ops/relax_gather.relax_gather_plain) chains PyTorch's
// index, where and sum over steps of 2^22 ids, which at the product's
// 85,056 x 10,000 table made about 50 GB of intermediates an iteration.
//
// What bounds it on an H100: the id table, 4 bytes an id read once from
// device memory (3.40 GB an iteration on the product's scene, 1.02 ms at
// 3.35 TB/s); the arena (113,964 texels and the windows' and lights', 1.8
// MB as float4) stays in L2, but every id is a random 16-byte read of it,
// one L2 sector request an id, and those requests, not the bytes, are the
// practical limit. What the design does about each:
//   - the ids stream through once as 16-byte int4 loads, neighbouring
//     threads on neighbouring int4s of a row, marked evict-first
//     (__ldcs), so the table does not push the arena out of L2; a row
//     that does not start on 16 bytes takes its first ids, and one whose
//     length is not a multiple of 4 its last, as scalar loads;
//   - each id is one aligned 16-byte read of the padded arena through the
//     read-only path (__ldg), so repeated texels hit in L1; a miss is
//     min(unsigned(id), total), the zero row: no branch, no select of a
//     value, and no id can read past the arena;
//   - each thread keeps two int4s (eight gathers) in flight before it
//     adds, to cover the L2's latency;
//   - a block of 256 threads a row: at the product's 10,000 rays each
//     thread streams about ten int4s. 32, 64 and 128 threads a row were
//     measured too and were no faster at any shape the program runs
//     (2,500 to 10,000 rays), so there is one instance;
//   - the sums are deterministic: each thread adds its ids in a fixed
//     order, a fixed shuffle tree sums a warp, and one thread adds a
//     row's warps in order from shared memory. No float atomics, so two
//     launches on the same inputs give the same bits.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (see
// flatmatch_tpu_torch/utils/cuda_build.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRgThreads = 256;

__device__ __forceinline__ void add_texel(const float4* __restrict__ src,
                                          unsigned miss, int id, float& x,
                                          float& y, float& z) {
  const float4 v = __ldg(src + min(static_cast<unsigned>(id), miss));
  x += v.x;
  y += v.y;
  z += v.z;
}

__device__ __forceinline__ void add_four(const float4* __restrict__ src,
                                         unsigned miss, int4 q, float& x,
                                         float& y, float& z) {
  add_texel(src, miss, q.x, x, y, z);
  add_texel(src, miss, q.y, x, y, z);
  add_texel(src, miss, q.z, x, y, z);
  add_texel(src, miss, q.w, x, y, z);
}

// a block a row
__global__ void __launch_bounds__(kRgThreads)
relax_gather_kernel(const float4* __restrict__ src,
                    const int* __restrict__ ids, float* __restrict__ dest,
                    int rays, unsigned miss) {
  constexpr int kWarps = kRgThreads / 32;
  const int t = threadIdx.x;
  const long long r = blockIdx.x;
  const int* row = ids + r * rays;
  // ids before the first 16-byte boundary, the int4s, the ids after
  const int head = min(
      rays,
      static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(row) & 15u))
                        & 15u) >> 2));
  const int body = (rays - head) >> 2;
  const int tail = head + 4 * body;
  const int4* vec = reinterpret_cast<const int4*>(row + head);
  float x = 0.0f, y = 0.0f, z = 0.0f;
  if (t < head) add_texel(src, miss, __ldcs(row + t), x, y, z);
  int v = t;
  for (; v + kRgThreads < body; v += 2 * kRgThreads) {
    const int4 a = __ldcs(vec + v);
    const int4 b = __ldcs(vec + v + kRgThreads);
    add_four(src, miss, a, x, y, z);
    add_four(src, miss, b, x, y, z);
  }
  if (v < body) add_four(src, miss, __ldcs(vec + v), x, y, z);
  if (t < rays - tail) add_texel(src, miss, __ldcs(row + tail + t), x, y, z);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_down_sync(0xffffffffu, x, off);
    y += __shfl_down_sync(0xffffffffu, y, off);
    z += __shfl_down_sync(0xffffffffu, z, off);
  }
  __shared__ float part[kWarps][3];
  if ((t & 31) == 0) {
    part[t / 32][0] = x;
    part[t / 32][1] = y;
    part[t / 32][2] = z;
  }
  __syncthreads();
  if (t == 0) {
    for (int k = 1; k < kWarps; ++k) {
      x += part[k][0];
      y += part[k][1];
      z += part[k][2];
    }
    dest[3 * r] = x;
    dest[3 * r + 1] = y;
    dest[3 * r + 2] = z;
  }
}

}  // namespace

// C entry point, loaded with ctypes. src4 [total + 1, 4] f32 (row `total`
// zero), ids [rows, rays] int32, dest [rows, 3] f32, all on the current
// device. Launches on `stream` and returns the CUDA error code of the
// launch (0 on success).
extern "C" int fm_relax_gather(const float* src4, const int* ids,
                               float* dest, int rows, int rays, int total,
                               void* stream) {
  if (rows <= 0) return 0;
  if (rays < 0 || total < 0) return static_cast<int>(cudaErrorInvalidValue);
  relax_gather_kernel<<<rows, kRgThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(src4), ids, dest, rays,
      static_cast<unsigned>(total));
  return static_cast<int>(cudaGetLastError());
}
