// jax.random.uniform's threefry draws, bit for bit: element i of the draw of
// key (k0, k1) is
//   (b0, b1) = threefry2x32((k0, k1), (i >> 32, i & 0xffffffff)),
//   u[i]     = ((b0 ^ b1) >> 9) * 2^-23,
// the partitionable random bits (jax_threefry_partitionable) turned into a
// float in [0, 1) as jax.random.uniform turns them (bitcast(bits >> 9 |
// 0x3f800000) - 1 is exactly (bits >> 9) * 2^-23). threefry2x32 is 20
// rounds over the rotations (13, 15, 26, 6) and (17, 29, 16, 24), with a
// key injection after every 4 (jax/_src/prng.py _threefry2x32_lowering;
// flatmatch_tpu_torch/ops/threefry.py threefry2x32 is the plain version).
//
// No Pallas kernel of the JAX package does this: jax.random runs it in XLA.
// It is the port's own kernel for what the JAX package draws with
// jax.random.uniform on the photon routes without the device RNG
// (engines/photon_pallas_wide.py:1692-1693, diff/render.py:393-395) and in
// the radiosity form factors (engines/radiosity.py:89), where the plain
// version's int64 torch ops took 4.4-6.1 ms per 131072-photon batch.
//
// Two layouts: the flat draw ([n], any shape the caller reshapes it to),
// and a [rows, cols] draw written transposed as [cols, rows], so that
// out[c * rows + p] = u[p * cols + c]: the [U, B] layout that the
// uniforms-in trace kernels read (UniformDraw, trace_wide.cuh), which then
// need no transposed copy. Each thread computes whole elements: uint32
// arithmetic, the rotations as funnel shifts, the element index in 64 bits
// so that its high word is right past 2^32 elements.
//
// What bounds it on an H100: integer operations, about 80 per element (20
// rounds of add, rotate and xor, the injections, the conversion) against
// 4 bytes written per element.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (see
// flatmatch_tpu_torch/utils/cuda_build.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTfThreads = 256;
constexpr int kTfMaxBlocks = 4096;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// One threefry2x32 block: (x0, x1) <- threefry2x32((k0, k1), (x0, x1)).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, kRot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// element i of the draw of (k0, k1), as a float in [0, 1)
__device__ __forceinline__ float uniform_at(uint32_t k0, uint32_t k1,
                                            unsigned long long i) {
  uint32_t x0 = static_cast<uint32_t>(i >> 32);
  uint32_t x1 = static_cast<uint32_t>(i);
  threefry2x32(k0, k1, x0, x1);
  return __uint2float_rn((x0 ^ x1) >> 9) * (1.0f / 8388608.0f);
}

__global__ void __launch_bounds__(kTfThreads)
uniform_kernel(uint32_t k0, uint32_t k1, long long n,
               float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    out[i] = uniform_at(k0, k1, static_cast<unsigned long long>(i));
  }
}

// out [cols, rows]: out[c * rows + p] = u[p * cols + c]; neighbouring
// threads write neighbouring p
__global__ void __launch_bounds__(kTfThreads)
uniform_t_kernel(uint32_t k0, uint32_t k1, int rows, int cols,
                 float* __restrict__ out) {
  const long long n = static_cast<long long>(rows) * cols;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long o = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       o < n; o += stride) {
    const long long c = o / rows;
    const long long p = o - c * rows;
    out[o] = uniform_at(k0, k1,
                        static_cast<unsigned long long>(p * cols + c));
  }
}

int blocks_of(long long n) {
  const long long want = (n + kTfThreads - 1) / kTfThreads;
  return static_cast<int>(want < kTfMaxBlocks ? want : kTfMaxBlocks);
}

}  // namespace

// C entry points, loaded with ctypes. Each writes its draw on `stream` and
// returns the CUDA error code of the launch (0 on success).
//
// out [n] f32: the flat draw of key (k0, k1).
extern "C" int fm_threefry_uniform(uint32_t k0, uint32_t k1, long long n,
                                   float* out, void* stream) {
  if (n <= 0) return 0;
  uniform_kernel<<<blocks_of(n), kTfThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(k0, k1, n, out);
  return static_cast<int>(cudaGetLastError());
}

// out [cols, rows] f32: the [rows, cols] draw of key (k0, k1), transposed.
extern "C" int fm_threefry_uniform_t(uint32_t k0, uint32_t k1, int rows,
                                     int cols, float* out, void* stream) {
  const long long n = static_cast<long long>(rows) * cols;
  if (rows <= 0 || cols <= 0) return 0;
  uniform_t_kernel<<<blocks_of(n), kTfThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(k0, k1, rows, cols,
                                                          out);
  return static_cast<int>(cudaGetLastError());
}
