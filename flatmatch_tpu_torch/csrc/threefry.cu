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
// need no transposed copy.
//
// What bounds it on an H100: integer operations, 71 an element as the
// compiler emits the function (one add for the counter, 20 rounds of add,
// funnel-shift rotate and xor, the x1 key injections, the last x0
// injection, the xor of the two words, the shift and the conversion; the
// other x0 injections fold into the next round's three-input add), against
// 4 bytes written. The rotates and xors (40 an element) run only on the
// ALU pipe, half the SM's issue rate, so a kernel that spends nothing
// else there still takes 40/64 of a cycle per element and SM lane.
// What the design does about the rest:
//   - the transposed draw gives each thread one photon p (neighbouring
//     threads, neighbouring p: the stores coalesce) and a run of its
//     columns; the counter p * cols + c is formed once and stepped, in 32
//     bits (the wrapper keeps rows * cols under 2^31, so its high word is
//     0): no 64-bit division per element;
//   - the flat draw indexes in 32 bits, the counter's high word fixed per
//     launch: the entry point cuts a draw past 2^31 elements into launches
//     of 2^31, whose low words then never wrap;
//   - the float is bitcast((bits >> 9) | 0x3f800000) - 1, exactly
//     (bits >> 9) * 2^-23 (both in [1, 2) before the subtraction, which is
//     exact), with no integer-to-float conversion;
//   - the key schedule is formed once per thread, and the grids are whole
//     waves of 8 blocks of 256 threads a SM (2,048 threads): one for the
//     transposed draw, its columns split over y to fill it, four for the
//     flat draw's grid-stride loop (one wave was 1% slower there).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (see
// flatmatch_tpu_torch/utils/cuda_build.py).
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm_count.cuh"

namespace {

constexpr int kTfThreads = 256;
constexpr int kTfBlocksPerSm = 8;
constexpr int kTfFlatWaves = 4;
constexpr long long kTfChunk = 1LL << 31;   // elements of one flat launch

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// The key schedule of threefry2x32: the words added after each group of
// four rounds, the round number folded into x1's.
struct Keys {
  uint32_t k0, k1, inj0[5], inj1[5];

  __device__ __forceinline__ Keys(uint32_t a, uint32_t b) : k0(a), k1(b) {
    const uint32_t ks[3] = {a, b, a ^ b ^ 0x1BD11BDAu};
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      inj0[i] = ks[(i + 1) % 3];
      inj1[i] = ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
    }
  }
};

// element (hi, lo) of the draw of `k`, as a float in [0, 1)
__device__ __forceinline__ float uniform_at(const Keys& k, uint32_t hi,
                                            uint32_t lo) {
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = hi + k.k0;
  uint32_t x1 = lo + k.k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, kRot[i % 2][j]) ^ x0;
    }
    x0 += k.inj0[i];
    x1 += k.inj1[i];
  }
  return __uint_as_float(((x0 ^ x1) >> 9) | 0x3f800000u) - 1.0f;
}

// out[j] = element (hi, lo0 + j) of the draw, j < m <= 2^31 (lo0 is 0 or
// 2^31, so lo0 + j does not wrap)
__global__ void __launch_bounds__(kTfThreads)
uniform_kernel(uint32_t k0, uint32_t k1, uint32_t hi, uint32_t lo0,
               uint32_t m, float* __restrict__ out) {
  const Keys k(k0, k1);
  const uint32_t stride = gridDim.x * kTfThreads;
  for (uint32_t j = blockIdx.x * kTfThreads + threadIdx.x; j < m;
       j += stride) {
    out[j] = uniform_at(k, hi, lo0 + j);
  }
}

// out [cols, rows]: out[c * rows + p] = u[p * cols + c], rows * cols <
// 2^31. Thread (p, blockIdx.y) writes photon p's columns [c0, c1).
__global__ void __launch_bounds__(kTfThreads)
uniform_t_kernel(uint32_t k0, uint32_t k1, int rows, int cols, int per,
                 float* __restrict__ out) {
  const Keys k(k0, k1);
  const int c0 = blockIdx.y * per;
  const int c1 = min(cols, c0 + per);
  for (int p = blockIdx.x * kTfThreads + threadIdx.x; p < rows;
       p += gridDim.x * kTfThreads) {
    const uint32_t ctr = static_cast<uint32_t>(p) * cols;
    float* o = out + static_cast<size_t>(c0) * rows + p;
    for (int c = c0; c < c1; ++c, o += rows) {
      *o = uniform_at(k, 0u, ctr + static_cast<uint32_t>(c));
    }
  }
}

// blocks of one wave on this device, or -1 on a CUDA error
int wave_blocks() {
  const int sms = sm_count();
  return sms > 0 ? sms * kTfBlocksPerSm : -1;
}

}  // namespace

// C entry points, loaded with ctypes. Each writes its draw on `stream` and
// returns the CUDA error code of the launch (0 on success).
//
// out [n] f32: the flat draw of key (k0, k1).
extern "C" int fm_threefry_uniform(uint32_t k0, uint32_t k1, long long n,
                                   float* out, void* stream) {
  if (n <= 0) return 0;
  const int wave = wave_blocks();
  if (wave <= 0) return sm_count_error();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (long long start = 0; start < n; start += kTfChunk) {
    const long long m = n - start < kTfChunk ? n - start : kTfChunk;
    const long long want = (m + kTfThreads - 1) / kTfThreads;
    const long long most = static_cast<long long>(kTfFlatWaves) * wave;
    const int blocks = static_cast<int>(want < most ? want : most);
    uniform_kernel<<<blocks, kTfThreads, 0, s>>>(
        k0, k1, static_cast<uint32_t>(start >> 32),
        static_cast<uint32_t>(start), static_cast<uint32_t>(m), out + start);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// out [cols, rows] f32: the [rows, cols] draw of key (k0, k1), transposed.
extern "C" int fm_threefry_uniform_t(uint32_t k0, uint32_t k1, int rows,
                                     int cols, float* out, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if (static_cast<long long>(rows) * cols >= kTfChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int wave = wave_blocks();
  if (wave <= 0) return sm_count_error();
  // photons across x, whole waves; the columns split over y into as many
  // runs as fill the rest of a wave
  const int bx = (rows + kTfThreads - 1) / kTfThreads < wave
                     ? (rows + kTfThreads - 1) / kTfThreads
                     : wave;
  int groups = wave / bx;
  groups = groups < 1 ? 1 : (groups > cols ? cols : groups);
  const int per = (cols + groups - 1) / groups;
  groups = (cols + per - 1) / per;
  uniform_t_kernel<<<dim3(bx, groups), kTfThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(k0, k1, rows, cols,
                                                          per, out);
  return static_cast<int>(cudaGetLastError());
}
