// Nearest front-face hit of rays over a scene of any orientation: one
// thread per ray, every rect of the general table, the running minimum
// and its column. The general engines' intersector: the photon engine of
// `--engine photon_xla` and of 2^24-texel arenas (engines/photon.py), the
// general AO (engines/ao_general.py), the general form factors of
// radiosity, the general differentiable renderer and the debug picture
// all reach it through ops/intersect.nearest_hit.
//
// Replaces flatmatch_tpu/ops/intersect.py intersect_all (:41) followed by
// nearest_hit (:74): in the JAX package one XLA fusion over [B, N] tiles
// (every ray against every rect, then a min and an argmin over the rect
// axis). Here a ray is a thread and no [B, N] tensor is made.
//
// Every output bit is the plain version's (ops/intersect.nearest_hit_plain,
// the same function in [B, N] torch ops), rect by rect:
//   - each dot product is three products summed left to right,
//     (a0 * b0 + a1 * b1) + a2 * b2, every product and sum rounded on its
//     own (-fmad=false), as torch's broadcast products and adds are;
//   - fac = (n_off - dot(src, n)) / denom, an IEEE division (div.rn);
//   - dx = (dot(src, w) + fac * dot(dir, w)) - off_w, where off_w =
//     dot(w_unit, pos) is computed once per rect by the plain version's own
//     expression (`_offset`) when the table is built; dy the same along h;
//   - valid = denom < 0 && fac >= 0 && dx >= 0 && dx <= wlen && dy >= 0 &&
//     dy <= hlen, a compare chain, false on NaN (0/0 on a parallel ray);
//   - the minimum is kept with a strict `<` from +inf and column 0, so ties
//     and the all-miss case give the first column, as torch.argmin does.
// The loop runs over the table's real rects; the 128-row padding of
// pack_rects has zero normals (denom = 0 fails denom < 0) and never wins,
// so leaving it out changes no bit.
//
// Design (a first one that is right): the table is four 16-byte records a
// rect, {n, n_off}, {w_unit, wlen}, {h_unit, hlen}, {off_w, off_h, 0, 0},
// 64 bytes a rect. Each block stages it in shared memory once and strides
// over the rays (capped_blocks), so a rect test reads four broadcasts; the
// loop is branch-free and unrolled by kUnroll. Tables past a block's shared
// memory (3,632 rects: rotated 13x13's extended rects) take the
// device-memory instance, which reads the same records where they lie
// (L1 and L2); launch_table chooses the instance in one place and
// fm_general_nearest_plan reports it.
//
// What bounds it on an H100: the instructions of the rect loop, every ray
// over all N rects: six dot products (30), the division's fast path (7),
// the two hit-point projections (6), seven compares and two selects
// (chip_smoke.GENERAL_NEAREST_RECT_TEST_INSTRUCTIONS, counted in the SASS
// with tools/sass_loops.py). The bytes (24 in and 8 out a ray) are far
// below that from a few rects on.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (see
// flatmatch_tpu_torch/utils/cuda_build.py).
#include "trace_wide.cuh"

namespace {

// floats a rect in the record table (ops/intersect.general_table)
constexpr int kRecordFloats = 16;

template <bool kSmem>
struct GeneralRects;

// shared-memory instance: the block's staged copy of the records
template <>
struct GeneralRects<true> {
  static constexpr int kUnroll = 4;
  const float4* rec;
  __device__ __forceinline__ void load(int j, float4& a, float4& b,
                                       float4& c, float4& o) const {
    a = rec[4 * j];
    b = rec[4 * j + 1];
    c = rec[4 * j + 2];
    o = rec[4 * j + 3];
  }
};

// device-memory instance: the records where they lie, read through the
// read-only cache
template <>
struct GeneralRects<false> {
  static constexpr int kUnroll = 1;
  const float4* __restrict__ rec;
  __device__ __forceinline__ void load(int j, float4& a, float4& b,
                                       float4& c, float4& o) const {
    a = __ldg(rec + 4 * j);
    b = __ldg(rec + 4 * j + 1);
    c = __ldg(rec + 4 * j + 2);
    o = __ldg(rec + 4 * j + 3);
  }
};

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
general_nearest_kernel(const float* __restrict__ table,
                       const float* __restrict__ src,
                       const float* __restrict__ dir,
                       float* __restrict__ dist, int* __restrict__ hit,
                       int N, int R) {
  extern __shared__ __align__(16) float smem[];
  GeneralRects<kSmem> rects;
  if constexpr (kSmem) {
    float4* rec = reinterpret_cast<float4*>(smem);
    const float4* t = reinterpret_cast<const float4*>(table);
    for (int q = threadIdx.x; q < 4 * N; q += blockDim.x) rec[q] = t[q];
    __syncthreads();
    rects.rec = rec;
  } else {
    rects.rec = reinterpret_cast<const float4*>(table);
  }
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < R; i += stride) {
    const size_t r = 3 * static_cast<size_t>(i);
    const float sx = src[r], sy = src[r + 1], sz = src[r + 2];
    const float dx = dir[r], dy = dir[r + 1], dz = dir[r + 2];
    float best = __int_as_float(0x7f800000);   // +inf
    int bj = 0;
#pragma unroll GeneralRects<kSmem>::kUnroll
    for (int j = 0; j < N; ++j) {
      float4 a, b, c, o;   // {n, n_off}, {w, wlen}, {h, hlen}, {off_w, off_h}
      rects.load(j, a, b, c, o);
      const float denom = dx * a.x + dy * a.y + dz * a.z;
      const float sn = sx * a.x + sy * a.y + sz * a.z;
      const float fac = (a.w - sn) / denom;
      const float sw = sx * b.x + sy * b.y + sz * b.z;
      const float dw = dx * b.x + dy * b.y + dz * b.z;
      const float sh = sx * c.x + sy * c.y + sz * c.z;
      const float dh = dx * c.x + dy * c.y + dz * c.z;
      const float px = (sw + fac * dw) - o.x;
      const float py = (sh + fac * dh) - o.y;
      const bool win = denom < 0.0f && fac >= 0.0f && px >= 0.0f &&
                       px <= b.w && py >= 0.0f && py <= c.w && fac < best;
      best = win ? fac : best;
      bj = win ? j : bj;
    }
    dist[i] = best;
    hit[i] = bj;
  }
}

inline size_t table_bytes(int N) {
  return sizeof(float) * kRecordFloats * static_cast<size_t>(N);
}

}  // namespace

// C entry point, loaded with ctypes. Launches on `stream` and returns the
// CUDA error code of the launch (0 on success). `table` is the
// [n_rects, 16] f32 record table, src and dir [n_rays, 3] f32; dist
// [n_rays] f32 (+inf on a miss) and hit [n_rays] int32 (0 on a miss) are
// written in full.
extern "C" int fm_general_nearest(const float* table, const float* src,
                                  const float* dir, float* dist, int* hit,
                                  int n_rects, int n_rays, void* stream) {
  if (n_rays <= 0) return 0;
  return launch_table(general_nearest_kernel<true>,
                      general_nearest_kernel<false>, table_bytes(n_rects), 0,
                      0, capped_blocks(n_rays, kThreads), kThreads,
                      static_cast<cudaStream_t>(stream), table, src, dir,
                      dist, hit, n_rects, n_rays);
}

// What fm_general_nearest launches for n_rects rects on the current device
// (table_plan): in_smem, shared bytes, registers, blocks per SM. No launch,
// no stream. Returns the CUDA error code.
extern "C" int fm_general_nearest_plan(int n_rects, int* in_smem,
                                       int* shared_bytes, int* registers,
                                       int* blocks_per_sm) {
  return table_plan(general_nearest_kernel<true>,
                    general_nearest_kernel<false>, table_bytes(n_rects), 0,
                    0, kThreads, in_smem, shared_bytes, registers,
                    blocks_per_sm);
}
