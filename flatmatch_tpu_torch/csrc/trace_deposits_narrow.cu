// General-orientation photon trace: the photon render of scenes that the
// axis-aligned table cannot hold (a rect whose axes are not x, y and z),
// one launch per photon batch, writing every bounce's deposit (texel id,
// rgb) for a separate splat (ops/splat.scatter_splat).
//
// Replaces the TPU kernel flatmatch_tpu/engines/photon_pallas.py
// trace_deposits_pallas (:299, body _make_kernel :109-293), with the
// draws read from the batch's threefry uniforms (UniformDraw, trace_wide.cuh:
// the [U, B] transpose that ops/threefry.batch_uniforms(..., transposed=True)
// draws). Emission and the bounce after a hit are trace_wide.cuh's
// emit_photon and bounce_in, the axis-aligned kernels' own code.
//
// The TPU kernel works on [TB, N] tiles: every photon of a block against
// every rect at once, then a row min, then the winner's fields by exact
// one-hot masked row sums (an MXU gather would round them to bf16), with
// the texel id computed in every lane. Here one thread traces one photon:
// each of its max_depth bounces loops over the N real rects (not the
// 128-row padding of pack_rects, whose zero normals never win) and keeps
// the nearest hit's distance and column; the winner's texel id comes once,
// after the loop.
//
// Parity with the TPU kernel, rect by rect:
//   - the hit point form: fac = (n_off - dot(p, n)) / denom as an IEEE
//     division (no reciprocal), h = p + dir * fac, then the projections of
//     (h - rect.pos) on the unit spans, each sum left to right;
//   - the bounds test: the TPU kernel writes min(min(fac, pdx), min(wlen -
//     pdx, min(pdy, hlen - pdy))) >= 0 and relies on jnp.minimum keeping
//     NaN (rays parallel to a rect give 0/0). fminf drops NaN, so this is
//     a compare chain, false on NaN as the min-tree is;
//   - misses are the sentinel 1e30 and a hit is a distance below 0.5e30;
//     the rect loop runs in column order with a strict `<`, so ties go to
//     the first column, as the TPU kernel's first-min one-hot does;
//   - the texel id: tx = min(floor(pdx * wt / wlen), wt - 1) (no lower
//     clip: the winner has pdx >= 0), the same for ty, from the
//     projections at fac, base + ty * wt + tx. The TPU kernel sums that in
//     f32, exact below 2^24 (scene_matrix refuses larger arenas), so int32
//     arithmetic gives the same id;
//   - the basis of a rotated normal: trace_wide.cuh's build_base divides by
//     sqrtf (IEEE-rounded), as the port's plain versions do; the TPU kernel
//     multiplies by rsqrt, which is not correctly rounded on any of the
//     devices. Axis-aligned normals have unit length, so either way is
//     exact there; on rotated normals the two may differ by an ulp.
// Dead photons (p >= n_valid), the bounce that misses and every bounce
// after it write id 0 and color 0, as the TPU kernel's alive mask does.
//
// Design on Hopper. Every traced bounce tests every rect, so on a scene of
// hundreds of rects the rect loop takes the time, bound by the
// instructions it issues; on a small scene the per-bounce work and the
// stores do. So (PERF.md has the ablation behind each choice):
//   - each block stages the [18, N] table as four 16-byte records a rect,
//     {n, n_off}, {pos, wlen}, {w_unit, hlen}, {h_unit, base}, and the wt
//     and ht rows: a rect test reads four shared-memory broadcasts, where
//     the rows take fifteen scalar loads (72 bytes a rect either way);
//   - the loop keeps only the running minimum and its column, with
//     selects, unrolled (GenRects::kUnroll), with no branch: the division
//     and the projections run for every rect, as the compare chain (denom
//     < 0 first) needs them. Skipping them where denom < 0 fails keeps
//     every bit, but the branch costs more than it saves: a warp's lanes
//     rarely agree. The division stays div.rn under -fmad=false. The
//     winner's projections are recomputed after the loop from the same
//     floats at fac = best;
//   - a bounce's uniforms are loaded before its rect loop, which hides the
//     load;
//   - the deposits are staged in shared memory, a warp's 32 photons at a
//     time (kGroup), then stored as 16-byte vectors, neighbouring threads
//     on neighbouring addresses: the outputs are photon-major, so a direct
//     store of one bounce's id strides 32 bytes between threads, and of
//     its color 96 bytes. The staging (16 bytes a photon and bounce) takes
//     shared memory from the table's blocks, so the launcher stages only
//     where that costs no block a SM (mini: yes; the 4x4 tiling's 432
//     rects: no), else each thread stores its deposits where they lie.
// Device-memory instance (tables past shared memory): the same loop on
// the rows read field by field where they lie (L1 and L2), not unrolled,
// the deposits stored directly, so that all of the SM's shared memory is
// left to the L1 that holds the table. Each output bit is what the
// rect-at-a-time loop of the first port gives.
//
// Outputs in the TPU kernel's layout: idx [B, D] int32 and col [B, 3D] f32,
// photon-major. What bounds it on an H100: the instructions of the rect
// loop, 48 a rect test that no implementation under -fmad=false can do
// without (17 FADD, 15 FMUL, the division's 7, 7 compares, 2 selects;
// chip_smoke.GENERAL_RECT_TEST_INSTRUCTIONS), and then 4 * U bytes of
// uniforms read and 16 bytes per bounce written per photon.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (see
// flatmatch_tpu_torch/utils/cuda_build.py).
#include "trace_wide.cuh"

namespace {

// rows of the [F_GEN, N] table (photon_pallas.py:41-51, scene_matrix)
enum { G_POS = 0, G_N = 3, G_WU = 6, G_HU = 9, G_WLEN = 12, G_HLEN = 13,
       G_NOFF = 14, G_BASE = 15, G_WT = 16, G_HT = 17, F_GEN = 18 };

// photons whose deposits are staged and stored together (one warp)
constexpr int kGroup = 32;

// Bytes of shared memory that stage a block's deposits: 4 * D ints and
// floats a photon.
inline size_t staging_bytes(int max_depth) {
  return sizeof(float) * 4 * static_cast<size_t>(max_depth) * kThreads;
}

template <bool kSmem>
struct GenRects;

// Shared-memory instance: rec[4j .. 4j + 3] = {n, n_off}, {pos, wlen},
// {w_unit, hlen}, {h_unit, base}, then the wt and ht rows.
template <>
struct GenRects<true> {
  // rect tests per step of the unrolled loop (on an H100, 8 measured
  // fastest on rotated mini and the rotated 4x4 tiling against 1, 2 and 4)
  static constexpr int kUnroll = 8;
  const float4* rec;
  const float* tex;   // [2][N]: wt, ht
  int n;

  __device__ __forceinline__ void loop(int j, float4& a, float4& b,
                                       float4& c, float4& h) const {
    a = rec[4 * j];
    b = rec[4 * j + 1];
    c = rec[4 * j + 2];
    h = rec[4 * j + 3];
  }
  __device__ __forceinline__ float wt(int j) const { return tex[j]; }
  __device__ __forceinline__ float ht(int j) const { return tex[n + j]; }
};

// Device-memory instance: the [F_GEN, N] rows where they lie, not unrolled
// (on an H100, unrolling by 2 took 64 registers and spilled, and was 10%
// slower on rotated 13x13).
template <>
struct GenRects<false> {
  static constexpr int kUnroll = 1;
  const float* __restrict__ s;
  int n;

  __device__ __forceinline__ float f(int row, int j) const {
    return __ldg(s + row * n + j);
  }
  __device__ __forceinline__ void loop(int j, float4& a, float4& b,
                                       float4& c, float4& h) const {
    a = make_float4(f(G_N, j), f(G_N + 1, j), f(G_N + 2, j), f(G_NOFF, j));
    b = make_float4(f(G_POS, j), f(G_POS + 1, j), f(G_POS + 2, j),
                    f(G_WLEN, j));
    c = make_float4(f(G_WU, j), f(G_WU + 1, j), f(G_WU + 2, j), f(G_HLEN, j));
    h = make_float4(f(G_HU, j), f(G_HU + 1, j), f(G_HU + 2, j), f(G_BASE, j));
  }
  __device__ __forceinline__ float wt(int j) const { return f(G_WT, j); }
  __device__ __forceinline__ float ht(int j) const { return f(G_HT, j); }
};

// Stage the table as GenRects<true> reads it into `recs` (18 N floats,
// 16-byte aligned); all threads of the block call it, and it ends in a
// barrier.
__device__ __forceinline__ GenRects<true> stage_records(
    float* recs, const float* __restrict__ t, int n) {
  float4* rec = reinterpret_cast<float4*>(recs);
  float* tex = recs + 16 * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    rec[4 * j] = make_float4(t[G_N * n + j], t[(G_N + 1) * n + j],
                             t[(G_N + 2) * n + j], t[G_NOFF * n + j]);
    rec[4 * j + 1] = make_float4(t[G_POS * n + j], t[(G_POS + 1) * n + j],
                                 t[(G_POS + 2) * n + j], t[G_WLEN * n + j]);
    rec[4 * j + 2] = make_float4(t[G_WU * n + j], t[(G_WU + 1) * n + j],
                                 t[(G_WU + 2) * n + j], t[G_HLEN * n + j]);
    rec[4 * j + 3] = make_float4(t[G_HU * n + j], t[(G_HU + 1) * n + j],
                                 t[(G_HU + 2) * n + j], t[G_BASE * n + j]);
    tex[j] = t[G_WT * n + j];
    tex[n + j] = t[G_HT * n + j];
  }
  __syncthreads();
  return GenRects<true>{rec, tex, n};
}

// dst[0, words) = src[0, words) by the kGroup threads of a group (lane =
// its index there): 16-byte vectors where dst is 16-byte aligned (src, in
// shared memory, always is), then the remaining words one a thread.
__device__ __forceinline__ void store_group(void* dst, const void* src,
                                            int words, int lane) {
  int from = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int quads = words / 4;
    int4* d4 = static_cast<int4*>(dst);
    const int4* s4 = static_cast<const int4*>(src);
    for (int q = lane; q < quads; q += kGroup) d4[q] = s4[q];
    from = 4 * quads;
  }
  int* d = static_cast<int*>(dst);
  const int* s = static_cast<const int*>(src);
  for (int w = from + lane; w < words; w += kGroup) d[w] = s[w];
}

// kSmem: the table in shared memory (GenRects); kStaged: the deposits
// staged there too (only with kSmem), else stored where they lie.
template <bool kSmem, bool kStaged>
__global__ void __launch_bounds__(kThreads)
trace_deposits_narrow_kernel(const float* __restrict__ scene,
                             const float* __restrict__ em,
                             const float* __restrict__ u_t, const Params P,
                             int batch, int* __restrict__ idx,
                             float* __restrict__ col) {
  static_assert(kSmem || !kStaged, "the staging needs the table's block");
  extern __shared__ __align__(16) float smem[];
  const int N = P.n_rects;
  const int D = P.max_depth;
  // kStaged: ids [kThreads][D], then colors [kThreads][3D], then the
  // records; else the records alone
  int* stage_idx = reinterpret_cast<int*>(smem);
  float* stage_col = smem + kThreads * D;
  GenRects<kSmem> R;
  if constexpr (kSmem) {
    R = stage_records(kStaged ? smem + 4 * kThreads * D : smem, scene, N);
  } else {
    R = GenRects<false>{scene, N};
  }

  const int t = threadIdx.x;
  const int p = blockIdx.x * kThreads + t;
  if (!kStaged && p >= batch) return;
  int* out_idx = kStaged ? stage_idx + t * D
                         : idx + static_cast<size_t>(p) * D;
  float* out_col = kStaged ? stage_col + t * 3 * D
                           : col + static_cast<size_t>(p) * 3 * D;
  int done = 0;
  if (p < P.n_valid) {
    const UniformDraw draws{u_t, batch, p};
    float px, py, pz, dirx, diry, dirz, cr, cg, cb;
    emit_photon(em, P, draws, px, py, pz, dirx, diry, dirz, cr, cg, cb);
    for (int d = 0; d < D; ++d) {
      const auto bd = bounce_draws(draws, d);   // before the rect loop
      // --- nearest hit over all rects (rectangle.c:67-95) ----------------
      float best = kMiss;
      int bj = 0;
#pragma unroll GenRects<kSmem>::kUnroll
      for (int j = 0; j < N; ++j) {
        float4 a, b, c, h;  // {n, n_off}, {pos, wlen}, {wu, hlen}, {hu, base}
        R.loop(j, a, b, c, h);
        const float denom = dirx * a.x + diry * a.y + dirz * a.z;
        const float pn = px * a.x + py * a.y + pz * a.z;
        const float fac = (a.w - pn) / denom;
        const float ex = px + dirx * fac - b.x;
        const float ey = py + diry * fac - b.y;
        const float ez = pz + dirz * fac - b.z;
        const float pdx = ex * c.x + ey * c.y + ez * c.z;
        const float pdy = ex * h.x + ey * h.y + ez * h.z;
        const bool hit = denom < 0.0f && fac >= 0.0f && pdx >= 0.0f &&
                         b.w - pdx >= 0.0f && pdy >= 0.0f &&
                         c.w - pdy >= 0.0f && fac < best;
        best = hit ? fac : best;
        bj = hit ? j : bj;
      }
      if (!(best < kHitBelow)) break;

      // the winner: its projections at fac = best, from the same floats
      float4 a, b, c, h;
      R.loop(bj, a, b, c, h);
      const float ex = px + dirx * best - b.x;
      const float ey = py + diry * best - b.y;
      const float ez = pz + dirz * best - b.z;
      const float pdx = ex * c.x + ey * c.y + ez * c.z;
      const float pdy = ex * h.x + ey * h.y + ez * h.z;
      const float wt = R.wt(bj), ht = R.ht(bj);
      const float tx = fminf(floorf(pdx * wt / b.w), wt - 1.0f);
      const float ty = fminf(floorf(pdy * ht / c.w), ht - 1.0f);
      const int btex = static_cast<int>(h.w) +
                       static_cast<int>(ty) * static_cast<int>(wt) +
                       static_cast<int>(tx);
      px = px + dirx * best;
      py = py + diry * best;
      pz = pz + dirz * best;

      // --- Russian roulette + bounce (photonmap.cl:236-254) --------------
      const float hnx = a.x, hny = a.y, hnz = a.z;
      bounce_in<false>(P, bd, hnx, hny, hnz, pz, nullptr, -1,
                       [&] { return basis_of(hnx, hny, hnz); }, dirx, diry,
                       dirz, cr, cg, cb);

      // --- deposit (photonmap.cl:256-258) ---------------------------------
      out_idx[d] = btex;
      out_col[3 * d] = cr;
      out_col[3 * d + 1] = cg;
      out_col[3 * d + 2] = cb;
      done = d + 1;

      px = px + dirx * P.eps;
      py = py + diry * P.eps;
      pz = pz + dirz * P.eps;
    }
  }
  for (int d = done; d < D; ++d) {
    out_idx[d] = 0;
    out_col[3 * d] = 0.0f;
    out_col[3 * d + 1] = 0.0f;
    out_col[3 * d + 2] = 0.0f;
  }

  if constexpr (kStaged) {
    // the group's rows [p0, p0 + rows) are one run of each output
    __syncwarp();
    const int first = t - t % kGroup;
    const int p0 = blockIdx.x * kThreads + first;
    const int rows = min(kGroup, batch - p0);
    if (rows > 0) {
      store_group(idx + static_cast<size_t>(p0) * D, stage_idx + first * D,
                  rows * D, t % kGroup);
      store_group(col + static_cast<size_t>(p0) * 3 * D,
                  stage_col + first * 3 * D, rows * 3 * D, t % kGroup);
    }
  }
}

// The instance that fm_trace_deposits_narrow launches for n_rects rects
// and max_depth bounces, and its dynamic shared memory: with the table in
// shared memory when it fits (72 bytes a rect), and then with the
// deposits staged there too when table and staging fit and the staging
// costs no block a SM (the occupancy calculator's blocks per SM of both
// instances, on the current device); else the device-memory instance.
enum NarrowInstance { kStagedTable = 0, kTable = 1, kDeviceTable = 2 };

int narrow_plan(int n_rects, int max_depth, NarrowInstance* inst,
                size_t* smem) {
  const size_t table = sizeof(float) * F_GEN * static_cast<size_t>(n_rects);
  const size_t staged = table + staging_bytes(max_depth);
  *inst = table <= kSmemLimit ? kTable : kDeviceTable;
  *smem = table <= kSmemLimit ? table : 0;
  if (staged > kSmemLimit) return 0;
  const auto ks = trace_deposits_narrow_kernel<true, true>;
  const auto kt = trace_deposits_narrow_kernel<true, false>;
  int with = 0, without = 0;
  cudaError_t err = cudaFuncSetAttribute(
      ks, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(staged));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kt,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(table));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&with, ks, kThreads,
                                                        staged);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&without, kt,
                                                        kThreads, table);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (with >= without) {
    *inst = kStagedTable;
    *smem = staged;
  }
  return 0;
}

}  // namespace

// C entry point, loaded with ctypes. Launches one batch of `batch` photons
// on `stream` and returns the CUDA error code of the launch (0 on success).
// `scene` is the [18, n_rects] table, `em` the 16-float emitter vector,
// `u_t` the [4 + 3 * max_depth, batch] f32 uniforms; idx [batch, max_depth]
// int32 and col [batch, 3 * max_depth] f32 are written in full.
extern "C" int fm_trace_deposits_narrow(
    const float* scene, const float* em, const float* u_t, int* idx,
    float* col, int batch, int n_rects, int n_valid, int max_depth,
    float eps, float two_pi, float rr, float mirror_z, float tint_z,
    float tint_r, float tint_g, float tint_b, float albedo, void* stream) {
  if (batch <= 0) return 0;
  const Params P = make_params(n_rects, n_rects, 0, 0, 0, n_valid, max_depth,
                               0, eps, two_pi, rr, mirror_z, tint_z, tint_r,
                               tint_g, tint_b, albedo, 0.0f);
  NarrowInstance inst;
  size_t smem;
  const int err = narrow_plan(n_rects, max_depth, &inst, &smem);
  if (err != 0) return err;
  const auto k = inst == kStagedTable
                     ? trace_deposits_narrow_kernel<true, true>
                 : inst == kTable ? trace_deposits_narrow_kernel<true, false>
                                  : trace_deposits_narrow_kernel<false, false>;
  // launch_table with the instance chosen: its table bytes are `smem`
  return launch_table(k, k, smem, 0, 0, blocks_for(batch), kThreads,
                      static_cast<cudaStream_t>(stream), scene, em, u_t, P,
                      batch, idx, col);
}

// The instance (0: table and staging in shared memory, 1: the table only,
// 2: the device-memory table) and the dynamic shared memory in bytes that
// fm_trace_deposits_narrow takes for n_rects rects and max_depth bounces
// on the current device; no launch, no stream. Returns the CUDA error
// code.
extern "C" int fm_trace_deposits_narrow_plan(int n_rects, int max_depth,
                                             int* instance,
                                             int* shared_bytes) {
  NarrowInstance inst;
  size_t smem;
  const int err = narrow_plan(n_rects, max_depth, &inst, &smem);
  *instance = static_cast<int>(inst);
  *shared_bytes = static_cast<int>(smem);
  return err;
}
