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
// emit_photon and bounce, the axis-aligned kernels' own code.
//
// Design. The TPU kernel works on [TB, N] tiles: every photon of a block
// against every rect at once, then a row min, then the winner's fields by
// exact one-hot masked row sums (an MXU gather would round them to bf16),
// with the texel id computed in every lane. Here one thread traces one
// photon: each of its max_depth bounces loops over the N real rects (not
// the 128-row padding of pack_rects, whose zero normals never win), keeps
// the nearest hit's column and its two projections, and computes the texel
// id of that winner only. The [18, N] table (72 bytes a rect) is staged in
// shared memory when it fits beside nothing else (3,228 rects), else read
// from device memory, where it stays in L1 and L2 (launch_table).
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
// Outputs in the TPU kernel's layout: idx [B, D] int32 and col [B, 3D] f32,
// photon-major. What bounds it on an H100: the rect loop, about 44 f32
// operations per photon, bounce and rect (one of them the division), and
// then 4 * U bytes of uniforms read and 16 bytes per bounce written per
// photon.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (see
// flatmatch_tpu_torch/utils/cuda_build.py).
#include "trace_wide.cuh"

namespace {

// rows of the [F_GEN, N] table (photon_pallas.py:41-51, scene_matrix)
enum { G_POS = 0, G_N = 3, G_WU = 6, G_HU = 9, G_WLEN = 12, G_HLEN = 13,
       G_NOFF = 14, G_BASE = 15, G_WT = 16, G_HT = 17, F_GEN = 18 };

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
trace_deposits_narrow_kernel(const float* __restrict__ scene,
                             const float* __restrict__ em,
                             const float* __restrict__ u_t, const Params P,
                             int batch, int* __restrict__ idx,
                             float* __restrict__ col) {
  extern __shared__ float smem[];
  const int N = P.n_rects;
  const float* s = scene;
  if constexpr (kSmem) {
    stage(smem, scene, F_GEN * N);
    __syncthreads();
    s = smem;
  }
#define S(row, j) s[(row) * N + (j)]

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= batch) return;
  const int D = P.max_depth;
  int* out_idx = idx + static_cast<size_t>(p) * D;
  float* out_col = col + static_cast<size_t>(p) * 3 * D;
  int done = 0;
  if (p < P.n_valid) {
    const UniformDraw draws{u_t, batch, p};
    float px, py, pz, dirx, diry, dirz, cr, cg, cb;
    emit_photon(em, P, draws, px, py, pz, dirx, diry, dirz, cr, cg, cb);
    for (int d = 0; d < D; ++d) {
      // --- nearest hit over all rects (rectangle.c:67-95) ----------------
      float best = kMiss;
      int bj = 0;
      float bpdx = 0.0f, bpdy = 0.0f;
      for (int j = 0; j < N; ++j) {
        const float rnx = S(G_N, j), rny = S(G_N + 1, j),
                    rnz = S(G_N + 2, j);
        const float denom = dirx * rnx + diry * rny + dirz * rnz;
        const float pn = px * rnx + py * rny + pz * rnz;
        const float fac = (S(G_NOFF, j) - pn) / denom;
        const float ex = px + dirx * fac - S(G_POS, j);
        const float ey = py + diry * fac - S(G_POS + 1, j);
        const float ez = pz + dirz * fac - S(G_POS + 2, j);
        const float pdx =
            ex * S(G_WU, j) + ey * S(G_WU + 1, j) + ez * S(G_WU + 2, j);
        const float pdy =
            ex * S(G_HU, j) + ey * S(G_HU + 1, j) + ez * S(G_HU + 2, j);
        const bool valid = denom < 0.0f && fac >= 0.0f && pdx >= 0.0f &&
                           S(G_WLEN, j) - pdx >= 0.0f && pdy >= 0.0f &&
                           S(G_HLEN, j) - pdy >= 0.0f;
        if (valid && fac < best) {
          best = fac;
          bj = j;
          bpdx = pdx;
          bpdy = pdy;
        }
      }
      if (!(best < kHitBelow)) break;

      const float wt = S(G_WT, bj), ht = S(G_HT, bj);
      const float tx = fminf(floorf(bpdx * wt / S(G_WLEN, bj)), wt - 1.0f);
      const float ty = fminf(floorf(bpdy * ht / S(G_HLEN, bj)), ht - 1.0f);
      const int btex = static_cast<int>(S(G_BASE, bj)) +
                       static_cast<int>(ty) * static_cast<int>(wt) +
                       static_cast<int>(tx);
      px = px + dirx * best;
      py = py + diry * best;
      pz = pz + dirz * best;

      // --- Russian roulette + bounce (photonmap.cl:236-254) --------------
      bounce<false>(P, draws, d, S(G_N, bj), S(G_N + 1, bj), S(G_N + 2, bj),
                    pz, nullptr, -1, dirx, diry, dirz, cr, cg, cb);

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
#undef S
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
  return launch_table(trace_deposits_narrow_kernel<true>,
                      trace_deposits_narrow_kernel<false>,
                      sizeof(float) * F_GEN * static_cast<size_t>(n_rects),
                      0, 0, blocks_for(batch), kThreads,
                      static_cast<cudaStream_t>(stream), scene, em, u_t, P,
                      batch, idx, col);
}
