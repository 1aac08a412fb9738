// The photon trace shared by the port's wide kernels: the draws (counter
// hash, or uniforms passed in), emission and max_depth axis-aligned bounces
// of one photon, with a callback at every live bounce's deposit.
//
// It is the body of the TPU factory flatmatch_tpu/engines/
// photon_pallas_wide.py _make_kernel (:105-733) for one photon:
//   - kDiff = false: the production trace (scalar albedo; rows 1-4 of the
//     kernel table), used by trace_splat_wide_rng.cu and
//     trace_deposits_wide.cu;
//   - kDiff = true: the differentiable tier (:290-292, :373-379, :494):
//     the albedo of a diffuse hit is the per-slot albedo of the winning
//     rect j, and the callback gets j at a diffuse hit (-1 at a mirror
//     bounce), used by trace_splat_wide_diff_rng.cu and
//     trace_fold_wide_rng.cu.
// With every per-slot albedo equal to the scalar one, both variants do the
// same float operations in the same order, so they give the same bits.
//
// Every kernel that includes this builds with -fmad=false (see
// flatmatch_tpu_torch/utils/cuda_build.py): each product is rounded on its
// own, as the plain PyTorch version (engines/photon_wide.py) rounds it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kMiss = 1e30f;
constexpr float kHitBelow = 5e29f;   // _MISS * 0.5

// rows of the [F_AA, N] scene table (ops/aa_scene.py)
enum { A_O = 0, A_SN, A_CU, A_WS, A_WLEN, A_CV, A_HS, A_HLEN, A_BASE, A_WT,
       A_HT, A_KTU, A_KTV, F_AA };

struct Params {
  float eps, two_pi, rr, mirror_z, tint_z, tint_r, tint_g, tint_b, albedo,
      inv_s;
  int n_rects, g0, g1, g2, n_valid, max_depth, num_texels;
  uint32_t seed;
};

inline Params make_params(int n_rects, int g0, int g1, int g2, int seed,
                          int n_valid, int max_depth, int num_texels,
                          float eps, float two_pi, float rr, float mirror_z,
                          float tint_z, float tint_r, float tint_g,
                          float tint_b, float albedo, float inv_s) {
  Params P;
  P.eps = eps;
  P.two_pi = two_pi;
  P.rr = rr;
  P.mirror_z = mirror_z;
  P.tint_z = tint_z;
  P.tint_r = tint_r;
  P.tint_g = tint_g;
  P.tint_b = tint_b;
  P.albedo = albedo;
  P.inv_s = inv_s;
  P.n_rects = n_rects;
  P.g0 = g0;
  P.g1 = g1;
  P.g2 = g2;
  P.n_valid = n_valid;
  P.max_depth = max_depth;
  P.num_texels = num_texels;
  P.seed = static_cast<uint32_t>(seed);
  return P;
}

// Shift, overflow and hash constants (note 2): jax.lax.shift_right_logical
// is `>>` on uint32_t here, and every product wraps mod 2^32 as the JAX
// int32 arithmetic does. 0x85EBCA6B == -2048144789, 0xC2B2AE35 ==
// -1028477387, 0x9E3779B9 == -1640531527.
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// top 24 bits -> [0, 1), exact in f32
__device__ __forceinline__ float unit24(uint32_t h) {
  return static_cast<float>(h >> 8) * (1.0f / 16777216.0f);
}

// Draw columns (note 3): c = 0..3 for emission, 4+3d, 5+3d, 6+3d for RR,
// u1 and u2 at bounce d.
__device__ __forceinline__ float draw(uint32_t p, uint32_t seed, int c) {
  return unit24(
      fmix32(p * 0x9E3779B9u + (seed + static_cast<uint32_t>(c) * 97929u)));
}

// The draw sources of trace_photon: a functor that returns draw column c of
// its photon. HashDraw is the counter hash above; the stream trace of
// trace_deposits_wide.cu adds one that loads precomputed uniforms.
struct HashDraw {
  uint32_t p, seed;
  __device__ __forceinline__ float operator()(int c) const {
    return draw(p, seed, c);
  }
};

// Dither of deposit key p*3D + 3d + ch, hashed as fmix32(key * 0x9E3779B9).
// The stream splat (splat_stream.cu) keys it by stream row * 3 + ch.
__device__ __forceinline__ float dither(uint32_t key) {
  return unit24(fmix32(key * 0x9E3779B9u));
}

// 7-bit quantization: clip(floor(c * inv_s + dither), 0, 127). A live
// photon's alive factor is exactly 1, so c * alive == c.
__device__ __forceinline__ int quant(float c, float inv_s, uint32_t key) {
  const float q = floorf(c * inv_s + dither(key));
  return static_cast<int>(fminf(fmaxf(q, 0.0f), 127.0f));
}

// Quantize photon p's deposit at bounce d and add it to the int32 [T, 3]
// accumulator. Integer sums do not depend on order, so two runs are
// bit-identical; zero deposits are skipped.
__device__ __forceinline__ void splat_i8(int* acc, const Params& P,
                                         float inv_s, uint32_t p, int d,
                                         int btex, float cr, float cg,
                                         float cb) {
  const uint32_t key = p * static_cast<uint32_t>(3 * P.max_depth) +
                       static_cast<uint32_t>(3 * d);
  const int qr = quant(cr, inv_s, key);
  const int qg = quant(cg, inv_s, key + 1u);
  const int qb = quant(cb, inv_s, key + 2u);
  if (static_cast<unsigned>(btex) < static_cast<unsigned>(P.num_texels)) {
    int* t = acc + 3 * btex;
    if (qr) atomicAdd(t, qr);
    if (qg) atomicAdd(t + 1, qg);
    if (qb) atomicAdd(t + 2, qb);
  }
}

// 1/sqrt(x) as 1.0f / sqrtf(x): both IEEE-rounded (-prec-div and
// -prec-sqrt are on by default). The plain version computes
// torch.reciprocal(torch.sqrt(x)), which is the same two roundings on the
// CPU and on the card; rsqrtf is not correctly rounded.
__device__ __forceinline__ float inv_norm(float x, float y, float z) {
  return 1.0f / sqrtf(x * x + y * y + z * z);
}

// build_base (photonmap.cl:43-48, photon_pallas._build_base_cols) with the
// JAX package's operation order (note 4).
__device__ __forceinline__ void build_base(float nx, float ny, float nz,
                                           float& ux, float& uy, float& uz,
                                           float& vx, float& vy, float& vz) {
  const bool colinear = fabsf(nz) >= 0.999999f;
  const float u0x = 0.0f;
  const float u0y = colinear ? 1.0f : 0.0f;
  const float u0z = colinear ? 0.0f : 1.0f;
  vx = u0y * nz - u0z * ny;
  vy = u0z * nx - u0x * nz;
  vz = u0x * ny - u0y * nx;
  float inv = inv_norm(vx, vy, vz);
  vx = vx * inv;
  vy = vy * inv;
  vz = vz * inv;
  ux = vy * nz - vz * ny;
  uy = vz * nx - vx * nz;
  uz = vx * ny - vy * nx;
  inv = inv_norm(ux, uy, uz);
  ux = ux * inv;
  uy = uy * inv;
  uz = uz * inv;
}

// Copy `n` floats from device memory into shared memory, block-strided.
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Trace one photon of the batch, whose draw column c is draws(c) (HashDraw,
// or the uniforms of trace_deposits_wide.cu). `s` is the [F_AA][N] scene
// table in shared memory, `s_alb` the per-slot albedo row (read only when
// kDiff), `em` the 16-float emitter vector. At every bounce whose hit keeps
// the photon alive, after the bounce's attenuation, it calls
//   deposit(d, btex, cr, cg, cb, slot)
// with slot = the winning rect's table column at a diffuse hit when kDiff,
// else -1. A photon that misses stops: it would deposit exactly 0 at this
// and every later bounce.
template <bool kDiff, class Draw, class Deposit>
__device__ __forceinline__ void trace_photon(const float* __restrict__ s,
                                             const float* __restrict__ s_alb,
                                             const float* __restrict__ em,
                                             const Params& P,
                                             const Draw& draws,
                                             Deposit&& deposit) {
  const int N = P.n_rects;
#define S(row, j) s[(row) * N + (j)]

  // --- emission (photonmap.cl:173-181) ------------------------------------
  const float epx = em[0], epy = em[1], epz = em[2];
  const float ewx = em[3], ewy = em[4], ewz = em[5];
  const float ehx = em[6], ehy = em[7], ehz = em[8];
  const float enx = em[9], eny = em[10], enz = em[11];
  float cr = em[12], cg = em[13], cb = em[14];
  const float is_window = em[15];

  const float dxe = draws(0);
  const float dye = draws(1);
  const float r = sqrtf(draws(2));
  const float phi = P.two_pi * draws(3);
  float uu = r * cosf(phi);
  const float vv = r * sinf(phi);
  const float nn = sqrtf(1.0f - r * r);
  // Window emission (note 6): a window emits into its inner half-space.
  if (is_window > 0.0f) uu = fabsf(uu);

  float ux, uy, uz, vx, vy, vz;
  build_base(enx, eny, enz, ux, uy, uz, vx, vy, vz);
  // Evaluation order (note 4): every sum associates left to right as in
  // the JAX source, e.g. epx + ewx*dxe + ehx*dye + dirx*eps.
  float dirx = ux * uu + vx * vv + enx * nn;
  float diry = uy * uu + vy * vv + eny * nn;
  float dirz = uz * uu + vz * vv + enz * nn;
  float px = epx + ewx * dxe + ehx * dye + dirx * P.eps;
  float py = epy + ewy * dxe + ehy * dye + diry * P.eps;
  float pz = epz + ewz * dxe + ehz * dye + dirz * P.eps;

  const int D = P.max_depth;
  const int counts[3] = {P.g0, P.g1, P.g2};
  for (int d = 0; d < D; ++d) {
    const float pos[3] = {px, py, pz};
    const float dr[3] = {dirx, diry, dirz};
    // division by zero gives inf; the bounds test rejects those rects.
    // aa_nearest.cuh (aa_nearest_hit) repeats this rect loop for the AO
    // and radiosity kernels: a change to its rules goes into both.
    const float inv[3] = {1.0f / dirx, 1.0f / diry, 1.0f / dirz};

    float best = kMiss;
    int btex = 0;
    int baxis = 0;
    float bsign = 0.0f;
    int bslot = -1;
    int start = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int au = (a == 0) ? 1 : 0;
      const int av = (a == 2) ? 1 : 2;
      const float pa = pos[a], ia = inv[a];
      const float pu = pos[au], du = dr[au];
      const float pv = pos[av], dv = dr[av];
      const bool da_neg = dr[a] < 0.0f;
      const int end = start + counts[a];
      // Rect loop: a strict `<` keeps the first of equal minima, the JAX
      // kernel's tie break (photon_pallas_wide.py:384-406).
      for (int j = start; j < end; ++j) {
        const float sn = S(A_SN, j);
        const float fac = (S(A_O, j) - pa) * ia;
        const bool front = da_neg != (sn < 0.0f);
        const float u = (pu + du * fac - S(A_CU, j)) * S(A_WS, j);
        const float v = (pv + dv * fac - S(A_CV, j)) * S(A_HS, j);
        // NaN handling in the bounds test (note 1): the JAX kernel writes
        // min(min(fac,u), min(wlen-u, min(v, hlen-v))) >= 0 and relies on
        // jnp.minimum propagating NaN (0 * inf from 1/dir). fminf drops
        // NaN and would accept the hit; this compare chain is false on
        // NaN, as the min-tree is.
        const bool valid = front && fac >= 0.0f && u >= 0.0f &&
                           S(A_WLEN, j) - u >= 0.0f && v >= 0.0f &&
                           S(A_HLEN, j) - v >= 0.0f;
        const float dist = valid ? fac : kMiss;
        if (dist < best) {
          best = dist;
          // Texel ids (note 7): base + ty*wt + tx with tx = min(floor(u *
          // ktu), wt - 1), ty = min(floor(v * ktv), ht - 1), as int32.
          // Below 2^24 they equal the JAX kernel's f32 ids.
          const float wt = S(A_WT, j);
          const float tx = fminf(floorf(u * S(A_KTU, j)), wt - 1.0f);
          const float ty = fminf(floorf(v * S(A_KTV, j)), S(A_HT, j) - 1.0f);
          btex = static_cast<int>(S(A_BASE, j)) +
                 static_cast<int>(ty) * static_cast<int>(wt) +
                 static_cast<int>(tx);
          baxis = a;
          bsign = sn;
          if (kDiff) bslot = j;
        }
      }
      start = end;
    }

    // Order within a bounce (note 5): alive *= hit comes before this
    // bounce's deposit, so a miss deposits nothing now or later.
    if (!(best < kHitBelow)) break;
    px = px + dirx * best;
    py = py + diry * best;
    pz = pz + dirz * best;

    const float hnx = (baxis == 0) ? bsign : 0.0f;
    const float hny = (baxis == 1) ? bsign : 0.0f;
    const float hnz = (baxis == 2) ? bsign : 0.0f;

    // --- Russian roulette + bounce (photonmap.cl:236-254) ------------------
    const float u_rr = draws(4 + 3 * d);
    const float u1 = draws(5 + 3 * d);
    const float u2 = draws(6 + 3 * d);
    // the diffuse/mirror choice reads pz at the hit point
    const bool diffuse = (pz > P.mirror_z) || (u_rr > P.rr);
    if (diffuse) {
      const float rd = sqrtf(u1);
      const float phid = P.two_pi * u2;
      const float duu = rd * cosf(phid);
      const float dvv = rd * sinf(phid);
      const float dnn = sqrtf(1.0f - rd * rd);
      float bux, buy, buz, bvx, bvy, bvz;
      build_base(hnx, hny, hnz, bux, buy, buz, bvx, bvy, bvz);
      const bool on_floor = pz < P.tint_z;
      const float tr = on_floor ? P.tint_r : 1.0f;
      const float tg = on_floor ? P.tint_g : 1.0f;
      const float tb = on_floor ? P.tint_b : 1.0f;
      // the order c * tint * albedo of photon_pallas_wide.py:495-497
      const float alb = kDiff ? s_alb[bslot] : P.albedo;
      cr = cr * tr * alb;
      cg = cg * tg * alb;
      cb = cb * tb * alb;
      dirx = bux * duu + bvx * dvv + hnx * dnn;
      diry = buy * duu + bvy * dvv + hny * dnn;
      dirz = buz * duu + bvz * dvv + hnz * dnn;
    } else {
      const float ndotd = hnx * dirx + hny * diry + hnz * dirz;
      const float mdx = dirx - 2.0f * ndotd * hnx;
      const float mdy = diry - 2.0f * ndotd * hny;
      const float mdz = dirz - 2.0f * ndotd * hnz;
      dirx = mdx;
      diry = mdy;
      dirz = mdz;
    }

    deposit(d, btex, cr, cg, cb, (kDiff && diffuse) ? bslot : -1);

    // the +eps nudge uses the NEW direction
    px = px + dirx * P.eps;
    py = py + diry * P.eps;
    pz = pz + dirz * P.eps;
  }
#undef S
}

}  // namespace
