// The photon trace shared by the port's wide kernels: the draws (counter
// hash, or uniforms passed in), emission and max_depth axis-aligned bounces
// of one photon, with a callback at every live bounce's deposit; and the
// two deposit splats the in-kernel tiers make of that callback (splat_i8,
// splat_f32), with the fixed-point f32 sum the stream splats share.
//
// It is the body of the TPU factory flatmatch_tpu/engines/
// photon_pallas_wide.py _make_kernel (:105-733) for one photon:
//   - kDiff = false: the production trace (scalar albedo; rows 1-5 of the
//     kernel table), used by trace_splat_wide_rng.cu, trace_splat_wide.cu
//     and trace_deposits_wide.cu;
//   - kDiff = true: the differentiable tier (:290-292, :373-379, :494):
//     the albedo of a diffuse hit is the per-slot albedo of the winning
//     rect j, and the callback gets j at a diffuse hit (-1 at a mirror
//     bounce), used by trace_splat_wide_diff_rng.cu and
//     trace_fold_wide_rng.cu.
// With every per-slot albedo equal to the scalar one, both variants do the
// same float operations in the same order, so they give the same bits.
// Its emission and bounce (emit_photon, bounce) also serve the general
// trace of trace_deposits_narrow.cu.
//
// Design on Hopper. Every traced bounce tests every rect, so on a scene of
// hundreds of rects the rect loop takes the time, bound by the
// instructions it issues. So: the shared-memory instance reads a rect as
// two 16-byte broadcasts from per-rect records that each block stages once
// (stage_scene), where the [F_AA][N] rows take eight scalar loads; the
// loop keeps only the running minimum and its column, with selects, and
// the winner's texel id, axis and sign come once after the three axis
// groups, from its u and v recomputed from the same floats; the loop is
// unrolled (Rects::kUnroll); the bases of the six axis normals and of the
// emitter are built once per block, not at every diffuse bounce and
// emission; a bounce's uniforms are loaded before its rect loop, which
// hides the load. Each output bit is what a rect-at-a-time loop with
// build_base at every bounce gives.
//
// Every kernel that includes this builds with -fmad=false (see
// flatmatch_tpu_torch/utils/cuda_build.py): each product is rounded on its
// own, as the plain PyTorch version (engines/photon_wide.py) rounds it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Blocks per SM that the shared-memory instances of the trace kernels ask
// the compiler to fit (__launch_bounds__): 48 registers a thread. Measured
// on an H100 (PERF.md): on mini, where bounces wait on the uniforms'
// loads, 5 blocks against the 4 that 64 registers give cut the
// uniforms-in instances' time by 10-30%; on the 4x4 tiling, where the rect
// loop issues at its rate, they cost 3%. The device-memory instances take
// no cap: at 48 registers they spill.
constexpr int kSmemMinBlocks = 5;
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
// its photon. HashDraw is the counter hash above; UniformDraw loads the
// precomputed (threefry) uniforms of photon p from their transposed [U, B]
// copy u_t[c * batch + p], so that a warp's load of draw column c reads 32
// neighbouring floats (the [B, U] layout would put them 4 * U bytes apart).
struct HashDraw {
  uint32_t p, seed;
  __device__ __forceinline__ float operator()(int c) const {
    return draw(p, seed, c);
  }
};

struct UniformDraw {
  const float* __restrict__ u_t;
  int batch;
  int p;
  __device__ __forceinline__ float operator()(int c) const {
    return u_t[static_cast<size_t>(c) * batch + p];
  }
};

// The three draws of bounce d (RR, u1, u2), k = 0, 1, 2. The counter hash
// computes each where it is used (u1 and u2 on the diffuse branch only);
// the uniforms are loaded when bounce_draws is called, so a trace that
// calls it before its rect loop hides the load behind the loop.
struct HashBounceDraws {
  HashDraw h;
  int c0;
  __device__ __forceinline__ float operator()(int k) const {
    return h(c0 + k);
  }
};

struct LoadedBounceDraws {
  float v[3];
  __device__ __forceinline__ float operator()(int k) const { return v[k]; }
};

__device__ __forceinline__ HashBounceDraws bounce_draws(const HashDraw& h,
                                                        int d) {
  return HashBounceDraws{h, 4 + 3 * d};
}

__device__ __forceinline__ LoadedBounceDraws bounce_draws(
    const UniformDraw& u, int d) {
  return LoadedBounceDraws{{u(4 + 3 * d), u(5 + 3 * d), u(6 + 3 * d)}};
}

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

// The deterministic f32 sum (no float atomics): a color becomes the 64-bit
// integer c * 2^k rounded to nearest, added by 64-bit atomicAdd (two's
// complement: an unsigned add of the signed value); each texel's sum is
// converted to f32 once (fixed_to_f32_kernel). to_fixed = 2^k, with k chosen
// by the wrapper (ops/splat.fixed_point_scale) so that no sum passes 2^62.
// Integer addition does not depend on order, so two runs give the same bits.
// With kBf16 the color is first rounded to bf16 once (round to nearest even,
// as astype(bfloat16)); zeros are skipped. to_fixed is the one step from a
// color to its integer, which the in-kernel splat (splat_f32) and the stream
// splat (splat_stream.cu) share, so both add the same integer for a deposit:
// it sets *v and returns true unless the (rounded) color is zero.
template <bool kBf16>
__device__ __forceinline__ bool to_fixed(float c, float scale, long long* v) {
  if (kBf16) c = __bfloat162float(__float2bfloat16_rn(c));
  if (c == 0.0f) return false;
  *v = __float2ll_rn(c * scale);
  return true;
}

template <bool kBf16>
__device__ __forceinline__ void add_fixed(unsigned long long* a, float c,
                                          float scale) {
  long long v;
  if (to_fixed<kBf16>(c, scale, &v)) {
    atomicAdd(a, static_cast<unsigned long long>(v));
  }
}

// The in-kernel f32 splat of one deposit: each channel rounded to bf16, as
// the TPU kernel's (c * alive).astype(bfloat16) (photon_pallas_wide.py:
// 549-551), and added in fixed point to the int64 [T, 3] accumulator; ids
// outside [0, T) are skipped. It adds what the stream splat
// (splat_stream.cu, fused_splat_kernel<true>) adds for the same deposit's
// stream row, so at the same k both sums are the same integers.
__device__ __forceinline__ void splat_f32(unsigned long long* acc,
                                          const Params& P, float to_fixed,
                                          int btex, float cr, float cg,
                                          float cb) {
  if (static_cast<unsigned>(btex) < static_cast<unsigned>(P.num_texels)) {
    unsigned long long* t = acc + 3 * static_cast<size_t>(btex);
    add_fixed<true>(t, cr, to_fixed);
    add_fixed<true>(t + 1, cg, to_fixed);
    add_fixed<true>(t + 2, cb, to_fixed);
  }
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// Dynamic shared memory a block may use on sm_90 (227 KB).
constexpr size_t kSmemLimit = 232448;

// Where the kernels keep the [F_AA][N] scene table (and the diff kernels'
// [N] albedo row): with kSmem each block stages it in shared memory (the
// trace kernels as per-rect records, stage_scene), so every rect read of
// the loop is a shared-memory broadcast; without, the
// loop reads it from device memory, where it stays in L1 and L2 (a table
// of 4,563 rects is 237 KB). The flag is a template argument, so the
// shared-memory instance compiles to the same loads as a kernel with no
// such choice. launch_table picks the shared-memory instance whenever the
// table fits beside the kernel's other shared buffers (`buffer_bytes` of
// dynamic shared memory after the table, `static_bytes` declared in the
// kernel), and the global instance only past that: the JAX package, which
// keeps the table in VMEM, has no cap on a scene's rect count, and the
// port has none either.
template <class Kernel, class... Args>
int launch_table(Kernel k_smem, Kernel k_global, size_t table_bytes,
                 size_t buffer_bytes, size_t static_bytes, int blocks,
                 int threads, cudaStream_t s, Args... args) {
  const bool in_smem =
      table_bytes + buffer_bytes + static_bytes <= kSmemLimit;
  const Kernel k = in_smem ? k_smem : k_global;
  const size_t smem = (in_smem ? table_bytes : 0) + buffer_bytes;
  if (smem + static_bytes > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  k<<<blocks, threads, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// out[i] = f32(acc[i]) * 2^-k: one rounding to f32, then an exact power-of-
// two scaling. from_fixed = 2^-k, read from the device when from_ptr is set
// (the diff tier's run-time grid).
__global__ void __launch_bounds__(kThreads)
fixed_to_f32_kernel(const long long* __restrict__ acc, int n,
                    const float* __restrict__ from_ptr, float from_fixed,
                    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __ll2float_rn(acc[i]) * (from_ptr ? *from_ptr
                                                        : from_fixed);
}

inline int launch_fixed_to_f32(const long long* acc, int n,
                               const float* from_ptr, float from_fixed,
                               float* out, cudaStream_t s) {
  if (n <= 0) return 0;
  fixed_to_f32_kernel<<<blocks_for(n), kThreads, 0, s>>>(acc, n, from_ptr,
                                                         from_fixed, out);
  return static_cast<int>(cudaGetLastError());
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

// The basis of a unit normal, as build_base gives it.
struct Basis {
  float ux, uy, uz, vx, vy, vz;
};

__device__ __forceinline__ Basis basis_of(float nx, float ny, float nz) {
  Basis b;
  build_base(nx, ny, nz, b.ux, b.uy, b.uz, b.vx, b.vy, b.vz);
  return b;
}

// Copy `n` floats from device memory into shared memory, block-strided.
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Emission (photonmap.cl:173-181) of one photon from the 16-float emitter
// vector `em` (pos, wvec, hvec, n, color, is_window flag) whose normal has
// the basis `eb`: its start point (nudged eps along the direction),
// direction and color.
template <class Draw>
__device__ __forceinline__ void emit_photon_in(const float* __restrict__ em,
                                               const Basis& eb,
                                               const Params& P,
                                               const Draw& draws, float& px,
                                               float& py, float& pz,
                                               float& dirx, float& diry,
                                               float& dirz, float& cr,
                                               float& cg, float& cb) {
  const float epx = em[0], epy = em[1], epz = em[2];
  const float ewx = em[3], ewy = em[4], ewz = em[5];
  const float ehx = em[6], ehy = em[7], ehz = em[8];
  const float enx = em[9], eny = em[10], enz = em[11];
  cr = em[12];
  cg = em[13];
  cb = em[14];
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

  // Evaluation order (note 4): every sum associates left to right as in
  // the JAX source, e.g. epx + ewx*dxe + ehx*dye + dirx*eps.
  dirx = eb.ux * uu + eb.vx * vv + enx * nn;
  diry = eb.uy * uu + eb.vy * vv + eny * nn;
  dirz = eb.uz * uu + eb.vz * vv + enz * nn;
  px = epx + ewx * dxe + ehx * dye + dirx * P.eps;
  py = epy + ewy * dxe + ehy * dye + diry * P.eps;
  pz = epz + ewz * dxe + ehz * dye + dirz * P.eps;
}

// emit_photon_in with the emitter's basis built here, per photon (the
// general trace of trace_deposits_narrow.cu).
template <class Draw>
__device__ __forceinline__ void emit_photon(const float* __restrict__ em,
                                            const Params& P,
                                            const Draw& draws, float& px,
                                            float& py, float& pz,
                                            float& dirx, float& diry,
                                            float& dirz, float& cr,
                                            float& cg, float& cb) {
  emit_photon_in(em, basis_of(em[9], em[10], em[11]), P, draws, px, py, pz,
                 dirx, diry, dirz, cr, cg, cb);
}

// Russian roulette and the bounce at a hit (photonmap.cl:236-254): with
// the bounce's draws bd (bounce_draws), the photon at height pz on a rect
// of normal hn takes the diffuse branch (cosine resample about hn, whose
// basis base_of() returns, floor tint, albedo: the per-slot albedo
// s_alb[bslot] when kDiff, else the scalar one) or the mirror branch;
// returns whether it was diffuse. base_of is called on the diffuse branch
// only.
template <bool kDiff, class BounceDraws, class BaseOf>
__device__ __forceinline__ bool bounce_in(const Params& P,
                                          const BounceDraws& bd, float hnx,
                                          float hny, float hnz, float pz,
                                          const float* __restrict__ s_alb,
                                          int bslot, const BaseOf& base_of,
                                          float& dirx, float& diry,
                                          float& dirz, float& cr, float& cg,
                                          float& cb) {
  const float u_rr = bd(0);
  const float u1 = bd(1);
  const float u2 = bd(2);
  // the diffuse/mirror choice reads pz at the hit point
  const bool diffuse = (pz > P.mirror_z) || (u_rr > P.rr);
  if (diffuse) {
    const float rd = sqrtf(u1);
    const float phid = P.two_pi * u2;
    const float duu = rd * cosf(phid);
    const float dvv = rd * sinf(phid);
    const float dnn = sqrtf(1.0f - rd * rd);
    const Basis b = base_of();
    const bool on_floor = pz < P.tint_z;
    const float tr = on_floor ? P.tint_r : 1.0f;
    const float tg = on_floor ? P.tint_g : 1.0f;
    const float tb = on_floor ? P.tint_b : 1.0f;
    // the order c * tint * albedo of photon_pallas_wide.py:495-497
    const float alb = kDiff ? s_alb[bslot] : P.albedo;
    cr = cr * tr * alb;
    cg = cg * tg * alb;
    cb = cb * tb * alb;
    dirx = b.ux * duu + b.vx * dvv + hnx * dnn;
    diry = b.uy * duu + b.vy * dvv + hny * dnn;
    dirz = b.uz * duu + b.vz * dvv + hnz * dnn;
  } else {
    const float ndotd = hnx * dirx + hny * diry + hnz * dirz;
    const float mdx = dirx - 2.0f * ndotd * hnx;
    const float mdy = diry - 2.0f * ndotd * hny;
    const float mdz = dirz - 2.0f * ndotd * hnz;
    dirx = mdx;
    diry = mdy;
    dirz = mdz;
  }
  return diffuse;
}

// bounce_in with the basis of hn built at each diffuse bounce (the general
// trace of trace_deposits_narrow.cu, whose normals are arbitrary).
template <bool kDiff, class Draw>
__device__ __forceinline__ bool bounce(const Params& P, const Draw& draws,
                                       int d, float hnx, float hny,
                                       float hnz, float pz,
                                       const float* __restrict__ s_alb,
                                       int bslot, float& dirx, float& diry,
                                       float& dirz, float& cr, float& cg,
                                       float& cb) {
  return bounce_in<kDiff>(
      P, bounce_draws(draws, d), hnx, hny, hnz, pz, s_alb, bslot,
      [&] { return basis_of(hnx, hny, hnz); }, dirx, diry, dirz, cr, cg, cb);
}

// ---------------------------------------------------------------------------
// The scene as the axis-aligned trace reads it.
//
// Shared-memory instance (kSmem): each block stages the [F_AA][N] table as
// per-rect records, so a rect test reads two 16-byte broadcasts where the
// [F_AA][N] rows take eight scalar loads:
//   rec[2j]     = {O, SN, CU, WS},   rec[2j + 1] = {CV, HS, WLEN, HLEN},
// then the five texel rows tex[(row - A_BASE) * N + j] (BASE, WT, HT, KTU,
// KTV), read once per bounce for the winner only: 52 bytes a rect, as the
// table. Before them, kConstFloats of block constants: the bases
// build_base gives the six axis normals +-e_a (class 2a + (sign < 0)), the
// emitter's basis and the emitter vector, each computed or copied once per
// block. A hit normal is (sign on axis a, +0 elsewhere), built from the
// winner's SN; the staging checks that build_base at every rect's normal
// equals its class's basis, bit for bit (it does for every
// |SN| in [0.999999, 1.0006), which holds the 1-ulp-off normals that
// normalization gives), and a block whose table fails the check calls
// build_base at each diffuse bounce instead.
// Device-memory instance: the [F_AA][N] table read field by field where it
// lies (L1 and L2), and build_base called per photon and diffuse bounce.
// Both feed the same rect loop (trace_photon).
constexpr int kConstFloats = 64;
enum { C_AXIS = 0, C_EMB = 36, C_EM = 42 };

// Floats of shared memory that the shared-memory instance stages for `n`
// rects (the launchers' table size).
__host__ __device__ __forceinline__ size_t table_floats(int n) {
  return kConstFloats + static_cast<size_t>(F_AA) * n;
}

__device__ __forceinline__ Basis load_basis(const float* b) {
  return Basis{b[0], b[1], b[2], b[3], b[4], b[5]};
}

__device__ __forceinline__ void store_basis(float* dst, const Basis& b) {
  dst[0] = b.ux;
  dst[1] = b.uy;
  dst[2] = b.uz;
  dst[3] = b.vx;
  dst[4] = b.vy;
  dst[5] = b.vz;
}

__device__ __forceinline__ bool same_bits(const Basis& b, const float* w) {
  return __float_as_uint(b.ux) == __float_as_uint(w[0]) &&
         __float_as_uint(b.uy) == __float_as_uint(w[1]) &&
         __float_as_uint(b.uz) == __float_as_uint(w[2]) &&
         __float_as_uint(b.vx) == __float_as_uint(w[3]) &&
         __float_as_uint(b.vy) == __float_as_uint(w[4]) &&
         __float_as_uint(b.vz) == __float_as_uint(w[5]);
}

// The normal-axis group of table column j: groups are contiguous, in axis
// order, so this is the group whose loop visits j.
__device__ __forceinline__ int axis_of(int j, const Params& P) {
  return (j >= P.g0) + (j >= P.g0 + P.g1);
}

template <bool kSmem>
struct Rects;

template <>
struct Rects<true> {
  // rect tests per step of the unrolled loop (on an H100, 8 measured
  // fastest on the 4x4 tiling against 2 and 4, and against two chains of
  // independent minimums over halves of each group)
  static constexpr int kUnroll = 8;
  const float* c;     // block constants
  const float4* rec;  // [2N] loop records
  const float* tex;   // [5][N] texel rows
  int n;
  bool exact;         // the axis bases stand for build_base at every rect

  __device__ __forceinline__ void loop(int j, float4& a, float4& b) const {
    a = rec[2 * j];
    b = rec[2 * j + 1];
  }
  __device__ __forceinline__ float field(int row, int j) const {
    return tex[(row - A_BASE) * n + j];
  }
  __device__ __forceinline__ const float* em() const { return c + C_EM; }
  __device__ __forceinline__ Basis emitter_basis() const {
    return load_basis(c + C_EMB);
  }
  __device__ __forceinline__ Basis hit_basis(int axis, float sign, float hnx,
                                             float hny, float hnz) const {
    if (exact) return load_basis(c + C_AXIS + 6 * (2 * axis + (sign < 0.0f)));
    return basis_of(hnx, hny, hnz);
  }
};

template <>
struct Rects<false> {
  // unrolled by 2 (measured on an H100 on mini tiled 13x13: 1 about 20%
  // slower on every instance; 4 holds some 170 registers and slows the
  // streams)
  static constexpr int kUnroll = 2;
  const float* __restrict__ s;    // [F_AA][N] in device memory
  const float* __restrict__ em_;  // the emitter vector in device memory
  int n;

  __device__ __forceinline__ void loop(int j, float4& a, float4& b) const {
    a = make_float4(__ldg(s + A_O * n + j), __ldg(s + A_SN * n + j),
                    __ldg(s + A_CU * n + j), __ldg(s + A_WS * n + j));
    b = make_float4(__ldg(s + A_CV * n + j), __ldg(s + A_HS * n + j),
                    __ldg(s + A_WLEN * n + j), __ldg(s + A_HLEN * n + j));
  }
  __device__ __forceinline__ float field(int row, int j) const {
    return __ldg(s + row * n + j);
  }
  __device__ __forceinline__ const float* em() const { return em_; }
  __device__ __forceinline__ Basis emitter_basis() const {
    return basis_of(em_[9], em_[10], em_[11]);
  }
  __device__ __forceinline__ Basis hit_basis(int, float, float hnx, float hny,
                                             float hnz) const {
    return basis_of(hnx, hny, hnz);
  }
};

// The scene of one block: with kSmem, stage the table, the bases and the
// emitter vector into `smem` (table_floats(N) floats, 16-byte aligned); all
// threads of the block call it, and it ends in a barrier. Without, only
// point at the table and the emitter vector.
template <bool kSmem>
__device__ __forceinline__ Rects<kSmem> stage_scene(
    float* smem, const float* __restrict__ table,
    const float* __restrict__ em, const Params& P) {
  const int n = P.n_rects;
  if constexpr (!kSmem) {
    return Rects<false>{table, em, n};
  } else {
    float* c = smem;
    float4* rec = reinterpret_cast<float4*>(smem + kConstFloats);
    float* tex = smem + kConstFloats + 8 * n;
    const int t = threadIdx.x;
    if (t < 6) {
      const int a = t >> 1;
      const float sign = (t & 1) ? -1.0f : 1.0f;
      store_basis(c + C_AXIS + 6 * t,
                  basis_of(a == 0 ? sign : 0.0f, a == 1 ? sign : 0.0f,
                           a == 2 ? sign : 0.0f));
    } else if (t == 6) {
      store_basis(c + C_EMB, basis_of(em[9], em[10], em[11]));
    }
    if (t < 16) c[C_EM + t] = em[t];
    for (int j = t; j < n; j += blockDim.x) {
      rec[2 * j] = make_float4(table[A_O * n + j], table[A_SN * n + j],
                               table[A_CU * n + j], table[A_WS * n + j]);
      rec[2 * j + 1] =
          make_float4(table[A_CV * n + j], table[A_HS * n + j],
                      table[A_WLEN * n + j], table[A_HLEN * n + j]);
      for (int k = 0; k < F_AA - A_BASE; ++k) {
        tex[k * n + j] = table[(A_BASE + k) * n + j];
      }
    }
    __syncthreads();
    bool ok = true;
    for (int j = t; j < n; j += blockDim.x) {
      const float sn = rec[2 * j].y;
      const int a = axis_of(j, P);
      ok = ok && same_bits(basis_of(a == 0 ? sn : 0.0f, a == 1 ? sn : 0.0f,
                                    a == 2 ? sn : 0.0f),
                           c + C_AXIS + 6 * (2 * a + (sn < 0.0f)));
    }
    const bool exact = __syncthreads_and(ok) != 0;
    return Rects<true>{c, rec, tex, n, exact};
  }
}

// Trace one photon of the batch, whose draw column c is draws(c) (HashDraw,
// or UniformDraw), over the scene `R` (stage_scene); `s_alb` is the
// per-slot albedo row (read only when kDiff). At every bounce whose hit
// keeps the photon alive, after the bounce's attenuation, it calls
//   deposit(d, btex, cr, cg, cb, slot)
// with slot = the winning rect's table column at a diffuse hit when kDiff,
// else -1. A photon that misses stops: it would deposit exactly 0 at this
// and every later bounce.
template <bool kDiff, class Scene, class Draw, class Deposit>
__device__ __forceinline__ void trace_photon(const Scene& R,
                                             const float* __restrict__ s_alb,
                                             const Params& P,
                                             const Draw& draws,
                                             Deposit&& deposit) {
  float px, py, pz, dirx, diry, dirz, cr, cg, cb;
  emit_photon_in(R.em(), R.emitter_basis(), P, draws, px, py, pz, dirx, diry,
                 dirz, cr, cg, cb);

  const int D = P.max_depth;
  const int counts[3] = {P.g0, P.g1, P.g2};
  for (int d = 0; d < D; ++d) {
    const auto bd = bounce_draws(draws, d);   // before the rect loop
    const float pos[3] = {px, py, pz};
    const float dr[3] = {dirx, diry, dirz};
    // division by zero gives inf; the bounds test rejects those rects.
    // aa_nearest.cuh (aa_nearest_hit) repeats this rect loop for the AO
    // and radiosity kernels on the [F_AA][N] rows, and
    // trace_deposits_narrow.cu the general one: the three rules (the
    // NaN-false compare chain, the strict `<`, the texel formula) hold in
    // all of them.
    const float inv[3] = {1.0f / dirx, 1.0f / diry, 1.0f / dirz};

    // Rect loop: only the running minimum and its column are kept, with
    // selects; the winner's texel comes after the loop. A strict `<` keeps
    // the first of equal minima, the JAX kernel's tie break
    // (photon_pallas_wide.py:384-406).
    float best = kMiss;
    int bj = 0;
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
#pragma unroll Scene::kUnroll
      for (int j = start; j < end; ++j) {
        float4 r0, r1;  // {O, SN, CU, WS}, {CV, HS, WLEN, HLEN}
        R.loop(j, r0, r1);
        const float fac = (r0.x - pa) * ia;
        const float u = (pu + du * fac - r0.z) * r0.w;
        const float v = (pv + dv * fac - r1.x) * r1.y;
        // NaN handling in the bounds test (note 1): the JAX kernel writes
        // min(min(fac,u), min(wlen-u, min(v, hlen-v))) >= 0 and relies on
        // jnp.minimum propagating NaN (0 * inf from 1/dir). fminf drops
        // NaN and would accept the hit; this compare chain is false on
        // NaN, as the min-tree is. `u <= wlen` is `wlen - u >= 0` for a
        // finite wlen (IEEE subtraction without flush to zero is exact in
        // sign), and (valid ? fac : MISS) < best is `valid && fac < best`
        // while best <= MISS.
        const bool hit = (da_neg != (r0.y < 0.0f)) && fac >= 0.0f &&
                         u >= 0.0f && u <= r1.z && v >= 0.0f && v <= r1.w &&
                         fac < best;
        best = hit ? fac : best;
        bj = hit ? j : bj;
      }
      start = end;
    }

    // Order within a bounce (note 5): alive *= hit comes before this
    // bounce's deposit, so a miss deposits nothing now or later.
    if (!(best < kHitBelow)) break;

    // The winner: its axis (its group), its sign, and its texel from the
    // u and v of the loop, recomputed from the same floats at fac = best.
    // Texel ids (note 7): base + ty*wt + tx with tx = min(floor(u * ktu),
    // wt - 1), ty = min(floor(v * ktv), ht - 1), as int32; below 2^24 they
    // equal the JAX kernel's f32 ids.
    const int baxis = axis_of(bj, P);
    float4 r0, r1;
    R.loop(bj, r0, r1);
    const float bsign = r0.y;
    const float pu = (baxis == 0) ? py : px;
    const float du = (baxis == 0) ? diry : dirx;
    const float pv = (baxis == 2) ? py : pz;
    const float dv = (baxis == 2) ? diry : dirz;
    const float u = (pu + du * best - r0.z) * r0.w;
    const float v = (pv + dv * best - r1.x) * r1.y;
    const float wt = R.field(A_WT, bj);
    const float tx = fminf(floorf(u * R.field(A_KTU, bj)), wt - 1.0f);
    const float ty = fminf(floorf(v * R.field(A_KTV, bj)),
                           R.field(A_HT, bj) - 1.0f);
    const int btex = static_cast<int>(R.field(A_BASE, bj)) +
                     static_cast<int>(ty) * static_cast<int>(wt) +
                     static_cast<int>(tx);

    px = px + dirx * best;
    py = py + diry * best;
    pz = pz + dirz * best;

    const float hnx = (baxis == 0) ? bsign : 0.0f;
    const float hny = (baxis == 1) ? bsign : 0.0f;
    const float hnz = (baxis == 2) ? bsign : 0.0f;
    const bool diffuse = bounce_in<kDiff>(
        P, bd, hnx, hny, hnz, pz, s_alb, bj,
        [&] { return R.hit_basis(baxis, bsign, hnx, hny, hnz); }, dirx, diry,
        dirz, cr, cg, cb);

    deposit(d, btex, cr, cg, cb, (kDiff && diffuse) ? bj : -1);

    // the +eps nudge uses the NEW direction
    px = px + dirx * P.eps;
    py = py + diry * P.eps;
    pz = pz + dirz * P.eps;
  }
}

}  // namespace
