// The axis-aligned nearest-hit query of one ray, shared by the kernels of
// aa_nearest.cu (rows 13 and 14 of the kernel table in PERF.md) and
// ao_fused.cu (row 12).
//
// It is the rect loop of the TPU kernels flatmatch_tpu/ops/aa_query.py
// _make_kernel (:39-121) and flatmatch_tpu/engines/ao_pallas.py
// _make_kernel / _make_fused_kernel (:42-105, :329-405), with the semantics
// of the photon trace's loop (trace_wide.cuh:213-268):
//   - rects are tested group by group, in table order, and a strict `<`
//     keeps the first of equal minima (the TPU kernels' tie break);
//   - the bounds test is a compare chain that is false on NaN. The TPU
//     kernels write a jnp.minimum tree, which propagates NaN; fminf would
//     drop it. AO directions from the geosphere table have exact zero
//     components, so 1/dir = inf and 0 * inf = NaN do occur;
//   - texel id = base + ty * wt + tx with tx = min(floor(u * ktu), wt - 1)
//     and ty = min(floor(v * ktv), ht - 1), no lower clip, as int32 (below
//     2^24 it equals the TPU kernel's f32 id).
// Every kernel that includes this builds with -fmad=false, so each product
// is rounded on its own, as the plain PyTorch version
// (flatmatch_tpu_torch/ops/aa_query.py nearest_hit) rounds it. The photon
// trace keeps its own copy of the loop: a change to these rules goes into
// both.
#pragma once

#include "trace_wide.cuh"  // table rows, kMiss, kHitBelow, stage()

namespace {

// Nearest front-face distance of the ray (o, d) over the [F_AA][N] table
// `s` (in shared memory), kMiss when nothing is hit. With kTex it also
// sets `btex` to the hit texel id (left 0 on a miss).
template <bool kTex>
__device__ __forceinline__ float aa_nearest_hit(const float* __restrict__ s,
                                                int N, int g0, int g1,
                                                int g2, float ox, float oy,
                                                float oz, float dx, float dy,
                                                float dz, int& btex) {
#define S(row, j) s[(row) * N + (j)]
  const float pos[3] = {ox, oy, oz};
  const float dr[3] = {dx, dy, dz};
  // division by zero gives inf; the bounds test rejects those rects
  const float inv[3] = {1.0f / dx, 1.0f / dy, 1.0f / dz};
  const int counts[3] = {g0, g1, g2};
  float best = kMiss;
  btex = 0;
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
    for (int j = start; j < end; ++j) {
      const float fac = (S(A_O, j) - pa) * ia;
      const bool front = da_neg != (S(A_SN, j) < 0.0f);
      const float u = (pu + du * fac - S(A_CU, j)) * S(A_WS, j);
      const float v = (pv + dv * fac - S(A_CV, j)) * S(A_HS, j);
      const bool valid = front && fac >= 0.0f && u >= 0.0f &&
                         S(A_WLEN, j) - u >= 0.0f && v >= 0.0f &&
                         S(A_HLEN, j) - v >= 0.0f;
      const float dist = valid ? fac : kMiss;
      if (dist < best) {
        best = dist;
        if (kTex) {
          const float wt = S(A_WT, j);
          const float tx = fminf(floorf(u * S(A_KTU, j)), wt - 1.0f);
          const float ty = fminf(floorf(v * S(A_KTV, j)), S(A_HT, j) - 1.0f);
          btex = static_cast<int>(S(A_BASE, j)) +
                 static_cast<int>(ty) * static_cast<int>(wt) +
                 static_cast<int>(tx);
        }
      }
    }
    start = end;
  }
#undef S
  return best;
}

// Blocks of a grid-stride launch over `work` items of `per_block` each:
// enough to fill the card, few enough that staging the scene table into
// every block's shared memory stays a small share of the work.
inline int capped_blocks(long long work, int per_block) {
  const long long want = (work + per_block - 1) / per_block;
  return static_cast<int>(want < 2048 ? (want > 0 ? want : 1) : 2048);
}

}  // namespace
