#!/usr/bin/env python3
"""Time the photon trace kernels, the nearest-hit kernels, the stream
splats and the threefry draws of checkouts of the port on one card, and
digest their outputs.

    python3 flatmatch_tpu_torch/tools/trace_kernel_times.py \
        [--scenes mini,4x4,13x13] [--placements K] [--kernels A,B,...] \
        [--routes] [--ao-walls K] [--general K] ROOT[+VARIANT] \
        [ROOT[+VARIANT] ...]

Each ROOT is a checkout of this repository (for example a `git archive` of
another commit unpacked into a directory that .gitignore lists);
ROOT+VARIANT is a copy of ROOT's package, made for the run in a temporary
directory, with the source edits of VARIANTS[VARIANT] (an ablation: one
design choice of a kernel undone; each edit must match exactly once). For each,
in a fresh interpreter, the script imports that checkout's
flatmatch_tpu_torch, builds its kernels and prints one JSON line: the
device milliseconds per call (chip_smoke.device_ms of this script's
checkout: the calls queued behind a device sleep, so no host work hides in
the time; the median of ROUNDS timed runs, the kernels taking turns) and
the host microseconds per call of
- every instance of the shared trace (rows 1-10 of PERF.md's kernel table:
  the counter-hash and threefry-uniforms renders with the 7-bit and the
  f32 splat, the two stream traces, the diff stream of `fit --splat
  scatter`, the diff forwards and the two folds), per 131072-photon batch;
- the narrow kernel of the general route (row 11,
  `trace_deposits_narrow`) on batch 0 of the scene turned 30 degrees about
  z (chip_smoke.rotated_scene), per 131072-photon batch;
- the stream splats on that batch's 1M-row stream: row 15
  (`fused_splat_i8`, and adding into a lightmap, `fused_splat_i8_add`; a
  checkout without that entry adds `fused_splat_i8`'s increment with
  torch, as its caller did), row 16 with bf16 colors (`fused_splat`) and
  f32 colors (`fused_splat_f32`), and row 16 adding into a lightmap
  (`fused_splat_add`; likewise; `fused_splat_then_add` always adds with
  torch);
- the threefry draws: the scene's last photon batch flat (`threefry_flat`)
  and transposed to [U, B] (`threefry_t`), and radiosity's first chunk of
  the scene's first wall (`threefry_radiosity`);
- the nearest-hit kernels (rows 12-14) on the inputs
  chip_smoke.nearest_inputs makes at the CLI's defaults: `aa_nearest` on
  the first form-factor chunk of wall 0 (512 texels x 10,000 rays) over
  radiosity's extended table, `nearest_distances` on the chunked AO's first
  launch, `ao_fused` on the fused AO's whole pass (on 13x13 its first
  NEAREST_AO_TEXELS_13 texels: the whole pass takes seconds);
on batch 0 of `tests/fixtures/mini.png`, of mini tiled 4x4 and of mini
tiled 13x13 (a table past shared memory: the device-memory instances) at
the CLI's defaults (or the scenes --scenes names), and the SHA-256 of each
kernel's outputs there. The threefry uniforms of the trace are drawn
once, in the [U, B] layout; each checkout's wrappers get the arguments its
signature takes (older ones a `transposed` flag). The diff kernels run at a
per-slot albedo from a numpy seed. After the roots, one line says whether
every root gave the same digests, and the last line names the card and its
power limit. Give two commits in turns (A B B A) to compare them on one
card. With --placements K, each kernel that reads the uniforms is also
timed (the median of ROUNDS runs) on K copies of them at other addresses,
all held at once, to show how far its time depends on where they lie.
--kernels times and digests only the named kernels. With --routes, the
SHA-256 of whole routes that run the stream splats, the narrow kernel and
the threefry draws (`routes`: renders of mini through the stream tiers,
`--splat fused_i8` among them, rotated mini through the narrow and the
general engine, a short `scatter` fit's losses and parameters) and the
wall seconds of three renders (rotated mini and mini tiled 4x4 and turned
30 degrees through the narrow route, mini through `--splat fused_i8`) are
added, and the lightmaps and wall seconds of mini and the 4x4 tiling
through `--engine radiosity` and `--engine ambient_occlusion` (fused and
`--ao-chunked`), the routes of rows 12-14. With --ao-walls K, each root
runs only the AO of the 4x4 tiling, fused and chunked: a digest of each,
K wall seconds of each in turns, and one profiled render of each (the
card's ms by kernel group and busy share); give the roots in turns (A B B
A ...) to compare the walls of two commits. With --general K, each root
runs only the routes of the general intersector (ops/intersect.nearest_hit:
csrc/general_nearest.cu where the checkout has it, else its plain torch
version): SHA-256 of `photon_xla` of mini at the CLI's defaults, of eight
`photon_xla` batches of mini tiled 4x4 and turned 30 degrees, of the
general AO of rotated mini, of `debug` of mini and of radiosity of rotated
mini (a checkout that refuses it records null); the wall seconds of each,
the median of K runs after the digest's run; and the card's ms per call of
nearest_hit (events around a loop of calls, chip_smoke.cuda_ms) on the
second bounce of a photon batch of mini and on the first form-factor
chunk of rotated mini and of rotated 4x4. It needs a CUDA device and
imports no JAX.
"""
import hashlib
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parents[2]
FIXTURES = REPO / "tests" / "fixtures"
# launches per timed run, per scene; each kernel's time is the median of
# ROUNDS runs, the kernels taking turns within each round
# (the stream splats and the draws: STREAM_REPS on every scene)
REPS = {"mini": 200, "4x4": 50, "13x13": 2}
STREAM_REPS = 100
# the nearest-hit kernels' launches per timed run (a 5.12M-ray chunk, a
# 2.1M-ray launch, a whole AO pass)
NEAREST_REPS = {"mini": 50, "4x4": 10, "13x13": 2}
NEAREST_AO_TEXELS_13 = 16384
NEAREST_KERNELS = ("aa_nearest", "nearest_distances", "ao_fused")
ROUNDS = 5

# ablations: (file under flatmatch_tpu_torch/, text, replacement) edits
# that undo one design choice of rows 11-16 or of the threefry kernel
_TF_FLAT = """  const uint32_t stride = gridDim.x * kTfThreads;
  for (uint32_t j = blockIdx.x * kTfThreads + threadIdx.x; j < m;
       j += stride) {
    out[j] = uniform_at(k, hi, lo0 + j);
  }"""
_TF_T = """  for (int p = blockIdx.x * kTfThreads + threadIdx.x; p < rows;
       p += gridDim.x * kTfThreads) {
    const uint32_t ctr = static_cast<uint32_t>(p) * cols;
    float* o = out + static_cast<size_t>(c0) * rows + p;
    for (int c = c0; c < c1; ++c, o += rows) {
      *o = uniform_at(k, 0u, ctr + static_cast<uint32_t>(c));
    }
  }"""
_NARROW = "csrc/trace_deposits_narrow.cu"
_SPLAT = "csrc/splat_stream.cu"
# row 15 as the first port ran it, one thread a row and an int32 atomic in
# L2 per non-zero channel (on the zeroed scratch, with the new finish)
_I8_ROWS = """__global__ void __launch_bounds__(kThreads)
i8_row_kernel(const int* __restrict__ idx, const float* __restrict__ col,
              int rows, int num_texels, float inv_s, int* __restrict__ acc) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int t = idx[r];
  if (static_cast<unsigned>(t) >= static_cast<unsigned>(num_texels)) return;
  const uint32_t key = static_cast<uint32_t>(r) * 3u;
  for (int ch = 0; ch < 3; ++ch) {
    const int q = quant(col[3 * static_cast<size_t>(r) + ch], inv_s,
                        key + static_cast<uint32_t>(ch));
    if (q) atomicAdd(acc + 3 * t + ch, q);
  }
}

int launch_splat(const int* idx, const float* col, int* acc, int rows,
                 int num_texels, I8Slot slot, cudaStream_t s) {
  i8_row_kernel<<<blocks_for(rows), kThreads, 0, s>>>(
      idx, col, rows, num_texels, slot.inv_s, acc);
  return static_cast<int>(cudaGetLastError());
}

// Splat, then finish into"""
_NEAREST = "csrc/aa_nearest.cu"
_AO = "csrc/ao_fused.cu"
_TRACE = "csrc/trace_wide.cuh"
_AO_LOOP = "    for (int k = j; k < k_pad; k += kAoThreads) {\n"
# rows 12-14 reading the [13, N] rows staged as they are, eight scalar
# loads a rect test (the first port's layout)
_ROWS = """#include "trace_wide.cuh"

namespace {

struct RowRects {
  static constexpr int kUnroll = 8;
  const float* s;
  int n;
  __device__ __forceinline__ void loop(int j, float4& a, float4& b) const {
    a = make_float4(s[A_O * n + j], s[A_SN * n + j], s[A_CU * n + j],
                    s[A_WS * n + j]);
    b = make_float4(s[A_CV * n + j], s[A_HS * n + j], s[A_WLEN * n + j],
                    s[A_HLEN * n + j]);
  }
  __device__ __forceinline__ float field(int row, int j) const {
    return s[row * n + j];
  }
};

template <bool kSmem>
__device__ __forceinline__ auto stage_rows(float* smem,
                                           const float* __restrict__ table,
                                           int n) {
  if constexpr (!kSmem) {
    return AaRects<false>{table, n};
  } else {
    stage(smem, table, F_AA * n);
    return RowRects{smem, n};
  }
}

}  // namespace
"""
_ROWS_EDITS = [(f, old, new) for f in (_NEAREST, _AO) for old, new in (
    ('#include "trace_wide.cuh"\n', _ROWS),
    ("  const AaRects<kSmem> rects = stage_aa_rects<kSmem>(smem, scene, N);",
     "  const auto rects = stage_rows<kSmem>(smem, scene, N);"))]
# row 14's texel id worked out inside the loop whenever the minimum
# improves (the first port's branch): nearest_rect writes it through a
# pointer that only row 14 passes
_TEX_IN_LOOP = [
    (_TRACE, "const float dr[3], int& bj) {",
     "const float dr[3], int& bj,\n    int* btex = nullptr) {"),
    (_TRACE, "      bj = hit ? j : bj;\n", """      bj = hit ? j : bj;
      if (btex && hit) {
        const float wt = R.field(A_WT, j);
        const float tx = fminf(floorf(u * R.field(A_KTU, j)), wt - 1.0f);
        const float ty = fminf(floorf(v * R.field(A_KTV, j)),
                               R.field(A_HT, j) - 1.0f);
        *btex = static_cast<int>(R.field(A_BASE, j)) +
                static_cast<int>(ty) * static_cast<int>(wt) +
                static_cast<int>(tx);
      }
"""),
    (_NEAREST, "    int bj;\n    const float best = nearest_rect(rects, g0, g1, "
     "g2, pos, dr, bj);", "    int bj, btex;\n    const float best = "
     "nearest_rect(rects, g0, g1, g2, pos, dr, bj,\n"
     "                                    kTex ? &btex : nullptr);"),
    (_NEAREST, """      float bsign;
      tex[i] = hit ? winner_texel(rects, bj, axis_of(bj, g0, g1), best, pos,
                                  dr, bsign)
                   : -1;""", "      tex[i] = hit ? btex : -1;"),
]
# the trace's rect loop apart from the nearest-hit kernels': its own
# instance of nearest_rect
_LOOPS_APART = [
    (_TRACE, "template <class Scene>\n__device__ __forceinline__ float "
     "nearest_rect(", "template <class Scene, int kCopy = 0>\n"
     "__device__ __forceinline__ float nearest_rect("),
    (_TRACE, "    const float best = nearest_rect(R, P.g0, P.g1, P.g2, pos, "
     "dr, bj);", "    const float best = nearest_rect<Scene, 1>(R, P.g0, "
     "P.g1, P.g2, pos, dr, bj);"),
]
VARIANTS = {
    # rows 12-14: the [13, N] rows, no records
    "nearest_rows": _ROWS_EDITS,
    # row 14: the texel inside the loop
    "nearest_tex_in_loop": _TEX_IN_LOOP,
    # the shared-memory loop (rows 1-10 and 12-14) unrolled 1, 2 or 4
    # times (the design: 8)
    **{f"nearest_unroll{k}": [(_TRACE, "static constexpr int kUnroll = 8;",
                               f"static constexpr int kUnroll = {k};")]
       for k in (1, 2, 4)},
    # row 12's 128 partials added in a shared-memory tree, seven barriers
    "ao_smem_tree": [(_AO, """    if (j < 64) red[j] = red[j] + red[j + 64];
    __syncthreads();
    if (j < 32) {
      float v = red[j] + red[j + 32];
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) {
        v = v + __shfl_down_sync(0xffffffffu, v, w);
      }
      if (j == 0) sums[t] = v;
    }
""", """    for (int w = kAoThreads / 2; w > 0; w >>= 1) {
      if (j < w) red[j] = red[j] + red[j + w];
      __syncthreads();
    }
    if (j == 0) sums[t] = red[0];
""")],
    # row 12 skipping the padded directions (weight 0), which add exactly
    # +0.0 (the same bits while sky is finite)
    "ao_skip_padded": [(_AO, _AO_LOOP,
                        _AO_LOOP + "      if (fac[k] == 0.0f) continue;\n")],
    # rows 12-14 on grids of at most 2,048 (the first port's cap) or 8,192
    # blocks (the design: 32,768)
    **{f"nearest_cap{n}": [(_TRACE, "constexpr int kStrideBlocks = 32768;",
                            f"constexpr int kStrideBlocks = {n};")]
       for n in (2048, 8192)},
    # the trace's rect loop apart from the nearest-hit kernels' (rows 1-10)
    "loops_apart": _LOOPS_APART,
    # row 11: the [18, N] rows staged as they are, fifteen scalar loads a
    # rect test
    "narrow_scalar": [
        (_NARROW, "  float* tex = recs + 16 * n;\n"
                  "  for (int j = threadIdx.x; j < n; j += blockDim.x) {",
         "  float* tex = recs + G_WT * n;\n"
         "  for (int i = threadIdx.x; i < F_GEN * n; i += blockDim.x) {\n"
         "    recs[i] = t[i];\n  }\n"
         "  for (int j = threadIdx.x; false; j += blockDim.x) {"),
        (_NARROW, """    a = rec[4 * j];
    b = rec[4 * j + 1];
    c = rec[4 * j + 2];
    h = rec[4 * j + 3];""",
         """    const float* s = reinterpret_cast<const float*>(rec);
    a = make_float4(s[G_N * n + j], s[(G_N + 1) * n + j],
                    s[(G_N + 2) * n + j], s[G_NOFF * n + j]);
    b = make_float4(s[G_POS * n + j], s[(G_POS + 1) * n + j],
                    s[(G_POS + 2) * n + j], s[G_WLEN * n + j]);
    c = make_float4(s[G_WU * n + j], s[(G_WU + 1) * n + j],
                    s[(G_WU + 2) * n + j], s[G_HLEN * n + j]);
    h = make_float4(s[G_HU * n + j], s[(G_HU + 1) * n + j],
                    s[(G_HU + 2) * n + j], s[G_BASE * n + j]);""")],
    # row 11's shared-memory loop unrolled 1, 2 or 4 times (the design: 8)
    **{f"narrow_unroll{k}": [(_NARROW, "static constexpr int kUnroll = 8;",
                              f"static constexpr int kUnroll = {k};")]
       for k in (1, 2, 4)},
    # row 11's device-memory loop unrolled by 2 (the design: 1)
    "narrow_device_unroll2": [(_NARROW, "static constexpr int kUnroll = 1;",
                               "static constexpr int kUnroll = 2;")],
    # row 11 skipping the division and the projections where denom < 0
    # fails (the same bits)
    "narrow_gated": [
        (_NARROW, "        const float pn = px * a.x + py * a.y + pz * a.z;",
         "        if (!(denom < 0.0f)) continue;\n"
         "        const float pn = px * a.x + py * a.y + pz * a.z;")],
    # row 11 storing each deposit where it lies, never staged
    "narrow_direct": [(_NARROW, "  if (with >= without) {", "  if (false) {")],
    # row 11 staging wherever table and staging fit, blocks or not
    "narrow_staged": [(_NARROW, "  if (with >= without) {", "  if (true) {")],
    # row 11 staging and storing the whole block's deposits together
    "narrow_stage_block": [
        (_NARROW, "constexpr int kGroup = 32;", "constexpr int kGroup = 256;"),
        (_NARROW, "    __syncwarp();", "    __syncthreads();")],
    # row 15 one thread a row, its atomics in L2
    "i8_rows": [(_SPLAT, "// Splat, then finish into", _I8_ROWS)],
    # the stream splats at two blocks a SM (row 15's int32 arena of mini
    # fits twice in an SM; row 16's does not)
    "splat_two_a_sm": [
        (_SPLAT, "__launch_bounds__(kSplatThreads, 1)",
         "__launch_bounds__(kSplatThreads, 2)"),
        (_SPLAT, "  const int most = sm_count();",
         "  const int most = 2 * sm_count();"),
        (_SPLAT, "constexpr int kSplatMinRows = 8192;",
         "constexpr int kSplatMinRows = 4096;")],
    **{f"splat_blocks{n}": [("csrc/splat_stream.cu", "std::min(most, want)",
                             f"std::min({n}, want)")]
       for n in (16, 32, 64, 96)},
    # every row's atomics to device memory (the shared sums stay zero)
    "splat_global": [("csrc/splat_stream.cu", "  if (s != nullptr) {",
                      "  if (false && s != nullptr) {")],
    "splat_atom64": [("csrc/splat_stream.cu",
                      "  unsigned* w = reinterpret_cast<unsigned*>(a);",
                      "  atomicAdd(a, static_cast<unsigned long long>(v));\n"
                      "  return;\n"
                      "  unsigned* w = reinterpret_cast<unsigned*>(a);")],
    # the float by __uint2float_rn and a multiply
    "threefry_i2f": [("csrc/threefry.cu",
                      "return __uint_as_float(((x0 ^ x1) >> 9) | 0x3f800000u)"
                      " - 1.0f;",
                      "return __uint2float_rn((x0 ^ x1) >> 9) * "
                      "(1.0f / 8388608.0f);")],
    # grids of up to 4096 blocks, not whole waves
    "threefry_grid4096": [("csrc/threefry.cu",
                           "return sms > 0 ? sms * kTfBlocksPerSm : -1;",
                           "return sms > 0 ? 4096 : -1;"),
                          ("csrc/threefry.cu",
                           "constexpr int kTfFlatWaves = 4;",
                           "constexpr int kTfFlatWaves = 1;")],
    # the flat draw on one wave
    "threefry_flat_onewave": [("csrc/threefry.cu",
                               "constexpr int kTfFlatWaves = 4;",
                               "constexpr int kTfFlatWaves = 1;")],
    # the flat draw indexed in 64 bits
    "threefry_flat64": [("csrc/threefry.cu", _TF_FLAT, """\
  const long long stride = static_cast<long long>(gridDim.x) * kTfThreads;
  const unsigned long long base =
      (static_cast<unsigned long long>(hi) << 32) | lo0;
  for (long long j = static_cast<long long>(blockIdx.x) * kTfThreads +
                     threadIdx.x;
       j < m; j += stride) {
    const unsigned long long i = base + j;
    out[j] = uniform_at(k, static_cast<uint32_t>(i >> 32),
                        static_cast<uint32_t>(i));
  }""")],
    # the transposed draw walked by its output index, divided by rows
    "threefry_tdiv": [("csrc/threefry.cu", _TF_T, """\
  const long long n = static_cast<long long>(rows) * cols;
  const long long stride =
      static_cast<long long>(gridDim.x) * gridDim.y * kTfThreads;
  for (long long o = (static_cast<long long>(blockIdx.y) * gridDim.x +
                      blockIdx.x) * kTfThreads + threadIdx.x;
       o < n; o += stride) {
    const long long c = o / rows;
    const long long p = o - c * rows;
    out[o] = uniform_at(k, 0u, static_cast<uint32_t>(p * cols + c));
  }""")],
}


def variant_root(root: str, name: str, tmp: str) -> str:
    """A copy of ROOT's package under tmp with VARIANTS[name]'s edits."""
    dst = pathlib.Path(tmp) / name
    shutil.copytree(pathlib.Path(root) / "flatmatch_tpu_torch",
                    dst / "flatmatch_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, old, new in VARIANTS[name]:
        f = dst / "flatmatch_tpu_torch" / rel
        text = f.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {rel} holds {text.count(old)} "
                               f"copies of the text to edit")
        f.write_text(text.replace(old, new))
    return str(dst)


def load_smoke():
    """chip_smoke of this script's checkout, whichever checkout is
    measured: its device_ms (fn, reps -> (device ms, host µs) per call) and
    rotated_scene."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def digest(out) -> str:
    """SHA-256 of a kernel's output tensors: dtype, shape and bytes."""
    import torch

    h = hashlib.sha256()
    for t in (out if isinstance(out, (tuple, list)) else (out,)):
        t = t.detach().contiguous().cpu()
        h.update(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def kernel_calls(pw, prender, cfg, f, gc, ev, seed, u_t, alb, inv,
                 fixed, g, T, B):
    """name -> call of every trace instance on one batch, with the uniforms-in wrappers given [U, B] uniforms in
    whatever form their signature asks for."""
    import inspect

    import torch

    def uniforms_in(fn):
        if "transposed" in inspect.signature(fn).parameters:
            return lambda *a, **kw: fn(*a, transposed=True, **kw)
        return fn

    n = f.shape[1]
    acc = torch.empty((T, 3), dtype=torch.int32, device=f.device)
    diff_block = prender.diff_block(B)
    return {
        "trace_splat_wide_rng_i8": lambda: pw.trace_splat_wide_rng_i8(
            f, gc, ev, seed, B, B, cfg, T, out=acc),
        "trace_splat_wide_rng_f32": lambda: pw.trace_splat_wide_rng_f32(
            f, gc, ev, seed, B, B, cfg, T),
        "trace_deposits_wide_rng": lambda: pw.trace_deposits_wide_rng(
            f, gc, ev, seed, B, B, cfg),
        "trace_deposits_wide": lambda: uniforms_in(pw.trace_deposits_wide)(
            f, gc, ev, u_t, B, cfg),
        "trace_splat_wide_i8": lambda: uniforms_in(pw.trace_splat_wide_i8)(
            f, gc, ev, u_t, B, cfg, T, out=acc),
        "trace_splat_wide_f32": lambda: uniforms_in(pw.trace_splat_wide_f32)(
            f, gc, ev, u_t, B, cfg, T),
        "trace_deposits_wide_diff": lambda: uniforms_in(
            pw.trace_deposits_wide_diff)(f, gc, alb, ev, u_t, B, cfg,
                                         diff_block),
        "trace_splat_wide_diff_i8": lambda: uniforms_in(
            pw.trace_splat_wide_diff_i8)(f, gc, alb, ev, u_t, B, cfg, T, inv,
                                         out=acc),
        "trace_splat_wide_diff_f32": lambda: uniforms_in(
            pw.trace_splat_wide_diff_f32)(f, gc, alb, ev, u_t, B, cfg, T,
                                          fixed),
        "trace_splat_wide_diff_rng_i8":
            lambda: pw.trace_splat_wide_diff_rng_i8(f, gc, alb, ev, seed, B,
                                                    B, cfg, T, inv, out=acc),
        "trace_splat_wide_diff_rng_f32":
            lambda: pw.trace_splat_wide_diff_rng_f32(f, gc, alb, ev, seed, B,
                                                     B, cfg, T, fixed),
        "trace_fold_wide": lambda: uniforms_in(pw.trace_fold_wide)(
            f, gc, alb, ev, g, u_t, B, cfg, n),
        "trace_fold_wide_rng": lambda: pw.trace_fold_wide_rng(
            f, gc, alb, ev, g, seed, B, B, cfg, n),
    }


def stream_calls(sp, threefry, cfg, rad, idx, col, T, gb, chunk, lm0):
    """name -> call of the stream splats on one batch's stream and of the
    threefry draws; `fused_splat_add` and `fused_splat_i8_add` add into
    copies of lm0 made once, so their digests are of lm0 plus one
    increment (each timed call adds one more)."""
    import math

    bound = sp.stream_bound(cfg)
    scale = sp.splat_color_scale(cfg)
    lm, lm2, lm8 = lm0.clone(), lm0.clone(), lm0.clone()
    if hasattr(sp, "fused_splat_add"):
        def add():
            return sp.fused_splat_add(lm, idx, col, bound)
    else:
        def add():
            lm.add_(sp.fused_splat(idx, col, T, bound))
            return lm
    if hasattr(sp, "fused_splat_i8_add"):
        def add_i8():
            return sp.fused_splat_i8_add(lm8, idx, col, scale)
    else:
        def add_i8():
            lm8.add_(sp.fused_splat_i8(idx, col, T, scale))
            return lm8
    key = threefry.fold_in(threefry.prng_key(cfg.seed), gb)
    U = 4 + 3 * int(cfg.max_depth)
    B = cfg.photons_per_batch
    rkey = threefry.fold_in(threefry.fold_in(threefry.prng_key(rad.seed), 0),
                            0)
    rshape = (chunk, int(rad.rays_per_texel), 2)
    assert math.prod(rshape) > 0
    return {
        "fused_splat_i8": lambda: sp.fused_splat_i8(idx, col, T, scale),
        "fused_splat_i8_add": add_i8,
        "fused_splat": lambda: sp.fused_splat(idx, col, T, bound),
        "fused_splat_f32": lambda: sp.scatter_splat(idx, col, T, bound),
        "fused_splat_add": add,
        "fused_splat_then_add": lambda: lm2.add_(sp.fused_splat(idx, col, T,
                                                                bound)),
        "threefry_flat": lambda: threefry.uniform(key, (B, U), idx.device),
        "threefry_t": lambda: threefry.uniform(key, (B, U), idx.device,
                                               transposed=True),
        "threefry_radiosity": lambda: threefry.uniform(rkey, rshape,
                                                       idx.device),
    }


def nearest_calls(smoke, scene, dev, name):
    """name -> call of the nearest-hit kernels (rows 12-14) on the inputs
    of chip_smoke.nearest_inputs at the CLI's defaults."""
    from flatmatch_tpu_torch.config import DEFAULT_CONFIG
    from flatmatch_tpu_torch.engines import ao
    from flatmatch_tpu_torch.ops import aa_query

    inp = smoke.nearest_inputs(scene, dev, DEFAULT_CONFIG)
    ext, aa = inp["aa_ext"], inp["aa"]
    centers, walls, dirs, fac = inp["fused"]
    if name == "13x13":
        centers = centers[:NEAREST_AO_TEXELS_13]
        walls = walls[:NEAREST_AO_TEXELS_13]
    return {
        "aa_nearest": lambda: aa_query.aa_nearest(
            ext.fields, ext.group_counts, inp["src"], inp["direc"]),
        "nearest_distances": lambda: aa_query.nearest_distances(
            aa.fields, aa.group_counts, inp["origins"], inp["dirs"], 10.0),
        "ao_fused": lambda: ao.ao_fused(aa.fields, aa.group_counts, centers,
                                        walls, dirs, fac, 10.0),
    }


UNIFORM_KERNELS = ("trace_deposits_wide", "trace_splat_wide_i8",
                   "trace_splat_wide_f32", "trace_deposits_wide_diff",
                   "trace_splat_wide_diff_i8", "trace_splat_wide_diff_f32",
                   "trace_fold_wide")


def routes(dev, mini, tiled4, rotated_scene):
    """SHA-256 of whole routes that run rows 11, 15 and 16 and the threefry
    draws, on the checkout imported: the photon arena of mini through
    `--splat fused`, `fused_i8` and `scatter` (device RNG) and threefry
    with `fused`, of mini turned 30 degrees at the library's defaults (the
    narrow route) and through `photon_xla` at a tenth of the samples (the
    general engine), and the losses, parameters and lightmap of a 3-step
    `scatter` fit of mini; and the wall seconds of renders of rotated mini
    and of mini through `--splat fused_i8` (each run again after its
    digest's run) and of the 4x4 tiling turned 30 degrees (the narrow
    route, once, after the others)."""
    import dataclasses

    import numpy as np
    import torch

    from flatmatch_tpu_torch.config import DEFAULT_CONFIG, Engine
    from flatmatch_tpu_torch.diff.fit import fit_materials
    from flatmatch_tpu_torch.diff.render import make_diff_renderer_wide
    from flatmatch_tpu_torch.ops.aa_scene import pack_aa
    from flatmatch_tpu_torch.ops.device_scene import pack_emitters
    from flatmatch_tpu_torch.render import compile_scene, run_engine

    base = DEFAULT_CONFIG
    ph = base.photon

    def photon(**kw):
        return base.replace(photon=dataclasses.replace(ph, **kw))

    scene, _ = compile_scene(str(mini), 30.0, base)
    rscene = rotated_scene(scene, 30)
    out = {
        "render_mini_fused": run_engine(
            scene, photon(device_rng=True, splat="fused"), dev),
        "render_mini_scatter": run_engine(
            scene, photon(device_rng=True, splat="scatter"), dev),
        "render_mini_fused_i8": run_engine(
            scene, photon(device_rng=True, splat="fused_i8"), dev),
        "render_mini_threefry_fused": run_engine(
            scene, photon(device_rng=False, splat="fused"), dev),
        "render_rotated_mini": run_engine(rscene, base, dev),
        "render_rotated_mini_xla": run_engine(
            rscene, photon(samples_per_area=ph.samples_per_area / 10).replace(
                engine=Engine.PHOTON_XLA), dev),
    }
    cfg = dataclasses.replace(ph, device_rng=False, splat="scatter")
    em = pack_emitters(scene, ph.samples_per_area, ph.window_color,
                       ph.light_color, device=dev)
    aa = pack_aa(scene.walls, device=dev)
    r = make_diff_renderer_wide(em, scene.num_texels, cfg, aa)
    with torch.no_grad():
        target = r(torch.full((len(scene.walls),), 0.9, device=dev),
                   torch.ones(len(em.counts), device=dev)).cpu().numpy()
    fit = fit_materials(target, None, em, scene.num_texels, cfg, aa=aa,
                        steps=3,
                        init_albedo=0.6, init_power=0.5)
    out["fit_mini_scatter"] = (fit.losses, fit.albedo, fit.power,
                               fit.lightmap)
    res = {k: digest(tuple(torch.from_numpy(np.ascontiguousarray(a))
                           for a in (v if isinstance(v, tuple) else (v,))))
           for k, v in out.items()}
    seconds = {}

    def wall(key, sc, c):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm = run_engine(sc, c, dev)
        torch.cuda.synchronize()
        seconds[key] = time.perf_counter() - t0
        return lm

    wall("render_rotated_mini", rscene, base)
    wall("render_mini_fused_i8", scene, photon(device_rng=True,
                                               splat="fused_i8"))
    scene4, _ = compile_scene(str(tiled4), 30.0, base)
    res["render_rotated_4x4"] = digest(torch.from_numpy(wall(
        "render_rotated_4x4", rotated_scene(scene4, 30), base)))
    # the nearest-hit routes (rows 12-14): radiosity and AO, fused and
    # chunked, of mini and the 4x4 tiling, each digested, then timed again
    ao_cfg = base.replace(engine=Engine.AMBIENT_OCCLUSION)
    engines = {
        "radiosity": base.replace(engine=Engine.RADIOSITY),
        "ao_fused": ao_cfg,
        "ao_chunked": ao_cfg.replace(ao=dataclasses.replace(base.ao,
                                                            fused=False)),
    }
    for sname, sc in (("mini", scene), ("4x4", scene4)):
        for ename, c in engines.items():
            key = f"render_{sname}_{ename}"
            res[key] = digest(torch.from_numpy(run_engine(sc, c, dev)))
            wall(key, sc, c)
    return res, seconds


def ao_walls(dev, tiled4, reps, profiled):
    """The AO of the 4x4 tiling through run_engine, fused and
    `--ao-chunked`: each rendered and digested once, then `reps` times
    each in turns (wall seconds a render), then once more each under
    chip_smoke.profiled (the card's ms by kernel group and its busy share
    of the wall: the rest of the wall is the host's)."""
    import dataclasses

    import torch

    from flatmatch_tpu_torch.config import DEFAULT_CONFIG, Engine
    from flatmatch_tpu_torch.render import compile_scene, run_engine

    fused = DEFAULT_CONFIG.replace(engine=Engine.AMBIENT_OCCLUSION)
    cfgs = {"fused": fused, "chunked": fused.replace(
        ao=dataclasses.replace(fused.ao, fused=False))}
    scene, _ = compile_scene(str(tiled4), 30.0, DEFAULT_CONFIG)
    sha = {f"render_4x4_ao_{k}": digest(torch.from_numpy(
        run_engine(scene, c, dev))) for k, c in cfgs.items()}
    walls = {k: [] for k in cfgs}
    for _ in range(reps):
        for k, c in cfgs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_engine(scene, c, dev)
            torch.cuda.synchronize()
            walls[k].append(time.perf_counter() - t0)
    prof = {k: profiled(lambda c=c: run_engine(scene, c, dev))
            for k, c in cfgs.items()}
    return sha, walls, prof


def general_routes(dev, smoke, tiled4, reps):
    """The --general mode: digests, median walls of `reps` runs and
    nearest_hit's ms on the general intersector's routes."""
    import dataclasses

    import numpy as np
    import torch

    from flatmatch_tpu_torch.config import DEFAULT_CONFIG, Engine
    from flatmatch_tpu_torch.debug.raytrace import Camera, render_first_hit
    from flatmatch_tpu_torch.engines import ao_general, photon
    from flatmatch_tpu_torch.engines.schedule import emitter_slice
    from flatmatch_tpu_torch.ops import intersect, threefry
    from flatmatch_tpu_torch.ops.device_scene import pack_rects
    from flatmatch_tpu_torch.render import compile_scene, run_engine

    base = DEFAULT_CONFIG
    ph = base.photon
    mini = FIXTURES / "mini.png"
    scene, _ = compile_scene(str(mini), 30.0, base)
    rscene = smoke.rotated_scene(scene, 30)
    r4 = smoke.rotated_scene(compile_scene(str(tiled4), 30.0, base)[0], 30)
    g4 = smoke.general_setup(r4, base, dev)
    em0 = emitter_slice(g4["em"], 0)
    U = 4 + 3 * ph.max_depth
    lay = scene.layout
    cam = Camera(position=(lay.starting_position[0],
                           lay.starting_position[1], 1.6))
    rects_mini = pack_rects(scene.walls, device=dev)
    rects_rot = pack_rects(rscene.walls, device=dev)

    def xla8():
        lm = torch.zeros((r4.num_texels, 3), device=dev)
        for gb in range(8):
            photon.trace_batch(lm, g4["rects"], em0, threefry.batch_uniforms(
                ph.seed, gb, ph.photons_per_batch, U, dev),
                ph.photons_per_batch, ph)
        return lm

    def radiosity():
        try:
            return run_engine(rscene, base.replace(engine=Engine.RADIOSITY),
                              dev)
        except NotImplementedError:
            return None

    jobs = {
        "photon_xla_mini": lambda: run_engine(
            scene, base.replace(engine=Engine.PHOTON_XLA), dev),
        "photon_xla_rotated_4x4_8_batches": xla8,
        "general_ao_rotated_mini": lambda: ao_general.render_ao(
            rscene, rects_rot, base.ao),
        "debug_mini": lambda: render_first_hit(scene, rects_mini, cam),
        "radiosity_rotated_mini": radiosity,
    }
    sha, walls = {}, {}
    for k, fn in jobs.items():
        out = fn()
        if out is None:
            sha[k] = walls[k] = None
            continue
        if isinstance(out, np.ndarray):
            out = torch.from_numpy(np.ascontiguousarray(out))
        sha[k] = digest(out)
        runs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        walls[k] = statistics.median(runs)
    rays = {"mini_photon_bounce": (rects_mini, *smoke.second_bounce_rays(
        smoke.general_setup(scene, base, dev), base))}
    for name, sc in (("rotated_mini", rscene), ("rotated_4x4", r4)):
        rays[f"{name}_form_factors"] = smoke.form_factor_rays(sc, dev)
    nearest_ms = {k: smoke.cuda_ms(
        lambda r=r, s=s_, d=d: intersect.nearest_hit(s, d, r),
        20 if k.startswith("mini") else 3) for k, (r, s_, d) in rays.items()}
    return sha, walls, nearest_ms


def measure(root: str, names, placements=0, kernels=None,
            with_routes=False, ao_reps=0, general_reps=0) -> dict:
    sys.path.insert(0, root)
    import dataclasses
    import importlib.util

    import numpy as np
    import torch

    from flatmatch_tpu_torch.config import DEFAULT_CONFIG
    from flatmatch_tpu_torch.diff import render as prender
    from flatmatch_tpu_torch.engines import photon_narrow as pn
    from flatmatch_tpu_torch.engines import photon_wide as pw
    from flatmatch_tpu_torch.ops import rng, splat as sp, threefry
    from flatmatch_tpu_torch.ops.aa_scene import pack_aa
    from flatmatch_tpu_torch.ops.device_scene import pack_emitters, pack_rects
    from flatmatch_tpu_torch.render import compile_scene
    from flatmatch_tpu_torch.scene.rectangle import num_tiles

    smoke = load_smoke()
    device_ms = smoke.device_ms
    if not pathlib.Path(pw.__file__).resolve().is_relative_to(
            pathlib.Path(root).resolve()):
        raise RuntimeError(f"imported {pw.__file__}, not from {root}")
    dev = torch.device("cuda")
    cfg = dataclasses.replace(DEFAULT_CONFIG.photon, device_rng=True,
                              splat="inkernel_i8")
    B = cfg.photons_per_batch
    spec = importlib.util.spec_from_file_location(
        "make_layout", FIXTURES / "make_layout.py")
    make_layout = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(make_layout)
    out = {"root": root, "sha256": {}}
    with tempfile.TemporaryDirectory() as tmp:
        scenes = {"mini": FIXTURES / "mini.png"}
        for k in (4, 13):
            scenes[f"{k}x{k}"] = pathlib.Path(tmp) / f"mini_{k}x{k}.png"
            make_layout.tiled(str(scenes["mini"]), str(scenes[f"{k}x{k}"]),
                              k, k)
        if ao_reps:
            out["sha256"]["routes"], out["ao_walls_s"], out["ao_profile"] = \
                ao_walls(dev, scenes["4x4"], ao_reps, smoke.profiled)
            return out
        if general_reps:
            (out["sha256"]["general"], out["general_wall_s"],
             out["nearest_hit_ms"]) = general_routes(
                 dev, smoke, scenes["4x4"], general_reps)
            return out
        for name in names:
            png = scenes[name]
            scene, _ = compile_scene(str(png), 30.0, DEFAULT_CONFIG)
            aa_c, T, _ = pw.compact_aa(pack_aa(scene.walls, dev),
                                       scene.num_texels)
            em = pack_emitters(scene, cfg.samples_per_area, cfg.window_color,
                               cfg.light_color, device=dev)
            f, gc = aa_c.fields, aa_c.group_counts
            rs = np.random.RandomState(1)
            g = torch.from_numpy(rs.rand(T, 3).astype(np.float32)).to(dev)
            alb = torch.from_numpy(rs.uniform(0.4, 0.95, f.shape[1]).astype(
                np.float32)).to(dev)
            inv = torch.full(
                (1,), np.float32(1.0 / pw.splat_color_scale(cfg)),
                device=dev)
            fixed = torch.tensor(
                [np.float32(x) for x in
                 sp.fixed_point_scale(sp.stream_bound(cfg))], device=dev)
            u_t = threefry.batch_uniforms(
                cfg.seed, 0, B, pw.uniforms_per_photon(cfg.max_depth), dev,
                transposed=True)
            ev, seed = pw.emitter_vector(em, 0), rng.batch_seed(cfg.seed, 0)
            fns = kernel_calls(pw, prender, cfg, f, gc, ev, seed, u_t, alb,
                               inv, fixed, g, T, B)
            # row 11 on the scene turned 30 degrees (no axis-aligned table)
            rsc = smoke.rotated_scene(scene, 30)
            table = pn.narrow_table(pack_rects(rsc.walls, device=dev))
            rev = pw.emitter_vector(pack_emitters(
                rsc, cfg.samples_per_area, cfg.window_color, cfg.light_color,
                device=dev), 0)
            fns["trace_deposits_narrow"] = (
                lambda table=table, rev=rev: pn.trace_deposits_narrow(
                    table, rev, u_t, B, cfg))
            idx, col = pw.trace_deposits_wide_rng(f, gc, ev, seed, B, B, cfg)
            last = sum(-(-int(n) // B) for n in em.counts if n > 0) - 1
            chunk = min(int(DEFAULT_CONFIG.radiosity.texels_per_chunk),
                        num_tiles(scene.walls[0]))
            lm0 = torch.from_numpy(rs.rand(T, 3).astype(np.float32)).to(dev)
            stream = stream_calls(sp, threefry, cfg, DEFAULT_CONFIG.radiosity,
                                  idx, col, T, last, chunk, lm0)
            fns.update(stream)
            if not kernels or set(kernels) & set(NEAREST_KERNELS):
                fns.update(nearest_calls(smoke, scene, dev, name))
            if kernels:
                fns = {k: fn for k, fn in fns.items() if k in kernels}
            out["sha256"][name] = {k: digest(fn()) for k, fn in fns.items()}
            runs = {k: [] for k in fns}
            for _ in range(ROUNDS):
                for k, fn in fns.items():
                    runs[k].append(device_ms(
                        fn, STREAM_REPS if k in stream else
                        NEAREST_REPS[name] if k in NEAREST_KERNELS else
                        REPS[name]))
            out[name] = {k: statistics.median(v[0] for v in runs[k])
                         for k in runs}
            out[f"{name}_host_us"] = {
                k: statistics.median(v[1] for v in runs[k]) for k in runs}
            if placements and not kernels:
                copies = [u_t.clone() for _ in range(placements)]
                times = {k: [] for k in UNIFORM_KERNELS}
                for u in copies:
                    fns = kernel_calls(pw, prender, cfg, f, gc, ev, seed, u,
                                       alb, inv, fixed, g, T, B)
                    for k in UNIFORM_KERNELS:
                        times[k].append(statistics.median(
                            device_ms(fns[k], REPS[name])[0]
                            for _ in range(ROUNDS)))
                out[f"{name}_placements"] = times
                del copies
        if with_routes:
            out["sha256"]["routes"], out["render_wall_s"] = routes(
                dev, scenes["mini"], scenes["4x4"], smoke.rotated_scene)
    return out


def main(argv):
    opts = {"--scenes": "mini,4x4,13x13", "--placements": "0",
            "--kernels": "", "--ao-walls": "0", "--general": "0"}
    with_routes = False
    while argv and (argv[0] in opts or argv[0] == "--routes"):
        if argv[0] == "--routes":
            with_routes, argv = True, argv[1:]
            continue
        opts[argv[0]] = argv[1]
        argv = argv[2:]
    scenes = opts["--scenes"]
    placements = int(opts["--placements"])
    kernels = [k for k in opts["--kernels"].split(",") if k]
    ao_reps = int(opts["--ao-walls"])
    general_reps = int(opts["--general"])
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(measure(argv[1], scenes.split(","), placements,
                                 kernels, with_routes, ao_reps,
                                 general_reps)), flush=True)
        return 0
    variants = {r.rpartition("+")[2] for r in argv if "+" in r}
    if (not argv or not set(scenes.split(",")) <= set(REPS)
            or not variants <= set(VARIANTS)):
        print(__doc__, file=sys.stderr)
        return 2
    digests = []
    for arg in argv:
        with tempfile.TemporaryDirectory() as tmp:
            root, _, variant = arg.partition("+")
            if variant:
                root = variant_root(root, variant, tmp)
            cmd = [sys.executable, __file__, "--scenes", scenes,
                   "--placements", str(placements), "--kernels",
                   ",".join(kernels), "--ao-walls", str(ao_reps),
                   "--general", str(general_reps)] + (
                       ["--routes"] if with_routes else [])
            res = subprocess.run(cmd + ["--one", root], capture_output=True,
                                 text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        line = json.loads(res.stdout.strip().splitlines()[-1])
        line["root"] = arg
        digests.append(line["sha256"])
        print(json.dumps(line), flush=True)
    differ = sorted({f"{scene}/{k}" for d in digests[1:]
                     for scene, ks in d.items() for k in ks
                     if ks[k] != digests[0][scene][k]})
    print(json.dumps({"same_digests": not differ, "differ": differ}))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    print(card.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
