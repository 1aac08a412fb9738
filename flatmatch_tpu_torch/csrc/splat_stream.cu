// Stream splats: sum a deposit stream (texel id [R] int32, color [R, 3]
// f32) into a [T, 3] f32 lightmap increment, or add it into a lightmap.
//
// Replaces the TPU kernels of flatmatch_tpu/ops/splat_pallas.py, whose
// one-hot MXU contraction it does not copy; it computes what they compute:
//   - fused_splat_i8 (:145, kernel :105): each color quantized to the 7-bit
//     grid, clip(floor(c * inv_s + dither01(row * 3 + ch)), 0, 127), summed
//     exactly into an int32 accumulator by integer atomicAdd, then de-scaled
//     once (acc * scale). Integer sums do not depend on order, so the
//     result equals the JAX package's bit for bit;
//   - fused_splat (:219, kernel :73): each color rounded to bf16 once
//     (round to nearest even, as astype(bfloat16)), summed in f32. With
//     kBf16 = false the colors stay f32: the `scatter` and `bucket_exact`
//     modes of engines/photon_pallas_wide._splat (:1541, ops/splat.py:88).
// The f32 sum is deterministic, with no float atomics: each color becomes a
// 64-bit fixed-point integer at a power-of-two scale 2^k chosen by the
// wrapper (ops/splat.py), to_fixed (trace_wide.cuh, shared with the
// in-kernel f32 splat), so that no texel's sum can pass 2^62; the integers
// are summed exactly and each texel's sum is converted to f32 once. Integer
// addition is associative even as it wraps, so every grouping of the sums
// gives the same bits. At the engine's k (37 for 131072-photon batches of 8
// bounces and colors up to 18) every color above 2^-14 converts exactly,
// so the sum is the exact sum rounded once to f32: closer to it than any
// f32 order. Ids outside [0, T) are skipped, as the JAX one-hot drops them;
// zero colors are skipped.
//
// What bounds both splats on an H100, and the design. The bytes are 16 a
// row (1M rows of a 131072-photon batch: 16.8 MB, 5 us at 3.35 TB/s) and
// the [T, 3] sums. One L2 atomic per non-zero channel (the first port) put
// 2.5M atomics a batch on the ~18k slots that one emitter's batch lights,
// each about 138 times, and serialized there. Here each block sums its run
// of rows into a private accumulator in shared memory, then adds its
// non-zero slots to the accumulator in device memory (int64 for the f32
// splat, int32 for the 7-bit one), coalesced; one kernel template serves
// both, on the slot type (FixedSlot, I8Slot):
//   - the int64 slots: 32-bit shared atomics on the two halves of each
//     slot, the carry of the low half taken from its atomicAdd's return
//     value: exact, and 1.7x faster than a 64-bit shared atomicAdd, which
//     sm_90 runs as a compare-and-swap loop (ATOMS.CAST.SPIN.64); the int32
//     slots take sm_90's native 32-bit shared atomicAdd;
//   - one block of 1024 threads a SM (an accumulator takes most of the
//     SM's shared memory), at least 8,192 rows a block: more blocks read
//     the stream faster and flush more slots, and one a SM was fastest on
//     mini and the 4x4 tiling;
//   - each thread reads four rows as 16-byte loads (an int4 of ids, three
//     float4 of colors) and loads its next four before it sums the last;
//     the 7-bit grid's dither is keyed by the row, 4 q + k for row k of
//     quad q.
// Two accumulator instances, chosen by the arena's size:
//   - arena: the whole [T, 3] accumulator in shared memory (24 T bytes for
//     int64 slots, up to 9,685 texels: mini's 6,008 take 144 KB; 12 T
//     bytes for int32, up to 19,370);
//   - paged: a table of up to kMaxPages pages of 256 texels, claimed by a
//     block on the first non-zero row that hits each page through a
//     1,024-entry directory keyed by page id; a row whose page finds no
//     entry or no free page adds to device memory directly (one emitter's
//     batch of the 4x4 tiling lights 33 pages of its 377).
// The finishing pass converts each slot once and zeroes it, so the scratch
// is left zeroed for the next call (no memset), and either writes the
// increment (fm_fused_splat, fm_fused_splat_i8) or adds it into the
// lightmap (fm_fused_splat_add: lm[i] + f32(acc[i]) * 2^-k;
// fm_fused_splat_i8_add: lm[i] + f32(acc[i]) * scale; each rounded as
// `lm += inc` rounds it under -fmad=false). A call is two launches.
// PERF.md has the measurements and the ablation behind each choice.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (see
// flatmatch_tpu_torch/utils/cuda_build.py).
#include <algorithm>

#include "sm_count.cuh"
#include "trace_wide.cuh"

namespace {

constexpr int kSplatThreads = 1024;
constexpr int kSplatMinRows = 8192;      // rows a block takes at least
constexpr int kPageTexels = 256;
constexpr int kPageSlots = 3 * kPageTexels;
constexpr int kDirEntries = 1024;
constexpr int kMaxPages = 64;
// the paged instance's directory: keys, page of each entry, page ids of
// the claimed pages and their count, ahead of the pages (16-byte aligned)
constexpr size_t kDirBytes = sizeof(int) * (2 * kDirEntries + kMaxPages + 4);

enum Accumulator { kArena = 0, kPaged = 1 };

// The slot types: what a color adds (value: false when it adds nothing)
// and how a slot in shared memory takes it.
// The fixed-point f32 splat: int64 slots, to_fixed (trace_wide.cuh).
template <bool kBf16>
struct FixedSlot {
  using T = unsigned long long;
  float scale;   // 2^k
  __device__ __forceinline__ bool value(float c, uint32_t, T* v) const {
    long long x;
    if (!to_fixed<kBf16>(c, scale, &x)) return false;
    *v = static_cast<T>(x);
    return true;
  }
};

// The 7-bit splat: int32 slots, quant (trace_wide.cuh) keyed by row * 3 +
// ch in 32-bit wrap arithmetic (dither01).
struct I8Slot {
  using T = int;
  float inv_s;
  __device__ __forceinline__ bool value(float c, uint32_t key, T* v) const {
    *v = quant(c, inv_s, key);
    return *v != 0;
  }
};

// a += v on a slot in shared memory, exactly (mod 2^64 or 2^32)
__device__ __forceinline__ void shared_add(int* a, int v) { atomicAdd(a, v); }

__device__ __forceinline__ void shared_add(unsigned long long* a,
                                           unsigned long long v) {
  // the low half by a 32-bit atomicAdd, whose return value says whether
  // it carried; the high half takes the value's high word and the carry
  unsigned* w = reinterpret_cast<unsigned*>(a);
  const unsigned lo = static_cast<unsigned>(v);
  const unsigned hi =
      static_cast<unsigned>(static_cast<unsigned long long>(v) >> 32);
  const unsigned old = atomicAdd(w, lo);
  const unsigned h = hi + (old + lo < old ? 1u : 0u);
  if (h != 0) atomicAdd(w + 1, h);
}

template <class T>
struct Pages {
  int* keys;        // [kDirEntries] page id, -1 when free
  int* entry_page;  // [kDirEntries] page slot of the entry, -1 when none
  int* page_id;     // [kMaxPages] page id of each claimed slot
  int* used;        // claimed slots (may pass `cap`: the rest are refused)
  T* sums;          // [cap][kPageSlots]
  int cap;

  // the slot of texel page p in this block, claimed on first use; -1 when
  // the directory entry is taken by another page or no slot is left.
  __device__ __forceinline__ int slot(int p) const {
    const int d = p & (kDirEntries - 1);
    const int k = reinterpret_cast<volatile int*>(keys)[d];
    if (k == p) return reinterpret_cast<volatile int*>(entry_page)[d];
    if (k == -1 && atomicCAS(keys + d, -1, p) == -1) {
      const int s = atomicAdd(used, 1);
      if (s < cap) {
        page_id[s] = p;
        reinterpret_cast<volatile int*>(entry_page)[d] = s;
        return s;
      }
    }
    return -1;
  }
};

// Add stream row r (id t, colors c0..c2) to the block's accumulator
// (kArena: `arena`, kPaged: `pages`, with device memory for the rows they
// refuse).
template <class Slot, int kAcc, class T = typename Slot::T>
__device__ __forceinline__ void add_row(T* arena, const Pages<T>& pages,
                                        T* __restrict__ acc, int num_texels,
                                        const Slot& slot, int r, int t,
                                        float c0, float c1, float c2) {
  if (static_cast<unsigned>(t) >= static_cast<unsigned>(num_texels)) return;
  const uint32_t key = static_cast<uint32_t>(r) * 3u;
  T v[3] = {0, 0, 0};
  const bool any = slot.value(c0, key, &v[0]) |
                   slot.value(c1, key + 1u, &v[1]) |
                   slot.value(c2, key + 2u, &v[2]);
  if (!any) return;
  T* s = nullptr;
  if (kAcc == kArena) {
    s = arena + 3 * t;
  } else {
    const int page = pages.slot(t / kPageTexels);
    if (page >= 0) {
      s = pages.sums + page * kPageSlots + 3 * (t % kPageTexels);
    }
  }
  if (s != nullptr) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      if (v[ch] != 0) shared_add(s + ch, v[ch]);
    }
  } else {
    T* g = acc + 3 * static_cast<size_t>(t);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      if (v[ch] != 0) atomicAdd(g + ch, v[ch]);
    }
  }
}

struct Quad {
  int4 t;
  float4 a, b, c;
};

__device__ __forceinline__ Quad load_quad(const int4* __restrict__ idx4,
                                          const float4* __restrict__ col4,
                                          int q) {
  return Quad{__ldg(idx4 + q), __ldg(col4 + 3 * q), __ldg(col4 + 3 * q + 1),
              __ldg(col4 + 3 * q + 2)};
}

// Sum `rows` stream rows into the zeroed [num_texels, 3] accumulator `acc`
// of Slot::T. Block b takes quads (four rows, 16-byte aligned) [q0, q1) of
// the first `quads`, each thread loading its next quad before it sums the
// last; the rows past the quads (rows % 4, or all rows when the stream is
// not 16-byte aligned and quads == 0) go one a thread over the grid.
template <class Slot, int kAcc, class T = typename Slot::T>
__global__ void __launch_bounds__(kSplatThreads, 1)
fused_splat_kernel(const int* __restrict__ idx, const float* __restrict__ col,
                   int rows, int quads, int num_texels, Slot slot, int cap,
                   T* __restrict__ acc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  T* arena = reinterpret_cast<T*>(smem);
  Pages<T> pages{};
  if (kAcc == kArena) {
    for (int i = tid; i < 3 * num_texels; i += kSplatThreads) arena[i] = 0;
  } else {
    int* dir = reinterpret_cast<int*>(smem);
    pages = Pages<T>{dir, dir + kDirEntries, dir + 2 * kDirEntries,
                     dir + 2 * kDirEntries + kMaxPages,
                     reinterpret_cast<T*>(smem + kDirBytes), cap};
    for (int i = tid; i < 2 * kDirEntries; i += kSplatThreads) dir[i] = -1;
    if (tid == 0) *pages.used = 0;
    for (int i = tid; i < cap * kPageSlots; i += kSplatThreads) {
      pages.sums[i] = 0;
    }
  }
  __syncthreads();

  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  const float4* col4 = reinterpret_cast<const float4*>(col);
  const int per = (quads + gridDim.x - 1) / gridDim.x;
  const int q0 = blockIdx.x * per;
  const int q1 = min(quads, q0 + per);
  int q = q0 + tid;
  Quad cur{};
  if (q < q1) cur = load_quad(idx4, col4, q);
  while (q < q1) {
    const int nq = q + kSplatThreads;
    Quad next = cur;
    if (nq < q1) next = load_quad(idx4, col4, nq);
    const int r = 4 * q;
    add_row<Slot, kAcc>(arena, pages, acc, num_texels, slot, r, cur.t.x,
                        cur.a.x, cur.a.y, cur.a.z);
    add_row<Slot, kAcc>(arena, pages, acc, num_texels, slot, r + 1, cur.t.y,
                        cur.a.w, cur.b.x, cur.b.y);
    add_row<Slot, kAcc>(arena, pages, acc, num_texels, slot, r + 2, cur.t.z,
                        cur.b.z, cur.b.w, cur.c.x);
    add_row<Slot, kAcc>(arena, pages, acc, num_texels, slot, r + 3, cur.t.w,
                        cur.c.y, cur.c.z, cur.c.w);
    cur = next;
    q = nq;
  }
  for (int r = 4 * quads + blockIdx.x * kSplatThreads + tid; r < rows;
       r += gridDim.x * kSplatThreads) {
    const size_t c = 3 * static_cast<size_t>(r);
    add_row<Slot, kAcc>(arena, pages, acc, num_texels, slot, r, idx[r],
                        col[c], col[c + 1], col[c + 2]);
  }
  __syncthreads();

  // the block's non-zero sums into device memory, neighbouring threads on
  // neighbouring slots
  if (kAcc == kArena) {
    for (int i = tid; i < 3 * num_texels; i += kSplatThreads) {
      const T v = arena[i];
      if (v != 0) atomicAdd(acc + i, v);
    }
  } else {
    const int used = min(*pages.used, cap);
    for (int i = tid; i < used * kPageSlots; i += kSplatThreads) {
      const T v = pages.sums[i];
      if (v != 0) {
        const int s = i / kPageSlots;
        atomicAdd(acc + static_cast<size_t>(pages.page_id[s]) * kPageSlots +
                      (i - s * kPageSlots),
                  v);
      }
    }
  }
}

// Finish: f = f32(acc[i]) * scale (2^-k: one rounding, then an exact
// power-of-two scaling; the 7-bit grid's spacing: two roundings, as
// `acc.float() * scale`); out[i] = f, or with kAdd out[i] += f. Each
// non-zero slot is zeroed, so the scratch is zero again for the next call.
__device__ __forceinline__ float slot_float(unsigned long long v) {
  return __ll2float_rn(static_cast<long long>(v));
}

__device__ __forceinline__ float slot_float(int v) { return __int2float_rn(v); }

template <class T, bool kAdd>
__global__ void __launch_bounds__(kThreads)
finish_kernel(T* __restrict__ acc, int n, float scale,
              float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T v = acc[i];
  if (v != 0) acc[i] = 0;
  const float f = slot_float(v) * scale;
  out[i] = kAdd ? out[i] + f : f;
}

// The accumulator instance for an arena of num_texels texels of `slot`
// bytes a channel, and its dynamic shared memory: the arena when its
// 3 * slot * T bytes fit in a block, else the pages (fm_fused_splat_plan
// and fm_fused_splat_i8_plan report this choice).
Accumulator accumulator_of(int num_texels, size_t slot, int* cap,
                           size_t* smem) {
  const size_t arena = slot * 3 * static_cast<size_t>(num_texels);
  if (arena <= kSmemLimit) {
    *cap = 0;
    *smem = arena;
    return kArena;
  }
  const int pages = (num_texels + kPageTexels - 1) / kPageTexels;
  const int fit =
      static_cast<int>((kSmemLimit - kDirBytes) / (slot * kPageSlots));
  *cap = std::min(std::min(kMaxPages, fit), pages);
  *smem = kDirBytes + slot * kPageSlots * *cap;
  return kPaged;
}

template <class Slot, class T = typename Slot::T>
int launch_splat(const int* idx, const float* col, T* acc, int rows,
                 int num_texels, Slot slot, cudaStream_t s) {
  int cap;
  size_t smem;
  const Accumulator a = accumulator_of(num_texels, sizeof(T), &cap, &smem);
  void (*k)(const int*, const float*, int, int, int, Slot, int, T*) =
      a == kArena ? fused_splat_kernel<Slot, kArena>
                  : fused_splat_kernel<Slot, kPaged>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool aligned = (reinterpret_cast<uintptr_t>(idx) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(col) % 16 == 0);
  const int quads = aligned ? rows / 4 : 0;
  // one block a SM: a block's accumulator takes most of an SM's shared
  // memory
  const int most = sm_count();
  if (most <= 0) return sm_count_error();
  const int want = (rows + kSplatMinRows - 1) / kSplatMinRows;
  const int blocks = std::max(1, std::min(most, want));
  k<<<blocks, kSplatThreads, smem, s>>>(idx, col, rows, quads, num_texels,
                                        slot, cap, acc);
  return static_cast<int>(cudaGetLastError());
}

// Splat, then finish into `out` (kAdd: add into it); acc is zero on entry
// and left zero.
template <bool kAdd, class Slot, class T = typename Slot::T>
int splat_entry(const int* idx, const float* col, T* acc, float* out,
                int rows, int num_texels, Slot slot, float scale,
                void* stream) {
  if (num_texels <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    const int err = launch_splat(idx, col, acc, rows, num_texels, slot, s);
    if (err != 0) return err;
  }
  const int n = 3 * num_texels;
  finish_kernel<T, kAdd><<<blocks_for(n), kThreads, 0, s>>>(acc, n, scale,
                                                            out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kAdd>
int fused_splat_entry(const int* idx, const float* col, long long* acc,
                      float* out, int rows, int num_texels, int round_bf16,
                      float to_fixed_scale, float from_fixed, void* stream) {
  unsigned long long* a = reinterpret_cast<unsigned long long*>(acc);
  return round_bf16
             ? splat_entry<kAdd>(idx, col, a, out, rows, num_texels,
                                 FixedSlot<true>{to_fixed_scale}, from_fixed,
                                 stream)
             : splat_entry<kAdd>(idx, col, a, out, rows, num_texels,
                                 FixedSlot<false>{to_fixed_scale},
                                 from_fixed, stream);
}

}  // namespace

// C entry points, loaded with ctypes. Each splats `rows` rows on `stream`
// and returns the CUDA error code (0 on success).
//
// acc: int32 [>= num_texels * 3] scratch, zero on entry and left zero;
// inv_s = f32(1 / scale). fm_fused_splat_i8 writes the f32 [num_texels, 3]
// increment acc * scale to `out`; fm_fused_splat_i8_add adds it into the
// lightmap `lm`.
extern "C" int fm_fused_splat_i8(const int* idx, const float* col, int* acc,
                                 float* out, int rows, int num_texels,
                                 float inv_s, float scale, void* stream) {
  return splat_entry<false>(idx, col, acc, out, rows, num_texels,
                            I8Slot{inv_s}, scale, stream);
}

extern "C" int fm_fused_splat_i8_add(const int* idx, const float* col,
                                     int* acc, float* lm, int rows,
                                     int num_texels, float inv_s, float scale,
                                     void* stream) {
  return splat_entry<true>(idx, col, acc, lm, rows, num_texels,
                           I8Slot{inv_s}, scale, stream);
}

// acc: int64 [>= num_texels * 3] scratch, zero on entry and left zero;
// colors are rounded to bf16 first when round_bf16 != 0; to_fixed = 2^k,
// from_fixed = 2^-k. fm_fused_splat writes the f32 [num_texels, 3]
// increment to `out`; fm_fused_splat_add adds it into the lightmap `lm`.
extern "C" int fm_fused_splat(const int* idx, const float* col,
                              long long* acc, float* out, int rows,
                              int num_texels, int round_bf16, float to_fixed,
                              float from_fixed, void* stream) {
  return fused_splat_entry<false>(idx, col, acc, out, rows, num_texels,
                                  round_bf16, to_fixed, from_fixed, stream);
}

extern "C" int fm_fused_splat_add(const int* idx, const float* col,
                                  long long* acc, float* lm, int rows,
                                  int num_texels, int round_bf16,
                                  float to_fixed, float from_fixed,
                                  void* stream) {
  return fused_splat_entry<true>(idx, col, acc, lm, rows, num_texels,
                                 round_bf16, to_fixed, from_fixed, stream);
}

// The accumulator instance (0: arena, 1: paged) that fm_fused_splat and
// fm_fused_splat_add (int64 slots), or fm_fused_splat_i8 and
// fm_fused_splat_i8_add (int32 slots, fm_fused_splat_i8_plan), take for
// an arena of num_texels texels, and its dynamic shared memory in bytes;
// no launch, no stream.
static int plan(int num_texels, size_t slot, int* instance,
                int* shared_bytes) {
  int cap;
  size_t smem;
  *instance = static_cast<int>(accumulator_of(num_texels, slot, &cap, &smem));
  *shared_bytes = static_cast<int>(smem);
  return 0;
}

extern "C" int fm_fused_splat_plan(int num_texels, int* instance,
                                   int* shared_bytes) {
  return plan(num_texels, sizeof(long long), instance, shared_bytes);
}

extern "C" int fm_fused_splat_i8_plan(int num_texels, int* instance,
                                      int* shared_bytes) {
  return plan(num_texels, sizeof(int), instance, shared_bytes);
}
