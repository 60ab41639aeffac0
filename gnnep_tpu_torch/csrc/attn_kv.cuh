// attn_kv.cuh: what the kv+e attention's forward (attn_fwd.cu, kernel 3)
// and backward (attn_bwd.cu, kernel 4) and the external-logits
// softmax-aggregate's (softmax_aggregate_fwd.cu and _bwd.cu, kernels 1 and
// 2) share: how a warp's lanes hold a row, the words they move it in, the
// sums over a head's lanes, and the lanes that do a group's softmax
// bookkeeping.
//
// A row of `hidden` channels (heads x ch) is cut into spans of SPAN bytes
// (16, 8, 4 or 2; VEC = SPAN / sizeof(T) channels), never straddling two
// heads: SPAN divides the head's bytes. A lane's slot holds one span, moved
// as SPAN / W words of W bytes. The launch plan
// (gnnep_tpu_torch/ops/cuda/kv_layout.py:kv_plan) picks SPAN from the
// head's bytes and the layout alone, W from SPAN and the base addresses of
// the rows the kernel moves in words, and the heads a warp holds (hpw):
//
//  - grouped (a head of at most 32 spans, wph): a head's spans sit in one
//    aligned group of `gl` lanes (gl = wph rounded up to a power of two),
//    32 / gl heads to a slab of 32 lanes, S slabs; lane l of slab s holds
//    span l % gl of the warp's head s * (32 / gl) + l / gl. A warp holds
//    hpw <= S * 32 / gl heads of one target (the plan: one slab's). A
//    head's dot product is summed inside the lane, then over its group by
//    butterfly shuffles, after which every lane of the group holds it.
//  - wide (more than 32 spans): a warp per (target, head); lane l of slab s
//    in pass p holds span (p * S + s) * 32 + l of the head. The dot product
//    is summed over the lane's slabs and passes, then over the warp.
//
// `split` warps (1, 2 or 4, consecutive in a block) may share a target's
// row: warp r takes the groups r, r + split, ... of each chunk; the kernels
// merge the warps' softmax statistics and partial sums through shared
// memory at a named barrier per target, in the order of the warps.
//
// The softmax's scalar work runs on pair lanes: after a group of G edges'
// dot products, lane h * G + g takes the pair (head h of the warp, edge g)
// (hpw * G <= 32), so one instruction serves every pair of the group, and a
// head's G pairs sit in one aligned group of G lanes for its max and sums.
//
// The order of every sum depends on SPAN and the layout alone, so a run on
// misaligned bases (narrower words) is bitwise the aligned run. Nothing
// depends on the data, so a captured CUDA graph replays the planned launch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace attn_kv {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;   // warps per block, at most
constexpr int kMaxHeads = 8;   // heads a by-target warp holds, at most
constexpr int kChunk = 32;     // edges whose per-head values sit on chip
// edges to a group: a lane loads the words of kEdges / S edges together
constexpr int kEdges = 4;

template <int B>
struct Raw;
template <>
struct Raw<16> {
  using type = uint4;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<4> {
  using type = uint32_t;
};
template <>
struct Raw<2> {
  using type = uint16_t;
};

// an element's bits as they sit in a word, widened to f32 and rounded back
// (round to nearest even, as torch's casts)
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  using bits = float;
  __device__ static float widen(float x) { return x; }
  __device__ static float narrow(float x) { return x; }
};
template <>
struct Elem<__nv_bfloat16> {
  using bits = uint16_t;
  __device__ static float widen(uint16_t b) {
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  }
  __device__ static uint16_t narrow(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

// round an f32 value to the storage type T and back
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return Elem<T>::widen(Elem<T>::narrow(x));
}

// One slot of a lane: SPAN bytes of a row (VEC = SPAN / sizeof(T)
// channels), moved as SPAN / W words of W bytes. The layout and the order of
// every sum depend on SPAN alone, which the head's bytes fix; W only follows
// the base addresses' alignment, so a misaligned run is bitwise an aligned
// one.
template <typename T, int SPAN, int W>
struct Span {
  static_assert(W >= static_cast<int>(sizeof(T)) && SPAN % W == 0,
                "a word holds whole elements and divides the span");
  static constexpr int kVec = SPAN / static_cast<int>(sizeof(T));
  static constexpr int kWords = SPAN / W;
  using R = typename Raw<W>::type;
  struct Regs {
    R w[kWords];
  };
  union U {
    R w[kWords];
    typename Elem<T>::bits e[kVec];
  };
  __device__ __forceinline__ static Regs zero() {
    U u;
#pragma unroll
    for (int i = 0; i < kVec; ++i) u.e[i] = Elem<T>::narrow(0.f);
    Regs r;
#pragma unroll
    for (int i = 0; i < kWords; ++i) r.w[i] = u.w[i];
    return r;
  }
  // kStream: evict-first loads, for rows read once from tensors larger
  // than L2
  template <bool kStream = false>
  __device__ __forceinline__ static Regs load(const T* p) {
    Regs r;
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      if constexpr (kStream)
        r.w[i] = __ldcs(reinterpret_cast<const R*>(p) + i);
      else
        r.w[i] = reinterpret_cast<const R*>(p)[i];
    }
    return r;
  }
  __device__ __forceinline__ static void unpack(const Regs& r, float* x) {
    U u;
#pragma unroll
    for (int i = 0; i < kWords; ++i) u.w[i] = r.w[i];
#pragma unroll
    for (int i = 0; i < kVec; ++i) x[i] = Elem<T>::widen(u.e[i]);
  }
  // x rounded to T, stored as SPAN / W words; kStream: streaming stores,
  // for rows written once to tensors larger than L2
  template <bool kStream = false>
  __device__ __forceinline__ static void store(T* p, const float* x) {
    U u;
#pragma unroll
    for (int i = 0; i < kVec; ++i) u.e[i] = Elem<T>::narrow(x[i]);
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      if constexpr (kStream)
        __stcs(reinterpret_cast<R*>(p) + i, u.w[i]);
      else
        reinterpret_cast<R*>(p)[i] = u.w[i];
    }
  }
};

// VEC f32 values to an f32 array, in stores of at most 16 bytes (the
// destination is aligned to min(VEC, 4) floats)
template <int VEC>
__device__ __forceinline__ void store_f32(float* p, const float* x) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(x[i], x[i + 1],
                                                      x[i + 2], x[i + 3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// The layout of a launch (see the top of this file), derived from the plan
// by `make_layout` and checked there.
struct Layout {
  int wide;         // 1: a head's spans over slabs and passes (hpw 1)
  int hpw;          // heads a warp holds
  int wph;          // spans per head
  int gl_log2;      // log2 of the lanes of a head group (5 if wide)
  int hps;          // heads per slab (0 if wide)
  int sw;           // spans per slab and pass if wide (32; else 0)
  int passes;       // passes of 32 * S spans if wide; else 1
  int split;        // warps that share a target's row
  int warps;        // warps per block (split x targets per block)
  int tblocks;      // blocks over the targets, for one group of heads
  int main_blocks;  // blocks over targets and groups of heads
  int tail_blocks;  // (backward) blocks that zero the dummy row's dk, dv
};

// lane's slot s: its head, counted from the warp's first head, and its span
// inside the head in pass 0
struct Slot {
  int hl;
  int wih0;
};

__device__ __forceinline__ Slot slot_of(const Layout& L, int s, int lane) {
  return Slot{s * L.hps + (lane >> L.gl_log2),
              s * L.sw + (lane & ((1 << L.gl_log2) - 1))};
}

// butterfly sum over the aligned group of 2^gl_log2 lanes
__device__ __forceinline__ float group_sum(float x, int gl_log2) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < (1 << gl_log2)) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Each slot's head dot product from the lanes' partial sums acc[G][S], in
// place: grouped, each slab over its head's group; wide, the slabs in
// order, then the warp (every slab then holds the head's one sum).
template <int G, int S>
__device__ __forceinline__ void head_dots(float (&acc)[G][S],
                                          const Layout& L) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (L.wide) {
      float d = acc[g][0];
#pragma unroll
      for (int s = 1; s < S; ++s) d += acc[g][s];
      d = warp_sum(d);
#pragma unroll
      for (int s = 0; s < S; ++s) acc[g][s] = d;
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s) acc[g][s] = group_sum(acc[g][s], L.gl_log2);
    }
  }
}

// Pair lanes: lane h * G + g of the warp takes head h (of the warp's nh)
// and edge g of a group. The pair's value from the slot lanes' x[G][S]
// (after head_dots): the lane of slab s = h / hps at the start of its head's
// group holds it; wide, every lane does.
template <int G, int S>
__device__ __forceinline__ float to_pair(const float (&x)[G][S],
                                         const Layout& L, int lane) {
  const int h = lane / G, g = lane % G;
  const int hps = L.hps > 0 ? L.hps : 1;
  const int src = (h % hps) << L.gl_log2;
  const int sh = h / hps;
  float out = 0.f;
#pragma unroll
  for (int gg = 0; gg < G; ++gg)
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float y = L.wide ? x[gg][s] : __shfl_sync(kFull, x[gg][s], src);
      if (gg == g && s == sh) out = y;
    }
  return out;
}

// The `split` warps of one target (consecutive in the block) wait for each
// other: a named barrier per target, so that the other targets of the
// block, whose rows differ, never wait on it.
__device__ __forceinline__ void target_barrier(int warp, int split) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + warp / split), "r"(split * 32)
               : "memory");
}

// max and sum over the aligned groups of G lanes (a head's pairs)
template <int G>
__device__ __forceinline__ float pair_max(float x) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
template <int G>
__device__ __forceinline__ float pair_sum(float x) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// lanes 0 and 1 load a target's CSR bounds, every lane gets both
__device__ __forceinline__ void row_bounds(const int* row_ptr, int t,
                                           int lane, int* lo, int* hi) {
  const int b = row_ptr[t + (lane & 1)];
  *lo = __shfl_sync(kFull, b, 0);
  *hi = __shfl_sync(kFull, b, 1);
}

// The external-logits kernels' clamp, as the TPU kernels'
// (csr_attention.py:93-96): a logit of -1e30 (masked) never counts.
__device__ __forceinline__ bool counts(float l) { return l > 0.5f * kNeg; }

// x[h][u] of a warp's shared rows, read unconditionally: h and u wrap into
// the rows (a caller selects the value only where they are in range), so
// the read needs no branch and a load it predicates stays a predicated load
__device__ __forceinline__ float row_at(const float (*x)[kChunk + 1], int h,
                                        int u) {
  return x[h & (kMaxHeads - 1)][u & (kChunk - 1)];
}

// Lane u of a chunk of `cnt` edges from j0, where its group of G edges is
// one of this warp's (every split-th from the r-th; split a power of two):
// the values of the warp's nh heads from h0 at edge j0 + u of NA [E, heads]
// arrays src[i] (a null one reads as 1), into the shared rows dst[i][h][u].
// An edge's heads are one contiguous run; every load is issued before the
// first store.
template <int G, int NA>
__device__ __forceinline__ void chunk_to_shared(
    const float* const (&src)[NA], int heads, int h0, int nh, int j0,
    int cnt, int lane, int r, int split,
    float (*const (&dst)[NA])[kChunk + 1]) {
  if (lane >= cnt || ((lane / G) & (split - 1)) != r) return;
  const size_t at = static_cast<size_t>(j0 + lane) * heads + h0;
  float xv[NA][kMaxHeads];
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h)
      if (h < nh) xv[i][h] = src[i] ? src[i][at + h] : 1.f;
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h)
      if (h < nh) dst[i][h][lane] = xv[i][h];
}

// Zero bytes [lo, hi) of each of the NP arrays p (16-byte aligned bases;
// lo and hi even): 16-byte stores inside, 2-byte stores at the ends;
// thread `me` of `stride` threads. A backward's first blocks zero the
// dummy row's per-edge gradient rows with it.
template <int NP>
__device__ __forceinline__ void zero_bytes(char* const (&p)[NP], size_t lo,
                                           size_t hi, size_t me,
                                           size_t stride) {
  const size_t lo16 = (lo + 15) / 16 * 16, hi16 = hi / 16 * 16;
  if (lo16 >= hi16) {  // under 32 bytes: 2-byte stores
    for (size_t b = lo + 2 * me; b < hi; b += 2 * stride)
#pragma unroll
      for (int i = 0; i < NP; ++i) *reinterpret_cast<uint16_t*>(p[i] + b) = 0;
    return;
  }
  for (size_t w = lo16 / 16 + me; w < hi16 / 16; w += stride)
#pragma unroll
    for (int i = 0; i < NP; ++i)
      reinterpret_cast<uint4*>(p[i])[w] = make_uint4(0, 0, 0, 0);
  // the unaligned ends, under 16 bytes each
  if (me < 8) {
    const size_t b0 = lo + 2 * me, b1 = hi16 + 2 * me;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (b0 < lo16) *reinterpret_cast<uint16_t*>(p[i] + b0) = 0;
      if (b1 < hi) *reinterpret_cast<uint16_t*>(p[i] + b1) = 0;
    }
  }
}

// The layout of a plan: spans of `span` bytes moved in words of `word`,
// `slabs` spans per lane and pass, `hpw` heads per warp, `split` warps per
// target, `warps` per block and `tail_blocks`; false where the plan does
// not fit the shape, the type or a base address (each pointer in `ptrs`
// must be aligned to the word). G = kEdges / slabs edges to a group; the
// kernel's pair lanes take windows of `pair_mult` groups, so hpw such
// windows must fit a warp.
inline bool make_layout(int n, int hidden, int heads, int item, int span,
                        int word, int slabs, int hpw, int split, int warps,
                        int tail_blocks, const void* const* ptrs, int nptrs,
                        Layout* L, int pair_mult = 1) {
  if (n < 1 || heads < 1 || hidden % heads) return false;
  const int ch = hidden / heads;
  auto pow2 = [](int b) { return b == 2 || b == 4 || b == 8 || b == 16; };
  if (!pow2(span) || !pow2(word) || word < item || word > span ||
      (ch * item) % span)
    return false;
  for (int i = 0; i < nptrs; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % word) return false;
  if (!(slabs == 1 || slabs == 2)) return false;
  if (warps < 1 || warps > kMaxWarps || tail_blocks < 0) return false;
  if (!(split == 1 || split == 2 || split == 4) || warps % split) return false;
  if (hpw < 1 || hpw > heads || hpw > kMaxHeads ||
      hpw * pair_mult * (kEdges / slabs) > 32)
    return false;
  L->hpw = hpw;
  L->wph = ch * item / span;
  L->wide = L->wph > 32;
  L->split = split;
  L->warps = warps;
  L->tblocks = (n + warps / split - 1) / (warps / split);
  L->tail_blocks = tail_blocks;
  if (L->wide) {
    if (hpw != 1) return false;
    L->gl_log2 = 5;
    L->hps = 0;
    L->sw = 32;
    L->passes = (L->wph + 32 * slabs - 1) / (32 * slabs);
  } else {
    int g = 0;
    while ((1 << g) < L->wph) ++g;
    L->gl_log2 = g;
    L->hps = 32 >> g;
    L->sw = 0;
    L->passes = 1;
    if (slabs * L->hps < hpw) return false;
  }
  // a split row reduces its warps' sums in the buffers of its one pass
  if (split > 1 && L->passes > 1) return false;
  const long long groups = (heads + hpw - 1) / hpw;
  L->main_blocks = static_cast<int>(L->tblocks * groups);
  return L->tblocks * groups + tail_blocks < (1LL << 31);
}

}  // namespace attn_kv
