// attn_eproj_bwd.cuh: backward of the CSR graph attention with the edge
// projection fused in, shared by two entry points, each built for sm_90a:
//
//  - attn_eproj_bwd.cu: kernel 6, the port of `_attn_ep_bwd_kernel`
//    (gnnep_tpu/ops/pallas/csr_attention.py), kv an edge-space arena
//    [E, 2H] whose gradient dkv [E, 2H] has one writer per row;
//  - attn_span_bwd.cu: kernel 9, the port of `_attn_sp_bwd_kernel`, kv the
//    node-space table [N_src, 2H] read at row src[j], whose gradient is
//    summed into node space (Span below).
//
// For every target t, head h and live edge j of t's CSR range, with the
// forward's softmax max m_t and denominator d_t:
//
//   e_j = ea_j · W_e[:, h],  k_j = kv_j[h] + e_j,  v_j = kv_j[H + h] + e_j
//   s_j = exp(q_t · k_j / sqrt(ch) - m_t) / d_t,    a_j = s_j · scale_t[h, j]
//   u_j = g_t · v_j,   inner_t = sum_j a_j u_j
//   dl_j = s_j (scale_t[h, j] u_j - inner_t)
//   dq_t = sum_j dl_j k_j / sqrt(ch),  dk_j = dl_j q_t / sqrt(ch),  dv_j = a_j g_t
//   de_j = dk_j + dv_j,  dea_j = de_j · W_eᵀ,  dW_e = sum_j ea_jᵀ de_j
//
// Arguments as the JAX function's: q [N, H], kv [E, 2H], ea [E, Fe], W_e
// [Fe, H] in float32 or bfloat16 (one type), scale_t f32 [heads, E], mask2
// f32 [E], row_ptr i32 [N+1], g f32 [N, H], the forward's max and denom f32
// [N, heads]; outputs dq [N, H], dkv [E, 2H], dea [E, Fe] in the input type
// and dW_e f32 [Fe, H] (the wrapper casts it to W_e's type).
//
// Design. Two kernels. A block of the first owns a tile of consecutive
// targets, so one contiguous range of the dst-sorted arena, and one head;
// each edge row of dkv and dea has exactly one writer.
//
//  Tiles are cut by edges, not by target count: the wrapper passes
//  tile_ptr [tiles + 1], the first target of each tile, from the rule in
//  `attention_eproj.bwd_tile_ptr` (every tile holds about E_live / tiles
//  edges, more only by the in-degree of its last row; the dummy row n-1 is
//  in none), with one wave of (tiles, heads) blocks over the SMs.
//
//  The three E·Fe·H products run on the tensor cores as warp-level
//  `mma.sync` tiles, from operands staged in shared memory:
//   bf16: m16n8k16 bf16 products with f32 accumulators (HMMA), operands
//    read with `ldmatrix` (its .trans form for the operands whose
//    contraction index is not the contiguous one);
//   f32: 3xTF32 on m16n8k8 tf32 tiles: each operand x splits into
//    hi = tf32(x) and lo = tf32(x - hi), and the tile sums lo·hi + hi·lo +
//    hi·hi in f32. Plain TF32 would keep 11 bits of each operand; the split
//    keeps 22, and its error stays at the f32 FMA design's scale
//    (chip_smoke's float64 line). Chosen over a register-blocked FFMA
//    tiling because it shares the bf16 path's tiles and staging and runs
//    at several times the CUDA cores' f32 rate.
//  Every staged tile (ea, de and W_e slices) arrives by `cp.async`
//  (16-byte copies, zero-filled past the ragged edges and for dead rows)
//  into a ring of four stages (two in phase 1 in f32, for shared memory):
//  three slices' copies are in flight while one slice's products run.
//  Rows or columns whose addresses are not 16-byte aligned (an odd Fe in
//  bf16, say) are staged by plain loads. In f32 each slice's products go
//  to a fresh tile, added to the running sum with IEEE adds, so the tensor
//  cores' own accumulation never spans more than one 32-deep slice.
//  Row strides are padded so that the eight rows an `ldmatrix` (or a
//  quarter-warp's scalar fragment loads) touches fall in distinct banks.
//
//  attn_eproj_bwd_attn: 256 threads per (tile, head), W_e's head slice
//  [Fe, ch] resident in shared memory in the input type.
//   Phase 1 recomputes e = ea · W_e[:, h] 64 edges at a time (M 64, N ch
//   padded to 16/32/64/128, K Fe padded to 32 in slices of 32; each warp a
//   16-row × ch/2 tile), puts e in shared memory and writes each edge's
//   logit and u, and its k row, to scratch (each thread's channels of a
//   row as one vector access).
//   Phase 2 gives each warp one target at a time: inner_t over the row, then
//   dl and the rounded alpha of 32 edges at a time, then per edge the dk, dv
//   and de rows and the running dq, two channels a lane (bf16x2 / float2
//   loads and stores where ch is even), the k rows of four edges loaded
//   before any is used.
//   Phase 3 sums ea_jᵀ de_j over the tile's edges (M Fe in passes of 128,
//   N ch, K the tile's edges in slices of 32; ea enters with Fe contiguous,
//   so as the transposed operand; each warp a 32 × ch/2 tile) and adds its
//   dW_e slice with one atomic add per (tile, Fe row, column): CUDA blocks
//   run in no order, so the TPU kernel's sum over its sequential grid into
//   one resident block has no counterpart.
//  attn_eproj_bwd_dea: one block per 64 edges, dea = de · W_eᵀ over all
//   heads (M 64, N Fe in passes of 128, K H in slices of 32), and zero
//   rows of dkv for every dead edge (a warp per row).
//
// With Span, phase 1 reads kv row src[j] of the node table, only for a live
// edge, and phase 2 adds each live edge's dk and dv rows, rounded to the
// input type as kernel 6 rounds its dkv rows, into an f32 node-space
// accumulator [N_src, 2H] with atomics (several tiles add into one source
// row, in no order); the dea kernel writes no dkv.
//
// Hazards, each handled here:
//  - Zeros, not garbage. A dead edge is one with mask2 <= 0 or one owned by
//    the dummy row n-1 (the arena's tail padding, never walked, as in the
//    forward). Its dkv and dea rows are written as zeros by the second
//    kernel; its de row is staged as zero for both products. dq of the
//    dummy row is written as zero. With Span a dead edge never reads kvn
//    and adds nothing to it.
//  - All-masked rows keep max -1e30: s is only formed for live edges, so no
//    exp of a huge argument and no inf·0 can arise.
//  - bf16 rounding mirrors the TPU kernel (csr_attention.py:1194-1243): e, k
//    and v round to the input type; g rounds to it before u and dv; dl and
//    alpha round to it; dq, dk, dv and de round to it after f32 sums; dea
//    rounds after its f32 product. dW_e stays f32.
//  - Padding: Fe is padded to 32 and ch to 16/32/64/128 inside the kernel
//    (zero-filled staging), the ragged last chunk and slice are zero rows.
//
// What bounds it on this card. The three products are about 26 GFLOP a
// launch at the flagship line-graph conv (E 74,880, Fe = H = 256) against
// about 220 MB (f32) or 120 MB (bf16) of traffic. Before this design they
// ran as f32 FMAs (1.9 / 2.6 ms); on the tensor cores they no longer set
// the time in bf16: copies of this header with a `return` after phase 1
// or phase 2, timed by dev/bwd_bench.py on an H100 (PERF.md §6), put
// 0.18 ms in phase 1 (mostly its epilogue's gathers of kv, q and g rows),
// 0.22 in phase 2's per-edge walk, 0.10 in phase 3 and 0.13 in the dea
// kernel, about 10× the bytes bound in all. In f32 the 3xTF32
// products still dominate (phase 1 0.37, phase 3 0.24, dea 0.31 ms): three
// tf32 products and the operand splits per tile run at about a tenth of
// the tensor cores' tf32 rate.
// Registers and occupancy: both kernels are built for two resident
// 256-thread blocks per SM (`__launch_bounds__(256, 2)`, at most 128
// registers a thread; nvcc's report in chip_smoke's build phase shows
// them). At ch 64 the attention kernel's builds take 128 registers, bf16
// with no spill, f32 with a 32-byte spill; at ch 128 both spill 104-440
// bytes (not a flagship width); the dea kernel takes 110 / 127, no
// spill. The attention kernel's shared memory at the flagship (f32: W_e's
// slice 73.7 KB, the ring 18.4 KB, e 17.4 KB; bf16 75 KB) fits two blocks
// on an SM; the tiles make one wave of 2 · SMs blocks, so one
// block's products overlap the other's latency-bound phase 2.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;           // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;           // resident attention blocks per SM
constexpr int kChunk = 64;              // edges per phase-1 tile (M)
constexpr int kKs = 32;                 // contraction columns per staged slice
constexpr int kRows3 = 128;             // dW_e rows per phase-3 pass (M)
constexpr int kEdges3 = 32;             // edges per phase-3 slice (K)
constexpr int kCols = 128;              // dea columns per pass (N)
constexpr int kUnroll = 4;              // phase 2: edges whose loads overlap
constexpr int kPadMN = 8;               // row padding, MN-contiguous tiles
constexpr unsigned kFull = 0xffffffffu;

using bf16 = __nv_bfloat16;

struct Args {
  const void* q;
  const void* kv;
  const void* ea;
  const void* w_edge;
  const float* scale_t;
  const float* mask2;
  const int* row_ptr;
  const int* tile_ptr;   // [tiles + 1] first target of each tile
  const long long* dst;
  const long long* src;  // Span only: the kv row of each edge
  const float* g;
  const float* stats_max;
  const float* stats_den;
  void* dq;
  void* dkv;        // kernel 6: [E, 2H], input type
  float* dkvn_acc;  // Span: [N_src, 2H] f32, zeroed by the caller
  void* dea;
  float* dw;
  float* logit_s;  // [heads, E] scratch
  float* u_s;      // [heads, E] scratch
  void* k_s;       // [E, H] scratch, input type
  void* de_s;      // [E, H] scratch, input type
  int n, e_total, hidden, fe, heads, ch, fe_pad, ch_pad, tiles;
  float inv_sqrt_ch;
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_t(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_t(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// round an f32 value to the storage type T and back
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<bf16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// two consecutive channels c, c + 1 of a row (zero from ch on); `vec`: ch
// is even, so the pair is one aligned bf16x2 / float2 access
__device__ __forceinline__ float2 load2(const float* row, int c, int ch,
                                        bool vec) {
  if (c >= ch) return make_float2(0.f, 0.f);
  if (vec) return *reinterpret_cast<const float2*>(row + c);
  return make_float2(row[c], c + 1 < ch ? row[c + 1] : 0.f);
}
__device__ __forceinline__ float2 load2(const bf16* row, int c, int ch,
                                        bool vec) {
  if (c >= ch) return make_float2(0.f, 0.f);
  if (vec)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + c));
  return make_float2(load_f(row + c), c + 1 < ch ? load_f(row + c + 1) : 0.f);
}
__device__ __forceinline__ void store2(float* row, int c, int ch, bool vec,
                                       float x, float y) {
  if (c >= ch) return;
  if (vec) {
    *reinterpret_cast<float2*>(row + c) = make_float2(x, y);
  } else {
    row[c] = x;
    if (c + 1 < ch) row[c + 1] = y;
  }
}
__device__ __forceinline__ void store2(bf16* row, int c, int ch, bool vec,
                                       float x, float y) {
  if (c >= ch) return;
  if (vec) {
    *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(x, y);
  } else {
    store_t(row + c, x);
    if (c + 1 < ch) store_t(row + c + 1, y);
  }
}

// ------------------------------------------------------------- staging
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros if !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ bf16 ldcg(const bf16* p) {
  return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}
template <typename T>
__device__ __forceinline__ T zero_t() { return T(0.f); }
template <>
__device__ __forceinline__ bf16 zero_t<bf16>() { return __float2bfloat16(0.f); }

struct AllRows {
  __device__ bool operator()(long long) const { return true; }
};
struct LiveRows {  // rows of live edges (mask2 > 0)
  const float* mask2;
  __device__ bool operator()(long long j) const { return mask2[j] > 0.f; }
};
struct SharedLive {  // the same, from flags in shared memory for rows row0..
  const int* live;
  long long row0;
  __device__ bool operator()(long long j) const { return live[j - row0]; }
};

// Stage the tile dst[r * lds + c] = src[(row0 + r) * ld + col0 + c] for r <
// rows, c < C, zero where row0 + r >= row_end, col0 + c >= col_end or the
// row is not live. 16-byte cp.async copies where every address is 16-byte
// aligned (the caller commits the group), else plain L2 loads.
template <typename T, int C, typename Live>
__device__ __forceinline__ void stage(T* dst, int lds, int rows, const T* src,
                                      long long ld, long long row0,
                                      long long row_end, int col0, int col_end,
                                      Live live) {
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(src) |
      (static_cast<uintptr_t>(ld | col0 | col_end) * sizeof(T));
  if (align % 16 == 0) {
    constexpr int V = 16 / sizeof(T), kPer = C / V;
    for (int i = threadIdx.x; i < rows * kPer; i += kThreads) {
      const int r = i / kPer, c = (i % kPer) * V;
      const long long j = row0 + r;
      const bool ok = j < row_end && col0 + c < col_end && live(j);
      cp_async16(dst + r * lds + c, ok ? src + j * ld + col0 + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * C; i += kThreads) {
      const int r = i / C, c = i % C;
      const long long j = row0 + r;
      const bool ok = j < row_end && col0 + c < col_end && live(j);
      dst[r * lds + c] = ok ? ldcg(src + j * ld + col0 + c) : zero_t<T>();
    }
  }
}

// --------------------------------------------------- warp-level products
// Fragments of mma.sync's m16n8kK tiles (lane = 4 g + t): A's (m, k) pairs
// (g, 2t..), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..) for bf16 and (g, t),
// (g+8, t), (g, t+4), (g+8, t+4) for tf32; B's (k, n) (2t.., g), (2t+8.., g)
// and (t, g), (t+4, g); the accumulator's (g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1). A tile is "K-major" when its contraction index is the
// contiguous one: A stored [m][k], B stored [n][k]; else A is [k][m] and B
// [k][n].
template <typename T>
struct Op;

template <>
struct Op<bf16> {
  static constexpr int kK = 16;
  static constexpr int kPadK = 8;  // row padding of a K-contiguous tile
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };

  template <bool KMajor>
  static __device__ __forceinline__ void load_a(A& a, const bf16* s, int ld,
                                                int m0, int k0) {
    const int l = threadIdx.x & 31, i = l >> 3, r = l & 7;
    if constexpr (KMajor) {
      const bf16* p = s + (m0 + (i & 1) * 8 + r) * ld + k0 + (i >> 1) * 8;
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
          : "=r"(a.r[0]), "=r"(a.r[1]), "=r"(a.r[2]), "=r"(a.r[3])
          : "r"(smem_u32(p)));
    } else {
      const bf16* p = s + (k0 + (i >> 1) * 8 + r) * ld + m0 + (i & 1) * 8;
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
          "[%4];\n"
          : "=r"(a.r[0]), "=r"(a.r[1]), "=r"(a.r[2]), "=r"(a.r[3])
          : "r"(smem_u32(p)));
    }
  }
  template <bool KMajor>
  static __device__ __forceinline__ void load_b(B& b, const bf16* s, int ld,
                                                int n0, int k0) {
    const int l = threadIdx.x & 31, i = (l >> 3) & 1, r = l & 7;
    if constexpr (KMajor) {
      const bf16* p = s + (n0 + r) * ld + k0 + i * 8;
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
          : "=r"(b.r[0]), "=r"(b.r[1])
          : "r"(smem_u32(p)));
    } else {
      const bf16* p = s + (k0 + i * 8 + r) * ld + n0;
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
          : "=r"(b.r[0]), "=r"(b.r[1])
          : "r"(smem_u32(p)));
    }
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a,
                                             const B& b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]),
          "r"(b.r[1]));
  }
};

// x = hi + lo, each a tf32 value (the low 13 bits of its f32 word zero)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

template <>
struct Op<float> {
  static constexpr int kK = 8;
  static constexpr int kPadK = 4;
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };

  template <bool KMajor>
  static __device__ __forceinline__ void load_a(A& a, const float* s, int ld,
                                                int m0, int k0) {
    const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
    float x[4];
    if constexpr (KMajor) {
      const float* p = s + (m0 + g) * ld + k0 + t;
      x[0] = p[0];
      x[1] = p[8 * ld];
      x[2] = p[4];
      x[3] = p[8 * ld + 4];
    } else {
      const float* p = s + (k0 + t) * ld + m0 + g;
      x[0] = p[0];
      x[1] = p[8];
      x[2] = p[4 * ld];
      x[3] = p[4 * ld + 8];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(x[i], a.hi[i], a.lo[i]);
  }
  template <bool KMajor>
  static __device__ __forceinline__ void load_b(B& b, const float* s, int ld,
                                                int n0, int k0) {
    const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
    float x[2];
    if constexpr (KMajor) {
      const float* p = s + (n0 + g) * ld + k0 + t;
      x[0] = p[0];
      x[1] = p[4];
    } else {
      const float* p = s + (k0 + t) * ld + n0 + g;
      x[0] = p[0];
      x[1] = p[4 * ld];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) split_tf32(x[i], b.hi[i], b.lo[i]);
  }
  static __device__ __forceinline__ void mma1(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  // 3xTF32: the small cross terms first, then hi·hi
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a,
                                             const B& b) {
    mma1(d, a.lo, b.hi);
    mma1(d, a.hi, b.lo);
    mma1(d, a.hi, b.hi);
  }
};

// acc[mt][nt] += A[m0 + 16 mt .., 0 .. K) · B[0 .. K, n0 + 8 nt ..] for one
// warp, from shared-memory tiles sa (row stride lda) and sb (ldb)
template <typename T, int MT, int NT, int K, bool AKMajor, bool BKMajor>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4],
                                         const T* sa, int lda, int m0,
                                         const T* sb, int ldb, int n0) {
#pragma unroll
  for (int k = 0; k < K; k += Op<T>::kK) {
    typename Op<T>::A fa[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      Op<T>::template load_a<AKMajor>(fa[mt], sa, lda, m0 + 16 * mt, k);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      typename Op<T>::B fb;
      Op<T>::template load_b<BKMajor>(fb, sb, ldb, n0 + 8 * nt, k);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) Op<T>::mma(acc[mt][nt], fa[mt], fb);
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
}

// acc = (first ? 0 : acc) + one staged slice's products. In f32 the
// slice's 3xTF32 products go to a fresh tile, added to acc with one IEEE
// add per element: the tensor cores' own accumulation then never runs over
// more than one slice (32 deep) at acc's magnitude.
template <typename T, int MT, int NT, int K, bool AKMajor, bool BKMajor>
__device__ __forceinline__ void slice_mma(float (&acc)[MT][NT][4], bool first,
                                          const T* sa, int lda, int m0,
                                          const T* sb, int ldb, int n0) {
  if constexpr (sizeof(T) == 4) {
    float part[MT][NT][4];
    zero_acc(part);
    warp_mma<T, MT, NT, K, AKMajor, BKMajor>(part, sa, lda, m0, sb, ldb, n0);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[mt][nt][i] = first ? part[mt][nt][i]
                                 : acc[mt][nt][i] + part[mt][nt][i];
  } else {
    if (first) zero_acc(acc);
    warp_mma<T, MT, NT, K, AKMajor, BKMajor>(acc, sa, lda, m0, sb, ldb, n0);
  }
}

// ------------------------------------------------------ shared memory
// Depth of each staging ring: slices in flight. Phase 1 in f32 keeps two,
// so that W_e's f32 slice, the ring and e fit two blocks on an SM.
template <typename T>
struct Stages {
  static constexpr int kP1 = sizeof(T) == 4 ? 2 : 4;
  static constexpr int kP3 = 4;
  static constexpr int kDea = 4;
};

// Row strides (elements) of the staged tiles: K-contiguous tiles pad by
// Op<T>::kPadK, the others by kPadMN, so that each fragment load's eight
// rows (or a quarter-warp's scalar loads) fall in distinct banks.
template <typename T>
struct Layout {
  int ch_pad, fe_pad;
  __host__ __device__ int ld_w() const { return ch_pad + kPadMN; }   // [Fe][ch]
  __host__ __device__ int ld_a1() const { return kKs + Op<T>::kPadK; }  // [64][32]
  __host__ __device__ int ld_e() const { return ch_pad + 4; }        // f32 [64][ch]
  __host__ __device__ int ld_ea3() const { return kRows3 + kPadMN; }  // [32][128]
  __host__ __device__ int ld_de3() const { return ch_pad + kPadMN; }  // [32][ch]
  // phase 1: W_e's slice, the ring of ea slices, e (f32)
  __host__ __device__ size_t w_elems() const {
    return static_cast<size_t>(fe_pad) * ld_w();
  }
  __host__ __device__ size_t a1_elems() const { return kChunk * ld_a1(); }
  __host__ __device__ size_t p1_bytes() const {
    return sizeof(T) * (w_elems() + Stages<T>::kP1 * a1_elems()) +
           sizeof(float) * kChunk * ld_e();
  }
  // phase 3: the ring of (ea, de) slice pairs
  __host__ __device__ size_t ea3_elems() const { return kEdges3 * ld_ea3(); }
  __host__ __device__ size_t de3_elems() const { return kEdges3 * ld_de3(); }
  __host__ __device__ size_t p3_bytes() const {
    return sizeof(T) * Stages<T>::kP3 * (ea3_elems() + de3_elems());
  }
  __host__ __device__ size_t bytes() const {
    return p1_bytes() > p3_bytes() ? p1_bytes() : p3_bytes();
  }
};

// dea kernel: the ring of (de, W_e) slice pairs
template <typename T>
struct DeaLayout {
  static constexpr int kLd = kKs + Op<T>::kPadK;  // [64][32] and [128][32]
  static constexpr size_t kA = kChunk * kLd, kB = kCols * kLd;
  static constexpr size_t kBytes = sizeof(T) * Stages<T>::kDea * (kA + kB);
};

// The staging ring: steps 0 .. steps-1, each one slice, `issue(s)` starts
// slice s's copies into ring stage s % S and `body(s)` runs on it. S - 1
// slices are in flight while a step runs; a stage is refilled only after
// the barrier that follows every thread's last read of it.
template <int S, typename Issue, typename Body>
__device__ __forceinline__ void pipeline(int steps, Issue issue, Body body) {
  for (int i = 0; i < S - 1; ++i) {
    if (i < steps) issue(i);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<S - 2>();  // slice s (and every older group) has landed
    __syncthreads();
    if (s + S - 1 < steps) issue(s + S - 1);
    cp_async_commit();
    body(s);
  }
  cp_async_wait<0>();
}

// ----------------------------------------------------------- phase 1
// N consecutive values of a row, one aligned access where `vec` and all N
// lie before the row's end (`valid` of them do; <= 0: none), else one by
// one
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_n(float (&x)[N], const T* p, bool vec,
                                       int valid) {
  if (vec && valid >= N) {
    const Vec<T, N> w = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
    for (int n = 0; n < N; ++n) x[n] = load_f(&w.v[n]);
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) x[n] = n < valid ? load_f(p + n) : 0.f;
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_n(T* p, const float (&x)[N], bool vec,
                                        int valid) {
  if (vec && valid >= N) {
    Vec<T, N> w;
#pragma unroll
    for (int n = 0; n < N; ++n) store_t(&w.v[n], x[n]);
    *reinterpret_cast<Vec<T, N>*>(p) = w;
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n)
      if (n < valid) store_t(p + n, x[n]);
  }
}

// Epilogue of the chunk [e0, e0 + kChunk) ∩ [.., hi): from e in shared
// memory (f32 [64][ld_e]), k, v, the logit and u of each edge. A thread
// owns 4 edges × CPT consecutive channels, loaded and stored as one access
// each where ch is a multiple of CPT; the 16 threads of an edge are a
// half-warp.
template <typename T, int CPT, bool Span>
__device__ __forceinline__ void chunk_epilogue(const Args& a, int e0, int hi,
                                               int h, const float* e_s,
                                               int ld_e) {
  const int tid = threadIdx.x;
  const int cg = tid % 16, eg = tid / 16;  // channel group, edge group
  long long dst[4];
  long long row[4];  // Span: the kv rows, -1 for a dead edge (none read)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = e0 + eg * 4 + i;
    dst[i] = j < hi ? a.dst[j] : 0;
    if constexpr (Span)
      row[i] = (j < hi && a.mask2[j] > 0.f) ? a.src[j] : -1;
  }
  const T* kv = static_cast<const T*>(a.kv);
  const T* q = static_cast<const T*>(a.q);
  T* k_s = static_cast<T*>(a.k_s);
  const int hid = a.hidden, ch = a.ch;
  const int c0 = cg * CPT, left = ch - c0;  // this thread's channels
  const bool vec =
      ch % CPT == 0 &&
      (reinterpret_cast<uintptr_t>(kv) | reinterpret_cast<uintptr_t>(q) |
       reinterpret_cast<uintptr_t>(k_s)) % (sizeof(T) * CPT) == 0 &&
      reinterpret_cast<uintptr_t>(a.g) % (sizeof(float) * CPT) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = e0 + eg * 4 + i;
    const bool valid = j < hi;
    const int n_ok = valid ? left : 0;
    const int n_kv = (Span ? row[i] >= 0 : valid) ? left : 0;
    const size_t kvb =
        static_cast<size_t>(Span ? (row[i] < 0 ? 0 : row[i]) : j) * 2 * hid +
        h * ch + c0;
    const size_t tb = static_cast<size_t>(valid ? dst[i] : 0) * hid + h * ch +
                      c0;
    float kx[CPT], vx[CPT], qx[CPT], gx[CPT], kr[CPT];
    load_n<T, CPT>(kx, kv + kvb, vec, n_kv);
    load_n<T, CPT>(vx, kv + kvb + hid, vec, n_kv);
    load_n<T, CPT>(qx, q + tb, vec, n_ok);
    load_n<float, CPT>(gx, a.g + tb, vec, n_ok);
    float pl = 0.f, pu = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const float e = round_to<T>(e_s[(eg * 4 + i) * ld_e + c0 + c]);
      kr[c] = round_to<T>(kx[c] + e);
      const float v = round_to<T>(vx[c] + e);
      if (c < n_ok) {
        pl = fmaf(qx[c], kr[c], pl);
        pu = fmaf(round_to<T>(gx[c]), v, pu);
      }
    }
    store_n<T, CPT>(k_s + static_cast<size_t>(j) * hid + h * ch + c0, kr, vec,
                    n_ok);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      pl += __shfl_xor_sync(kFull, pl, o);
      pu += __shfl_xor_sync(kFull, pu, o);
    }
    if (valid && cg == 0) {
      const size_t hj = static_cast<size_t>(h) * a.e_total + j;
      a.logit_s[hj] = pl * a.inv_sqrt_ch;
      a.u_s[hj] = pu;
    }
  }
}

template <typename T, int CPT, bool Span>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    attn_eproj_bwd_attn_kernel(Args a) {
  constexpr int kChp = 16 * CPT;          // padded head width
  constexpr int NT = CPT;                 // n8 tiles of a warp's ch/2 columns
  constexpr int CPP = (kChp / 2 + 31) / 32;  // phase 2: channel pairs a lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float dl_w[kWarps][32];
  __shared__ float al_w[kWarps][32];
  // per edge of a warp's batch: 0 if dead; else 1, or with Span the kv
  // row + 1
  __shared__ int live_w[kWarps][32];
  const int h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;  // the warp's tile in M and N
  const int ch = a.ch, hid = a.hidden, fe = a.fe;
  constexpr int kS1 = Stages<T>::kP1, kS3 = Stages<T>::kP3;
  const Layout<T> lay{kChp, a.fe_pad};

  const int t0 = a.tile_ptr[blockIdx.x], t1 = a.tile_ptr[blockIdx.x + 1];
  // the dummy row n-1 is never walked; its dq is zero
  if (blockIdx.x == gridDim.x - 1) {
    T* dq = static_cast<T*>(a.dq);
    for (int c = tid; c < ch; c += kThreads)
      store_t(dq + static_cast<size_t>(a.n - 1) * hid + h * ch + c, 0.f);
  }
  if (t0 >= t1) return;
  const int lo = a.row_ptr[t0], hi = a.row_ptr[t1];
  const T* ea = static_cast<const T*>(a.ea);

  // phase 1: logit, u and k of the tile's edges, 64 at a time
  {
    T* w_s = reinterpret_cast<T*>(smem_raw);     // [fe_pad][ld_w]
    T* a_s = w_s + lay.w_elems();                // kP1 × [64][ld_a1]
    float* e_s = reinterpret_cast<float*>(a_s + kS1 * lay.a1_elems());
    stage<T, kChp>(w_s, lay.ld_w(), a.fe_pad, static_cast<const T*>(a.w_edge),
                   hid, 0, fe, h * ch, h * ch + ch, AllRows{});
    cp_async_commit();
    const int nks = a.fe_pad / kKs;
    const int steps = (hi - lo + kChunk - 1) / kChunk * nks;
    float acc[1][NT][4];
    pipeline<kS1>(
        steps,
        [&](int s) {
          stage<T, kKs>(a_s + s % kS1 * lay.a1_elems(), lay.ld_a1(), kChunk,
                        ea, fe, lo + (s / nks) * kChunk, hi, (s % nks) * kKs,
                        fe, AllRows{});
        },
        [&](int s) {
          const int ks = s % nks;
          slice_mma<T, 1, NT, kKs, true, false>(
              acc, ks == 0, a_s + s % kS1 * lay.a1_elems(), lay.ld_a1(),
              16 * wm, w_s + ks * kKs * lay.ld_w(), lay.ld_w(),
              wn * (kChp / 2));
          if (ks == nks - 1) {
            const int g = lane >> 2, t = lane & 3;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const int r = 16 * wm + g, c = wn * (kChp / 2) + 8 * nt + 2 * t;
              e_s[r * lay.ld_e() + c] = acc[0][nt][0];
              e_s[r * lay.ld_e() + c + 1] = acc[0][nt][1];
              e_s[(r + 8) * lay.ld_e() + c] = acc[0][nt][2];
              e_s[(r + 8) * lay.ld_e() + c + 1] = acc[0][nt][3];
            }
            __syncthreads();
            chunk_epilogue<T, CPT, Span>(a, lo + (s / nks) * kChunk, hi, h,
                                         e_s, lay.ld_e());
          }
        });
  }
  __syncthreads();  // phase 1's scratch writes are visible to the block

  // phase 2: one warp per target
  const T* q = static_cast<const T*>(a.q);
  const T* k_s = static_cast<const T*>(a.k_s);
  T* dkv = static_cast<T*>(a.dkv);
  T* de_s = static_cast<T*>(a.de_s);
  T* dq = static_cast<T*>(a.dq);
  const float* logit = a.logit_s + static_cast<size_t>(h) * a.e_total;
  const float* u_h = a.u_s + static_cast<size_t>(h) * a.e_total;
  const float* scale = a.scale_t + static_cast<size_t>(h) * a.e_total;
  const bool vec = (ch & 1) == 0;
  for (int t = t0 + warp; t < t1; t += kWarps) {
    const int rlo = a.row_ptr[t], rhi = a.row_ptr[t + 1];
    const float m = a.stats_max[static_cast<size_t>(t) * a.heads + h];
    const float den = a.stats_den[static_cast<size_t>(t) * a.heads + h];
    const size_t tb = static_cast<size_t>(t) * hid + h * ch;
    float2 qr[CPP], gr[CPP], dqa[CPP];
#pragma unroll
    for (int i = 0; i < CPP; ++i) {
      const int c = 2 * (lane + 32 * i);
      qr[i] = load2(q + tb, c, ch, vec);
      gr[i] = load2(a.g + tb, c, ch, vec);
      gr[i] = make_float2(round_to<T>(gr[i].x), round_to<T>(gr[i].y));
      dqa[i] = make_float2(0.f, 0.f);
    }
    float inner = 0.f;
    for (int j = rlo + lane; j < rhi; j += 32) {
      if (a.mask2[j] > 0.f) {
        const float s = expf(logit[j] - m) / den;
        inner = fmaf(s * scale[j], u_h[j], inner);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) inner += __shfl_xor_sync(kFull, inner, o);

    for (int j0 = rlo; j0 < rhi; j0 += 32) {
      const int j = j0 + lane;
      const bool live = j < rhi && a.mask2[j] > 0.f;
      float dl = 0.f, al = 0.f;
      if (live) {
        const float s = expf(logit[j] - m) / den;
        const float sc = scale[j];
        dl = round_to<T>(s * (sc * u_h[j] - inner));
        al = round_to<T>(s * sc);
      }
      dl_w[warp][lane] = dl;
      al_w[warp][lane] = al;
      if constexpr (Span)
        live_w[warp][lane] = live ? static_cast<int>(a.src[j]) + 1 : 0;
      else
        live_w[warp][lane] = live;
      __syncwarp();
      // kUnroll edges at a time: their k rows are loaded before any is used
      const int cnt = min(32, rhi - j0);
      for (int u0 = 0; u0 < cnt; u0 += kUnroll) {
        float2 kf[kUnroll][CPP];
#pragma unroll
        for (int v = 0; v < kUnroll; ++v) {
          const int u = u0 + v;
          const bool ok = u < cnt && live_w[warp][u];
          const T* krow = k_s + static_cast<size_t>(j0 + u) * hid + h * ch;
#pragma unroll
          for (int i = 0; i < CPP; ++i)
            kf[v][i] = ok ? load2(krow, 2 * (lane + 32 * i), ch, vec)
                          : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int v = 0; v < kUnroll; ++v) {
          const int u = u0 + v;
          if (u >= cnt || !live_w[warp][u]) continue;
          const size_t jj = static_cast<size_t>(j0 + u);
          const float dlu = dl_w[warp][u], alu = al_w[warp][u];
#pragma unroll
          for (int i = 0; i < CPP; ++i) {
            const int c = 2 * (lane + 32 * i);
            if (c >= ch) continue;
            const float dk0 = dlu * qr[i].x * a.inv_sqrt_ch;
            const float dk1 = dlu * qr[i].y * a.inv_sqrt_ch;
            const float dv0 = alu * gr[i].x, dv1 = alu * gr[i].y;
            if constexpr (Span) {
              float* acc = a.dkvn_acc +
                           static_cast<size_t>(live_w[warp][u] - 1) * 2 * hid +
                           h * ch + c;
              atomicAdd(acc, round_to<T>(dk0));
              atomicAdd(acc + hid, round_to<T>(dv0));
              if (c + 1 < ch) {
                atomicAdd(acc + 1, round_to<T>(dk1));
                atomicAdd(acc + hid + 1, round_to<T>(dv1));
              }
            } else {
              store2(dkv + jj * 2 * hid + h * ch, c, ch, vec, dk0, dk1);
              store2(dkv + jj * 2 * hid + hid + h * ch, c, ch, vec, dv0, dv1);
            }
            store2(de_s + jj * hid + h * ch, c, ch, vec, dk0 + dv0,
                   dk1 + dv1);
            dqa[i].x = fmaf(dlu, kf[v][i].x, dqa[i].x);
            dqa[i].y = fmaf(dlu, kf[v][i].y, dqa[i].y);
          }
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int i = 0; i < CPP; ++i)
      store2(dq + tb, 2 * (lane + 32 * i), ch, vec, dqa[i].x * a.inv_sqrt_ch,
             dqa[i].y * a.inv_sqrt_ch);
  }
  __syncthreads();  // phase 2's de rows are visible; phase 1's memory free

  // phase 3: dW_e[:, h] += sum over the tile's live edges of ea_jᵀ de_j
  {
    T* ea3 = reinterpret_cast<T*>(smem_raw);   // kP3 × [32][ld_ea3]
    T* de3 = ea3 + kS3 * lay.ea3_elems();      // kP3 × [32][ld_de3]
    const int slices = (hi - lo + kEdges3 - 1) / kEdges3;
    const int steps = (fe + kRows3 - 1) / kRows3 * slices;
    float acc[2][NT][4];
    pipeline<kS3>(
        steps,
        [&](int s) {
          const int f0 = s / slices * kRows3, e0 = lo + s % slices * kEdges3;
          stage<T, kRows3>(ea3 + s % kS3 * lay.ea3_elems(), lay.ld_ea3(),
                           kEdges3, ea, fe, e0, hi, f0, fe, AllRows{});
          // a dead edge's de row is staged as zero
          stage<T, kChp>(de3 + s % kS3 * lay.de3_elems(), lay.ld_de3(),
                         kEdges3, static_cast<const T*>(a.de_s), hid, e0, hi,
                         h * ch, h * ch + ch, LiveRows{a.mask2});
        },
        [&](int s) {
          const int f0 = s / slices * kRows3, sl = s % slices;
          if (f0 + 32 * wm >= fe) return;  // rows past Fe: nothing to add
          slice_mma<T, 2, NT, kEdges3, false, false>(
              acc, sl == 0, ea3 + s % kS3 * lay.ea3_elems(), lay.ld_ea3(),
              32 * wm, de3 + s % kS3 * lay.de3_elems(), lay.ld_de3(),
              wn * (kChp / 2));
          if (sl != slices - 1) return;
          const int g = lane >> 2, t = lane & 3;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int f = f0 + 32 * wm + 16 * mt + g + (i >> 1) * 8;
                const int c = wn * (kChp / 2) + 8 * nt + 2 * t + (i & 1);
                const float v = acc[mt][nt][i];
                if (f < fe && c < ch && v != 0.f)
                  atomicAdd(a.dw + static_cast<size_t>(f) * hid + h * ch + c,
                            v);
              }
        });
  }
}

// dea = de · W_eᵀ for 64 edges per block, and (kernel 6) zero dkv rows of
// dead edges.
template <typename T, bool Span>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    attn_eproj_bwd_dea_kernel(Args a) {
  using L = DeaLayout<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int S = Stages<T>::kDea;
  T* a_s = reinterpret_cast<T*>(smem_raw);  // S × [64][kLd] de slices
  T* b_s = a_s + S * L::kA;                 // S × [128][kLd] W_e slices
  __shared__ int live_s[kChunk];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int e0 = blockIdx.x * kChunk;
  const int hid = a.hidden, fe = a.fe;
  const int live_end = a.row_ptr[a.n - 1];  // the dummy row's edges are dead
  if (tid < kChunk) {
    const int j = e0 + tid;
    live_s[tid] = j < a.e_total && j < live_end && a.mask2[j] > 0.f;
  }
  __syncthreads();
  T* dea = static_cast<T*>(a.dea);
  const T* de_s = static_cast<const T*>(a.de_s);
  const T* w_edge = static_cast<const T*>(a.w_edge);
  const int rows = min(kChunk, a.e_total - e0);
  if constexpr (!Span) {
    T* dkv = static_cast<T*>(a.dkv);
    for (int r = warp; r < rows; r += kWarps)  // a warp per dead row
      if (!live_s[r])
        for (int i = lane; i < 2 * hid; i += 32)
          store_t(dkv + static_cast<size_t>(e0 + r) * 2 * hid + i, 0.f);
  }
  const int nks = (hid + kKs - 1) / kKs;
  const int steps = (fe + kCols - 1) / kCols * nks;
  const bool vec = (fe & 1) == 0;
  float acc[1][8][4];
  pipeline<S>(
      steps,
      [&](int s) {
        const int f0 = s / nks * kCols, k0 = s % nks * kKs;
        stage<T, kKs>(a_s + s % S * L::kA, L::kLd, kChunk, de_s, hid, e0,
                      a.e_total, k0, hid, SharedLive{live_s, e0});
        stage<T, kKs>(b_s + s % S * L::kB, L::kLd, kCols, w_edge, hid, f0,
                      fe, k0, hid, AllRows{});
      },
      [&](int s) {
        const int f0 = s / nks * kCols, ks = s % nks;
        if (f0 + 64 * wn >= fe) return;  // columns past Fe
        slice_mma<T, 1, 8, kKs, true, true>(
            acc, ks == 0, a_s + s % S * L::kA, L::kLd, 16 * wm,
            b_s + s % S * L::kB, L::kLd, 64 * wn);
        if (ks != nks - 1) return;
        // dead rows were staged as zero, so their acc is 0
        const int g = lane >> 2, t = lane & 3;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = 16 * wm + g + 8 * half;
            if (r < rows)
              store2(dea + static_cast<size_t>(e0 + r) * fe,
                     f0 + 64 * wn + 8 * nt + 2 * t, fe, vec,
                     acc[0][nt][2 * half], acc[0][nt][2 * half + 1]);
          }
      });
}

int pad_channels(int ch) {
  return ch <= 16 ? 16 : ch <= 32 ? 32 : ch <= 64 ? 64 : 128;
}

int pad_fe(int fe) {
  const int p = (fe + kKs - 1) / kKs * kKs;
  return p > kKs ? p : kKs;
}

template <typename T>
size_t attn_smem_bytes(int fe, int ch) {
  return Layout<T>{pad_channels(ch), pad_fe(fe)}.bytes();
}

// the larger of the two types' needs (f32's)
size_t smem_bytes(int fe, int ch) {
  const size_t a = attn_smem_bytes<float>(fe, ch);
  return a > DeaLayout<float>::kBytes ? a : DeaLayout<float>::kBytes;
}

template <typename T, int CPT, bool Span>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = attn_smem_bytes<T>(a.fe, a.ch);
  auto kernel = attn_eproj_bwd_attn_kernel<T, CPT, Span>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.tiles, a.heads), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto dea = attn_eproj_bwd_dea_kernel<T, Span>;
  err = cudaFuncSetAttribute(dea, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(DeaLayout<T>::kBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid_dea((a.e_total + kChunk - 1) / kChunk);
  dea<<<grid_dea, kThreads, DeaLayout<T>::kBytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool Span>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  switch (a.ch_pad) {
    case 16: return launch<T, 1, Span>(a, stream);
    case 32: return launch<T, 2, Span>(a, stream);
    case 64: return launch<T, 4, Span>(a, stream);
    default: return launch<T, 8, Span>(a, stream);
  }
}

// Fill the arguments both entry points share; the caller sets dkv or
// src and dkvn_acc.
Args make_args(const void* q, const void* kv, const void* ea,
               const void* w_edge, const void* scale_t, const void* mask2,
               const void* row_ptr, const void* dst, const void* g,
               const void* stats_max, const void* stats_den, void* dq,
               void* dea, void* dw, void* logit_s, void* u_s, void* k_s,
               void* de_s, int n, int e_total, int hidden, int fe, int heads,
               float inv_sqrt_ch, const void* tile_ptr, int tiles) {
  Args a;
  a.q = q;
  a.kv = kv;
  a.ea = ea;
  a.w_edge = w_edge;
  a.scale_t = static_cast<const float*>(scale_t);
  a.mask2 = static_cast<const float*>(mask2);
  a.row_ptr = static_cast<const int*>(row_ptr);
  a.tile_ptr = static_cast<const int*>(tile_ptr);
  a.dst = static_cast<const long long*>(dst);
  a.src = nullptr;
  a.g = static_cast<const float*>(g);
  a.stats_max = static_cast<const float*>(stats_max);
  a.stats_den = static_cast<const float*>(stats_den);
  a.dq = dq;
  a.dkv = nullptr;
  a.dkvn_acc = nullptr;
  a.dea = dea;
  a.dw = static_cast<float*>(dw);
  a.logit_s = static_cast<float*>(logit_s);
  a.u_s = static_cast<float*>(u_s);
  a.k_s = k_s;
  a.de_s = de_s;
  a.n = n;
  a.e_total = e_total;
  a.hidden = hidden;
  a.fe = fe;
  a.heads = heads;
  a.ch = hidden / heads;
  a.fe_pad = pad_fe(fe);
  a.ch_pad = pad_channels(a.ch);
  a.tiles = tiles;
  a.inv_sqrt_ch = inv_sqrt_ch;
  return a;
}

}  // namespace
