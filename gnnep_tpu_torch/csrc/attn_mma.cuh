// attn_mma.cuh: the building blocks the eproj and span attention kernels
// share (attn_eproj_fwd.cuh: kernels 5 and 8; attn_eproj_bwd.cuh: kernels 6
// and 9), each for sm_90a:
//
//  - staging: 16-byte `cp.async` copies into shared memory, zero-filled
//    past ragged rows and columns and for dead rows (source size 0), plain
//    loads where a row is not 16-byte aligned, and a ring of stages that
//    keeps S - 1 slices in flight while one is used;
//  - warp-level tensor-core products (`mma.sync`): bf16 m16n8k16 with
//    operands read by `ldmatrix`, and f32 as 3xTF32 on m16n8k8 tiles,
//    each slice's products in a fresh tile added to the running sum with
//    IEEE adds;
//  - `project`, the edge projection e = ea · W_e[:, columns] of a range of
//    edges, 64 · MT at a time, with both operands streamed over Fe in 32-deep
//    slices through the ring, so that shared memory does not grow with Fe
//    or with the head width: columns are taken in tiles of at most 128.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;           // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;           // resident blocks per SM
constexpr int kChunk = 64;              // edges per projection tile (M)
constexpr int kKs = 32;                 // contraction columns per staged slice
constexpr int kPadMN = 8;               // row padding, MN-contiguous tiles
constexpr int kMaxTile = 128;           // widest column tile (N)
constexpr unsigned kFull = 0xffffffffu;

using bf16 = __nv_bfloat16;

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

// acc[mt][nt] += A[m0 + MS mt .., 0 .. K) · B[0 .. K, n0 + 8 nt ..] for one
// warp, from shared-memory tiles sa (row stride lda) and sb (ldb). The MT
// A fragments of a k step are held at once and each B fragment serves
// them all, or with OneA one A fragment at a time, each B fragment loaded
// again for each (fewer registers: `project`'s tiles with MT > 1).
template <typename T, int MT, int NT, int K, bool AKMajor, bool BKMajor,
          int MS = 16, bool OneA = false>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4],
                                         const T* sa, int lda, int m0,
                                         const T* sb, int ldb, int n0) {
#pragma unroll
  for (int k = 0; k < K; k += Op<T>::kK) {
    if constexpr (OneA) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        typename Op<T>::A fa;
        Op<T>::template load_a<AKMajor>(fa, sa, lda, m0 + MS * mt, k);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          typename Op<T>::B fb;
          Op<T>::template load_b<BKMajor>(fb, sb, ldb, n0 + 8 * nt, k);
          Op<T>::mma(acc[mt][nt], fa, fb);
        }
      }
    } else {
      typename Op<T>::A fa[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        Op<T>::template load_a<AKMajor>(fa[mt], sa, lda, m0 + MS * mt, k);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        typename Op<T>::B fb;
        Op<T>::template load_b<BKMajor>(fb, sb, ldb, n0 + 8 * nt, k);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) Op<T>::mma(acc[mt][nt], fa[mt], fb);
      }
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
template <typename T, int MT, int NT, int K, bool AKMajor, bool BKMajor,
          int MS = 16, bool OneA = false>
__device__ __forceinline__ void slice_mma(float (&acc)[MT][NT][4], bool first,
                                          const T* sa, int lda, int m0,
                                          const T* sb, int ldb, int n0) {
  if constexpr (sizeof(T) == 4) {
    float part[MT][NT][4];
    zero_acc(part);
    warp_mma<T, MT, NT, K, AKMajor, BKMajor, MS, OneA>(part, sa, lda, m0, sb,
                                                       ldb, n0);
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
    warp_mma<T, MT, NT, K, AKMajor, BKMajor, MS, OneA>(acc, sa, lda, m0, sb,
                                                       ldb, n0);
  }
}

// ------------------------------------------------------ the projection
// Column tile of a head width: 16, 32, 64 or 128 (a wider head is walked
// in tiles of 128).
inline int tile_width(int ch) {
  return ch <= 16 ? 16 : ch <= 32 ? 32 : ch <= 64 ? 64 : kMaxTile;
}
inline int column_tiles(int ch) {
  const int nw = tile_width(ch);
  return (ch + nw - 1) / nw;
}

// Shared memory of `project` for column tiles of NW, 64 · MT edges a tile
// and a ring of S stages: each stage an ea slice [64 MT][32] and a W_e
// slice [32][NW] of the input type; then e of the whole tile [64 MT][NW] in
// the input type (the epilogues round e to it first in any case). Strides
// pad K-contiguous rows by Op<T>::kPadK and the others by kPadMN (e: by 16
// bytes), so that each fragment load's eight rows fall in distinct banks.
template <typename T, int NW, int MT, int S>
struct ProjLayout {
  static constexpr int kLdA = kKs + Op<T>::kPadK;
  static constexpr int kLdB = NW + kPadMN;
  static constexpr int kLdE = NW + 16 / sizeof(T);
  static constexpr int kA = kChunk * MT * kLdA, kB = kKs * kLdB;
  static constexpr int kPair = kA + kB;
  static constexpr size_t kRing = sizeof(T) * S * kPair;
  static constexpr size_t kBytes =
      kRing + sizeof(T) * static_cast<size_t>(kChunk) * MT * kLdE;
};

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// The projection e = ea[j] · W_e[:, columns] of the edges [lo, hi), 64 · MT
// at a time (M; the 8 warps each 16 · MT rows, interleaved by 64, × NW/2
// columns), for every column tile of head h: a head of width ch is ntiles
// tiles of NW columns, the last zero-filled past ch. K is
// Fe, in 32-deep slices that arrive, ea's and W_e's together, through a
// ring of S stages, so S - 1 slices' copies are in flight while one slice's
// products run; each staged W_e slice serves 64 · MT edges. f32 operands
// split into their tf32 parts at fragment load (splitting them once when a
// slice lands, into a second buffer, measured slower: PERF.md §6).
// After a tile's last slice its e (zero past Fe and ch and for rows past
// hi) goes to shared memory in the input type, and `epi(c, e0, h, nt, e_s,
// ld_e)` runs on each 64-edge chunk of it, every thread: chunk c of the
// tile (a caller carrying per-edge sums across column tiles keeps one per
// chunk), its first edge e0, the head, column tile nt, e_s its first
// row. Without `Mma` (the ladder's
// load-only stage) the slices are staged and nothing is computed.
template <typename T, int NW, int MT, int S, bool Mma, typename Epi>
__device__ __forceinline__ void project(unsigned char* smem, const T* ea,
                                        const T* w_edge, int fe, int hid,
                                        int ch, int lo, int hi, int h,
                                        int ntiles, Epi epi) {
  using L = ProjLayout<T, NW, MT, S>;
  constexpr int NT = NW / 16;  // n8 tiles of a warp's NW / 2 columns
  constexpr int M = kChunk * MT;
  T* ring = reinterpret_cast<T*>(smem);
  T* e_s = reinterpret_cast<T*>(smem + L::kRing);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int nks = (fe + kKs - 1) / kKs;
  const int steps = (hi - lo + M - 1) / M * ntiles * nks;
  float acc[MT][NT][4];
  pipeline<S>(
      steps,
      [&](int s) {
        const int ks = s % nks, nt = s / nks % ntiles;
        const int e0 = lo + s / (nks * ntiles) * M;
        T* a = ring + s % S * L::kPair;
        stage<T, kKs>(a, L::kLdA, M, ea, fe, e0, hi, ks * kKs, fe,
                      AllRows{});
        stage<T, NW>(a + L::kA, L::kLdB, kKs, w_edge, hid, ks * kKs, fe,
                     h * ch + nt * NW, h * ch + ch, AllRows{});
      },
      [&](int s) {
        const int ks = s % nks, nt = s / nks % ntiles;
        if constexpr (Mma) {
          const T* a = ring + s % S * L::kPair;
          slice_mma<T, MT, NT, kKs, true, false, kChunk, true>(
              acc, ks == 0, a, L::kLdA, 16 * wm, a + L::kA, L::kLdB,
              wn * (NW / 2));
        }
        if (ks != nks - 1) return;
        if constexpr (Mma) {
          const int g = lane >> 2, t = lane & 3;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int n8 = 0; n8 < NT; ++n8) {
              const int r = 16 * wm + kChunk * mt + g;
              const int col = wn * (NW / 2) + 8 * n8 + 2 * t;
              store_pair(e_s + r * L::kLdE + col, acc[mt][n8][0],
                         acc[mt][n8][1]);
              store_pair(e_s + (r + 8) * L::kLdE + col, acc[mt][n8][2],
                         acc[mt][n8][3]);
            }
          // the next slice restarts the sum: zeroing here frees the
          // accumulators' registers for the epilogues below
          zero_acc(acc);
        }
        __syncthreads();
        const int e0 = lo + s / (nks * ntiles) * M;
#pragma unroll
        for (int c = 0; c < MT; ++c) {
          if (e0 + c * kChunk >= hi) break;
          epi(c, e0 + c * kChunk, h, nt,
              static_cast<const T*>(e_s + c * kChunk * L::kLdE), L::kLdE);
        }
      });
}

}  // namespace
