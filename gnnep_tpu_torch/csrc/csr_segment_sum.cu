// csr_segment_sum.cu: sum over contiguous CSR segments, through a row
// permutation, for Hopper, built for sm_90a.
//
// Replaces the TPU kernel `_sum_kernel` in
// gnnep_tpu/ops/pallas/csr_attention.py (reached there through
// `windowed_segment_sum`, the backward of `csr_gather_ordered` and of
// `csr_gather`, and the eproj backward's XLA fallback):
//
//   out[n, :] = sum_{j in [seg_starts[n], end_n)} values[order[j], :]
//
// with end_n = seg_starts[n + 1], for every segment but the last; a null
// `order` is the identity (the backward of `csr_gather`, whose index is the
// arena's own sort key). The last segment is the dummy row's, which owns
// the arena's tail padding; its sum is unspecified by the contract, as the
// JAX package's `measure_seg_win64` states, and it is written as zeros.
// values [E, W] float32 or bfloat16, order i32 [E] or null, seg_starts i32
// [N]; out [N, W] float32 or the values' type. The sum is taken in f32 and
// rounded once to the output's type, so a bf16 output is bit for bit the
// f32 output cast to bf16: what the JAX package's
// `_csr_gather_ordered_bwd` returns (`dx.astype(g.dtype)`), without a
// separate cast kernel.
//
// What bounds it: bytes. It reads each row of a live segment once and
// writes each output row once, one add per element read (about 152 MB,
// 0.046 ms, at the flagship line-graph conv in f32). Segments are short
// (8.4 rows on average at the flagship, p99 17, at most 20) and the atom
// conv has only 768 of them, so what holds a simple design back is the
// chain of dependent loads in each warp and the warps in flight, not
// imbalance.
//
// Design. The TPU kernel multiplies a 0/1 membership matrix into a window
// of rows on the matrix unit. Here a warp owns one column slice of one
// segment: lane l holds word l of the slice, VEC consecutive columns in
// one load of up to 16 bytes (4 f32 or 8 bf16), so a slice is 32 words
// wide and a segment of W columns takes ceil(W / (32 VEC)) warps, next to
// each other in a block (the atom conv's 768 segments of 512 f32 columns
// make 3,072 warps). The chain per warp is three loads long:
//   1. the segment's two starts (lanes 0 and 1);
//   2. the order entries, 32 at a time, lane r loading order[lo + r]
//      (skipped for the identity order);
//   3. the rows: each index is broadcast with __shfl_sync and kRows rows'
//      loads are issued before the first add, through L2 only (the rows
//      are read once; L1 would only evict).
// Rows are added in segment order, one lane per word, starting from 0, so
// the sum is deterministic and bitwise the sequential sum in row order:
// no atomics, no split across warps. Against one-knob variants on the
// H100 (dev/gather_variants.py, PERF.md PR 8): 16 rows in flight are
// 5-21 % slower (more registers), 4 rows, plain loads and 256-thread
// blocks within 5 %; warps that each walked a run of several segments
// were slower still. The plan (VEC, from the
// width, the types and the pointers' alignment) is chosen by the caller
// (gnnep_tpu_torch/ops/cuda/segment_sum.py:segsum_plan); this file checks
// it. Nothing of the plan depends on the data, so a captured CUDA graph
// replays it as it is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// rows whose loads are in flight at once; a segment's rows beyond it are
// loaded in the next step of the round
constexpr int kRows = 8;

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

// an element's bits as they sit in a loaded word, widened to f32 and
// rounded back (round to nearest even, as torch's casts)
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

// acc[i] += the i-th element of one loaded word
template <typename T, int VEC>
__device__ __forceinline__ void add_word(
    float* acc, const typename Raw<VEC * sizeof(T)>::type& w) {
  union {
    typename Raw<VEC * sizeof(T)>::type raw;
    typename Elem<T>::bits e[VEC];
  } u;
  u.raw = w;
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] += Elem<T>::widen(u.e[i]);
}

// VEC sums rounded to O, stored in words of at most 16 bytes
template <typename O, int VEC>
__device__ __forceinline__ void store_word(O* dst, const float* acc) {
  constexpr int kBytes = VEC * static_cast<int>(sizeof(O));
  constexpr int kChunk = kBytes < 16 ? kBytes : 16;
  using R = typename Raw<kChunk>::type;
  union {
    typename Elem<O>::bits e[VEC];
    R raw[kBytes / kChunk];
  } u;
#pragma unroll
  for (int i = 0; i < VEC; ++i) u.e[i] = Elem<O>::narrow(acc[i]);
#pragma unroll
  for (int b = 0; b < kBytes / kChunk; ++b)
    reinterpret_cast<R*>(dst)[b] = u.raw[b];
}

template <typename T, typename O, int VEC>
__global__ void __launch_bounds__(kThreads)
    csr_segment_sum_kernel(const T* __restrict__ values,
                           const int* __restrict__ order,
                           const int* __restrict__ seg_starts,
                           O* __restrict__ out, int n, int width,
                           int slices) {
  using R = typename Raw<VEC * sizeof(T)>::type;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int seg = warp / slices;  // warp-uniform
  if (seg >= n) return;
  const int words = width / VEC;
  const int c = (warp - seg * slices) * 32 + lane;  // this lane's word
  const bool active = c < words;
  // lane 0 loads the segment's start, lane 1 its end (the next segment's
  // start). The last segment is the dummy row's: it owns the arena's tail
  // padding (thousands of rows, whose cotangents are zero) and its sum is
  // unspecified by the contract, so it ends where it starts: written as
  // zeros, never walked.
  const int bound = seg_starts[min(seg + (lane & 1), n - 1)];
  const int lo = __shfl_sync(0xffffffffu, bound, 0);
  const int hi = __shfl_sync(0xffffffffu, bound, 1);
  const R* col = reinterpret_cast<const R*>(values) + c;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  for (int r0 = lo; r0 < hi; r0 += 32) {
    const int m = min(hi - r0, 32);
    // lane r holds the arena row of the round's r-th entry
    int mine = r0 + lane;
    if (order != nullptr && lane < m) mine = order[mine];
    for (int s0 = 0; s0 < m; s0 += kRows) {
      R x[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = __shfl_sync(0xffffffffu, mine, s0 + r);
        if (active && s0 + r < m)
          x[r] = __ldcg(col + static_cast<size_t>(row) * words);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (active && s0 + r < m) add_word<T, VEC>(acc, x[r]);
    }
  }
  if (active)
    store_word<O, VEC>(out + static_cast<size_t>(seg) * width + c * VEC,
                       acc);
}

__global__ void __launch_bounds__(kThreads) csr_segment_sum_empty_kernel() {}

// the grid of a plan: n segments x slices warps, kWarps to a block
dim3 grid_of(int n, int width, int vec, int* slices) {
  *slices = (width / vec + 31) / 32;
  return dim3(static_cast<unsigned>(
      (static_cast<long long>(n) * *slices + kWarps - 1) / kWarps));
}

template <typename T, typename O>
cudaError_t launch(const void* values, const void* order,
                   const void* seg_starts, void* out, int n, int width,
                   int vec, cudaStream_t stream) {
  const T* v = static_cast<const T*>(values);
  const int* o = static_cast<const int*>(order);
  const int* s = static_cast<const int*>(seg_starts);
  O* dst = static_cast<O*>(out);
  int slices;
  const dim3 grid = grid_of(n, width, vec, &slices);
#define SEGSUM(VEC)                                                         \
  csr_segment_sum_kernel<T, O, VEC><<<grid, kThreads, 0, stream>>>(         \
      v, o, s, dst, n, width, slices)
  switch (vec) {
    case 8:
      if constexpr (sizeof(T) == 2) {
        SEGSUM(8);
        break;
      }
      return cudaErrorInvalidValue;
    case 4:
      SEGSUM(4);
      break;
    case 2:
      SEGSUM(2);
      break;
    case 1:
      SEGSUM(1);
      break;
    default:
      return cudaErrorInvalidValue;
  }
#undef SEGSUM
  return cudaGetLastError();
}

// the plan's words fit the width and both base addresses: a load of VEC
// values, a store of VEC outputs in chunks of at most 16 bytes
bool plan_fits(const void* values, const void* out, int width, int vec,
               int in_item, int out_item) {
  const int out_chunk = vec * out_item < 16 ? vec * out_item : 16;
  return vec > 0 && vec * in_item <= 16 && width % vec == 0 &&
         reinterpret_cast<uintptr_t>(values) % (vec * in_item) == 0 &&
         reinterpret_cast<uintptr_t>(out) % out_chunk == 0;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue where the plan does not fit (VEC values per load
// must divide the width and fit both base addresses, at most 16 bytes a
// load) or the types are not taken (out is f32 or the values' type). The
// caller guarantees: n >= 1, contiguous tensors of the types above,
// seg_starts nondecreasing within [0, E], order a permutation of [0, E)
// or null (the identity), n x slices < 2^31.
int csr_segment_sum(const void* values, const void* order,
                    const void* seg_starts, void* out, int n, int width,
                    int in_bf16, int out_bf16, int vec, void* stream) {
  if (!plan_fits(values, out, width, vec, in_bf16 ? 2 : 4, out_bf16 ? 2 : 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_bf16 && out_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(values, order, seg_starts,
                                               out, n, width, vec, s);
  else if (in_bf16)
    err = launch<__nv_bfloat16, float>(values, order, seg_starts, out, n,
                                       width, vec, s);
  else if (!out_bf16)
    err = launch<float, float>(values, order, seg_starts, out, n, width, vec,
                               s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// An empty kernel on the grid and block of the plan: the launch latency
// that a chain of segment-sums cannot go below.
int csr_segment_sum_empty(int n, int width, int vec, void* stream) {
  if (vec <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int slices;
  csr_segment_sum_empty_kernel<<<grid_of(n, width, vec, &slices),
                                 kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
