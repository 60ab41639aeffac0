// row_gather.cu: out[i, :] = tab[idx[i], :], a row gather, for Hopper,
// built for sm_90a.
//
// Replaces the dev probe `_kernel` in scripts_dev/exp_gather_probe.py,
// which asked whether Mosaic's in-kernel row gather (take_along_axis on
// axis 0) compiles on the TPU at all. On this card the gather is plain; the
// question is what it costs, at the probe's shapes and at the one the span
// kernels (attn_span_*.cu) do inside themselves: the line-graph conv's
// node-space kv [N, 2H] gathered by its src [E].
//
// What bounds it: bytes (the output written once, each gathered row read
// once, mostly from L2); no arithmetic. So the design is about bytes in
// flight and the chain of dependent loads, which is two long: idx[row],
// then the row.
//
// Design. A row is cut into words of 16 bytes (8, 4 or 2 where the row's
// bytes or the base pointers do not allow 16: the word is chosen from
// both, so a contiguous table at any element offset is copied right). A
// warp owns one slice of a row, 128 words: lane l copies words l, l + 32,
// l + 64 and l + 96 of the slice, issuing its four loads before its four
// stores, so that each lane keeps four words in flight (on the H100 one
// word a lane is 3-5 % slower in f32, two are within 3 %:
// dev/gather_variants.py, PERF.md PR 8). Outputs larger than the 50 MB L2
// are written with streaming (evict-first) stores, so that they do not
// push the table out of L2 (the bf16 span gather: 0.78 -> 0.91 of its
// bound). The copy is of bits, so it is exact for every element type. The
// launch plan (word size, slices, streaming) is chosen by the caller from
// the shape and the pointers' alignment
// (gnnep_tpu_torch/dev/gather_probe.py:gather_plan); this file checks it.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 128;  // 4 warps, one slice of a row each
constexpr int kWarps = kThreads / 32;
constexpr int kWordsPerLane = 4;
constexpr int kSliceWords = 32 * kWordsPerLane;

template <bool kStream, typename W>
__device__ __forceinline__ void put(W* p, const W& v) {
  if constexpr (kStream) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

template <typename W, typename I, bool kStream>
__global__ void __launch_bounds__(kThreads)
    row_gather_kernel(const W* __restrict__ tab, const I* __restrict__ idx,
                      W* __restrict__ out, int rows, int words, int slices) {
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int row = warp / slices;
  if (row >= rows) return;
  const int c0 = (warp - row * slices) * kSliceWords + (threadIdx.x & 31);
  const W* src = tab + static_cast<size_t>(idx[row]) * words;
  W* dst = out + static_cast<size_t>(row) * words;
  W v[kWordsPerLane];
#pragma unroll
  for (int k = 0; k < kWordsPerLane; ++k)
    if (c0 + 32 * k < words) v[k] = src[c0 + 32 * k];
#pragma unroll
  for (int k = 0; k < kWordsPerLane; ++k)
    if (c0 + 32 * k < words) put<kStream>(dst + c0 + 32 * k, v[k]);
}

__global__ void __launch_bounds__(kThreads) row_gather_empty_kernel() {}

// the grid of a plan: rows x slices warps, kWarps to a block
dim3 grid_of(int rows, int words, int* slices) {
  *slices = (words + kSliceWords - 1) / kSliceWords;
  return dim3(static_cast<unsigned>(
      (static_cast<long long>(rows) * *slices + kWarps - 1) / kWarps));
}

template <typename W, typename I>
cudaError_t launch(const void* tab, const void* idx, void* out, int rows,
                   int words, bool stream_stores, cudaStream_t s) {
  const W* t = static_cast<const W*>(tab);
  const I* ix = static_cast<const I*>(idx);
  W* o = static_cast<W*>(out);
  int slices;
  const dim3 grid = grid_of(rows, words, &slices);
  if (stream_stores)
    row_gather_kernel<W, I, true><<<grid, kThreads, 0, s>>>(t, ix, o, rows,
                                                            words, slices);
  else
    row_gather_kernel<W, I, false><<<grid, kThreads, 0, s>>>(t, ix, o, rows,
                                                             words, slices);
  return cudaGetLastError();
}

template <typename I>
cudaError_t launch_word(const void* tab, const void* idx, void* out,
                        int rows, int row_bytes, int word_bytes,
                        bool stream_stores, cudaStream_t s) {
  const int words = row_bytes / word_bytes;
  switch (word_bytes) {
    case 16:
      return launch<uint4, I>(tab, idx, out, rows, words, stream_stores, s);
    case 8:
      return launch<uint2, I>(tab, idx, out, rows, words, stream_stores, s);
    case 4:
      return launch<uint32_t, I>(tab, idx, out, rows, words, stream_stores,
                                 s);
    case 2:
      return launch<uint16_t, I>(tab, idx, out, rows, words, stream_stores,
                                 s);
    default:
      return cudaErrorInvalidValue;
  }
}

bool word_fits(const void* tab, const void* out, int row_bytes,
               int word_bytes) {
  return word_bytes > 0 && row_bytes % word_bytes == 0 &&
         reinterpret_cast<uintptr_t>(tab) % word_bytes == 0 &&
         reinterpret_cast<uintptr_t>(out) % word_bytes == 0;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue where the plan does not fit: `word_bytes` (16, 8,
// 4 or 2) must divide row_bytes and both base addresses. The caller
// guarantees: rows >= 1, tab and out contiguous, rows x slices < 2^31,
// idx int64 (idx_is_64) or int32 with 0 <= idx[i] < the table's row
// count.
int row_gather(const void* tab, const void* idx, void* out, int rows,
               int row_bytes, int word_bytes, int stream_stores,
               int idx_is_64, void* stream) {
  if (!word_fits(tab, out, row_bytes, word_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      idx_is_64 ? launch_word<long long>(tab, idx, out, rows, row_bytes,
                                         word_bytes, stream_stores != 0, s)
                : launch_word<int>(tab, idx, out, rows, row_bytes, word_bytes,
                                   stream_stores != 0, s);
  return static_cast<int>(err);
}

// An empty kernel on the grid and block of the gather's plan: the launch
// latency that a chain of gathers cannot go below.
int row_gather_empty(int rows, int row_bytes, int word_bytes, void* stream) {
  if (word_bytes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int slices;
  row_gather_empty_kernel<<<grid_of(rows, row_bytes / word_bytes, &slices),
                            kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
