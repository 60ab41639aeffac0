// row_gather.cu: out[i, :] = tab[idx[i], :], a row gather, for Hopper,
// built for sm_90a.
//
// Replaces the dev probe `_kernel` in scripts_dev/exp_gather_probe.py,
// which asked whether Mosaic's in-kernel row gather (take_along_axis on
// axis 0) compiles on the TPU at all. On this card the gather is plain; the
// question is what it costs, at the probe's shapes and at the one the span
// kernels (attn_span_*.cu) now do inside themselves: the line-graph conv's
// node-space kv [N, 2H] gathered by its src [E].
//
// Design: one warp per output row, lanes over the row in 16-byte words when
// the row's bytes allow (4- or 2-byte words otherwise), so each warp moves
// 512 contiguous bytes per instruction. The copy is of bits, so it is exact
// for every element type. What bounds it: bytes (the output written once,
// the table's rows read once each, mostly from L2); no arithmetic.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 8 warps, 8 rows per block

template <typename W, typename I>
__global__ void __launch_bounds__(kThreads)
    row_gather_kernel(const W* tab, const I* idx, W* out, int rows,
                      int words) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const W* src = tab + static_cast<size_t>(idx[row]) * words;
  W* dst = out + static_cast<size_t>(row) * words;
  for (int c = lane; c < words; c += 32) dst[c] = src[c];
}

template <typename I>
cudaError_t launch(const void* tab, const void* idx, void* out, int rows,
                   int row_bytes, cudaStream_t stream) {
  const dim3 grid((rows + kThreads / 32 - 1) / (kThreads / 32));
  const I* ix = static_cast<const I*>(idx);
  if (row_bytes % 16 == 0)
    row_gather_kernel<uint4, I><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint4*>(tab), ix, static_cast<uint4*>(out), rows,
        row_bytes / 16);
  else if (row_bytes % 4 == 0)
    row_gather_kernel<uint32_t, I><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint32_t*>(tab), ix, static_cast<uint32_t*>(out),
        rows, row_bytes / 4);
  else
    row_gather_kernel<uint16_t, I><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint16_t*>(tab), ix, static_cast<uint16_t*>(out),
        rows, row_bytes / 2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched). The
// caller guarantees: rows >= 1, row_bytes even, tab and out contiguous and
// 16-byte aligned, idx int64 (idx_is_64) or int32 with 0 <= idx[i] < the
// table's row count.
int row_gather(const void* tab, const void* idx, void* out, int rows,
               int row_bytes, int idx_is_64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      idx_is_64 ? launch<long long>(tab, idx, out, rows, row_bytes, s)
                : launch<int>(tab, idx, out, rows, row_bytes, s);
  return static_cast<int>(err);
}

}  // extern "C"
