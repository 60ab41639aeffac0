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
// [N]; out f32 [N, W]. The caller casts the result to the cotangent's type,
// as `_csr_gather_ordered_bwd` does.
//
// Design. The TPU kernel multiplies a 0/1 membership matrix into a window
// of rows on the matrix unit. Here one warp owns one segment and streams
// its rows: each lane holds four consecutive columns (one 16-byte load in
// f32, 8 bytes in bf16), and eight rows are in flight at a time. Rows are
// added in segment order, one lane per column group, so the sum is
// deterministic: no atomics, no split across blocks.
//
// What bounds it on this card: it reads each live row once and writes each
// output row once, with one add per element read, so it is bounded by
// bytes (about 150 MB, 0.046 ms, at the flagship line-graph conv in f32).
// The permuted read `values[order[j]]` gathers whole rows, so every load is
// still a full, aligned row segment.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsInFlight = 8;

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
    out[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  if constexpr (VEC == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    out[0] = a.x;
    out[1] = a.y;
    out[2] = b.x;
    out[3] = b.y;
  } else {
    out[0] = __bfloat162float(*p);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    csr_segment_sum_kernel(const T* __restrict__ values,
                           const int* __restrict__ order,
                           const int* __restrict__ seg_starts,
                           float* __restrict__ out, int n, int width) {
  const int seg = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (seg >= n) return;
  // the last segment is the dummy row's: it owns the arena's tail padding
  // (thousands of rows, whose cotangents are zero) and its sum is
  // unspecified by the contract, so it is written as zeros, never walked
  const int lo = seg_starts[seg];
  const int hi = seg + 1 < n ? seg_starts[seg + 1] : lo;
  for (int c0 = lane * VEC; c0 < width; c0 += 32 * VEC) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    int j = lo;
    // eight rows' loads issued before their adds; the adds keep row order
    for (; j + kRowsInFlight <= hi; j += kRowsInFlight) {
      float x[kRowsInFlight][VEC];
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
        const long long row = order ? order[j + r] : j + r;
        load_vec<VEC>(values + static_cast<size_t>(row) * width + c0, x[r]);
      }
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r)
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += x[r][i];
    }
    for (; j < hi; ++j) {
      const long long row = order ? order[j] : j;
      float x[VEC];
      load_vec<VEC>(values + static_cast<size_t>(row) * width + c0, x);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += x[i];
    }
    float* o = out + static_cast<size_t>(seg) * width + c0;
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      *o = acc[0];
    }
  }
}

template <typename T>
cudaError_t launch(const void* values, const void* order,
                   const void* seg_starts, void* out, int n, int width,
                   cudaStream_t stream) {
  const dim3 grid((n + kWarps - 1) / kWarps);
  const T* v = static_cast<const T*>(values);
  const int* o = static_cast<const int*>(order);
  const int* s = static_cast<const int*>(seg_starts);
  float* dst = static_cast<float*>(out);
  const bool aligned =
      reinterpret_cast<uintptr_t>(values) % (4 * sizeof(T)) == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (width % 4 == 0 && aligned) {
    csr_segment_sum_kernel<T, 4><<<grid, kThreads, 0, stream>>>(
        v, o, s, dst, n, width);
  } else {
    csr_segment_sum_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        v, o, s, dst, n, width);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched). The
// caller guarantees: n >= 1, contiguous tensors of the types above,
// seg_starts nondecreasing within [0, E], and order a permutation of
// [0, E) or null (the identity). Four-column loads are taken where the
// width and the base pointers allow them, single-column loads otherwise.
int csr_segment_sum(const void* values, const void* order,
                    const void* seg_starts, void* out, int n, int width,
                    int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(values, order, seg_starts, out, n,
                                      width, s)
              : launch<float>(values, order, seg_starts, out, n, width, s);
  return static_cast<int>(err);
}

}  // extern "C"
