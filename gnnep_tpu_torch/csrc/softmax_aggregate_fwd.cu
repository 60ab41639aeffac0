// softmax_aggregate_fwd.cu: segment softmax of external per-edge logits and
// the weighted sum of per-edge values (forward), for Hopper, built for
// sm_90a.
//
// Replaces the TPU kernel `_kernel` in gnnep_tpu/ops/pallas/csr_attention.py
// (reached there through `_pallas_forward_t` from `csr_softmax_aggregate` /
// `fused_aggregate_t`, the external-logits rung of the conv:
// attn_fused=False). For every aggregation target t and head h, over the CSR
// range [row_ptr[t], row_ptr[t+1]) of the dst-sorted edge arena:
//
//   out_t = Σ_j softmax_j(logits_t[h, j]) · scale_t[h, j] · v_j[h]
//
// and it saves the softmax max and denominator of every (t, h) in [N, heads]
// layouts, for the backward (softmax_aggregate_bwd.cu). Argument layout as
// the JAX function:
// logits_t and scale_t f32 [heads, E], v [E, H] float32 or bfloat16, row_ptr
// i32 [N+1]; out f32 [N, H].
//
// Design. One warp per (target, head), eight per block, lanes over the
// head's channels (lane, lane + 32, ...; up to four a lane, and a head
// wider than 128 channels in passes of 128), as attn_fwd.cu without the
// q·k products.
//  Pass 1: the row's logits, 32 at a time, into a running (max,
//  denominator) per lane, merged over the warp.
//  Pass 2: alpha of 32 edges at a time into shared memory, then the sum of
//  alpha · v over the chunk. Edges of weight 0 are not read.
// Each (target, head) belongs to one warp: no atomics, no sums across
// warps. The dummy row n-1 owns the arena's tail padding; it is written as
// an all-masked row and never walked.
//
// Hazards, each handled here:
//  - There is no mask stream. Interior padding rows and masked edges are
//    excluded only because the caller wrote their logits as -1e30. The
//    kernel keeps them at weight 0 with the TPU kernel's clamp
//    (csr_attention.py:93-96): an edge counts only if its logit is above
//    0.5 · -1e30. Without it an all-masked row (max -1e30) would give
//    exp(0) = 1 on each of its masked edges. Such a row gives out = 0,
//    max = -1e30, denom = 1e-16.
//  - bf16 rounding mirrors the TPU kernel: the logits arrive in f32, alpha is
//    rounded to v's type before the aggregation (:101-103), and out and the
//    stats are f32.
//  - scale_t multiplies alpha after normalisation and never enters the
//    denominator.
//
// What bounds it on this card: it reads v of every live edge once and the
// logits and scales of the row, with one multiply-add per value read, so it
// is bounded by bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* logits_t;
  const float* scale_t;
  const void* v;
  const int* row_ptr;
  float* out;
  float* stats_max;
  float* stats_den;
  int n, e_total, hidden, heads, ch;
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// round an f32 value to the storage type T and back
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// the TPU kernel's clamp: a logit of -1e30 (masked) never counts
__device__ __forceinline__ bool counts(float l) { return l > 0.5f * kNeg; }

// CPL = channels per lane = ceil(ch / 32) for ch <= 128; Wide: a head
// wider than 128 channels, walked in passes of 32 · CPL channels
template <typename T, int CPL, bool Wide>
__global__ void __launch_bounds__(kThreads) softmax_aggregate_fwd_kernel(Args a) {
  __shared__ float alpha_s[kWarps][32];
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + warp;
  const int ch = a.ch, hid = a.hidden;
  if (t >= a.n) return;
  const size_t th = static_cast<size_t>(t) * a.heads + h;
  float* out = a.out + static_cast<size_t>(t) * hid + h * ch;
  if (t == a.n - 1) {
    // the dummy row: written as an all-masked row, never walked
    for (int c = lane; c < ch; c += 32) out[c] = 0.f;
    if (lane == 0) {
      a.stats_max[th] = kNeg;
      a.stats_den[th] = 1e-16f;
    }
    return;
  }

  const int rlo = a.row_ptr[t], rhi = a.row_ptr[t + 1];
  const float* logit = a.logits_t + static_cast<size_t>(h) * a.e_total;
  const float* scale = a.scale_t + static_cast<size_t>(h) * a.e_total;

  // pass 1: running max and denominator over the row's counted logits
  float m = kNeg, d = 0.f;
  for (int j = rlo + lane; j < rhi; j += 32) {
    const float l = logit[j];
    if (counts(l)) {
      const float mn = fmaxf(m, l);
      d = d * expf(m - mn) + expf(l - mn);
      m = mn;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(kFull, m, o);
    const float d2 = __shfl_xor_sync(kFull, d, o);
    const float mn = fmaxf(m, m2);
    d = d * expf(m - mn) + d2 * expf(m2 - mn);
    m = mn;
  }
  const float den = fmaxf(d, 1e-16f);

  // pass 2: alpha of 32 edges at a time, then the sum of alpha · v; a wide
  // head channel pass by channel pass, alpha recomputed in each pass by the
  // same instructions from the same values (so it rounds alike)
  const T* v = static_cast<const T*>(a.v);
  const int npass = Wide ? (ch + 32 * CPL - 1) / (32 * CPL) : 1;
  for (int pass = 0; pass < npass; ++pass) {
    const int cb = pass * 32 * CPL;
    float acc[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) acc[i] = 0.f;
    for (int j0 = rlo; j0 < rhi; j0 += 32) {
      const int j = j0 + lane;
      float al = 0.f;
      if (j < rhi) {
        const float l = logit[j];
        if (counts(l)) al = round_to<T>((expf(l - m) / den) * scale[j]);
      }
      alpha_s[warp][lane] = al;
      __syncwarp();
      const int cnt = min(32, rhi - j0);
#pragma unroll 4
      for (int u = 0; u < cnt; ++u) {
        const float w = alpha_s[warp][u];
        if (w == 0.f) continue;  // masked or dropped: v is not read
        const T* vr = v + static_cast<size_t>(j0 + u) * hid + h * ch + cb;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int c = lane + 32 * i;
          if (cb + c < ch) acc[i] = fmaf(w, load_f(vr + c), acc[i]);
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int i = 0; i < CPL; ++i)
      if (cb + lane + 32 * i < ch) out[cb + lane + 32 * i] = acc[i];
  }
  if (lane == 0) {
    a.stats_max[th] = m;
    a.stats_den[th] = den;
  }
}

template <typename T, int CPL, bool Wide>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.n + kWarps - 1) / kWarps, a.heads);
  softmax_aggregate_fwd_kernel<T, CPL, Wide><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  if (a.ch <= 32) return launch<T, 1, false>(a, stream);
  if (a.ch <= 64) return launch<T, 2, false>(a, stream);
  if (a.ch <= 128) return launch<T, 4, false>(a, stream);
  return launch<T, 4, true>(a, stream);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched). The
// caller guarantees: n >= 1, hidden = heads * ch (any ch >= 1), contiguous
// tensors of the types above, and row_ptr nondecreasing with row_ptr[n] <=
// e_total.
int softmax_aggregate_fwd(const void* logits_t, const void* scale_t,
                          const void* v, const void* row_ptr, void* out,
                          void* stats_max, void* stats_den, int n,
                          int e_total, int hidden, int heads, int is_bf16,
                          void* stream) {
  Args a;
  a.logits_t = static_cast<const float*>(logits_t);
  a.scale_t = static_cast<const float*>(scale_t);
  a.v = v;
  a.row_ptr = static_cast<const int*>(row_ptr);
  a.out = static_cast<float*>(out);
  a.stats_max = static_cast<float*>(stats_max);
  a.stats_den = static_cast<float*>(stats_den);
  a.n = n;
  a.e_total = e_total;
  a.hidden = hidden;
  a.heads = heads;
  a.ch = hidden / heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? dispatch<__nv_bfloat16>(a, s)
                                  : dispatch<float>(a, s);
  return static_cast<int>(err);
}

}  // extern "C"
