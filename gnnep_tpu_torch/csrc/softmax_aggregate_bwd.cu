// softmax_aggregate_bwd.cu: backward of the segment softmax of external
// per-edge logits and the weighted sum of per-edge values, for Hopper, built
// for sm_90a.
//
// Replaces the TPU kernel `_bwd_kernel` in
// gnnep_tpu/ops/pallas/csr_attention.py (reached there through
// `_pallas_backward_t` from the custom VJP `_bwd` of
// `csr_softmax_aggregate`). For every target t, head h and counted edge j of
// t's CSR range, with the forward's softmax max m_t and denominator d_t:
//
//   s_j = exp(logits_t[h, j] - m_t) / d_t,    a_j = s_j · scale_t[h, j]
//   u_j = g_t · v_j,   inner_t = sum_j a_j u_j
//   dl_j = s_j (scale_t[h, j] u_j - inner_t),   dv_j = a_j g_t
//
// Arguments as the JAX function's: logits_t and scale_t f32 [heads, E], v
// [E, H] float32 or bfloat16, row_ptr i32 [N+1], g f32 [N, H], the forward's
// max and denom f32 [N, heads]; outputs dl_t f32 [heads, E] and dv [E, H] in
// v's type.
//
// Design. Two kernels.
//  softmax_aggregate_bwd_kernel: one warp per (target, head), eight per
//  block, lanes over the head's channels, as the forward (a head wider than
//  128 channels in passes of 128, alpha recomputed alike in each).
//   Pass 1 walks the row's counted edges four at a time (their v loads
//   issued together), reduces g · v over the warp, and writes each edge's s
//   and u to scratch [heads, E] arrays the wrapper allocates; the warp sums
//   inner_t.
//   Pass 2 writes dl for 32 edges at a time (zero for edges that do not
//   count), then the dv rows of the chunk, lanes over channels.
//  zero_tail_kernel: zero dl_t and dv for the dummy row's edges
//   [row_ptr[n-1], E), which the first kernel never walks.
// Each edge has exactly one writer: no read-modify-write windows and no
// atomics (the TPU kernel accumulates over overlapping windows, which is
// safe only on its sequential grid, :237-245, :289-297).
//
// Hazards, each handled here:
//  - The clamp of the forward (:266-268): an edge counts only if its logit
//    is above 0.5 · -1e30, so masked edges and all-masked rows (max -1e30)
//    get s = 0, never exp(0) = 1.
//  - Zeros, not garbage: edges that do not count, and the dummy row's, get
//    zero dl and zero dv rows.
//  - bf16 rounding mirrors the TPU kernel (:273-286): g rounds to v's type
//    before u and dv, alpha rounds to v's type before dv, dv rounds after
//    its f32 product; dl, inner and s stay f32.
//
// What bounds it on this card: it reads v of every counted edge once and
// writes dv for all E rows, with a few operations per value, so it is
// bounded by bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;      // edges whose v loads a warp issues together
constexpr int kTailBlocks = 264;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* logits_t;
  const float* scale_t;
  const void* v;
  const int* row_ptr;
  const float* g;
  const float* stats_max;
  const float* stats_den;
  float* dl_t;
  void* dv;
  float* s_s;  // [heads, E] scratch
  float* u_s;  // [heads, E] scratch
  int n, e_total, hidden, heads, ch;
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_t(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_t(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
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
__global__ void __launch_bounds__(kThreads)
    softmax_aggregate_bwd_kernel(Args a) {
  __shared__ float al_w[kWarps][32];
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + warp;
  const int ch = a.ch, hid = a.hidden;
  // the dummy row n-1 is never walked (zero_tail_kernel zeroes its edges)
  if (t >= a.n - 1) return;

  const T* v = static_cast<const T*>(a.v);
  T* dv = static_cast<T*>(a.dv);
  const float* grow = a.g + static_cast<size_t>(t) * hid + h * ch;
  // channel passes of 32 · CPL channels (one unless Wide); g of a pass
  float gr[CPL];
  const int npass = Wide ? (ch + 32 * CPL - 1) / (32 * CPL) : 1;
  auto load_g = [&](int cb) {
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = cb + lane + 32 * i;
      gr[i] = c < ch ? round_to<T>(grow[c]) : 0.f;
    }
  };
  load_g(0);
  const size_t th = static_cast<size_t>(t) * a.heads + h;
  const float m = a.stats_max[th], den = a.stats_den[th];
  const int rlo = a.row_ptr[t], rhi = a.row_ptr[t + 1];
  const size_t hoff = static_cast<size_t>(h) * a.e_total;
  const float* logit = a.logits_t + hoff;
  const float* scale = a.scale_t + hoff;
  float* dl_h = a.dl_t + hoff;
  float* s_h = a.s_s + hoff;
  float* u_h = a.u_s + hoff;

  // pass 1: s and u of the row's counted edges, and inner
  float inner = 0.f;
  for (int j0 = rlo; j0 < rhi; j0 += 32) {
    const int cnt = min(32, rhi - j0);
    const float my_l = lane < cnt ? logit[j0 + lane] : kNeg;
    const bool mine = lane < cnt && counts(my_l);
    const unsigned live = __ballot_sync(kFull, mine);
    float my_u = 0.f;
    for (int u0 = 0; u0 < cnt; u0 += kGroup) {
      if (!((live >> u0) & 0xfu)) continue;  // four edges that do not count
      float pu[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) pu[g] = 0.f;
      for (int pass = 0; pass < npass; ++pass) {
        const int cb = pass * 32 * CPL;
        if constexpr (Wide) load_g(cb);
        float vx[kGroup][CPL];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const bool ok = u0 + g < cnt && ((live >> (u0 + g)) & 1u);
          const size_t row = static_cast<size_t>(j0 + u0 + g) * hid + h * ch;
#pragma unroll
          for (int i = 0; i < CPL; ++i) {
            const int c = cb + lane + 32 * i;
            vx[g][i] = ok && c < ch ? load_f(v + row + c) : 0.f;
          }
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
#pragma unroll
          for (int i = 0; i < CPL; ++i) pu[g] = fmaf(gr[i], vx[g][i], pu[g]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int g = 0; g < kGroup; ++g) pu[g] += __shfl_xor_sync(kFull, pu[g], o);
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        if (lane == u0 + g) my_u = pu[g];
    }
    if (mine) {
      const int j = j0 + lane;
      const float s = expf(my_l - m) / den;
      s_h[j] = s;
      u_h[j] = my_u;
      inner = fmaf(s * scale[j], my_u, inner);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) inner += __shfl_xor_sync(kFull, inner, o);

  // pass 2: dl of 32 edges at a time (written in the first channel pass),
  // then their dv rows; alpha recomputed alike in each pass
  for (int pass = 0; pass < npass; ++pass) {
    const int cb = pass * 32 * CPL;
    if constexpr (Wide) load_g(cb);
    for (int j0 = rlo; j0 < rhi; j0 += 32) {
      const int j = j0 + lane;
      float al = 0.f;
      if (j < rhi) {
        float dl = 0.f;
        // the same lane wrote s and u of its edge in pass 1
        if (counts(logit[j])) {
          const float s = s_h[j], sc = scale[j];
          dl = s * (sc * u_h[j] - inner);
          al = round_to<T>(s * sc);
        }
        if (pass == 0) dl_h[j] = dl;
      }
      al_w[warp][lane] = al;
      __syncwarp();
      const int cnt = min(32, rhi - j0);
      for (int u = 0; u < cnt; ++u) {
        const float alu = al_w[warp][u];
        T* dvr = dv + static_cast<size_t>(j0 + u) * hid + h * ch + cb;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int c = lane + 32 * i;
          if (cb + c < ch) store_t(dvr + c, alu * gr[i]);
        }
      }
      __syncwarp();
    }
  }
}

// zero dl_t[:, j] and dv rows j for j in [row_ptr[n-1], E): the dummy row's
// edges
template <typename T>
__global__ void __launch_bounds__(kThreads) zero_tail_kernel(Args a) {
  const size_t lo = static_cast<size_t>(a.row_ptr[a.n - 1]);
  const size_t rows = static_cast<size_t>(a.e_total) - lo;
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  const size_t first = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x;
  T* dv = static_cast<T*>(a.dv);
  for (size_t i = lo * a.hidden + first; i < a.e_total * static_cast<size_t>(a.hidden);
       i += stride)
    store_t(dv + i, 0.f);
  for (size_t i = first; i < rows * a.heads; i += stride)
    a.dl_t[(i / rows) * a.e_total + lo + i % rows] = 0.f;
}

template <typename T, int CPL, bool Wide>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.n + kWarps - 1) / kWarps, a.heads);
  softmax_aggregate_bwd_kernel<T, CPL, Wide><<<grid, kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  zero_tail_kernel<T><<<kTailBlocks, kThreads, 0, stream>>>(a);
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

// Launches both kernels on `stream` and returns cudaGetLastError() (0 =
// launched). The caller guarantees: n >= 1, hidden = heads * ch (any ch >=
// 1), contiguous tensors of the types above, row_ptr nondecreasing with
// row_ptr[n] <= e_total, and scratch buffers s_s and u_s f32 [heads, E].
int softmax_aggregate_bwd(const void* logits_t, const void* scale_t,
                          const void* v, const void* row_ptr, const void* g,
                          const void* stats_max, const void* stats_den,
                          void* dl_t, void* dv, void* s_s, void* u_s, int n,
                          int e_total, int hidden, int heads, int is_bf16,
                          void* stream) {
  Args a;
  a.logits_t = static_cast<const float*>(logits_t);
  a.scale_t = static_cast<const float*>(scale_t);
  a.v = v;
  a.row_ptr = static_cast<const int*>(row_ptr);
  a.g = static_cast<const float*>(g);
  a.stats_max = static_cast<const float*>(stats_max);
  a.stats_den = static_cast<const float*>(stats_den);
  a.dl_t = static_cast<float*>(dl_t);
  a.dv = dv;
  a.s_s = static_cast<float*>(s_s);
  a.u_s = static_cast<float*>(u_s);
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
