// attn_fwd.cu: CSR graph attention over precomputed per-edge keys and values
// (forward), for Hopper, built for sm_90a.
//
// Replaces the TPU kernel `_attn_kernel` in
// gnnep_tpu/ops/pallas/csr_attention.py (reached there through
// `_attn_forward` from `csr_attention` / `fused_attention`, the kv+e rung of
// the conv: attn_eproj=False). For every aggregation target t and head h,
// over the CSR range [row_ptr[t], row_ptr[t+1]) of the dst-sorted edge arena:
//
//   l_j   = q_t[h] · k_j[h] / sqrt(ch)             only where mask2[j] > 0
//   out_t = Σ_j softmax_j(l) · scale_t[h, j] · v_j[h]
//
// and it saves the softmax max and denominator of every (t, h) in [N, heads]
// layouts, for the backward (attn_bwd.cu). Argument layout as the JAX
// function: q [N, H], k_e and v_e [E, H] in float32 or bfloat16 (all three
// the same type), scale_t f32 [heads, E], mask2 f32 [E], row_ptr i32 [N+1];
// out f32 [N, H].
//
// Design. One warp per (target, head); a block holds eight warps, i.e. eight
// consecutive targets of one head. A lane holds the channels lane, lane + 32,
// ... of the head (up to four), so every row load of k or v is a coalesced
// run of the head's channels; a head wider than 128 channels is walked in
// passes of 128 (the dot products summed over the passes before the logit
// is formed, alpha recomputed alike in each pass of the aggregation).
//  Pass 1 walks the row in chunks of 32 edges. Four live edges at a time,
//  every lane issues its k loads for all four before the dot products; each
//  dot is reduced over the warp, and lane u keeps the logit of edge u of the
//  chunk. Each lane then writes its edge's logit to a scratch [heads, E]
//  array the wrapper allocates and folds it into a running (max,
//  denominator), merged over the warp at the end.
//  Pass 2 reads each lane's logit back (the same lane wrote it), forms alpha
//  for 32 edges at a time into shared memory, and sums alpha · v over the
//  chunk, lanes over channels. Edges of weight 0 (masked, dropped) are not
//  read.
//
// Each edge row belongs to exactly one target and each (target, head) to one
// warp, so there are no atomics and no sums across warps. The dummy row n-1
// owns the arena's tail padding (thousands of masked edges at the flagship
// size); it is written as an all-masked row and never walked.
//
// Hazards, each handled here:
//  - mask2 joins the membership test before the exp (csr_attention.py:586).
//    An all-masked or empty row gives out = 0, max = -1e30, denom = 1e-16,
//    as the TPU kernel does (:598-603): no exp of a masked logit is taken.
//  - Interior padding rows (the packer's dilution) sit inside real rows' CSR
//    ranges; only mask2 excludes them. The output of the dummy row n-1 is
//    unspecified by the contract (here: out 0, max -1e30, denom 1e-16).
//  - bf16 rounding mirrors the TPU kernel: q·k products are summed in f32,
//    so the logits are f32; alpha is rounded to v's type before the
//    aggregation (:604-606); out and the stats are f32. Keeping every logit
//    until the row's denominator is known (rather than an online rescaled
//    sum of alpha · v) is what lets alpha be rounded where the TPU kernel
//    rounds it.
//  - scale_t multiplies alpha after normalisation and never enters the
//    denominator.
//
// What bounds it on this card: it reads k and v of every live edge once (the
// bulk of the bytes: 137 MB at the flagship line-graph conv in f32) and does
// about four operations per byte-pair read, so it is bounded by bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;      // edges whose k loads a warp issues together
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* scale_t;
  const float* mask2;
  const int* row_ptr;
  float* out;
  float* stats_max;
  float* stats_den;
  float* logit_s;  // [heads, E] scratch
  int n, e_total, hidden, heads, ch;
  float inv_sqrt_ch;
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

// CPL = channels per lane = ceil(ch / 32) for ch <= 128; Wide: a head
// wider than 128 channels, walked in passes of 32 · CPL channels
template <typename T, int CPL, bool Wide>
__global__ void __launch_bounds__(kThreads) attn_fwd_kernel(Args a) {
  __shared__ float alpha_s[kWarps][32];
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + warp;
  const int ch = a.ch, hid = a.hidden;
  if (t >= a.n) return;
  const size_t th = static_cast<size_t>(t) * a.heads + h;
  if (t == a.n - 1) {
    // the dummy row: written as an all-masked row, never walked
    for (int c = lane; c < ch; c += 32)
      a.out[static_cast<size_t>(t) * hid + h * ch + c] = 0.f;
    if (lane == 0) {
      a.stats_max[th] = kNeg;
      a.stats_den[th] = 1e-16f;
    }
    return;
  }

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* qrow = q + static_cast<size_t>(t) * hid + h * ch;
  // channel passes of 32 · CPL channels (one unless Wide); q of a pass
  float qr[CPL];
  const int npass = Wide ? (ch + 32 * CPL - 1) / (32 * CPL) : 1;
  auto load_q = [&](int cb) {
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = cb + lane + 32 * i;
      qr[i] = c < ch ? load_f(qrow + c) : 0.f;
    }
  };
  load_q(0);
  const int rlo = a.row_ptr[t], rhi = a.row_ptr[t + 1];
  float* logit = a.logit_s + static_cast<size_t>(h) * a.e_total;
  const float* scale = a.scale_t + static_cast<size_t>(h) * a.e_total;

  // pass 1: logits of the row's live edges, running max and denominator
  float m = kNeg, d = 0.f;
  for (int j0 = rlo; j0 < rhi; j0 += 32) {
    const int cnt = min(32, rhi - j0);
    const bool mine = lane < cnt && a.mask2[j0 + lane] > 0.f;
    const unsigned live = __ballot_sync(kFull, mine);
    float my_l = 0.f;
    for (int u0 = 0; u0 < cnt; u0 += kGroup) {
      if (!((live >> u0) & 0xfu)) continue;  // four masked edges
      float p[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) p[g] = 0.f;
      for (int pass = 0; pass < npass; ++pass) {
        const int cb = pass * 32 * CPL;
        if constexpr (Wide) load_q(cb);
        float kx[kGroup][CPL];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const bool ok = u0 + g < cnt && ((live >> (u0 + g)) & 1u);
          const size_t row = static_cast<size_t>(j0 + u0 + g) * hid + h * ch;
#pragma unroll
          for (int i = 0; i < CPL; ++i) {
            const int c = cb + lane + 32 * i;
            kx[g][i] = ok && c < ch ? load_f(k + row + c) : 0.f;
          }
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
#pragma unroll
          for (int i = 0; i < CPL; ++i) p[g] = fmaf(qr[i], kx[g][i], p[g]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int g = 0; g < kGroup; ++g) p[g] += __shfl_xor_sync(kFull, p[g], o);
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        if (lane == u0 + g) my_l = p[g] * a.inv_sqrt_ch;
    }
    if (mine) {
      logit[j0 + lane] = my_l;
      const float mn = fmaxf(m, my_l);
      d = d * expf(m - mn) + expf(my_l - mn);
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
  // same instructions from the same logits (so it rounds alike)
  for (int pass = 0; pass < npass; ++pass) {
    const int cb = pass * 32 * CPL;
    float acc[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) acc[i] = 0.f;
    for (int j0 = rlo; j0 < rhi; j0 += 32) {
      const int j = j0 + lane;
      float al = 0.f;
      if (j < rhi && a.mask2[j] > 0.f)
        al = round_to<T>((expf(logit[j] - m) / den) * scale[j]);
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
    for (int i = 0; i < CPL; ++i) {
      const int c = cb + lane + 32 * i;
      if (c < ch) a.out[static_cast<size_t>(t) * hid + h * ch + c] = acc[i];
    }
  }
  if (lane == 0) {
    a.stats_max[th] = m;
    a.stats_den[th] = den;
  }
}

template <typename T, int CPL, bool Wide>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.n + kWarps - 1) / kWarps, a.heads);
  attn_fwd_kernel<T, CPL, Wide><<<grid, kThreads, 0, stream>>>(a);
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
// tensors of the types above, row_ptr nondecreasing with row_ptr[n] <=
// e_total, and a scratch buffer logit_s f32 [heads, E]. inv_sqrt_ch is
// 1/sqrt(ch) rounded once to f32, as the JAX kernel's constant is.
int attn_fwd(const void* q, const void* k, const void* v, const void* scale_t,
             const void* mask2, const void* row_ptr, void* out,
             void* stats_max, void* stats_den, void* logit_s, int n,
             int e_total, int hidden, int heads, float inv_sqrt_ch,
             int is_bf16, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.scale_t = static_cast<const float*>(scale_t);
  a.mask2 = static_cast<const float*>(mask2);
  a.row_ptr = static_cast<const int*>(row_ptr);
  a.out = static_cast<float*>(out);
  a.stats_max = static_cast<float*>(stats_max);
  a.stats_den = static_cast<float*>(stats_den);
  a.logit_s = static_cast<float*>(logit_s);
  a.n = n;
  a.e_total = e_total;
  a.hidden = hidden;
  a.heads = heads;
  a.ch = hidden / heads;
  a.inv_sqrt_ch = inv_sqrt_ch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? dispatch<__nv_bfloat16>(a, s)
                                  : dispatch<float>(a, s);
  return static_cast<int>(err);
}

}  // extern "C"
