// attn_bwd.cu: backward of the CSR graph attention over precomputed per-edge
// keys and values, for Hopper, built for sm_90a.
//
// Replaces the TPU kernel `_attn_bwd_kernel` in
// gnnep_tpu/ops/pallas/csr_attention.py (reached there through
// `_attn_backward` from the custom VJP `_attn_bwd`). For every target t,
// head h and live edge j of t's CSR range, with the forward's softmax max
// m_t and denominator d_t:
//
//   s_j = exp(q_t · k_j / sqrt(ch) - m_t) / d_t,    a_j = s_j · scale_t[h, j]
//   u_j = g_t · v_j,   inner_t = sum_j a_j u_j
//   dl_j = s_j (scale_t[h, j] u_j - inner_t)
//   dq_t = sum_j dl_j k_j / sqrt(ch),  dk_j = dl_j q_t / sqrt(ch),  dv_j = a_j g_t
//
// Arguments as the JAX function's: q [N, H], k_e and v_e [E, H] in float32
// or bfloat16 (one type), scale_t f32 [heads, E], mask2 f32 [E], row_ptr i32
// [N+1], g f32 [N, H], the forward's max and denom f32 [N, heads]; outputs
// dq [N, H], dk and dv [E, H] in the input type.
//
// Design. Two kernels.
//  attn_bwd_kernel: one warp per (target, head), eight per block, lanes over
//  the head's channels, as the forward (attn_fwd.cu). A head wider than 128
//  channels takes attn_bwd_wide_kernel, the same walk in passes of 128
//  channels, dl and alpha recomputed alike in each.
//   Pass 1 walks the row's live edges four at a time (their k and v loads
//   issued together), reduces q · k and g · v over the warp, and writes each
//   edge's s and u to scratch [heads, E] arrays the wrapper allocates; the
//   warp sums inner_t.
//   Pass 2 forms dl and the rounded alpha of 32 edges at a time into shared
//   memory, then per edge writes the dk and dv rows (lanes over channels)
//   and adds dl · k to the running dq. A dead edge of the row (mask2 <= 0)
//   gets zero dk and dv rows from the same warp.
//  zero_tail_kernel: zero dk and dv rows for the dummy row's edges
//   [row_ptr[n-1], E), which the first kernel never walks.
// Each edge row of dk and dv has exactly one writer: no read-modify-write
// windows and no atomics (the TPU kernel accumulates over overlapping
// windows, which is safe only on its sequential grid, :654-660, :712-719).
//
// Hazards, each handled here:
//  - Zeros, not garbage. Dead edges (masked ones, and the dummy row's) get
//    zero rows in dk and dv; the JAX package leaves them unspecified, but
//    here they flow through k = kv[:, :H] + e into W_e's and every
//    encoder's gradient. dq of the dummy row is written as zero.
//  - All-masked rows keep max -1e30: s is only formed for live edges, so no
//    exp of a huge argument and no inf·0 can arise.
//  - bf16 rounding mirrors the TPU kernel (csr_attention.py:691-710): g
//    rounds to v's type before u and dv; dl rounds to k's type before both
//    products (:696); alpha rounds to v's type; dq, dk and dv round to the
//    input type after their f32 sums. inner and the logits stay f32.
//
// What bounds it on this card: it reads k and v of every live edge (twice k,
// the second time mostly from L2) and writes dk and dv for all E rows, at a
// few operations per byte, so it is bounded by bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;      // edges whose loads a warp issues together
constexpr int kTailBlocks = 264;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* scale_t;
  const float* mask2;
  const int* row_ptr;
  const float* g;
  const float* stats_max;
  const float* stats_den;
  void* dq;
  void* dk;
  void* dv;
  float* s_s;  // [heads, E] scratch
  float* u_s;  // [heads, E] scratch
  int n, e_total, hidden, heads, ch;
  float inv_sqrt_ch;
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

// CPL = channels per lane = ceil(ch / 32)
template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads) attn_bwd_kernel(Args a) {
  __shared__ float dl_w[kWarps][32];
  __shared__ float al_w[kWarps][32];
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + warp;
  const int ch = a.ch, hid = a.hidden;
  if (t >= a.n) return;
  T* dq = static_cast<T*>(a.dq);
  if (t == a.n - 1) {
    // the dummy row is never walked; its dq is zero
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c < ch) store_t(dq + static_cast<size_t>(t) * hid + h * ch + c, 0.f);
    }
    return;
  }

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
  float qr[CPL], gr[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    const size_t tb = static_cast<size_t>(t) * hid + h * ch + c;
    qr[i] = c < ch ? load_f(q + tb) : 0.f;
    gr[i] = c < ch ? round_to<T>(a.g[tb]) : 0.f;
  }
  const size_t th = static_cast<size_t>(t) * a.heads + h;
  const float m = a.stats_max[th], den = a.stats_den[th];
  const int rlo = a.row_ptr[t], rhi = a.row_ptr[t + 1];
  const size_t hoff = static_cast<size_t>(h) * a.e_total;
  const float* scale = a.scale_t + hoff;
  float* s_h = a.s_s + hoff;
  float* u_h = a.u_s + hoff;

  // pass 1: s and u of the row's live edges, and inner
  float inner = 0.f;
  for (int j0 = rlo; j0 < rhi; j0 += 32) {
    const int cnt = min(32, rhi - j0);
    const bool mine = lane < cnt && a.mask2[j0 + lane] > 0.f;
    const unsigned live = __ballot_sync(kFull, mine);
    float my_l = 0.f, my_u = 0.f;
    for (int u0 = 0; u0 < cnt; u0 += kGroup) {
      if (!((live >> u0) & 0xfu)) continue;  // four dead edges
      float kx[kGroup][CPL], vx[kGroup][CPL];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const bool ok = u0 + g < cnt && ((live >> (u0 + g)) & 1u);
        const size_t row = static_cast<size_t>(j0 + u0 + g) * hid + h * ch;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int c = lane + 32 * i;
          kx[g][i] = ok && c < ch ? load_f(k + row + c) : 0.f;
          vx[g][i] = ok && c < ch ? load_f(v + row + c) : 0.f;
        }
      }
      float pl[kGroup], pu[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        pl[g] = 0.f;
        pu[g] = 0.f;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          pl[g] = fmaf(qr[i], kx[g][i], pl[g]);
          pu[g] = fmaf(gr[i], vx[g][i], pu[g]);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          pl[g] += __shfl_xor_sync(kFull, pl[g], o);
          pu[g] += __shfl_xor_sync(kFull, pu[g], o);
        }
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        if (lane == u0 + g) {
          my_l = pl[g] * a.inv_sqrt_ch;
          my_u = pu[g];
        }
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

  // pass 2: dl and alpha of 32 edges at a time, then dk, dv rows and dq
  float dqa[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) dqa[i] = 0.f;
  for (int j0 = rlo; j0 < rhi; j0 += 32) {
    const int j = j0 + lane;
    float dl = 0.f, al = 0.f;
    // the same lane wrote s and u of its edge in pass 1
    if (j < rhi && a.mask2[j] > 0.f) {
      const float s = s_h[j], sc = scale[j];
      dl = round_to<T>(s * (sc * u_h[j] - inner));
      al = round_to<T>(s * sc);
    }
    dl_w[warp][lane] = dl;
    al_w[warp][lane] = al;
    __syncwarp();
    const int cnt = min(32, rhi - j0);
    for (int u = 0; u < cnt; ++u) {
      const size_t row = static_cast<size_t>(j0 + u) * hid + h * ch;
      // dead edges have dl = alpha = 0 and get zero rows; k is read only
      // where it adds to dq
      const float dlu = dl_w[warp][u], alu = al_w[warp][u];
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        if (c < ch) {
          if (dlu != 0.f) dqa[i] = fmaf(dlu, load_f(k + row + c), dqa[i]);
          store_t(dk + row + c, dlu * qr[i] * a.inv_sqrt_ch);
          store_t(dv + row + c, alu * gr[i]);
        }
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    if (c < ch)
      store_t(dq + static_cast<size_t>(t) * hid + h * ch + c,
              dqa[i] * a.inv_sqrt_ch);
  }
}

// A head wider than 128 channels: attn_bwd_kernel walked in passes of 128
// channels, 4 a lane (a separate kernel, so that the narrow widths' code
// is not touched)
template <typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_wide_kernel(Args a) {
  constexpr int CPL = 4;
  __shared__ float dl_w[kWarps][32];
  __shared__ float al_w[kWarps][32];
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + warp;
  const int ch = a.ch, hid = a.hidden;
  if (t >= a.n) return;
  T* dq = static_cast<T*>(a.dq);
  if (t == a.n - 1) {
    // the dummy row is never walked; its dq is zero
    for (int c = lane; c < ch; c += 32)
      store_t(dq + static_cast<size_t>(t) * hid + h * ch + c, 0.f);
    return;
  }

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
  const size_t tb0 = static_cast<size_t>(t) * hid + h * ch;
  // channel passes of 32 · CPL channels; q and g of a pass
  float qr[CPL], gr[CPL];
  const int npass = (ch + 32 * CPL - 1) / (32 * CPL);
  auto load_qg = [&](int cb) {
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = cb + lane + 32 * i;
      qr[i] = c < ch ? load_f(q + tb0 + c) : 0.f;
      gr[i] = c < ch ? round_to<T>(a.g[tb0 + c]) : 0.f;
    }
  };
  load_qg(0);
  const size_t th = static_cast<size_t>(t) * a.heads + h;
  const float m = a.stats_max[th], den = a.stats_den[th];
  const int rlo = a.row_ptr[t], rhi = a.row_ptr[t + 1];
  const size_t hoff = static_cast<size_t>(h) * a.e_total;
  const float* scale = a.scale_t + hoff;
  float* s_h = a.s_s + hoff;
  float* u_h = a.u_s + hoff;

  // pass 1: s and u of the row's live edges, and inner
  float inner = 0.f;
  for (int j0 = rlo; j0 < rhi; j0 += 32) {
    const int cnt = min(32, rhi - j0);
    const bool mine = lane < cnt && a.mask2[j0 + lane] > 0.f;
    const unsigned live = __ballot_sync(kFull, mine);
    float my_l = 0.f, my_u = 0.f;
    for (int u0 = 0; u0 < cnt; u0 += kGroup) {
      if (!((live >> u0) & 0xfu)) continue;  // four dead edges
      float pl[kGroup], pu[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) pl[g] = pu[g] = 0.f;
      for (int pass = 0; pass < npass; ++pass) {
        const int cb = pass * 32 * CPL;
        load_qg(cb);
        float kx[kGroup][CPL], vx[kGroup][CPL];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const bool ok = u0 + g < cnt && ((live >> (u0 + g)) & 1u);
          const size_t row = static_cast<size_t>(j0 + u0 + g) * hid + h * ch;
#pragma unroll
          for (int i = 0; i < CPL; ++i) {
            const int c = cb + lane + 32 * i;
            kx[g][i] = ok && c < ch ? load_f(k + row + c) : 0.f;
            vx[g][i] = ok && c < ch ? load_f(v + row + c) : 0.f;
          }
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
#pragma unroll
          for (int i = 0; i < CPL; ++i) {
            pl[g] = fmaf(qr[i], kx[g][i], pl[g]);
            pu[g] = fmaf(gr[i], vx[g][i], pu[g]);
          }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          pl[g] += __shfl_xor_sync(kFull, pl[g], o);
          pu[g] += __shfl_xor_sync(kFull, pu[g], o);
        }
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        if (lane == u0 + g) {
          my_l = pl[g] * a.inv_sqrt_ch;
          my_u = pu[g];
        }
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

  // pass 2: dl and alpha of 32 edges at a time, then dk, dv rows and dq; a
  // wide head channel pass by channel pass, dl and alpha recomputed in each
  // pass by the same instructions from the same values (so they round
  // alike)
  for (int pass = 0; pass < npass; ++pass) {
    const int cb = pass * 32 * CPL;
    load_qg(cb);
    float dqa[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) dqa[i] = 0.f;
    for (int j0 = rlo; j0 < rhi; j0 += 32) {
      const int j = j0 + lane;
      float dl = 0.f, al = 0.f;
      // the same lane wrote s and u of its edge in pass 1
      if (j < rhi && a.mask2[j] > 0.f) {
        const float s = s_h[j], sc = scale[j];
        dl = round_to<T>(s * (sc * u_h[j] - inner));
        al = round_to<T>(s * sc);
      }
      dl_w[warp][lane] = dl;
      al_w[warp][lane] = al;
      __syncwarp();
      const int cnt = min(32, rhi - j0);
      for (int u = 0; u < cnt; ++u) {
        const size_t row = static_cast<size_t>(j0 + u) * hid + h * ch + cb;
        // dead edges have dl = alpha = 0 and get zero rows; k is read only
        // where it adds to dq
        const float dlu = dl_w[warp][u], alu = al_w[warp][u];
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int c = lane + 32 * i;
          if (cb + c < ch) {
            if (dlu != 0.f) dqa[i] = fmaf(dlu, load_f(k + row + c), dqa[i]);
            store_t(dk + row + c, dlu * qr[i] * a.inv_sqrt_ch);
            store_t(dv + row + c, alu * gr[i]);
          }
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = cb + lane + 32 * i;
      if (c < ch) store_t(dq + tb0 + c, dqa[i] * a.inv_sqrt_ch);
    }
  }
}

// zero rows [row_ptr[n-1], E) of dk and dv: the dummy row's edges
template <typename T>
__global__ void __launch_bounds__(kThreads) zero_tail_kernel(Args a) {
  const size_t lo = static_cast<size_t>(a.row_ptr[a.n - 1]) * a.hidden;
  const size_t hi = static_cast<size_t>(a.e_total) * a.hidden;
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
  for (size_t i = lo + blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x;
       i < hi; i += static_cast<size_t>(gridDim.x) * kThreads) {
    store_t(dk + i, 0.f);
    store_t(dv + i, 0.f);
  }
}

template <typename T, int CPL, bool Wide>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.n + kWarps - 1) / kWarps, a.heads);
  if constexpr (Wide)
    attn_bwd_wide_kernel<T><<<grid, kThreads, 0, stream>>>(a);
  else
    attn_bwd_kernel<T, CPL><<<grid, kThreads, 0, stream>>>(a);
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
// inv_sqrt_ch is 1/sqrt(ch) rounded once to f32, as the JAX kernel's
// constant is.
int attn_bwd(const void* q, const void* k, const void* v, const void* scale_t,
             const void* mask2, const void* row_ptr, const void* g,
             const void* stats_max, const void* stats_den, void* dq,
             void* dk, void* dv, void* s_s, void* u_s, int n, int e_total,
             int hidden, int heads, float inv_sqrt_ch, int is_bf16,
             void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.scale_t = static_cast<const float*>(scale_t);
  a.mask2 = static_cast<const float*>(mask2);
  a.row_ptr = static_cast<const int*>(row_ptr);
  a.g = static_cast<const float*>(g);
  a.stats_max = static_cast<const float*>(stats_max);
  a.stats_den = static_cast<const float*>(stats_den);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.s_s = static_cast<float*>(s_s);
  a.u_s = static_cast<float*>(u_s);
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
