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
// Design. Two kernels, both laid out as the forward kernel is: a block owns
// a tile of consecutive targets, and so one contiguous range of the
// dst-sorted arena, and each edge row of dkv and dea has exactly one
// writer. No read-modify-write windows.
//
//  attn_eproj_bwd_attn: one block of 256 threads per (tile, head), W_e's
//  head slice [Fe, ch] in dynamic shared memory as f32.
//   Phase 1 recomputes e, k and v chunk by chunk (64 edges, the forward's
//   register-tiled projection) and writes each edge's logit and u, and its
//   k row, to scratch. Chunks without a live edge are skipped.
//   Phase 2 gives each warp one target at a time: inner_t over the row, then
//   dl and the rounded alpha of 32 edges at a time, then per edge the dk, dv
//   and de rows (lanes over channels) and the running dq.
//   Phase 3 sums ea_jᵀ de_j over the tile's edges into a register tile of
//   dW_e's head slice (32 edges per shared-memory stage, their live flags
//   read once per stage, each thread's staging loads issued together; 128
//   rows of Fe per pass) and adds it to dW_e with atomics: CUDA blocks run in no order, so
//   the TPU kernel's sum over its sequential grid into one resident block
//   has no counterpart. One add per (tile, Fe row, column): the tiles are
//   sized so that there are about two blocks per SM, not one per 64 edges.
//  attn_eproj_bwd_dea: one block per 64 edges, dea = de · W_eᵀ over all
//   heads as a tiled product (32-wide stages of de and of W_eᵀ), and zero
//   rows of dkv for every dead edge.
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
//    kernel; its de row is read as zero by both products. dq of the dummy
//    row is written as zero. With Span a dead edge never reads kvn and adds
//    nothing to it.
//  - All-masked rows keep max -1e30: s is only formed for live edges, so no
//    exp of a huge argument and no inf·0 can arise.
//  - bf16 rounding mirrors the TPU kernel (csr_attention.py:1194-1243): e, k
//    and v round to the input type; g rounds to it before u and dv; dl and
//    alpha round to it; dq, dk, dv and de round to it after f32 sums; dea
//    rounds after its f32 product. dW_e stays f32.
//
// What bounds it on this card: three E·Fe·H products (the projection
// recompute, dea and dW_e; about 26 GFLOP at the flagship line-graph conv)
// run as f32 FMAs on the CUDA cores for both input types, against about
// 220 MB of traffic in f32. So it is bounded by operations.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;           // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;              // edges per projection tile
constexpr int kKt = 32;                 // contraction columns per stage
constexpr int kLdA = kKt + 4;           // staged A row stride: 16-byte rows
constexpr int kStage = kChunk * kKt / kThreads;  // A loads per thread
constexpr int kInFlight = 8;            // W_e loads a thread issues at once
constexpr int kRows3 = 128;             // dW_e rows (of Fe) per phase-3 pass
constexpr int kLd3 = kRows3 + 4;
constexpr int kCols = 128;              // dea columns (of Fe) per pass
constexpr int kLdB = kCols + 4;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;
  const void* kv;
  const void* ea;
  const void* w_edge;
  const float* scale_t;
  const float* mask2;
  const int* row_ptr;
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
  int n, e_total, hidden, fe, heads, ch, fe_pad, ch_pad, rows_per_block;
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

// Phase 1 for the chunk [e0, e0 + kChunk) ∩ [.., hi): projection, k, v,
// logit and u. CPT = channels per thread = ch_pad / 16.
template <typename T, int CPT, bool Span>
__device__ __forceinline__ void project_chunk(const Args& a, int e0, int hi,
                                              int h, const float* w_s,
                                              float* ea_s) {
  const int tid = threadIdx.x;
  const int cg = tid % 16, eg = tid / 16;  // channel group, edge group
  const int fe = a.fe, chp = a.ch_pad;
  const T* ea = static_cast<const T*>(a.ea);
  long long dst[4];
  long long row[4];  // Span: the kv rows, -1 for a dead edge (none read)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = e0 + eg * 4 + i;
    dst[i] = j < hi ? a.dst[j] : 0;
    if constexpr (Span)
      row[i] = (j < hi && a.mask2[j] > 0.f) ? a.src[j] : -1;
  }

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < a.fe_pad; k0 += kKt) {
    float x[kStage];
#pragma unroll
    for (int r = 0; r < kStage; ++r) {
      const int lin = r * kThreads + tid;
      const int j = lin / kKt, f = k0 + lin % kKt, e = e0 + j;
      x[r] = (e < hi && f < fe) ? load_f(ea + static_cast<size_t>(e) * fe + f)
                                : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kStage; ++r) {
      const int lin = r * kThreads + tid;
      ea_s[(lin / kKt) * kLdA + lin % kKt] = x[r];
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < kKt; kk += 4) {
      float4 av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = *reinterpret_cast<const float4*>(ea_s + (eg * 4 + i) * kLdA + kk);
      float b[4][CPT];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float* row_w = w_s + (k0 + kk + s) * chp + cg * CPT;
#pragma unroll
        for (int c = 0; c < CPT; ++c) b[s][c] = row_w[c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          acc[i][c] = fmaf(av[i].x, b[0][c], acc[i][c]);
          acc[i][c] = fmaf(av[i].y, b[1][c], acc[i][c]);
          acc[i][c] = fmaf(av[i].z, b[2][c], acc[i][c]);
          acc[i][c] = fmaf(av[i].w, b[3][c], acc[i][c]);
        }
    }
  }

  // epilogue: k, v, the logit and u of each of this thread's four edges
  const T* kv = static_cast<const T*>(a.kv);
  const T* q = static_cast<const T*>(a.q);
  T* k_s = static_cast<T*>(a.k_s);
  const int hid = a.hidden, ch = a.ch;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = e0 + eg * 4 + i;
    const bool valid = j < hi;
    const long long t = valid ? dst[i] : 0;
    float kx[CPT], vx[CPT], qx[CPT], gx[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int cc = cg * CPT + c;
      const bool ok = valid && cc < ch;
      const bool ok_kv = Span ? row[i] >= 0 && cc < ch : ok;
      const size_t kvb =
          static_cast<size_t>(Span ? row[i] : j) * 2 * hid + h * ch + cc;
      const size_t tb = static_cast<size_t>(t) * hid + h * ch + cc;
      kx[c] = ok_kv ? load_f(kv + kvb) : 0.f;
      vx[c] = ok_kv ? load_f(kv + kvb + hid) : 0.f;
      qx[c] = ok ? load_f(q + tb) : 0.f;
      gx[c] = ok ? round_to<T>(a.g[tb]) : 0.f;
    }
    float pl = 0.f, pu = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int cc = cg * CPT + c;
      if (valid && cc < ch) {
        const float e = round_to<T>(acc[i][c]);
        const float k = round_to<T>(kx[c] + e);
        const float v = round_to<T>(vx[c] + e);
        pl = fmaf(qx[c], k, pl);
        pu = fmaf(gx[c], v, pu);
        store_t(k_s + static_cast<size_t>(j) * hid + h * ch + cc, k);
      }
    }
    // the 16 threads of an edge are one half-warp
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
__global__ void __launch_bounds__(kThreads) attn_eproj_bwd_attn_kernel(Args a) {
  constexpr int CPL = (CPT + 1) / 2;  // phase 2: channels per lane
  extern __shared__ __align__(16) float smem[];
  __shared__ float dl_w[kWarps][32];
  __shared__ float al_w[kWarps][32];
  // per edge of a warp's batch: 0 if dead; else 1, or with Span the kv
  // row + 1
  __shared__ int live_w[kWarps][32];
  __shared__ int live3[kKt];
  const int h = blockIdx.y, tid = threadIdx.x;
  const int fe = a.fe, ch = a.ch, chp = a.ch_pad, hid = a.hidden;

  const int t0 = blockIdx.x * a.rows_per_block;
  const int t1 = min(t0 + a.rows_per_block, a.n - 1);
  // the dummy row n-1 is never walked; its dq is zero
  if (blockIdx.x == gridDim.x - 1) {
    T* dq = static_cast<T*>(a.dq);
    for (int c = tid; c < ch; c += kThreads)
      store_t(dq + static_cast<size_t>(a.n - 1) * hid + h * ch + c, 0.f);
  }
  if (t0 >= t1) return;
  const int lo = a.row_ptr[t0], hi = a.row_ptr[t1];

  // W_e's head slice, zero beyond fe and ch
  float* w_s = smem;                       // [fe_pad, ch_pad]
  float* ea_s = smem + a.fe_pad * chp;     // [kChunk, kLdA]
  const T* w_edge = static_cast<const T*>(a.w_edge);
  const int w_size = a.fe_pad * chp;
  for (int i0 = tid; i0 < w_size; i0 += kThreads * kInFlight) {
    float x[kInFlight];
#pragma unroll
    for (int r = 0; r < kInFlight; ++r) {
      const int i = i0 + r * kThreads;
      const int f = i / chp, c = i - f * chp;
      x[r] = (i < w_size && f < fe && c < ch)
                 ? load_f(w_edge + static_cast<size_t>(f) * hid + h * ch + c)
                 : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kInFlight; ++r) {
      const int i = i0 + r * kThreads;
      if (i < w_size) w_s[i] = x[r];
    }
  }
  __syncthreads();

  // phase 1: logit, u and k of the tile's edges, chunk by chunk
  for (int e0 = lo; e0 < hi; e0 += kChunk) {
    const int j = e0 + tid;
    const bool live = tid < kChunk && j < hi && a.mask2[j] > 0.f;
    if (!__syncthreads_or(live)) continue;
    project_chunk<T, CPT, Span>(a, e0, hi, h, w_s, ea_s);
  }
  __syncthreads();  // phase 1's scratch writes are visible to the block

  // phase 2: one warp per target
  const int warp = tid >> 5, lane = tid & 31;
  const T* q = static_cast<const T*>(a.q);
  const T* k_s = static_cast<const T*>(a.k_s);
  T* dkv = static_cast<T*>(a.dkv);
  T* de_s = static_cast<T*>(a.de_s);
  T* dq = static_cast<T*>(a.dq);
  const float* logit = a.logit_s + static_cast<size_t>(h) * a.e_total;
  const float* u_h = a.u_s + static_cast<size_t>(h) * a.e_total;
  const float* scale = a.scale_t + static_cast<size_t>(h) * a.e_total;
  for (int t = t0 + warp; t < t1; t += kWarps) {
    const int rlo = a.row_ptr[t], rhi = a.row_ptr[t + 1];
    const float m = a.stats_max[static_cast<size_t>(t) * a.heads + h];
    const float den = a.stats_den[static_cast<size_t>(t) * a.heads + h];
    float qr[CPL], gr[CPL], dqa[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      const size_t tb = static_cast<size_t>(t) * hid + h * ch + c;
      qr[i] = c < ch ? load_f(q + tb) : 0.f;
      gr[i] = c < ch ? round_to<T>(a.g[tb]) : 0.f;
      dqa[i] = 0.f;
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
      const int cnt = min(32, rhi - j0);
      for (int u = 0; u < cnt; ++u) {
        if (!live_w[warp][u]) continue;
        const size_t jj = static_cast<size_t>(j0 + u);
        const float dlu = dl_w[warp][u], alu = al_w[warp][u];
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int c = lane + 32 * i;
          if (c < ch) {
            const float kf = load_f(k_s + jj * hid + h * ch + c);
            const float dk = dlu * qr[i] * a.inv_sqrt_ch;
            const float dv = alu * gr[i];
            if constexpr (Span) {
              float* acc = a.dkvn_acc +
                           static_cast<size_t>(live_w[warp][u] - 1) * 2 * hid +
                           h * ch + c;
              atomicAdd(acc, round_to<T>(dk));
              atomicAdd(acc + hid, round_to<T>(dv));
            } else {
              store_t(dkv + jj * 2 * hid + h * ch + c, dk);
              store_t(dkv + jj * 2 * hid + hid + h * ch + c, dv);
            }
            store_t(de_s + jj * hid + h * ch + c, dk + dv);
            dqa[i] = fmaf(dlu, kf, dqa[i]);
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
  __syncthreads();  // phase 2's de rows are visible; W_e's slice is free

  // phase 3: dW_e[:, h] += sum over the tile's live edges of ea_jᵀ de_j
  float* ea3 = smem;                  // [kKt, kLd3]
  float* de3 = smem + kKt * kLd3;     // [kKt, ch_pad + 4]
  const int ld_de = chp + 4;
  const int fg = tid / 16, cg = tid % 16;
  const T* ea = static_cast<const T*>(a.ea);
  for (int f0 = 0; f0 < fe; f0 += kRows3) {
    float acc[8][CPT];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;
    for (int e0 = lo; e0 < hi; e0 += kKt) {
      const int j = e0 + tid;
      const bool live = tid < kKt && j < hi && a.mask2[j] > 0.f;
      if (tid < kKt) live3[tid] = live;
      if (!__syncthreads_or(live)) continue;
      // every load of the stage is issued before the first store; ea needs
      // no mask, since a dead edge's de row is staged as zero
      constexpr int kEa = kKt * kRows3 / kThreads;
      constexpr int kDe = kKt * 16 * CPT / kThreads;  // ch_pad = 16 * CPT
      float xa[kEa], xd[kDe];
#pragma unroll
      for (int r = 0; r < kEa; ++r) {
        const int i = r * kThreads + tid;
        const int e = e0 + i / kRows3, f = f0 + i % kRows3;
        xa[r] = (e < hi && f < fe)
                    ? load_f(ea + static_cast<size_t>(e) * fe + f) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kDe; ++r) {
        const int i = r * kThreads + tid;
        const int row = i / chp, c = i % chp;
        xd[r] = (live3[row] && c < ch)
                    ? load_f(de_s + static_cast<size_t>(e0 + row) * hid +
                             h * ch + c)
                    : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kEa; ++r) {
        const int i = r * kThreads + tid;
        ea3[(i / kRows3) * kLd3 + i % kRows3] = xa[r];
      }
#pragma unroll
      for (int r = 0; r < kDe; ++r) {
        const int i = r * kThreads + tid;
        de3[(i / chp) * ld_de + i % chp] = xd[r];
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kKt; ++kk) {
        const float4 x0 = *reinterpret_cast<const float4*>(ea3 + kk * kLd3 + fg * 8);
        const float4 x1 =
            *reinterpret_cast<const float4*>(ea3 + kk * kLd3 + fg * 8 + 4);
        const float xa[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        float b[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) b[c] = de3[kk * ld_de + cg * CPT + c];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(xa[r], b[c], acc[r][c]);
      }
      __syncthreads();  // readers done before the next stage overwrites
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int f = f0 + fg * 8 + r;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int cc = cg * CPT + c;
        if (f < fe && cc < ch && acc[r][c] != 0.f)
          atomicAdd(a.dw + static_cast<size_t>(f) * hid + h * ch + cc,
                    acc[r][c]);
      }
    }
  }
}

// dea = de · W_eᵀ for 64 edges per block, and (kernel 6) zero dkv rows of
// dead edges. CPT = 8 output columns per thread, 128 per pass.
template <typename T, bool Span>
__global__ void __launch_bounds__(kThreads) attn_eproj_bwd_dea_kernel(Args a) {
  __shared__ __align__(16) float a_s[kChunk * kLdA];   // de stage [64, 36]
  __shared__ __align__(16) float b_s[kKt * kLdB];      // W_eᵀ stage [32, 132]
  __shared__ int live_s[kChunk];
  const int tid = threadIdx.x;
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
    for (int i = tid; i < rows * 2 * hid; i += kThreads) {
      const int r = i / (2 * hid);
      if (!live_s[r])
        store_t(dkv + static_cast<size_t>(e0) * 2 * hid + i, 0.f);
    }
  }
  const int cg = tid % 16, eg = tid / 16;
  for (int f0 = 0; f0 < fe; f0 += kCols) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
    for (int k0 = 0; k0 < hid; k0 += kKt) {
      __syncthreads();  // the previous stage's readers are done
      for (int i = tid; i < kChunk * kKt; i += kThreads) {
        const int r = i / kKt, k = k0 + i % kKt;
        a_s[r * kLdA + i % kKt] =
            (live_s[r] && k < hid)
                ? load_f(de_s + static_cast<size_t>(e0 + r) * hid + k)
                : 0.f;
      }
      for (int i = tid; i < kKt * kCols; i += kThreads) {
        const int f = i / kKt, kk = i % kKt;  // consecutive threads along k
        b_s[kk * kLdB + f] =
            (f0 + f < fe && k0 + kk < hid)
                ? load_f(w_edge + static_cast<size_t>(f0 + f) * hid + k0 + kk)
                : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kKt; ++kk) {
        float av[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = a_s[(eg * 4 + i) * kLdA + kk];
        const float4 b0 = *reinterpret_cast<const float4*>(b_s + kk * kLdB + cg * 8);
        const float4 b1 =
            *reinterpret_cast<const float4*>(b_s + kk * kLdB + cg * 8 + 4);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = eg * 4 + i;
      if (r >= rows) continue;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int f = f0 + cg * 8 + c;
        // dead rows staged as zero: their acc is 0
        if (f < fe) store_t(dea + static_cast<size_t>(e0 + r) * fe + f, acc[i][c]);
      }
    }
  }
}

int pad_channels(int ch) {
  return ch <= 16 ? 16 : ch <= 32 ? 32 : ch <= 64 ? 64 : 128;
}

int pad_fe(int fe) { return (fe + kKt - 1) / kKt * kKt; }

size_t smem_bytes(int fe, int ch) {
  const size_t p12 = static_cast<size_t>(pad_fe(fe)) * pad_channels(ch) +
                     static_cast<size_t>(kChunk) * kLdA;
  const size_t p3 = static_cast<size_t>(kKt) * kLd3 +
                    static_cast<size_t>(kKt) * (pad_channels(ch) + 4);
  return sizeof(float) * (p12 > p3 ? p12 : p3);
}

template <typename T, int CPT, bool Span>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.fe, a.ch);
  auto kernel = attn_eproj_bwd_attn_kernel<T, CPT, Span>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + a.rows_per_block - 1) / a.rows_per_block, a.heads);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_dea((a.e_total + kChunk - 1) / kChunk);
  attn_eproj_bwd_dea_kernel<T, Span><<<grid_dea, kThreads, 0, stream>>>(a);
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
               float inv_sqrt_ch, int rows_per_block) {
  Args a;
  a.q = q;
  a.kv = kv;
  a.ea = ea;
  a.w_edge = w_edge;
  a.scale_t = static_cast<const float*>(scale_t);
  a.mask2 = static_cast<const float*>(mask2);
  a.row_ptr = static_cast<const int*>(row_ptr);
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
  a.rows_per_block = rows_per_block;
  a.inv_sqrt_ch = inv_sqrt_ch;
  return a;
}

}  // namespace
