// attn_eproj_fwd.cuh: the CSR graph attention with the edge projection fused
// in (forward), shared by three entry points, each built for sm_90a:
//
//  - attn_eproj_fwd.cu: kernel 5, the port of `_attn_ep_kernel`
//    (gnnep_tpu/ops/pallas/csr_attention.py), kv an edge-space arena [E, 2H];
//  - attn_eproj_fwd.cu: the ladder, kernel 5 cut short after one of its
//    phases (Stage below), the port of `make_kernel` in
//    scripts_dev/exp_kernel_ladder.py;
//  - attn_span_fwd.cu: kernel 8, the port of `_attn_sp_kernel`, kv the
//    node-space table [N_src, 2H] read at row src[j] (Span below).
//
// For every aggregation target t and head h, over the CSR range
// [row_ptr[t], row_ptr[t+1]) of the dst-sorted edge arena:
//
//   e_j   = ea_j · W_e[:, h]                       edge projection
//   k_j   = kv_j[h] + e_j,  v_j = kv_j[H + h] + e_j
//   l_j   = q_t[h] · k_j / sqrt(ch)                only where mask2[j] > 0
//   out_t = Σ_j softmax_j(l) · scale_t[h, j] · v_j
//
// and it saves the softmax max and denominator of every (t, h) in [N, heads]
// layouts, for the backward. Argument layout as the JAX function: q [N, H],
// kv [E, 2H] (or [N_src, 2H] with src i64 [E]), ea [E, Fe], W_e [Fe, H] in
// float32 or bfloat16 (all four the same type), scale_t f32 [heads, E],
// mask2 f32 [E], row_ptr i32 [N+1], dst i64 [E]; out f32 [N, H].
//
// Design. One block of 256 threads per (tile of consecutive targets, head).
// The block keeps W_e's head slice [Fe, ch] in dynamic shared memory as f32
// (64 KB at Fe = 256, ch = 64: above the 48 KB static limit, hence
// cudaFuncSetAttribute). The tile's edges are one contiguous range of the
// arena, so the projection ignores row boundaries:
//
//  Phase 1 walks the range in chunks of 64 edges and computes each chunk's
//  [64, ch] projection as a small GEMM (ea staged in 32-wide k-tiles, each
//  thread a 4-edge x ch/16-channel register tile, so one shared-memory read
//  feeds four to eight FMAs). Its epilogue forms k and v, reduces q_t · k
//  over the 16 threads that share an edge, and writes each edge's logit and
//  v to scratch arrays the wrapper allocates. Chunks without a live edge
//  (runs of interior padding) are skipped.
//  Phase 2 gives each warp one target at a time: the max and denominator
//  over the row's live logits, then alpha and the sum of alpha · v, read
//  back from the scratch (written by this block, so mostly from L2).
//
// Each edge row belongs to exactly one target and each target to one block,
// so there are no atomics and no sums across blocks. The dummy row n-1 owns
// the arena's tail padding (thousands of masked edges at the flagship size);
// walking them kept one warp busy long after the rest of the grid, so the
// kernel writes that row as an all-masked row and never walks it.
//
// Hazards, each handled here:
//  - Masked edges are skipped before the exp. The running max starts at
//    -1e30, so exp(-1e30 - (-1e30)) = 1 would otherwise count a masked edge.
//    An all-masked or empty row gives out = 0, max = -1e30, denom = 1e-16,
//    as the TPU kernel does (csr_attention.py:1050-1054).
//  - Interior padding rows (the packer's dilution) sit inside real rows' CSR
//    ranges; only mask2 excludes them. The output of the dummy row n-1 is
//    unspecified by the contract (here: out 0, max -1e30, denom 1e-16).
//  - bf16 rounding mirrors the TPU kernel (csr_attention.py:1034-1040, 1057):
//    e is rounded to the input type before the k and v adds, k and v are
//    rounded after them, alpha is rounded to v's type before the aggregation,
//    and every sum is taken in f32. Keeping all logits until the row's
//    denominator is known (rather than an online rescaled sum) is what lets
//    alpha be rounded where the TPU kernel rounds it.
//  - scale_t multiplies alpha after normalisation and never enters the
//    denominator.
//  - Span: a dead edge (masked) may carry a padding source index, so the
//    kernel reads kv row src[j] only for a live edge; a dead edge's k and v
//    are zeros and its logit is never read.
//
// What bounds it on this card: the projection, 2·E·Fe·H operations (about
// 9 GFLOP at the flagship line-graph conv), runs as f32 FMAs on the CUDA
// cores for both input types, against about 130 MB of inputs in f32. So it
// is bounded by operations; bf16, whose tensor-core rate this kernel does
// not use, sits furthest from its bound.

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
constexpr int kKt = 32;                 // Fe columns per staged ea tile
constexpr int kLdA = kKt + 4;           // staged ea row stride: 16-byte rows
constexpr int kStage = kChunk * kKt / kThreads;  // ea loads per thread
constexpr int kInFlight = 8;            // W_e loads a thread issues at once
constexpr unsigned kFull = 0xffffffffu;

// The ladder's stages, each keeping the work of those before it:
//  kDma     every load kernel 5 makes (W_e's slice into shared memory, the
//           ea tiles, kv, q, the logits' scratch, scale and mask), no math;
//  kEproj   + phase 1's projection, k and v formed, v written to scratch;
//  kSddmm   + q · k, the logits written to scratch (phase 1 in full);
//  kSoftmax + phase 2's max, denominator and alpha;
//  kFull    kernel 5 itself (phase 2's aggregation over v).
// A stage cut short writes a sum of what it computed (the row's scaled
// logits, or its alphas) to every channel of out, so that nvcc keeps the
// work; those outputs are timing aids, not results.
constexpr int kDma = 0, kEproj = 1, kSddmm = 2, kSoftmax = 3,
              kFullStage = 4;

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
  float* out;
  float* stats_max;
  float* stats_den;
  float* logit_s;  // [heads, E] scratch
  void* v_s;       // [E, H] scratch, input type
  int n, e_total, hidden, fe, heads, ch, fe_pad, ch_pad, rows_per_block;
  float inv_sqrt_ch;
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_t(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_t(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // x is already a bf16 value: exact
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
// logits. CPT = channels per thread = ch_pad / 16.
template <typename T, int CPT, int Stage, bool Span>
__device__ __forceinline__ void project_chunk(const Args& a, int e0, int hi,
                                              int h, const float* w_s,
                                              float* ea_s) {
  const int tid = threadIdx.x;
  const int cg = tid % 16, eg = tid / 16;  // channel group, edge group
  const int fe = a.fe, chp = a.ch_pad;
  const T* ea = static_cast<const T*>(a.ea);
  long long dst[4];  // targets of this thread's four edges, for the epilogue
  long long row[4];  // Span: their kv rows, -1 for a dead edge (none read)
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
  float ck = 0.f;  // kDma: a sum of the ea values this thread loaded

  for (int k0 = 0; k0 < a.fe_pad; k0 += kKt) {
    float x[kStage];
#pragma unroll
    for (int r = 0; r < kStage; ++r) {
      const int lin = r * kThreads + tid;
      const int j = lin / kKt, f = k0 + lin % kKt, e = e0 + j;
      x[r] = (e < hi && f < fe) ? load_f(ea + static_cast<size_t>(e) * fe + f)
                                : 0.f;
    }
    if constexpr (Stage == kDma) {
#pragma unroll
      for (int r = 0; r < kStage; ++r) ck += x[r];
    }
    __syncthreads();  // the previous tile's readers are done
#pragma unroll
    for (int r = 0; r < kStage; ++r) {
      const int lin = r * kThreads + tid;
      ea_s[(lin / kKt) * kLdA + lin % kKt] = x[r];
    }
    __syncthreads();
    if constexpr (Stage > kDma) {
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
          if constexpr (CPT % 4 == 0) {
#pragma unroll
            for (int c = 0; c < CPT; c += 4) {
              const float4 w4 = *reinterpret_cast<const float4*>(row_w + c);
              b[s][c] = w4.x;
              b[s][c + 1] = w4.y;
              b[s][c + 2] = w4.z;
              b[s][c + 3] = w4.w;
            }
          } else {
#pragma unroll
            for (int c = 0; c < CPT; ++c) b[s][c] = row_w[c];
          }
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
  }

  // epilogue: k, v and the logit of each of this thread's four edges
  const T* kv = static_cast<const T*>(a.kv);
  const T* q = static_cast<const T*>(a.q);
  T* v_s = static_cast<T*>(a.v_s);
  const int hid = a.hidden, ch = a.ch;
  // every load of the epilogue is issued before the first use
  float kx[4][CPT], vx[4][CPT], qx[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = e0 + eg * 4 + i;
    const long long t = j < hi ? dst[i] : 0;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int cc = cg * CPT + c;
      const bool ok = j < hi && cc < ch;
      const bool ok_kv = Span ? row[i] >= 0 && cc < ch : ok;
      const size_t kvb =
          static_cast<size_t>(Span ? row[i] : j) * 2 * hid + h * ch + cc;
      kx[i][c] = ok_kv ? load_f(kv + kvb) : 0.f;
      vx[i][c] = ok_kv ? load_f(kv + kvb + hid) : 0.f;
      qx[i][c] = ok ? load_f(q + static_cast<size_t>(t) * hid + h * ch + cc)
                    : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = e0 + eg * 4 + i;
    const bool valid = j < hi;
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int cc = cg * CPT + c;
      if (valid && cc < ch) {
        if constexpr (Stage == kDma) {
          part += kx[i][c] + vx[i][c] + qx[i][c];
        } else {
          const float e = round_to<T>(acc[i][c]);
          const float k = round_to<T>(kx[i][c] + e);
          const float v = round_to<T>(vx[i][c] + e);
          if constexpr (Stage == kEproj)
            part += k;
          else
            part = fmaf(qx[i][c], k, part);
          store_t(v_s + static_cast<size_t>(j) * hid + h * ch + cc, v);
        }
      }
    }
    if constexpr (Stage == kDma) {
      if (i == 0) part += ck;
    }
    // the 16 threads of an edge are one half-warp
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) part += __shfl_xor_sync(kFull, part, o);
    if (valid && cg == 0)
      a.logit_s[static_cast<size_t>(h) * a.e_total + j] =
          Stage >= kSddmm ? part * a.inv_sqrt_ch : part;
  }
}

// Phase 2 of a ladder stage cut short of kFullStage, one warp per target:
// up to kSddmm the sum of the row's live logits times their scale (every
// load phase 2 makes but v's); at kSoftmax kernel 5's max, denominator and
// alphas, their sum written in place of the aggregation over v.
template <typename T, int Stage>
__device__ void ladder_phase2(const Args& a, int h, int t0, int t1) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* logit = a.logit_s + static_cast<size_t>(h) * a.e_total;
  const float* scale = a.scale_t + static_cast<size_t>(h) * a.e_total;
  for (int t = t0 + warp; t < t1; t += kWarps) {
    const int rlo = a.row_ptr[t], rhi = a.row_ptr[t + 1];
    float s = 0.f, m = kNeg, den = 1.f;
    if constexpr (Stage < kSoftmax) {
      for (int j = rlo + lane; j < rhi; j += 32)
        if (a.mask2[j] > 0.f) s = fmaf(logit[j], scale[j], s);
    } else {
      float d = 0.f;
      for (int j = rlo + lane; j < rhi; j += 32) {
        if (a.mask2[j] > 0.f) {
          const float l = logit[j];
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
      den = fmaxf(d, 1e-16f);
      for (int j = rlo + lane; j < rhi; j += 32)
        if (a.mask2[j] > 0.f)
          s += round_to<T>((expf(logit[j] - m) / den) * scale[j]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    for (int c = lane; c < a.ch; c += 32)
      a.out[static_cast<size_t>(t) * a.hidden + h * a.ch + c] = s;
    if (lane == 0) {
      a.stats_max[static_cast<size_t>(t) * a.heads + h] = m;
      a.stats_den[static_cast<size_t>(t) * a.heads + h] = den;
    }
  }
}

template <typename T, int CPT, int Stage, bool Span>
__global__ void __launch_bounds__(kThreads) attn_eproj_fwd_kernel(Args a) {
  constexpr int CPL = (CPT + 1) / 2;  // phase 2: channels per lane
  extern __shared__ __align__(16) float smem[];
  __shared__ float alpha_s[kWarps][32];
  const int h = blockIdx.y, tid = threadIdx.x;
  const int fe = a.fe, ch = a.ch, chp = a.ch_pad;
  float* w_s = smem;                       // [fe_pad, ch_pad]
  float* ea_s = smem + a.fe_pad * chp;     // [kChunk, kLdA]

  // W_e's head slice, zero beyond fe and ch
  const T* w_edge = static_cast<const T*>(a.w_edge);
  const int w_size = a.fe_pad * chp;
  for (int i0 = tid; i0 < w_size; i0 += kThreads * kInFlight) {
    float x[kInFlight];
#pragma unroll
    for (int r = 0; r < kInFlight; ++r) {
      const int i = i0 + r * kThreads;
      const int f = i / chp, c = i - f * chp;
      x[r] = (i < w_size && f < fe && c < ch)
                 ? load_f(w_edge + static_cast<size_t>(f) * a.hidden + h * ch + c)
                 : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kInFlight; ++r) {
      const int i = i0 + r * kThreads;
      if (i < w_size) w_s[i] = x[r];
    }
  }
  __syncthreads();

  // the dummy row n-1 owns the arena's tail padding and its output is
  // unspecified: it is written as an all-masked row and never walked
  const int t0 = blockIdx.x * a.rows_per_block;
  const int t1 = min(t0 + a.rows_per_block, a.n - 1);
  if (blockIdx.x == gridDim.x - 1) {
    for (int c = tid; c < a.ch; c += kThreads)
      a.out[static_cast<size_t>(a.n - 1) * a.hidden + h * a.ch + c] = 0.f;
    if (tid == 0) {
      a.stats_max[static_cast<size_t>(a.n - 1) * a.heads + h] = kNeg;
      a.stats_den[static_cast<size_t>(a.n - 1) * a.heads + h] = 1e-16f;
    }
  }
  if (t0 >= t1) return;
  const int lo = a.row_ptr[t0], hi = a.row_ptr[t1];

  // phase 1: logits and v of the tile's edges, chunk by chunk
  for (int e0 = lo; e0 < hi; e0 += kChunk) {
    const int j = e0 + tid;
    const bool live = tid < kChunk && j < hi && a.mask2[j] > 0.f;
    if (!__syncthreads_or(live)) continue;
    project_chunk<T, CPT, Stage, Span>(a, e0, hi, h, w_s, ea_s);
  }
  __syncthreads();  // phase 1's scratch writes are visible to the block

  if constexpr (Stage < kFullStage) {
    ladder_phase2<T, Stage>(a, h, t0, t1);
    return;
  }

  // phase 2: one warp per target
  const int warp = tid >> 5, lane = tid & 31;
  const T* v_s = static_cast<const T*>(a.v_s);
  const float* logit = a.logit_s + static_cast<size_t>(h) * a.e_total;
  const float* scale = a.scale_t + static_cast<size_t>(h) * a.e_total;
  for (int t = t0 + warp; t < t1; t += kWarps) {
    const int rlo = a.row_ptr[t], rhi = a.row_ptr[t + 1];
    float m = kNeg, d = 0.f;
    for (int j = rlo + lane; j < rhi; j += 32) {
      if (a.mask2[j] > 0.f) {
        const float l = logit[j];
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
        const T* vr = v_s + static_cast<size_t>(j0 + u) * a.hidden + h * ch;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int c = lane + 32 * i;
          // a masked edge (w = 0) may have no v written: never read into
          // the sum, even as 0 * v
          const float v = c < ch ? load_f(vr + c) : 0.f;
          if (w != 0.f) acc[i] = fmaf(w, v, acc[i]);
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c < ch) a.out[static_cast<size_t>(t) * a.hidden + h * ch + c] = acc[i];
    }
    if (lane == 0) {
      a.stats_max[static_cast<size_t>(t) * a.heads + h] = m;
      a.stats_den[static_cast<size_t>(t) * a.heads + h] = den;
    }
  }
}

int pad_channels(int ch) {
  return ch <= 16 ? 16 : ch <= 32 ? 32 : ch <= 64 ? 64 : 128;
}

int pad_fe(int fe) { return (fe + kKt - 1) / kKt * kKt; }

size_t smem_bytes(int fe, int ch) {
  return sizeof(float) * (static_cast<size_t>(pad_fe(fe)) * pad_channels(ch) +
                          static_cast<size_t>(kChunk) * kLdA);
}

template <typename T, int CPT, int Stage, bool Span>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.fe, a.ch);
  auto kernel = attn_eproj_fwd_kernel<T, CPT, Stage, Span>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + a.rows_per_block - 1) / a.rows_per_block, a.heads);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int Stage, bool Span>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  switch (a.ch_pad) {
    case 16: return launch<T, 1, Stage, Span>(a, stream);
    case 32: return launch<T, 2, Stage, Span>(a, stream);
    case 64: return launch<T, 4, Stage, Span>(a, stream);
    default: return launch<T, 8, Stage, Span>(a, stream);
  }
}

// Fill the arguments every entry point shares.
Args make_args(const void* q, const void* kv, const void* ea,
               const void* w_edge, const void* scale_t, const void* mask2,
               const void* row_ptr, const void* dst, const void* src,
               void* out, void* stats_max, void* stats_den, void* logit_s,
               void* v_s, int n, int e_total, int hidden, int fe, int heads,
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
  a.src = static_cast<const long long*>(src);
  a.out = static_cast<float*>(out);
  a.stats_max = static_cast<float*>(stats_max);
  a.stats_den = static_cast<float*>(stats_den);
  a.logit_s = static_cast<float*>(logit_s);
  a.v_s = v_s;
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
