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
// Design. A block of 256 threads owns a tile of consecutive targets, so one
// contiguous range of the arena, and one head (grid (tiles, heads)). One
// block per tile for every head, which reads each ea row from device
// memory once and not once a head, was timed slower at every flagship case
// (PERF.md §6) and is not kept.
//
//  Phase 1 is `project` (attn_mma.cuh): the projection of the tile's edges,
//  256 (bf16) or 128 (f32) at a time (`FwdTiling`), on the tensor cores
//  (bf16 `mma.sync` m16n8k16 from `ldmatrix`; f32 as 3xTF32 on m16n8k8,
//  operands split into their tf32 parts at fragment load), with ea and W_e
//  streamed over Fe in 32-deep slices through a `cp.async` ring, so
//  shared memory holds no whole W_e slice and does not grow with Fe; each
//  W_e slice serves 256 (bf16) or 128 (f32) edges. A head wider than 128 channels is
//  walked in column tiles of 128. After each tile (e in shared memory in
//  the input type, as the epilogue would round it), the epilogue forms k and
//  v from e and 16-byte (f32) or 8-byte (bf16) vector loads of kv and q,
//  sums q · k over the tile's channels (16 threads an edge, 4 edges a
//  thread), writes v to a scratch [E, H] and, after the head's last tile,
//  each edge's logit to a scratch [heads, E]. Dead edges (masked) load
//  nothing and write nothing.
//  Phase 2 gives each warp one target at a time: the max and
//  denominator over the row's live logits, then alpha and the sum of
//  alpha · v, two channels a lane (bf16x2 / float2 loads), read back from
//  the scratch (written by this block, so mostly from L2). A head wider
//  than 128 is summed in passes of 128 channels; alpha is recomputed in
//  each pass from the same logits by the same instructions, so it rounds
//  at the same point and to the same value in every pass.
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
//  - A masked edge writes no v; phase 2 never reads its v into the sum,
//    not even as 0 · v.
//  - bf16 rounding mirrors the TPU kernel (csr_attention.py:1034-1040, 1057):
//    e is rounded to the input type before the k and v adds, k and v are
//    rounded after them, alpha is rounded to v's type before the aggregation,
//    and every sum is taken in f32. Keeping all logits until the row's
//    denominator is known (rather than an online rescaled sum) is what lets
//    alpha be rounded where the TPU kernel rounds it.
//  - f32: 3xTF32 keeps 22 bits of each operand, and each 32-deep slice's
//    products go to a fresh tile added with IEEE adds (the fix found on
//    kernel 6); chip_smoke holds its error against float64 beside the plain
//    f32 version's.
//  - scale_t multiplies alpha after normalisation and never enters the
//    denominator.
//  - Span: a dead edge (masked) may carry a padding source index, so the
//    kernel reads kv row src[j] only for a live edge.
//
// What bounds it on this card: the projection is 2·E·Fe·H operations (about
// 9.8 GFLOP at the flagship line-graph conv), on the tensor cores: in bf16
// it is far below the bytes (about 117 MB of inputs read once), so bytes
// bound it; in f32 its three TF32 products (29 GFLOP at 495 TFLOP/s) and
// the bytes (about 230 MB) are within a factor of two of each other.

#pragma once

#include "attn_mma.cuh"

namespace {

// The projection's tiling (`project`): edges per staged W_e slice 64 · MT
// and ring stages, per input type and column tile, chosen by timing
// variants at the flagship line-graph conv (PERF.md §6). bf16 takes
// 256 edges per slice; f32, whose slices and accumulators (a fresh tile
// per slice) are twice as large, 128; both half that at NW 128, where the
// accumulators would spill. Two stages: at the flagship's NW 64 a block
// takes 87 KB (bf16) or 90 KB (f32) of shared memory, two blocks an SM,
// and the rest of the SM's 256 KB serves as L1 for the epilogue's kv, q
// and scratch reads (a third stage was slower in both types).
template <typename T, int NW>
struct FwdTiling {
  static constexpr int kMT =
      NW == kMaxTile ? (sizeof(T) == 2 ? 2 : 1) : (sizeof(T) == 2 ? 4 : 2);
  static constexpr int kStages = 2;
};

// The ladder's stages, each keeping the work of those before it:
//  kDma     every load kernel 5 makes (the ea and W_e slices through the
//           ring, kv, q, the logits' scratch, scale and mask), no math;
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
  int n, e_total, hidden, fe, heads, ch, ntiles, rows_per_block;
  float inv_sqrt_ch;
};

// The epilogue of one projection tile: chunk e0, head h, column tile nt of
// NW channels, e in shared memory. A thread owns 4 edges × CPT = NW / 16
// consecutive channels; the 16 threads of an edge are a half-warp. pl
// carries each edge's partial q · k across a head's column tiles (NW 128
// only: a narrower tile is the head's only one).
template <typename T, int NW, int Stage, bool Span>
__device__ __forceinline__ void fwd_epilogue(const Args& a, int e0, int hi,
                                             int h, int nt, const T* e_s,
                                             int ld_e, float (&pl)[4]) {
  constexpr int CPT = NW / 16;
  const int tid = threadIdx.x;
  const int cg = tid % 16, eg = tid / 16;  // channel group, edge group
  const T* kv = static_cast<const T*>(a.kv);
  const T* q = static_cast<const T*>(a.q);
  T* v_s = static_cast<T*>(a.v_s);
  const int hid = a.hidden, ch = a.ch;
  const int c0 = nt * NW + cg * CPT, left = ch - c0;  // this thread's channels
  const bool vec =
      ch % CPT == 0 &&
      (reinterpret_cast<uintptr_t>(kv) | reinterpret_cast<uintptr_t>(q) |
       reinterpret_cast<uintptr_t>(v_s)) % (sizeof(T) * CPT) == 0;
  // edge i of the thread's four: k, v and its q · k summed onto `sum`;
  // after the head's last column tile, the logit written
  auto edge = [&](int i, float sum) {
    const int r = eg * 4 + i, j = e0 + r;
    const bool live = j < hi && a.mask2[j] > 0.f;
    const int n_ok = live ? left : 0;  // a dead edge loads and writes nothing
    const long long row = live ? (Span ? a.src[j] : j) : 0;
    const long long t = live ? a.dst[j] : 0;
    const size_t kvb = static_cast<size_t>(row) * 2 * hid + h * ch + c0;
    float kx[CPT], vx[CPT], qx[CPT];
    load_n<T, CPT>(kx, kv + kvb, vec, n_ok);
    load_n<T, CPT>(vx, kv + kvb + hid, vec, n_ok);
    load_n<T, CPT>(qx, q + static_cast<size_t>(t) * hid + h * ch + c0, vec,
                   n_ok);
    if constexpr (Stage == kDma) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) sum += kx[c] + vx[c] + qx[c];
    } else {
      float vr[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float e = load_f(e_s + r * ld_e + cg * CPT + c);
        const float k = round_to<T>(kx[c] + e);
        vr[c] = round_to<T>(vx[c] + e);
        if (c < n_ok) {
          if constexpr (Stage == kEproj)
            sum += k;
          else
            sum = fmaf(qx[c], k, sum);
        }
      }
      store_n<T, CPT>(v_s + static_cast<size_t>(j) * hid + h * ch + c0, vr,
                      vec, n_ok);
    }
    if (nt == a.ntiles - 1) {
      float part = sum;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) part += __shfl_xor_sync(kFull, part, o);
      if (j < hi && cg == 0)
        a.logit_s[static_cast<size_t>(h) * a.e_total + j] =
            Stage >= kSddmm ? part * a.inv_sqrt_ch : part;
    }
    return sum;
  };
  if constexpr (NW == kMaxTile) {
    // a head may span several column tiles: the four partial sums carry
    // over in pl
#pragma unroll
    for (int i = 0; i < 4; ++i) pl[i] = edge(i, nt == 0 ? 0.f : pl[i]);
  } else {
    // one column tile a head, so each sum ends here: two edges' loads in
    // flight at a time, not four, keep the kernel within the 128 registers
    // that two blocks an SM allow (four spilled)
#pragma unroll 1
    for (int i0 = 0; i0 < 4; i0 += 2) {
#pragma unroll
      for (int i = i0; i < i0 + 2; ++i) edge(i, 0.f);
    }
  }
}

// The softmax statistics of target t, head h over its live logits, merged
// over the warp → (max, denominator clamped at 1e-16).
__device__ __forceinline__ float2 row_stats(const Args& a, const float* logit,
                                            int rlo, int rhi) {
  const int lane = threadIdx.x & 31;
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
  return make_float2(m, fmaxf(d, 1e-16f));
}

// Phase 2 of a ladder stage cut short of kFullStage, one warp per target:
// up to kSddmm the sum of the row's live logits times their scale
// (every load phase 2 makes but v's); at kSoftmax kernel 5's max,
// denominator and alphas, their sum written in place of the aggregation
// over v.
template <typename T, int Stage>
__device__ void ladder_phase2(const Args& a, int t0, int t1, int h) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = t0 + warp; t < t1; t += kWarps) {
    const float* logit = a.logit_s + static_cast<size_t>(h) * a.e_total;
    const float* scale = a.scale_t + static_cast<size_t>(h) * a.e_total;
    const int rlo = a.row_ptr[t], rhi = a.row_ptr[t + 1];
    float s = 0.f, m = kNeg, den = 1.f;
    if constexpr (Stage < kSoftmax) {
      for (int j = rlo + lane; j < rhi; j += 32)
        if (a.mask2[j] > 0.f) s = fmaf(logit[j], scale[j], s);
    } else {
      const float2 st = row_stats(a, logit, rlo, rhi);
      m = st.x;
      den = st.y;
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

// NW: the column tile (16, 32, 64 or 128; `tile_width`)
template <typename T, int NW, int Stage, bool Span>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    attn_eproj_fwd_kernel(Args a) {
  constexpr int CPP = (NW / 2 + 31) / 32;  // phase 2: channel pairs a lane
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float alpha_s[kWarps][32];
  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int ch = a.ch, hid = a.hidden;

  // the dummy row n-1 owns the arena's tail padding and its output is
  // unspecified: it is written as an all-masked row and never walked
  const int t0 = blockIdx.x * a.rows_per_block;
  const int t1 = min(t0 + a.rows_per_block, a.n - 1);
  if (blockIdx.x == gridDim.x - 1) {
    for (int c = tid; c < ch; c += kThreads)
      a.out[static_cast<size_t>(a.n - 1) * hid + h * ch + c] = 0.f;
    if (tid == 0) {
      a.stats_max[static_cast<size_t>(a.n - 1) * a.heads + h] = kNeg;
      a.stats_den[static_cast<size_t>(a.n - 1) * a.heads + h] = 1e-16f;
    }
  }
  if (t0 >= t1) return;
  const int lo = a.row_ptr[t0], hi = a.row_ptr[t1];

  // phase 1: logits and v of the tile's edges, chunk by chunk
  using Tiling = FwdTiling<T, NW>;
  // partial q · k of the edges, one set per chunk where a head can span
  // several column tiles (NW 128); else each chunk's sum ends in its call
  constexpr int kSets = NW == kMaxTile ? Tiling::kMT : 1;
  float pl[kSets][4];
  project<T, NW, Tiling::kMT, Tiling::kStages, (Stage > kDma)>(
      smem, static_cast<const T*>(a.ea), static_cast<const T*>(a.w_edge),
      a.fe, hid, ch, lo, hi, h, a.ntiles,
      [&](int c, int e0, int, int nt, const T* e_s, int ld_e) {
        fwd_epilogue<T, NW, Stage, Span>(a, e0, hi, h, nt, e_s, ld_e,
                                         pl[c % kSets]);
      });
  __syncthreads();  // phase 1's scratch writes are visible to the block

  if constexpr (Stage < kFullStage) {
    ladder_phase2<T, Stage>(a, t0, t1, h);
    return;
  }

  // phase 2: one warp per target
  const int warp = tid >> 5, lane = tid & 31;
  const T* v_s = static_cast<const T*>(a.v_s);
  const bool vec = (ch & 1) == 0;
  for (int t = t0 + warp; t < t1; t += kWarps) {
    const float* logit = a.logit_s + static_cast<size_t>(h) * a.e_total;
    const float* scale = a.scale_t + static_cast<size_t>(h) * a.e_total;
    const int rlo = a.row_ptr[t], rhi = a.row_ptr[t + 1];
    const float2 st = row_stats(a, logit, rlo, rhi);
    const float m = st.x, den = st.y;
    float* out = a.out + static_cast<size_t>(t) * hid + h * ch;
    for (int nt = 0; nt < a.ntiles; ++nt) {
      float2 acc[CPP];
#pragma unroll
      for (int i = 0; i < CPP; ++i) acc[i] = make_float2(0.f, 0.f);
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
          // a masked edge (w = 0) has no v written: never read into the
          // sum, even as 0 * v
          if (w == 0.f) continue;
          const T* vr = v_s + static_cast<size_t>(j0 + u) * hid + h * ch;
#pragma unroll
          for (int i = 0; i < CPP; ++i) {
            const int cc = 2 * (lane + 32 * i);
            if (cc >= NW) continue;
            const float2 v = load2(vr, nt * NW + cc, ch, vec);
            acc[i].x = fmaf(w, v.x, acc[i].x);
            acc[i].y = fmaf(w, v.y, acc[i].y);
          }
        }
        __syncwarp();
      }
#pragma unroll
      for (int i = 0; i < CPP; ++i) {
        const int cc = 2 * (lane + 32 * i);
        if (cc < NW) store2(out, nt * NW + cc, ch, vec, acc[i].x, acc[i].y);
      }
    }
    if (lane == 0) {
      a.stats_max[static_cast<size_t>(t) * a.heads + h] = m;
      a.stats_den[static_cast<size_t>(t) * a.heads + h] = den;
    }
  }
}

template <typename T, int NW, int Stage, bool Span>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using Tiling = FwdTiling<T, NW>;
  constexpr size_t smem =
      ProjLayout<T, NW, Tiling::kMT, Tiling::kStages>::kBytes;
  auto kernel = attn_eproj_fwd_kernel<T, NW, Stage, Span>;
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
  switch (tile_width(a.ch)) {
    case 16: return launch<T, 16, Stage, Span>(a, stream);
    case 32: return launch<T, 32, Stage, Span>(a, stream);
    case 64: return launch<T, 64, Stage, Span>(a, stream);
    default: return launch<T, kMaxTile, Stage, Span>(a, stream);
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
  a.ntiles = column_tiles(a.ch);
  a.rows_per_block = rows_per_block;
  a.inv_sqrt_ch = inv_sqrt_ch;
  return a;
}

}  // namespace
