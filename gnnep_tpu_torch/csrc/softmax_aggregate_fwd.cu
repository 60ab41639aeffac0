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
//   out_t = Σ_j softmax_j(logits[j, h]) · scale[j, h] · v_j[h]
//
// and it saves the softmax max and denominator of every (t, h) in [N, heads]
// layouts, for the backward (softmax_aggregate_bwd.cu). Arguments: logits
// and scale f32 [E, heads] (the JAX function's logits_t and scale_t
// transposed; a null scale is all ones), v [E, H] float32 or bfloat16,
// row_ptr i32 [N+1]; out f32 [N, H].
//
// What bounds it on this card: bytes. It reads v of every live edge once
// (77 MB at the flagship line-graph conv in f32) with one multiply-add per
// value, and the row's logits and scales. A row is short (8.7 edges on
// average at the flagship, at most 20), so a warp's time is a chain of
// dependent loads; the design is about wide words, bytes in flight and few
// instructions per edge.
//
// Design: kernel 3's (attn_fwd.cu) without the q·k products, on the layout
// in attn_kv.cuh (the plan: gnnep_tpu_torch/ops/cuda/aggregate.py:
// aggregate_plan). Against the previous (element-wise) design's limits:
//  1. Element-wise loads -> wide words. v moves in the widest word (16, 8,
//     4 or 2 bytes) that the span and v's base allow: at the flagship one
//     16-byte word is 8 bf16 or 4 f32 channels. Where v exceeds L2 (the
//     f32 line graph) it is read with evict-first loads.
//  2. A row read in head-sized pieces -> a warp holds a slab of heads: one
//     contiguous run of each v row (all 4 heads of a flagship bf16 row, 2
//     of an f32 one), and row_ptr read once per warp, not once per head. A
//     head of more than 32 spans takes a warp alone, in passes.
//  3. Per-lane online softmax and a five-level merge -> pair lanes. A
//     chunk's logits and scales (of up to 32 edges, every head of the
//     warp) are loaded together, lane u holding edge u, into shared
//     memory; [E, heads] rather than the TPU kernel's [heads, E], so an
//     edge's heads are one contiguous run (faster at the line graph, level
//     at the atom conv: PERF.md §6, PR 10); then for each window of 2G
//     edges the pair lanes (one per (head, edge) of the window: all 32
//     lanes at the flagship) keep their head's running max and sum: one
//     exp per pair and window, and three shuffles each for the max and the
//     sum over the head's 2G lanes (rather than windows of G edges, as
//     kernel 3's groups: PERF.md §6, PR 10).
//  4. Alpha recomputed per value -> alpha on chip. Once the row's max and
//     denominator are known the pair lanes form alpha, rounded to v's type,
//     in place of the logits in shared memory; pass 2 reads neither logits
//     nor scales again. A row of more than 32 edges reloads its logits and
//     scales chunk by chunk and forms each chunk's alpha alike.
//  5. Edges summed one at a time -> two groups of G edges in flight: each
//     group's v words are loaded before its FMAs into one of two register
//     sets, and the group two ahead is issued into the set as soon as it is
//     spent. A row of one chunk issues its first two groups right after
//     row_ptr (every edge in range; a masked edge's words then meet alpha
//     0), so that the logits, pass 1 and alpha run while they are in
//     flight; later groups load only edges whose alpha is nonzero (none of
//     a masked or dropped edge).
// A conv with few targets (the flagship's atom conv: 768) is bound by each
// warp's chain of loads over its longest rows, not by bytes; there 2 or 4
// warps share a row (split), each taking every split-th group, and merge
// their softmax max and sum, then their partial sums, through shared
// memory in the order of the warps at a named barrier per target, so that
// the result is deterministic and each output still has one writer.
//
// Each (target, head) belongs to one warp (or one split of warps): no
// atomics. The dummy row n-1 owns the arena's tail padding; it is written
// as an all-masked row and never walked.
//
// Hazards, each handled here:
//  - There is no mask stream. Interior padding rows and masked edges are
//    excluded only because the caller wrote their logits as -1e30; an edge
//    counts only if its logit is above 0.5 · -1e30 (`counts`). Without it
//    an all-masked row (max -1e30) would give exp(0) = 1 on each of its
//    masked edges. Such a row gives out = 0, max = -1e30, denom = 1e-16.
//  - bf16 rounding mirrors the TPU kernel: the logits arrive in f32, alpha
//    is rounded to v's type before the aggregation (:101-103), and out and
//    the stats are f32.
//  - scale_t multiplies alpha after normalisation and never enters the
//    denominator.
//  - The order of every sum follows the span and the layout alone, so a
//    run on a misaligned v (narrower words) is bitwise the aligned run.

#include "attn_kv.cuh"

namespace {

using namespace attn_kv;

struct Args {
  const float* logits;  // [E, heads]
  const float* scale;   // [E, heads], or null: all ones
  const void* v;
  const int* row_ptr;
  float* out;
  float* stats_max;
  float* stats_den;
  int n, e_total, hidden, heads, ch;
  Layout lay;
};

// SPAN bytes a slot in words of W bytes, S slots a lane in each pass;
// kStream: v read with evict-first loads (it exceeds L2)
template <typename T, int SPAN, int W, int S, bool kStream>
__global__ void __launch_bounds__(kMaxWarps * 32)
    softmax_aggregate_fwd_kernel(Args a) {
  using Sp = Span<T, SPAN, W>;
  using Rg = typename Sp::Regs;
  constexpr int V = Sp::kVec;
  constexpr int G = kEdges / S;  // edges to a group, loaded together
  // per warp, by local head and edge of the chunk: the logit (then alpha)
  // and scale_t (33 columns: the lanes of different heads hit different
  // banks); at the end of a split row, the warp's partial sums
  __shared__ float ws_s[kMaxWarps][2][kMaxHeads][kChunk + 1];
  __shared__ float st_s[kMaxWarps][kMaxHeads][2];  // a split row's stats
  const Layout& L = a.lay;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hy = blockIdx.x / L.tblocks;
  const int h0 = hy * L.hpw, nh = min(L.hpw, a.heads - h0);
  // the warp's target, and its share r of the target's groups
  const int r = warp % L.split;
  const int t = (blockIdx.x - hy * L.tblocks) * (L.warps / L.split) +
                warp / L.split;
  if (t >= a.n) return;  // the target's warps leave together
  const int ch = a.ch, hid = a.hidden;
  float(*lg)[kChunk + 1] = ws_s[warp][0];
  float(*scs)[kChunk + 1] = ws_s[warp][1];

  // this lane's slots: head, and the channel offset of its span in pass p
  // (-1: idle)
  int hl[S], wih0[S], cof[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const Slot sl = slot_of(L, s, lane);
    hl[s] = sl.hl;
    wih0[s] = sl.wih0;
  }
  auto set_pass = [&](int p) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int w = wih0[s] + p * S * L.sw;
      cof[s] = hl[s] < nh && w < L.wph ? (h0 + hl[s]) * ch + w * V : -1;
    }
  };
  set_pass(0);
  // the softmax's pair lanes: lane qh * PG + qg takes edge k0 + qg of a
  // window of PG = 2G edges for head qh (the plan keeps hpw * PG <= 32); a
  // split row's warp counts only the edges of its own groups
  constexpr int PG = 2 * G;
  const int qh = lane / PG, qg = lane % PG;
  const bool q_on = qh < nh;
  auto own = [&](int u) { return ((u / G) & (L.split - 1)) == r; };

  float* out_t = a.out + static_cast<size_t>(t) * hid;
  if (t == a.n - 1) {
    // the dummy row: written as an all-masked row, never walked
    if (r > 0) return;
    const float zero[V] = {};
    for (int p = 0; p < L.passes; ++p) {
      set_pass(p);
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (cof[s] >= 0) store_f32<V>(out_t + cof[s], zero);
    }
    if (lane < nh) {
      a.stats_max[static_cast<size_t>(t) * a.heads + h0 + lane] = kNeg;
      a.stats_den[static_cast<size_t>(t) * a.heads + h0 + lane] = 1e-16f;
    }
    return;
  }

  const T* v = static_cast<const T*>(a.v);
  int rlo, rhi;
  row_bounds(a.row_ptr, t, lane, &rlo, &rhi);
  const int nchunk = (rhi - rlo + kChunk - 1) / kChunk;
  // the warp's groups of a chunk start at r * G, one in `split`
  const int g0 = r * G, gstep = L.split * G;
  // a chunk's logits and scales of the warp's groups into shared memory
  const float* const src[2] = {a.logits, a.scale};
  float(*const dst[2])[kChunk + 1] = {lg, scs};
  auto load_chunk = [&](int j0, int cnt) {
    chunk_to_shared<G, 2>(src, a.heads, h0, nh, j0, cnt, lane, r, L.split,
                          dst);
    __syncwarp();
  };

  // the v words of group u0 of the chunk from j0 (none past the chunk):
  // with `formed`, only of edges whose alpha is nonzero
  auto fetch_v = [&](int j0, int cnt, int u0, bool formed,
                     Rg (&vx)[G][S]) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const T* row = v + static_cast<size_t>(j0 + u0 + g) * hid;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int u = u0 + g;
        const bool on = u < cnt && cof[s] >= 0 &&
                        (!formed || row_at(lg, hl[s], u) != 0.f);
        vx[g][s] = on ? Sp::template load<kStream>(row + cof[s]) : Sp::zero();
      }
    }
  };
  // two register sets: the groups u0 and u0 + gstep of a pair
  Rg va[G][S], vb[G][S];
  // a row of one chunk (and one pass) loads its first two groups' v words
  // with its logits, before pass 1
  const bool early = nchunk == 1 && L.passes == 1;
  if (early) {
    fetch_v(rlo, rhi - rlo, g0, false, va);
    fetch_v(rlo, rhi - rlo, g0 + gstep, false, vb);
  }

  // pass 1: the pair lanes' running max and sum of their head, merged per
  // group of G edges
  float m = kNeg, d = 0.f;
  for (int c = 0; c < nchunk; ++c) {
    const int j0 = rlo + c * kChunk;
    const int cnt = min(kChunk, rhi - j0);
    if (c > 0) __syncwarp();  // the previous chunk's logits are spent
    load_chunk(j0, cnt);
    for (int k0 = 0; k0 < cnt; k0 += PG) {
      const int u = k0 + qg;
      const float x = row_at(lg, qh, u);
      const float l = q_on && u < cnt && own(u) ? x : kNeg;
      const bool ok = counts(l);
      if (__any_sync(kFull, ok)) {
        const float mn = fmaxf(m, pair_max<PG>(ok ? l : kNeg));
        const float sum = pair_sum<PG>(ok ? expf(l - mn) : 0.f);
        d = d * expf(m - mn) + sum;
        m = mn;
      }
    }
  }
  if (L.split > 1) {
    // a split row: each head's max and sum over the target's warps, merged
    // in the order of the warps
    if (q_on && qg == 0) {
      st_s[warp][qh][0] = m;
      st_s[warp][qh][1] = d;
    }
    target_barrier(warp, L.split);
    const int base = warp - r;
    if (q_on) {
      m = kNeg;
      for (int i = 0; i < L.split; ++i) m = fmaxf(m, st_s[base + i][qh][0]);
      d = 0.f;
      for (int i = 0; i < L.split; ++i)
        d += st_s[base + i][qh][1] * expf(st_s[base + i][qh][0] - m);
    }
  }
  d = fmaxf(d, 1e-16f);

  // alpha of the warp's groups of a chunk, rounded to v's type, in place of
  // the logits (0 where an edge does not count)
  auto form_alpha = [&](int cnt) {
    for (int k0 = 0; k0 < cnt; k0 += PG) {
      const int u = k0 + qg;
      if (q_on && u < cnt && own(u)) {
        const float l = lg[qh][u];
        lg[qh][u] =
            counts(l) ? round_to<T>((expf(l - m) / d) * scs[qh][u]) : 0.f;
      }
    }
    __syncwarp();
  };
  if (nchunk == 1) form_alpha(rhi - rlo);

  // pass 2: out = Σ alpha · v, two groups of v words in flight
  for (int p = 0; p < L.passes; ++p) {
    if (L.passes > 1) set_pass(p);
    float acc[S][V];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[s][i] = 0.f;
    for (int c = 0; c < nchunk; ++c) {
      const int j0 = rlo + c * kChunk;
      const int cnt = min(kChunk, rhi - j0);
      if (nchunk > 1) {
        // a long row's chunk: its logits and scales again, then its alpha
        __syncwarp();
        load_chunk(j0, cnt);
        form_alpha(cnt);
      }
      if (!early) {
        fetch_v(j0, cnt, g0, true, va);
        fetch_v(j0, cnt, g0 + gstep, true, vb);
      }
      // group u0's FMAs from the words vx, in edge order; then the group two
      // ahead goes out into the spent registers
      auto sum_group = [&](int u0, Rg (&vx)[G][S]) {
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int s = 0; s < S; ++s) {
            // slot s's alpha of the edge (0 for an idle slot)
            const float a = row_at(lg, hl[s], u0 + g);
            const float w = u0 + g < cnt && cof[s] >= 0 ? a : 0.f;
            float x[V];
            Sp::unpack(vx[g][s], x);
#pragma unroll
            for (int i = 0; i < V; ++i) acc[s][i] = fmaf(w, x[i], acc[s][i]);
          }
        if (u0 + 2 * gstep < cnt) fetch_v(j0, cnt, u0 + 2 * gstep, true, vx);
      };
      for (int u0 = g0; u0 < cnt; u0 += 2 * gstep) {
        sum_group(u0, va);
        if (u0 + gstep < cnt) sum_group(u0 + gstep, vb);
      }
    }
    if (L.split > 1) {
      // a split row: the warps' partial sums added in the order of the
      // warps by the first, each lane's through shared memory
      float* mine = &ws_s[warp][0][0][0];
      __syncwarp();
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int i = 0; i < V; ++i) mine[(s * V + i) * 32 + lane] = acc[s][i];
      target_barrier(warp, L.split);
      if (r == 0)
        for (int w = 1; w < L.split; ++w) {
          const float* theirs = &ws_s[warp + w][0][0][0];
#pragma unroll
          for (int s = 0; s < S; ++s)
#pragma unroll
            for (int i = 0; i < V; ++i)
              acc[s][i] += theirs[(s * V + i) * 32 + lane];
        }
    }
    if (r == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (cof[s] >= 0) store_f32<V>(out_t + cof[s], acc[s]);
    }
  }
  if (r == 0 && q_on && qg == 0) {
    const size_t th = static_cast<size_t>(t) * a.heads + h0 + qh;
    a.stats_max[th] = m;
    a.stats_den[th] = d;
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32)
    softmax_aggregate_fwd_empty_kernel() {}

template <typename T, int SPAN, int W>
cudaError_t launch_sw(const Args& a, int slabs, int streamed,
                      cudaStream_t stream) {
  const dim3 grid(a.lay.main_blocks), block(a.lay.warps * 32);
  if (slabs == 1 && streamed)
    softmax_aggregate_fwd_kernel<T, SPAN, W, 1, true>
        <<<grid, block, 0, stream>>>(a);
  else if (slabs == 1)
    softmax_aggregate_fwd_kernel<T, SPAN, W, 1, false>
        <<<grid, block, 0, stream>>>(a);
  else if (streamed)
    softmax_aggregate_fwd_kernel<T, SPAN, W, 2, true>
        <<<grid, block, 0, stream>>>(a);
  else
    softmax_aggregate_fwd_kernel<T, SPAN, W, 2, false>
        <<<grid, block, 0, stream>>>(a);
  return cudaGetLastError();
}

// the instantiation of (span, word): word a power of two from the element
// size up to the span
template <typename T, int SPAN, int W>
cudaError_t launch_w(const Args& a, int word, int slabs, int streamed,
                     cudaStream_t s) {
  if (word == W) return launch_sw<T, SPAN, W>(a, slabs, streamed, s);
  if constexpr (W / 2 >= static_cast<int>(sizeof(T)))
    return launch_w<T, SPAN, W / 2>(a, word, slabs, streamed, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const Args& a, int span, int word, int slabs,
                   int streamed, cudaStream_t s) {
  switch (span) {
    case 16:
      return launch_w<T, 16, 16>(a, word, slabs, streamed, s);
    case 8:
      return launch_w<T, 8, 8>(a, word, slabs, streamed, s);
    case 4:
      return launch_w<T, 4, 4>(a, word, slabs, streamed, s);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch_w<T, 2, 2>(a, word, slabs, streamed, s);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue where the plan (span and word bytes, slabs, heads
// per warp, warps per target, warps per block; streamed loads) does not fit
// the shape, the type or v's base address. The caller guarantees: n >= 1,
// hidden = heads * ch, contiguous tensors of the types above, row_ptr
// nondecreasing with row_ptr[n] <= e_total, and out aligned to 16 bytes.
int softmax_aggregate_fwd(const void* logits, const void* scale,
                          const void* v, const void* row_ptr, void* out,
                          void* stats_max, void* stats_den, int n,
                          int e_total, int hidden, int heads, int is_bf16,
                          int span, int word, int slabs, int hpw, int split,
                          int warps, int streamed, void* stream) {
  Args a;
  const void* ptrs[] = {v};
  if (!make_layout(n, hidden, heads, is_bf16 ? 2 : 4, span, word, slabs,
                   hpw, split, warps, 0, ptrs, 1, &a.lay, 2) ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  a.logits = static_cast<const float*>(logits);
  a.scale = static_cast<const float*>(scale);
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
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(a, span, word, slabs, streamed, s)
              : launch<float>(a, span, word, slabs, streamed, s);
  return static_cast<int>(err);
}

// An empty kernel on the grid and block of the plan: the launch latency
// that a chain of forward calls cannot go below.
int softmax_aggregate_fwd_empty(int n, int hidden, int heads, int is_bf16,
                                int span, int word, int slabs, int hpw,
                                int split, int warps, void* stream) {
  Layout L;
  if (!make_layout(n, hidden, heads, is_bf16 ? 2 : 4, span, word, slabs, hpw,
                   split, warps, 0, nullptr, 0, &L, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  softmax_aggregate_fwd_empty_kernel<<<L.main_blocks, L.warps * 32, 0,
                                       static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
