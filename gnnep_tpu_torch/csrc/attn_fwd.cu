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
// What bounds it on this card: bytes. It reads k and v of every live edge
// once (137 MB at the flagship line-graph conv in f32) and does about four
// operations per element pair, far under the card's ridge (about 20 per
// byte in f32). A row is short (8.7 edges on average at the flagship, at
// most 20), so a warp's time is a chain of dependent loads; the design is
// about wide words, bytes in flight, short chains and few instructions.
//
// Design (layouts, spans and pair lanes in attn_kv.cuh; the plan that
// picks them is gnnep_tpu_torch/ops/cuda/attention.py:attention_plan).
// Against the previous (element-wise) design's five limits:
//  1. Element-wise loads -> wide words. q, k and v move in the widest word
//     (16, 8, 4 or 2 bytes) that the span and the three base addresses
//     allow: at the flagship one 16-byte word is 8 bf16 or 4 f32 channels.
//     Where k and v exceed L2 (the line graph) they are read with
//     evict-first loads.
//  2. Few rows in flight -> G = 4 edges a group, their words loaded before
//     the first FMA; mask2, scale_t and the first group's k words are
//     loaded together as soon as row_ptr is known, and the next group's
//     go out into the same registers as soon as the dot products have
//     spent them, in flight during the group's sums and softmax
//     bookkeeping. Pass 2's v words are predicated on the edge's liveness
//     and scale_t, read from shared memory, not on its alpha, so they are
//     in flight while alpha is formed. No branch stands between a load and
//     its use. (A second set of registers for the next group, or 8 edges a
//     group, cost more in registers than they gained: PERF.md §6, PR 9.)
//  3. A scratch round trip per logit -> logits on chip. After a group's dot
//     products the pair lanes (one per (head, edge) of the group) take the
//     logits, keep each head's running max and sum, and write the logit
//     and scale_t to shared memory ([heads][32] per warp); in pass 2 they
//     form alpha, rounded once at the row's final denominator, and every
//     slot takes its head's by a shuffle. Only a row of more than 32 edges
//     writes its logits to the [heads, E] scratch and reads them back chunk
//     by chunk.
//  4. (The backward's second launch; see attn_bwd.cu.)
//  5. A row read in head-sized pieces -> a warp holds a slab of heads: one
//     contiguous run of each row of 32 spans (all 4 heads of a flagship
//     bf16 row, 2 of an f32 one), and row_ptr, mask2 and q loaded once per
//     warp, not once per head. A head of more than 32 spans takes a warp
//     alone, in passes of 32 x S spans.
// A conv with few targets (the flagship's atom conv: 768) is bound by each
// warp's chain of loads over its longest rows, not by bytes; there 2 or 4
// warps share a row (split), each taking every split-th group, and merge
// their softmax max and sum, then their partial sums, through shared
// memory in a fixed order, so that the result is deterministic and each
// output still has one writer.

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
//    so the logits are f32; alpha is rounded to v's type after the row's
//    denominator is known, before the aggregation (:604-606); out and the
//    stats are f32.
//  - scale_t multiplies alpha after normalisation and never enters the
//    denominator.

#include "attn_kv.cuh"

namespace {

using namespace attn_kv;

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
  float* logit_s;  // [heads, E] scratch, for rows of more than 32 edges
  int n, e_total, hidden, heads, ch;
  float inv_sqrt_ch;
  Layout lay;
};

// SPAN bytes a slot in words of W bytes, S slots a lane in each pass;
// kStream: k and v read with evict-first loads (they exceed L2)
template <typename T, int SPAN, int W, int S, bool kStream>
__global__ void __launch_bounds__(kMaxWarps * 32) attn_fwd_kernel(Args a) {
  using Sp = Span<T, SPAN, W>;
  using Rg = typename Sp::Regs;
  constexpr int V = Sp::kVec;
  constexpr int G = kEdges / S;  // edges to a group, loaded together
  // per warp, by local head and edge of the chunk: the logit and scale_t
  // (33 columns: the pair lanes of different heads hit different banks);
  // at the end of a split row, the warp's partial sums
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
  const size_t e_total = static_cast<size_t>(a.e_total);
  float(*lg)[kChunk + 1] = ws_s[warp][0];
  float(*scs)[kChunk + 1] = ws_s[warp][1];

  // this lane's slots: head, and the channel offset of its span in pass p
  // (-1: idle); and its pair (head ph, edge pg of a group)
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
  const int ph = lane / G, pg = lane % G;
  const bool pair_on = ph < nh;

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

  const T* q = static_cast<const T*>(a.q) + static_cast<size_t>(t) * hid;
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const float* scale = a.scale_t + static_cast<size_t>(h0 + ph) * e_total;
  float qf[S][V];
  auto load_q = [&]() {
#pragma unroll
    for (int s = 0; s < S; ++s)
      Sp::unpack(cof[s] >= 0 ? Sp::load(q + cof[s]) : Sp::zero(), qf[s]);
  };
  load_q();
  int rlo, rhi;
  row_bounds(a.row_ptr, t, lane, &rlo, &rhi);
  const int nchunk = (rhi - rlo + kChunk - 1) / kChunk;
  // the warp's groups of a chunk start at r * G, one in `split`
  const int g0 = r * G, gstep = L.split * G;

  // the k words of group u0 (edges in range) and the pair lane's scale_t
  auto fetch_k = [&](int j0, int cnt, int u0, Rg (&kx)[G][S], float& scx) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const T* row = k + static_cast<size_t>(j0 + u0 + g) * hid;
#pragma unroll
      for (int s = 0; s < S; ++s)
        kx[g][s] = u0 + g < cnt && cof[s] >= 0
                       ? Sp::template load<kStream>(row + cof[s])
                       : Sp::zero();
    }
    scx = pair_on && u0 + pg < cnt ? scale[j0 + u0 + pg] : 0.f;
  };
  auto dots = [&](const Rg (&kx)[G][S], float (&acc)[G][S]) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float x[V];
        Sp::unpack(kx[g][s], x);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[g][s] = fmaf(qf[s][i], x[i], acc[g][s]);
      }
  };

  // pass 1: the logits, G edges at a time; the pair lanes keep their
  // head's running max and sum. mask2, scale_t and the first group's k
  // words are loaded together
  float m = kNeg, d = 0.f;
  unsigned live = 0;  // the current chunk's live edges
  for (int c = 0; c < nchunk; ++c) {
    const int j0 = rlo + c * kChunk;
    const int cnt = min(kChunk, rhi - j0);
    const float mk = lane < cnt ? a.mask2[j0 + lane] : 0.f;
    Rg kr[G][S];
    float sc = 0.f, scn = 0.f;
    if (L.passes == 1) fetch_k(j0, cnt, g0, kr, scn);
    live = __ballot_sync(kFull, mk > 0.f);
    for (int u0 = g0; u0 < cnt; u0 += gstep) {
      float acc[G][S];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int s = 0; s < S; ++s) acc[g][s] = 0.f;
      if (L.passes == 1) {
        sc = scn;
        dots(kr, acc);
        // the words are spent: the next group's loads go out into the same
        // registers now, in flight during this group's sums and bookkeeping
        if (u0 + gstep < cnt) fetch_k(j0, cnt, u0 + gstep, kr, scn);
      } else {
        for (int p = 0; p < L.passes; ++p) {
          set_pass(p);
          load_q();
          fetch_k(j0, cnt, u0, kr, sc);
          dots(kr, acc);
        }
      }
      const unsigned gl = (live >> u0) & ((1u << G) - 1u);
      head_dots<G, S>(acc, L);
      const float l = to_pair<G, S>(acc, L, lane) * a.inv_sqrt_ch;
      const bool ok = pair_on && (gl >> pg) & 1u;
      // the head's max over the group's live edges, then its sum, merged
      if (gl) {
        const float mn = fmaxf(m, pair_max<G>(ok ? l : kNeg));
        const float sum = pair_sum<G>(ok ? expf(l - mn) : 0.f);
        d = d * expf(m - mn) + sum;
        m = mn;
      }
      if (ok) {
        lg[ph][u0 + pg] = l;
        scs[ph][u0 + pg] = sc;
        if (nchunk > 1)
          a.logit_s[static_cast<size_t>(h0 + ph) * e_total + j0 + u0 + pg] =
              l;
      }
    }
  }
  if (L.split > 1) {
    // a split row: each head's max and sum over the target's warps, merged
    // in the order of the warps
    if (pair_on && pg == 0) {
      st_s[warp][ph][0] = m;
      st_s[warp][ph][1] = d;
    }
    target_barrier(warp, L.split);
    const int base = warp - r;
    if (pair_on) {
      m = kNeg;
      for (int i = 0; i < L.split; ++i) m = fmaxf(m, st_s[base + i][ph][0]);
      d = 0.f;
      for (int i = 0; i < L.split; ++i)
        d += st_s[base + i][ph][1] * expf(st_s[base + i][ph][0] - m);
    }
  }
  __syncwarp();
  d = fmaxf(d, 1e-16f);

  // pass 2: out = Σ alpha · v. Each group's v words (of live edges whose
  // scale_t is nonzero: none of a masked or dropped edge) are loaded
  // first; meanwhile the pair lanes form alpha, rounded to v's type, and
  // each slot takes its head's
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
        // a long row's chunk: liveness, logits and scale_t again, lane u
        // holding edge u
        __syncwarp();
        const bool mine = lane < cnt && a.mask2[j0 + lane] > 0.f;
        live = __ballot_sync(kFull, mine);
        for (int h = 0; h < nh; ++h)
          if (mine) {
            const size_t at = static_cast<size_t>(h0 + h) * e_total + j0 +
                              lane;
            lg[h][lane] = a.logit_s[at];
            scs[h][lane] = a.scale_t[at];
          }
        __syncwarp();
      }
      auto fetch_v = [&](int u0, Rg (&vx)[G][S]) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const T* row = v + static_cast<size_t>(j0 + u0 + g) * hid;
#pragma unroll
          for (int s = 0; s < S; ++s)
            vx[g][s] = u0 + g < cnt && ((live >> (u0 + g)) & 1u) &&
                               cof[s] >= 0 && scs[hl[s]][u0 + g] != 0.f
                           ? Sp::template load<kStream>(row + cof[s])
                           : Sp::zero();
        }
      };
      Rg vr[G][S];
      fetch_v(g0, vr);
      for (int u0 = g0; u0 < cnt; u0 += gstep) {
        const unsigned gl = (live >> u0) & ((1u << G) - 1u);
        float al = 0.f;
        if (pair_on && (gl >> pg) & 1u)
          al = round_to<T>((expf(lg[ph][u0 + pg] - m) / d) *
                           scs[ph][u0 + pg]);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const float w = __shfl_sync(kFull, al, hl[s] * G + g);
            float x[V];
            Sp::unpack(vr[g][s], x);
#pragma unroll
            for (int i = 0; i < V; ++i)
              acc[s][i] = fmaf(cof[s] >= 0 ? w : 0.f, x[i], acc[s][i]);
          }
        if (u0 + gstep < cnt) fetch_v(u0 + gstep, vr);
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
  if (r == 0 && pair_on && pg == 0) {
    const size_t th = static_cast<size_t>(t) * a.heads + h0 + ph;
    a.stats_max[th] = m;
    a.stats_den[th] = d;
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32) attn_fwd_empty_kernel() {}

template <typename T, int SPAN, int W>
cudaError_t launch_sw(const Args& a, int slabs, int streamed,
                      cudaStream_t stream) {
  const dim3 grid(a.lay.main_blocks), block(a.lay.warps * 32);
  if (slabs == 1 && streamed)
    attn_fwd_kernel<T, SPAN, W, 1, true><<<grid, block, 0, stream>>>(a);
  else if (slabs == 1)
    attn_fwd_kernel<T, SPAN, W, 1, false><<<grid, block, 0, stream>>>(a);
  else if (streamed)
    attn_fwd_kernel<T, SPAN, W, 2, true><<<grid, block, 0, stream>>>(a);
  else
    attn_fwd_kernel<T, SPAN, W, 2, false><<<grid, block, 0, stream>>>(a);
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
// per warp, warps per target, warps per block; streamed loads) does not fit the shape, the type or a base
// address. The caller guarantees: n >= 1, hidden = heads * ch, contiguous
// tensors of the types above, row_ptr nondecreasing with row_ptr[n] <=
// e_total, out aligned to 16 bytes, and a scratch buffer logit_s f32
// [heads, E] (read and written only for rows of more than 32 edges).
// inv_sqrt_ch is 1/sqrt(ch) rounded once to f32, as the JAX kernel's
// constant is.
int attn_fwd(const void* q, const void* k, const void* v, const void* scale_t,
             const void* mask2, const void* row_ptr, void* out,
             void* stats_max, void* stats_den, void* logit_s, int n,
             int e_total, int hidden, int heads, float inv_sqrt_ch,
             int is_bf16, int span, int word, int slabs, int hpw, int split,
             int warps, int streamed, void* stream) {
  Args a;
  const void* ptrs[] = {q, k, v};
  if (!make_layout(n, hidden, heads, is_bf16 ? 2 : 4, span, word, slabs,
                   hpw, split, warps, 0, ptrs, 3, &a.lay) ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
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
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(a, span, word, slabs, streamed, s)
              : launch<float>(a, span, word, slabs, streamed, s);
  return static_cast<int>(err);
}

// An empty kernel on the grid and block of the plan: the launch latency
// that a chain of forward calls cannot go below.
int attn_fwd_empty(int n, int hidden, int heads, int is_bf16, int span,
                   int word, int slabs, int hpw, int split, int warps,
                   void* stream) {
  Layout L;
  if (!make_layout(n, hidden, heads, is_bf16 ? 2 : 4, span, word, slabs, hpw,
                   split, warps, 0, nullptr, 0, &L))
    return static_cast<int>(cudaErrorInvalidValue);
  attn_fwd_empty_kernel<<<L.main_blocks, L.warps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
