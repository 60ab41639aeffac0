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
//   s_j = exp(logits[j, h] - m_t) / d_t,    a_j = s_j · scale[j, h]
//   u_j = g_t · v_j,   inner_t = sum_j a_j u_j
//   dl_j = s_j (scale[j, h] u_j - inner_t),   dv_j = a_j g_t
//
// Arguments: logits and scale f32 [E, heads] (the JAX function's logits_t
// and scale_t transposed; a null scale is all ones), v [E, H] float32 or
// bfloat16, row_ptr i32 [N+1], g f32 [N, H], the forward's max and denom
// f32 [N, heads]; outputs dl f32 [E, heads] (the JAX function's dl_t
// transposed) and dv [E, H] in v's type.
//
// What bounds it on this card: bytes. It reads v of every counted edge once
// and writes dv and dl for all E rows, with a few operations per value.
//
// Design: kernel 4's (attn_bwd.cu) without dq and dk, on the layout in
// attn_kv.cuh (the plan: gnnep_tpu_torch/ops/cuda/aggregate.py:
// aggregate_plan). Against the previous (element-wise) design's limits:
//  1. One launch. The grid's first blocks zero dl and dv for the dummy
//     row's edges [row_ptr[n-1], E) in 16-byte stores, alongside the first
//     wave of targets; the previous design did this in a second kernel
//     (zero_tail_kernel), a second launch floor per call.
//  2. Wide words. v is loaded, and dv stored, in the widest word (16, 8, 4
//     or 2 bytes) the span and v's base allow (dv is the wrapper's own,
//     16-byte aligned); where v and dv exceed L2 (the line graph), with
//     evict-first loads and streaming stores. A warp holds a slab of heads (all 4 of a flagship
//     bf16 row, 2 of an f32 one), or one head of more than 32 spans: g,
//     the stats and row_ptr are loaded once per warp, not once per head.
//  3. Short sums. g·v is summed inside each lane over its span, then over
//     the head's group of lanes (three butterfly steps for a 64-channel
//     f32 head, not five per edge over the warp).
//  4. s and u on chip. A chunk's logits and scales (of up to 32 edges,
//     every head of the warp) are loaded together, lane u holding edge u,
//     into shared memory, from [E, heads] rows (an edge's heads one
//     contiguous run, as kernel 1's); pass 1 loads the v words of G = 4
//     counted edges before their products, and the next group's into the
//     same registers as soon as they are spent (a second register set, as
//     kernel 1 has, cost more in registers than it gained: PERF.md §6, PR
//     10); after a group the pair lanes (one per (head, edge)) form s, add
//     s · scale · u to their share of inner, and keep s and u in shared
//     memory. Pass 2 forms dl and alpha from them, writes dl, and stores
//     the group's dv words. No [heads, E] scratch: a row of more than 32
//     edges keeps u in dl's own slot until pass 2 overwrites it with dl,
//     and recomputes s from the logits (the same instructions on the same
//     values, so the same bits).
// A conv with few targets splits its rows over 2 or 4 warps, adding the
// warps' shares of inner in the order of the warps.
// Each edge has exactly one writer: no read-modify-write windows and no
// atomics (the TPU kernel accumulates over overlapping windows, which is
// safe only on its sequential grid, :237-245, :289-297).
//
// Hazards, each handled here:
//  - The clamp of the forward (:266-268, `counts`): an edge counts only if
//    its logit is above 0.5 · -1e30, so masked edges and all-masked rows
//    (max -1e30) get s = 0, never exp(0) = 1.
//  - Zeros, not garbage: edges that do not count, and the dummy row's, get
//    exact-zero dl and zero dv rows.
//  - bf16 rounding mirrors the TPU kernel (:273-286): g rounds to v's type
//    before u and dv, alpha rounds to v's type before dv, dv rounds after
//    its f32 product; dl, inner and s stay f32.
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
  const float* g;
  const float* stats_max;
  const float* stats_den;
  float* dl;  // [E, heads]
  void* dv;
  int n, e_total, hidden, heads, ch;
  Layout lay;
};

// zero the dl and dv rows j for j in [row_ptr[n-1], E), the dummy row's
// edges: block `tb` of `L.tail_blocks`
template <typename T>
__device__ void zero_tail(const Args& a, int tb) {
  const size_t lo = static_cast<size_t>(a.row_ptr[a.n - 1]);
  const size_t e_total = static_cast<size_t>(a.e_total);
  const size_t me = static_cast<size_t>(tb) * blockDim.x + threadIdx.x;
  const size_t stride = static_cast<size_t>(a.lay.tail_blocks) * blockDim.x;
  const size_t row_bytes = static_cast<size_t>(a.hidden) * sizeof(T);
  char* const dv[1] = {static_cast<char*>(a.dv)};
  zero_bytes<1>(dv, lo * row_bytes, e_total * row_bytes, me, stride);
  char* const dl[1] = {reinterpret_cast<char*>(a.dl)};
  const size_t dl_bytes = static_cast<size_t>(a.heads) * 4;
  zero_bytes<1>(dl, lo * dl_bytes, e_total * dl_bytes, me, stride);
}

// SPAN bytes a slot in words of W bytes, S slots a lane in each pass;
// kStream: v read with evict-first loads and dv written with streaming
// stores (together they exceed L2)
template <typename T, int SPAN, int W, int S, bool kStream>
__global__ void __launch_bounds__(kMaxWarps * 32)
    softmax_aggregate_bwd_kernel(Args a) {
  using Sp = Span<T, SPAN, W>;
  using Rg = typename Sp::Regs;
  constexpr int V = Sp::kVec;
  constexpr int G = kEdges / S;  // edges to a group, loaded together
  // per warp, by local head and edge of the chunk: the logit (then s; -1
  // where the edge does not count), u and scale_t
  __shared__ float ws_s[kMaxWarps][3][kMaxHeads][kChunk + 1];
  __shared__ float st_s[kMaxWarps][kMaxHeads];  // a split row's inner
  const Layout& L = a.lay;
  // the first blocks zero the dummy row's edges, alongside the first wave
  // of targets rather than after the last
  if (static_cast<int>(blockIdx.x) < L.tail_blocks) {
    zero_tail<T>(a, blockIdx.x);
    return;
  }
  const int bid = blockIdx.x - L.tail_blocks;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hy = bid / L.tblocks;
  const int h0 = hy * L.hpw, nh = min(L.hpw, a.heads - h0);
  // the warp's target, and its share r of the target's groups
  const int r = warp % L.split;
  const int t = (bid - hy * L.tblocks) * (L.warps / L.split) +
                warp / L.split;
  // the dummy row n-1 is never walked (the tail blocks zero its edges);
  // the target's warps leave together
  if (t >= a.n - 1) return;
  const int ch = a.ch, hid = a.hidden;
  float(*ss)[kChunk + 1] = ws_s[warp][0];
  float(*us)[kChunk + 1] = ws_s[warp][1];
  float(*cs)[kChunk + 1] = ws_s[warp][2];
  // a chunk's [E, heads] rows into the shared rows: logits and scales; a
  // long row's reload, logits, its u (kept in dl) and scales
  const float* const ls[2] = {a.logits, a.scale};
  float(*const lsd[2])[kChunk + 1] = {ss, cs};
  const float* const lus[3] = {a.logits, a.dl, a.scale};
  float(*const lusd[3])[kChunk + 1] = {ss, us, cs};

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

  const float* gt = a.g + static_cast<size_t>(t) * hid;
  const T* v = static_cast<const T*>(a.v);
  T* dv = static_cast<T*>(a.dv);
  // the pair lane's head's column of dl ([E, heads]: edge j at j * heads)
  float* dl = a.dl + h0 + (pair_on ? ph : 0);
  // g rounded to v's type, of the pass's spans
  float gf[S][V];
  auto load_g = [&]() {
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int i = 0; i < V; ++i)
        gf[s][i] = cof[s] >= 0 ? round_to<T>(gt[cof[s] + i]) : 0.f;
  };
  load_g();
  // the pair lane's head: the forward's max and denominator
  const size_t th = static_cast<size_t>(t) * a.heads + h0 + (pair_on ? ph : 0);
  const float m = a.stats_max[th], den = a.stats_den[th];
  int rlo, rhi;
  row_bounds(a.row_ptr, t, lane, &rlo, &rhi);
  const int nchunk = (rhi - rlo + kChunk - 1) / kChunk;
  // the warp's groups of a chunk start at r * G, one in `split`
  const int g0 = r * G, gstep = L.split * G;

  // the v words of group u0's counted edges
  auto fetch_v = [&](int j0, int cnt, int u0, Rg (&vx)[G][S]) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const T* row = v + static_cast<size_t>(j0 + u0 + g) * hid;
#pragma unroll
      for (int s = 0; s < S; ++s)
        vx[g][s] = u0 + g < cnt && cof[s] >= 0 &&
                           counts(row_at(ss, hl[s], u0 + g))
                       ? Sp::template load<kStream>(row + cof[s])
                       : Sp::zero();
    }
  };
  auto dots = [&](const Rg (&vx)[G][S], float (&pu)[G][S]) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float y[V];
        Sp::unpack(vx[g][s], y);
#pragma unroll
        for (int i = 0; i < V; ++i) pu[g][s] = fmaf(gf[s][i], y[i], pu[g][s]);
      }
  };

  // pass 1: u = g·v, G edges at a time; the pair lanes form s and add
  // s · scale · u to their share of inner
  float inner = 0.f;
  for (int c = 0; c < nchunk; ++c) {
    const int j0 = rlo + c * kChunk;
    const int cnt = min(kChunk, rhi - j0);
    if (c > 0) __syncwarp();  // the previous chunk's values are spent
    chunk_to_shared<G, 2>(ls, a.heads, h0, nh, j0, cnt, lane, r, L.split,
                          lsd);
    __syncwarp();
    Rg vr[G][S];
    if (L.passes == 1) fetch_v(j0, cnt, g0, vr);
    for (int u0 = g0; u0 < cnt; u0 += gstep) {
      float pu[G][S];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int s = 0; s < S; ++s) pu[g][s] = 0.f;
      if (L.passes == 1) {
        dots(vr, pu);
        // the words are spent: the next group's loads go out into the same
        // registers now, in flight during this group's sums and bookkeeping
        if (u0 + gstep < cnt) fetch_v(j0, cnt, u0 + gstep, vr);
      } else {
        for (int p = 0; p < L.passes; ++p) {
          set_pass(p);
          load_g();
          fetch_v(j0, cnt, u0, vr);
          dots(vr, pu);
        }
      }
      head_dots<G, S>(pu, L);
      const float u = to_pair<G, S>(pu, L, lane);
      const int uu = u0 + pg;
      if (pair_on && uu < cnt) {
        const float l = ss[ph][uu];
        float sg = -1.f;
        if (counts(l)) {
          sg = expf(l - m) / den;
          inner = fmaf(sg * cs[ph][uu], u, inner);
          // a long row's u waits in its dl slot for pass 2
          if (nchunk > 1) dl[static_cast<size_t>(j0 + uu) * a.heads] = u;
        }
        ss[ph][uu] = sg;
        us[ph][uu] = u;
      }
    }
  }
  inner = pair_sum<G>(inner);
  if (L.split > 1) {
    // a split row: each head's inner, the target's warps' shares added in
    // the order of the warps
    if (pair_on && pg == 0) st_s[warp][ph] = inner;
    target_barrier(warp, L.split);
    if (pair_on) {
      inner = 0.f;
      for (int i = 0; i < L.split; ++i) inner += st_s[warp - r + i][ph];
    }
  }
  __syncwarp();

  // pass 2, G edges at a time: the pair lanes form dl and alpha (rounded
  // to v's type) and write dl; each slot takes its head's alpha by a
  // shuffle and stores the edge's dv words (zeros for an edge that does
  // not count, from the same warp)
  for (int p = 0; p < L.passes; ++p) {
    if (L.passes > 1) {
      set_pass(p);
      load_g();
    }
    for (int c = 0; c < nchunk; ++c) {
      const int j0 = rlo + c * kChunk;
      const int cnt = min(kChunk, rhi - j0);
      if (nchunk > 1) {
        // a long row's chunk: the logits, u and scales again
        __syncwarp();
        chunk_to_shared<G, 3>(lus, a.heads, h0, nh, j0, cnt, lane, r,
                              L.split, lusd);
        __syncwarp();
      }
      for (int u0 = g0; u0 < cnt; u0 += gstep) {
        const int uu = u0 + pg;
        float pal = 0.f;
        if (pair_on && uu < cnt) {
          float pdl = 0.f;
          const float x = ss[ph][uu];
          // s: kept from pass 1 (-1: does not count), or a long row's
          // recomputed from its logit
          const bool ok = nchunk > 1 ? counts(x) : x >= 0.f;
          if (ok) {
            const float sg = nchunk > 1 ? expf(x - m) / den : x;
            const float sc = cs[ph][uu];
            pdl = sg * (sc * us[ph][uu] - inner);
            pal = round_to<T>(sg * sc);
          }
          // the last pass: a long row reads u from dl's column until then
          if (p == L.passes - 1)
            dl[static_cast<size_t>(j0 + uu) * a.heads] = pdl;
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const size_t row = static_cast<size_t>(j0 + u0 + g) * hid;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const float al = __shfl_sync(kFull, pal, hl[s] * G + g);
            if (u0 + g >= cnt || cof[s] < 0) continue;
            float ov[V];
#pragma unroll
            for (int i = 0; i < V; ++i) ov[i] = al * gf[s][i];
            Sp::template store<kStream>(dv + row + cof[s], ov);
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32)
    softmax_aggregate_bwd_empty_kernel() {}

template <typename T, int SPAN, int W>
cudaError_t launch_sw(const Args& a, int slabs, int streamed,
                      cudaStream_t stream) {
  const dim3 grid(a.lay.main_blocks + a.lay.tail_blocks),
      block(a.lay.warps * 32);
  if (slabs == 1 && streamed)
    softmax_aggregate_bwd_kernel<T, SPAN, W, 1, true>
        <<<grid, block, 0, stream>>>(a);
  else if (slabs == 1)
    softmax_aggregate_bwd_kernel<T, SPAN, W, 1, false>
        <<<grid, block, 0, stream>>>(a);
  else if (streamed)
    softmax_aggregate_bwd_kernel<T, SPAN, W, 2, true>
        <<<grid, block, 0, stream>>>(a);
  else
    softmax_aggregate_bwd_kernel<T, SPAN, W, 2, false>
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
// per warp, warps per target, warps per block, tail blocks >= 1; streamed
// loads and stores) does not fit the shape, the type or v's base address. The caller guarantees: n >=
// 1, hidden = heads * ch, contiguous tensors of the types above, row_ptr
// nondecreasing with row_ptr[n] <= e_total, and dl and dv aligned to 16
// bytes.
int softmax_aggregate_bwd(const void* logits, const void* scale,
                          const void* v, const void* row_ptr, const void* g,
                          const void* stats_max, const void* stats_den,
                          void* dl, void* dv, int n, int e_total,
                          int hidden, int heads, int is_bf16, int span,
                          int word, int slabs, int hpw, int split, int warps,
                          int tail_blocks, int streamed, void* stream) {
  Args a;
  const void* ptrs[] = {v};
  if (tail_blocks < 1 ||
      !make_layout(n, hidden, heads, is_bf16 ? 2 : 4, span, word, slabs,
                   hpw, split, warps, tail_blocks, ptrs, 1, &a.lay) ||
      reinterpret_cast<uintptr_t>(dl) % 16 ||
      reinterpret_cast<uintptr_t>(dv) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  a.logits = static_cast<const float*>(logits);
  a.scale = static_cast<const float*>(scale);
  a.v = v;
  a.row_ptr = static_cast<const int*>(row_ptr);
  a.g = static_cast<const float*>(g);
  a.stats_max = static_cast<const float*>(stats_max);
  a.stats_den = static_cast<const float*>(stats_den);
  a.dl = static_cast<float*>(dl);
  a.dv = dv;
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
// that a chain of backward calls cannot go below.
int softmax_aggregate_bwd_empty(int n, int hidden, int heads, int is_bf16,
                                int span, int word, int slabs, int hpw,
                                int split, int warps, int tail_blocks,
                                void* stream) {
  Layout L;
  if (tail_blocks < 1 ||
      !make_layout(n, hidden, heads, is_bf16 ? 2 : 4, span, word, slabs, hpw,
                   split, warps, tail_blocks, nullptr, 0, &L))
    return static_cast<int>(cudaErrorInvalidValue);
  softmax_aggregate_bwd_empty_kernel<<<L.main_blocks + L.tail_blocks,
                                       L.warps * 32, 0,
                                       static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
