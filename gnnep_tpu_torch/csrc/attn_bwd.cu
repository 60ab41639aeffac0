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
// What bounds it on this card: bytes. It reads k and v of every live edge
// (k twice, the second time mostly from L1 or L2) and writes dk and dv for
// all E rows, at about ten operations per element, far under the ridge.
//
// Design: the forward's (attn_fwd.cu, attn_kv.cuh), against the previous
// (element-wise) design's five limits:
//  1. Wide words: q, k and v loaded, and dq, dk and dv stored, in the
//     widest word (16, 8, 4 or 2 bytes) the span and the bases of q, k and
//     v allow (the outputs are the wrapper's own 16-byte aligned tensors).
//  2. Rows in flight. Pass 1 loads the k and v words of G = 4 edges, with
//     mask2 and scale_t, before the two dot products, and the next group's
//     into the same registers as soon as the products have spent them;
//     pass 2 loads the k words of a group's live edges before it forms dl,
//     so the dq sum no longer waits on each load; then it adds dl · k to dq
//     and stores the group's dk and dv words.
//  3. s and u on chip. After a group's dot products the pair lanes take
//     q·k and g·v, form s, add s · scale · u to their share of inner, and
//     write s, u and scale_t to shared memory; in pass 2 they form dl and
//     alpha, and each slot takes its head's by a shuffle. Only a row of
//     more than 32 edges writes s and u to the [heads, E] scratches in
//     pass 1 and reads them back chunk by chunk.
//  4. One launch. The grid's first blocks zero the dk and dv rows of the
//     dummy row's edges [row_ptr[n-1], E) in 16-byte stores, alongside the
//     first wave of targets; the previous design did this in a second kernel
//     (zero_tail_kernel), a second launch floor per call.
//  5. A warp holds a slab of heads (all 4 of a flagship bf16 row, 2 of an
//     f32 one), or one head of more than 32 spans: one contiguous run of
//     each row, and row_ptr, mask2, q, g and the stats loaded once per
//     warp. Pass 2 reads k again (from L1 or L2) rather than keeping it
//     from pass 1: kept in registers it cost occupancy and was slower at
//     the flagship (PERF.md §6, PR 9).
// A conv with few targets splits its rows over 2 warps, as the forward
// does (attn_fwd.cu), adding the warps' shares of inner, then their
// partial dq sums, in a fixed order.
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
  const float* g;
  const float* stats_max;
  const float* stats_den;
  void* dq;
  void* dk;
  void* dv;
  float* s_s;  // [heads, E] scratch, for rows of more than 32 edges
  float* u_s;  // [heads, E] scratch, for rows of more than 32 edges
  int n, e_total, hidden, heads, ch;
  float inv_sqrt_ch;
  Layout lay;
};

// zero the dk and dv rows [row_ptr[n-1], E): blocks `tb` of `L.tail_blocks`
template <typename T>
__device__ void zero_tail(const Args& a, int tb) {
  const size_t row_bytes = static_cast<size_t>(a.hidden) * sizeof(T);
  char* const rows[2] = {static_cast<char*>(a.dk), static_cast<char*>(a.dv)};
  zero_bytes<2>(rows, static_cast<size_t>(a.row_ptr[a.n - 1]) * row_bytes,
                static_cast<size_t>(a.e_total) * row_bytes,
                static_cast<size_t>(tb) * blockDim.x + threadIdx.x,
                static_cast<size_t>(a.lay.tail_blocks) * blockDim.x);
}

// SPAN bytes a slot in words of W bytes, S slots a lane in each pass
template <typename T, int SPAN, int W, int S>
__global__ void __launch_bounds__(kMaxWarps * 32) attn_bwd_kernel(Args a) {
  using Sp = Span<T, SPAN, W>;
  using Rg = typename Sp::Regs;
  constexpr int V = Sp::kVec;
  constexpr int G = kEdges / S;  // edges to a group, loaded together
  // per warp, by local head and edge of the chunk: s, u and scale_t; at
  // the end of a split row, the warp's partial dq sums
  __shared__ float ws_s[kMaxWarps][3][kMaxHeads][kChunk + 1];
  __shared__ float st_s[kMaxWarps][kMaxHeads];  // a split row's inner
  const Layout& L = a.lay;
  // the first blocks zero the dummy row's rows, alongside the first wave
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
  if (t >= a.n) return;  // the target's warps leave together
  const int ch = a.ch, hid = a.hidden;
  const size_t e_total = static_cast<size_t>(a.e_total);
  float(*ss)[kChunk + 1] = ws_s[warp][0];
  float(*us)[kChunk + 1] = ws_s[warp][1];
  float(*cs)[kChunk + 1] = ws_s[warp][2];

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

  T* dq = static_cast<T*>(a.dq) + static_cast<size_t>(t) * hid;
  if (t == a.n - 1) {
    // the dummy row is never walked; its dq is zero
    if (r > 0) return;
    const float zero[V] = {};
    for (int p = 0; p < L.passes; ++p) {
      set_pass(p);
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (cof[s] >= 0) Sp::store(dq + cof[s], zero);
    }
    return;
  }

  const T* q = static_cast<const T*>(a.q) + static_cast<size_t>(t) * hid;
  const float* gt = a.g + static_cast<size_t>(t) * hid;
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
  const size_t hoff = static_cast<size_t>(h0 + (pair_on ? ph : 0)) * e_total;
  const float* scale = a.scale_t + hoff;
  // q, and g rounded to the input type, of the pass's spans
  float qf[S][V], gf[S][V];
  auto load_qg = [&]() {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      Sp::unpack(cof[s] >= 0 ? Sp::load(q + cof[s]) : Sp::zero(), qf[s]);
#pragma unroll
      for (int i = 0; i < V; ++i)
        gf[s][i] = cof[s] >= 0 ? round_to<T>(gt[cof[s] + i]) : 0.f;
    }
  };
  load_qg();
  // the pair lane's head: the forward's max and denominator
  const size_t th = static_cast<size_t>(t) * a.heads + h0 + (pair_on ? ph : 0);
  const float m = a.stats_max[th], den = a.stats_den[th];
  int rlo, rhi;
  row_bounds(a.row_ptr, t, lane, &rlo, &rhi);
  const int nchunk = (rhi - rlo + kChunk - 1) / kChunk;
  // the warp's groups of a chunk start at r * G, one in `split`
  const int g0 = r * G, gstep = L.split * G;

  // the k and v words of group u0 (edges in range) and the pair lane's
  // scale_t
  auto fetch_kv = [&](int j0, int cnt, int u0, Rg (&kx)[G][S],
                      Rg (&vx)[G][S], float& scx) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const size_t row = static_cast<size_t>(j0 + u0 + g) * hid;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const bool on = u0 + g < cnt && cof[s] >= 0;
        kx[g][s] = on ? Sp::load(k + row + cof[s]) : Sp::zero();
        vx[g][s] = on ? Sp::load(v + row + cof[s]) : Sp::zero();
      }
    }
    scx = pair_on && u0 + pg < cnt ? scale[j0 + u0 + pg] : 0.f;
  };
  auto dots = [&](const Rg (&kx)[G][S], const Rg (&vx)[G][S],
                  float (&pl)[G][S], float (&pu)[G][S]) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float x[V], y[V];
        Sp::unpack(kx[g][s], x);
        Sp::unpack(vx[g][s], y);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          pl[g][s] = fmaf(qf[s][i], x[i], pl[g][s]);
          pu[g][s] = fmaf(gf[s][i], y[i], pu[g][s]);
        }
      }
  };

  // pass 1: q·k and g·v, G edges at a time; the pair lanes form s and add
  // s · scale · u to their share of inner. mask2, scale_t and the first
  // group's words are loaded together, and (one pass) each group's
  // successor's as soon as the group's products are formed
  float inner = 0.f;
  unsigned live = 0;  // the current chunk's live edges
  for (int c = 0; c < nchunk; ++c) {
    const int j0 = rlo + c * kChunk;
    const int cnt = min(kChunk, rhi - j0);
    const float mk = lane < cnt ? a.mask2[j0 + lane] : 0.f;
    Rg kr[G][S], vr[G][S];
    float sc = 0.f, scn = 0.f;
    if (L.passes == 1) fetch_kv(j0, cnt, g0, kr, vr, scn);
    live = __ballot_sync(kFull, mk > 0.f);
    for (int u0 = g0; u0 < cnt; u0 += gstep) {
      float pl[G][S], pu[G][S];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int s = 0; s < S; ++s) pl[g][s] = pu[g][s] = 0.f;
      if (L.passes == 1) {
        sc = scn;
        dots(kr, vr, pl, pu);
        // the words are spent: the next group's loads go out into the same
        // registers now, in flight during this group's sums and bookkeeping
        if (u0 + gstep < cnt) fetch_kv(j0, cnt, u0 + gstep, kr, vr, scn);
      } else {
        for (int p = 0; p < L.passes; ++p) {
          set_pass(p);
          load_qg();
          fetch_kv(j0, cnt, u0, kr, vr, sc);
          dots(kr, vr, pl, pu);
        }
      }
      const unsigned gl = (live >> u0) & ((1u << G) - 1u);
      head_dots<G, S>(pl, L);
      head_dots<G, S>(pu, L);
      const float l = to_pair<G, S>(pl, L, lane) * a.inv_sqrt_ch;
      const float u = to_pair<G, S>(pu, L, lane);
      if (pair_on && (gl >> pg) & 1u) {
        const float sg = expf(l - m) / den;
        inner = fmaf(sg * sc, u, inner);
        ss[ph][u0 + pg] = sg;
        us[ph][u0 + pg] = u;
        cs[ph][u0 + pg] = sc;
        if (nchunk > 1) {
          const size_t at = hoff + j0 + u0 + pg;
          a.s_s[at] = sg;
          a.u_s[at] = u;
        }
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

  // pass 2, G edges at a time: the k words of the live edges loaded first;
  // meanwhile the pair lanes form dl and alpha,
  // rounded to the input type, and each slot takes its head's; then
  // dq += dl · k, and the edges' dk and dv words are stored (zeros for dead
  // edges, from the same warp)
  for (int p = 0; p < L.passes; ++p) {
    if (L.passes > 1) {
      set_pass(p);
      load_qg();
    }
    float acc[S][V];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[s][i] = 0.f;
    for (int c = 0; c < nchunk; ++c) {
      const int j0 = rlo + c * kChunk;
      const int cnt = min(kChunk, rhi - j0);
      if (nchunk > 1) {
        // a long row's chunk: liveness, s, u and scale_t again, lane u
        // holding edge u
        __syncwarp();
        const bool mine = lane < cnt && a.mask2[j0 + lane] > 0.f;
        live = __ballot_sync(kFull, mine);
        for (int h = 0; h < nh; ++h)
          if (mine) {
            const size_t at = static_cast<size_t>(h0 + h) * e_total + j0 +
                              lane;
            ss[h][lane] = a.s_s[at];
            us[h][lane] = a.u_s[at];
            cs[h][lane] = a.scale_t[at];
          }
        __syncwarp();
      }
      auto fetch_k = [&](int u0, Rg (&kx)[G][S]) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const size_t row = static_cast<size_t>(j0 + u0 + g) * hid;
#pragma unroll
          for (int s = 0; s < S; ++s)
            kx[g][s] = u0 + g < cnt && ((live >> (u0 + g)) & 1u) &&
                               cof[s] >= 0
                           ? Sp::load(k + row + cof[s])
                           : Sp::zero();
        }
      };
      Rg kr[G][S];
      fetch_k(g0, kr);
      for (int u0 = g0; u0 < cnt; u0 += gstep) {
        const unsigned gl = (live >> u0) & ((1u << G) - 1u);
        float pdl = 0.f, pal = 0.f;
        if (pair_on && (gl >> pg) & 1u) {
          const float sg = ss[ph][u0 + pg], sc = cs[ph][u0 + pg];
          pdl = round_to<T>(sg * (sc * us[ph][u0 + pg] - inner));
          pal = round_to<T>(sg * sc);
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const size_t row = static_cast<size_t>(j0 + u0 + g) * hid;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const float dl = __shfl_sync(kFull, pdl, hl[s] * G + g);
            const float al = __shfl_sync(kFull, pal, hl[s] * G + g);
            if (u0 + g >= cnt || cof[s] < 0) continue;
            float x[V], ok[V], ov[V];
            Sp::unpack(kr[g][s], x);
#pragma unroll
            for (int i = 0; i < V; ++i) {
              acc[s][i] = fmaf(dl, x[i], acc[s][i]);
              ok[i] = dl * qf[s][i] * a.inv_sqrt_ch;
              ov[i] = al * gf[s][i];
            }
            Sp::store(dk + row + cof[s], ok);
            Sp::store(dv + row + cof[s], ov);
          }
        }
        if (u0 + gstep < cnt) fetch_k(u0 + gstep, kr);
      }
    }
    if (L.split > 1) {
      // a split row: the warps' partial dq sums added in the order of the
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
    if (r > 0) continue;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (cof[s] < 0) continue;
      float x[V];
#pragma unroll
      for (int i = 0; i < V; ++i) x[i] = acc[s][i] * a.inv_sqrt_ch;
      Sp::store(dq + cof[s], x);
    }
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32) attn_bwd_empty_kernel() {}

template <typename T, int SPAN, int W>
cudaError_t launch_sw(const Args& a, int slabs, cudaStream_t stream) {
  const dim3 grid(a.lay.main_blocks + a.lay.tail_blocks),
      block(a.lay.warps * 32);
  if (slabs == 1)
    attn_bwd_kernel<T, SPAN, W, 1><<<grid, block, 0, stream>>>(a);
  else
    attn_bwd_kernel<T, SPAN, W, 2><<<grid, block, 0, stream>>>(a);
  return cudaGetLastError();
}

// the instantiation of (span, word): word a power of two from the element
// size up to the span
template <typename T, int SPAN, int W>
cudaError_t launch_w(const Args& a, int word, int slabs, cudaStream_t s) {
  if (word == W) return launch_sw<T, SPAN, W>(a, slabs, s);
  if constexpr (W / 2 >= static_cast<int>(sizeof(T)))
    return launch_w<T, SPAN, W / 2>(a, word, slabs, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const Args& a, int span, int word, int slabs,
                   cudaStream_t s) {
  switch (span) {
    case 16:
      return launch_w<T, 16, 16>(a, word, slabs, s);
    case 8:
      return launch_w<T, 8, 8>(a, word, slabs, s);
    case 4:
      return launch_w<T, 4, 4>(a, word, slabs, s);
    case 2:
      if constexpr (sizeof(T) == 2) return launch_w<T, 2, 2>(a, word, slabs, s);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue where the plan (span and word bytes, slabs, heads
// per warp, warps per target, warps per block, tail blocks >= 1) does not
// fit the shape, the
// type or a base address. The caller guarantees: n >= 1, hidden = heads *
// ch, contiguous tensors of the types above, row_ptr nondecreasing with
// row_ptr[n] <= e_total, dq, dk and dv aligned to 16 bytes, and scratch
// buffers s_s and u_s f32 [heads, E] (read and written only for rows of
// more than 32 edges). inv_sqrt_ch is 1/sqrt(ch) rounded once to f32, as
// the JAX kernel's constant is.
int attn_bwd(const void* q, const void* k, const void* v, const void* scale_t,
             const void* mask2, const void* row_ptr, const void* g,
             const void* stats_max, const void* stats_den, void* dq,
             void* dk, void* dv, void* s_s, void* u_s, int n, int e_total,
             int hidden, int heads, float inv_sqrt_ch, int is_bf16, int span,
             int word, int slabs, int hpw, int split, int warps,
             int tail_blocks, void* stream) {
  Args a;
  const void* ptrs[] = {q, k, v};
  if (tail_blocks < 1 ||
      !make_layout(n, hidden, heads, is_bf16 ? 2 : 4, span, word, slabs,
                   hpw, split, warps, tail_blocks, ptrs, 3, &a.lay) ||
      reinterpret_cast<uintptr_t>(dq) % 16 ||
      reinterpret_cast<uintptr_t>(dk) % 16 ||
      reinterpret_cast<uintptr_t>(dv) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
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
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(a, span, word, slabs, s)
              : launch<float>(a, span, word, slabs, s);
  return static_cast<int>(err);
}

// An empty kernel on the grid and block of the plan: the launch latency
// that a chain of backward calls cannot go below.
int attn_bwd_empty(int n, int hidden, int heads, int is_bf16, int span,
                   int word, int slabs, int hpw, int split, int warps,
                   int tail_blocks, void* stream) {
  Layout L;
  if (tail_blocks < 1 ||
      !make_layout(n, hidden, heads, is_bf16 ? 2 : 4, span, word, slabs, hpw,
                   split, warps, tail_blocks, nullptr, 0, &L))
    return static_cast<int>(cudaErrorInvalidValue);
  attn_bwd_empty_kernel<<<L.main_blocks + L.tail_blocks, L.warps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
