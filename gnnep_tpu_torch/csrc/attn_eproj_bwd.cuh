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
// Design. Two kernels. A block of the first owns a tile of consecutive
// targets, so one contiguous range of the dst-sorted arena, and one head;
// each edge row of dkv and dea has exactly one writer.
//
//  Tiles are cut by edges, not by target count: the wrapper passes
//  tile_ptr [tiles + 1], the first target of each tile, from the rule in
//  `attention_eproj.bwd_tile_ptr` (every tile holds about E_live / tiles
//  edges, more only by the in-degree of its last row; the dummy row n-1 is
//  in none), with one wave of (tiles, heads) blocks over the SMs.
//
//  The three E·Fe·H products run on the tensor cores as warp-level
//  `mma.sync` tiles, from operands staged in shared memory:
//   bf16: m16n8k16 bf16 products with f32 accumulators (HMMA), operands
//    read with `ldmatrix` (its .trans form for the operands whose
//    contraction index is not the contiguous one);
//   f32: 3xTF32 on m16n8k8 tf32 tiles: each operand x splits into
//    hi = tf32(x) and lo = tf32(x - hi), and the tile sums lo·hi + hi·lo +
//    hi·hi in f32. Plain TF32 would keep 11 bits of each operand; the split
//    keeps 22, and its error stays at the f32 FMA design's scale
//    (chip_smoke's float64 line). Chosen over a register-blocked FFMA
//    tiling because it shares the bf16 path's tiles and staging and runs
//    at several times the CUDA cores' f32 rate.
//  Every staged tile (ea, de and W_e slices) arrives by `cp.async`
//  (16-byte copies, zero-filled past the ragged edges and for dead rows)
//  into a ring of four stages: three slices' copies are in flight while
//  one slice's products run. Rows or columns whose addresses are not
//  16-byte aligned (an odd Fe in bf16, say) are staged by plain loads. In
//  f32 each slice's products go to a fresh tile, added to the running sum
//  with IEEE adds, so the tensor cores' own accumulation never spans more
//  than one 32-deep slice. Row strides are padded so that the eight rows an
//  `ldmatrix` (or a quarter-warp's scalar fragment loads) touches fall in
//  distinct banks. Past Fe 256 nothing in shared memory grows with Fe or
//  with the head width: a head is walked in column tiles of NW = 16, 32, 64 or 128
//  channels (`tile_width`; a head wider than 128 in tiles of 128, the last
//  zero-filled past ch), and every product streams its operands over its
//  contraction in slices.
//
//  attn_eproj_bwd_attn: 256 threads per (tile, head).
//   Phase 1 recomputes e = ea · W_e[:, h] 64 edges at a time (M 64, N a
//   column tile, K Fe in slices of 32; each warp a 16-row × NW/2 tile).
//   Up to Fe 256 with one column tile (the flagship), W_e's head slice is
//   staged once and stays resident while ea's slices stream through the
//   ring; a wider Fe or head goes through `project` (attn_mma.cuh), which
//   streams W_e's slices with ea's, so shared memory does not grow with Fe
//   (streaming at the
//   flagship cost 12-14 % of the kernel: PERF.md §6). It puts e in
//   shared memory and writes each edge's k row to scratch (each thread's
//   channels of a row as one vector access), and its logit and u after
//   the head's last column tile.
//   Phase 2 gives each warp one target at a time: inner_t over the row, then
//   dl and the rounded alpha of 32 edges at a time, then per edge the dk, dv
//   and de rows and the running dq, two channels a lane (bf16x2 / float2
//   loads and stores where ch is even), the k rows of four edges loaded
//   before any is used. A head wider than NW is walked in passes of NW
//   channels; dl and alpha are recomputed in each pass by the same
//   instructions from the same values, so they round alike in every pass.
//   Phase 3 sums ea_jᵀ de_j over the tile's edges (M Fe in passes of 128,
//   N a column tile, K the tile's edges in slices of 32; ea enters with Fe
//   contiguous, so as the transposed operand; each warp a 32 × NW/2 tile)
//   and adds its dW_e slice with one atomic add per (tile, Fe row, column):
//   CUDA blocks run in no order, so the TPU kernel's sum over its
//   sequential grid into one resident block has no counterpart.
//  attn_eproj_bwd_dea: one block per 64 edges, dea = de · W_eᵀ over all
//   heads (M 64, N Fe in passes of 128, K H in slices of 32), and zero
//   rows of dkv for every dead edge (a warp per row).
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
//    kernel; its de row is staged as zero for both products. dq of the
//    dummy row is written as zero. With Span a dead edge never reads kvn
//    and adds nothing to it.
//  - All-masked rows keep max -1e30: s is only formed for live edges, so no
//    exp of a huge argument and no inf·0 can arise.
//  - bf16 rounding mirrors the TPU kernel (csr_attention.py:1194-1243): e, k
//    and v round to the input type; g rounds to it before u and dv; dl and
//    alpha round to it; dq, dk, dv and de round to it after f32 sums; dea
//    rounds after its f32 product. dW_e stays f32.
//  - Padding: Fe is padded to 32 and ch to its column tiles inside the
//    kernel (zero-filled staging), the ragged last chunk and slice are zero
//    rows.
//
// What bounds it on this card. The three products are about 26 GFLOP a
// launch at the flagship line-graph conv (E 74,880, Fe = H = 256) against
// about 220 MB (f32) or 120 MB (bf16) of traffic. Before this design they
// ran as f32 FMAs (1.9 / 2.6 ms); on the tensor cores they no longer set
// the time in bf16: copies of this header with a `return` after phase 1
// or phase 2, timed by dev/bwd_bench.py on an H100 (PERF.md §6), put
// 0.18 ms in phase 1 (mostly its epilogue's gathers of kv, q and g rows),
// 0.22 in phase 2's per-edge walk, 0.10 in phase 3 and 0.13 in the dea
// kernel, about 10× the bytes bound in all. In f32 the 3xTF32
// products still dominate (phase 1 0.37, phase 3 0.24, dea 0.31 ms): three
// tf32 products and the operand splits per tile run at about a tenth of
// the tensor cores' tf32 rate.
// Registers and occupancy: both kernels are built for two resident
// 256-thread blocks per SM (`__launch_bounds__(256, 2)`, at most 128
// registers a thread; nvcc's report in chip_smoke's build phase shows
// them). At the flagship (ch 64) the attention kernel's shared memory (f32:
// W_e's slice 73.7 KB, the ring 18.4 KB, e 17.4 KB; bf16 75 KB) fits two
// blocks on an SM; the tiles make one wave of 2 · SMs blocks, so one
// block's products overlap the other's latency-bound phase 2.

#pragma once

#include "attn_mma.cuh"

namespace {

constexpr int kRows3 = 128;             // dW_e rows per phase-3 pass (M)
constexpr int kEdges3 = 32;             // edges per phase-3 slice (K)
constexpr int kCols = 128;              // dea columns per pass (N)
constexpr int kUnroll = 4;              // phase 2: edges whose loads overlap

struct Args {
  const void* q;
  const void* kv;
  const void* ea;
  const void* w_edge;
  const float* scale_t;
  const float* mask2;
  const int* row_ptr;
  const int* tile_ptr;   // [tiles + 1] first target of each tile
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
  int n, e_total, hidden, fe, heads, ch, ntiles, tiles;
  float inv_sqrt_ch;
};

// ------------------------------------------------------ shared memory
// Depth of each staging ring: slices in flight. Phase 1 with W_e resident
// keeps two in f32, so that W_e's f32 slice, the ring and e fit two blocks
// on an SM.
constexpr int kP1 = 4, kP3 = 4, kDeaStages = 4;
template <typename T>
constexpr int kP1Resident = sizeof(T) == 4 ? 2 : 4;
// W_e's head slice stays resident in phase 1 up to this Fe (the flagship's
// 256); a wider Fe, or a head wider than 128, streams it with ea
constexpr int kResidentFe = 256;

// The attention kernel's shared memory for column tiles of NW: phase 1's
// or phase 3's (the ring of (ea, de) slice pairs), whichever is larger.
// Phase 1 streams W_e (`ProjLayout`: the ring of ea and W_e slices, e) or
// keeps its head slice [Fe][NW] resident beside a ring
// of ea slices and e. Row strides pad K-contiguous tiles by Op<T>::kPadK
// and the others by kPadMN, so that each fragment load's eight rows (or a
// quarter-warp's scalar loads) fall in distinct banks.
template <typename T, int NW>
struct Layout {
  static constexpr int kLdW = NW + kPadMN;          // [Fe][NW]
  static constexpr int kLdA1 = kKs + Op<T>::kPadK;  // [64][32]
  static constexpr int kLdE = NW + 4;               // f32 [64][NW]
  static constexpr int kA1 = kChunk * kLdA1;
  static constexpr int kLdEa3 = kRows3 + kPadMN;  // [32][128]
  static constexpr int kLdDe3 = NW + kPadMN;      // [32][NW]
  static constexpr int kEa3 = kEdges3 * kLdEa3, kDe3 = kEdges3 * kLdDe3;
  static constexpr size_t kStream = ProjLayout<T, NW, 1, kP1>::kBytes;
  static constexpr size_t kP3Bytes = sizeof(T) * kP3 * (kEa3 + kDe3);
  static size_t resident(int fe_pad) {
    return sizeof(T) * (static_cast<size_t>(fe_pad) * kLdW +
                        kP1Resident<T> * kA1) +
           sizeof(float) * kChunk * kLdE;
  }
  static size_t bytes(bool resident_w, int fe_pad) {
    const size_t p1 = resident_w ? resident(fe_pad) : kStream;
    return p1 > kP3Bytes ? p1 : kP3Bytes;
  }
};

// dea kernel: the ring of (de, W_e) slice pairs
template <typename T>
struct DeaLayout {
  static constexpr int kLd = kKs + Op<T>::kPadK;  // [64][32] and [128][32]
  static constexpr size_t kA = kChunk * kLd, kB = kCols * kLd;
  static constexpr size_t kBytes = sizeof(T) * kDeaStages * (kA + kB);
};

// ----------------------------------------------------------- phase 1
// Epilogue of one projection tile: chunk e0 ∩ [.., hi), head h, column tile
// nt of NW channels, e in shared memory (f32 [64][ld_e]): k, v, and each
// edge's partial logit and u (pl, pu, carried across the head's column
// tiles; the logit and u are written after its last). A thread owns 4 edges
// × CPT = NW / 16 consecutive channels, loaded and stored as one access
// each where ch is a multiple of CPT; the 16 threads of an edge are a
// half-warp.
template <typename T, int NW, bool Span, typename E>
__device__ __forceinline__ void bwd_epilogue(const Args& a, int e0, int hi,
                                             int h, int nt, const E* e_s,
                                             int ld_e, float (&pl)[4],
                                             float (&pu)[4]) {
  constexpr int CPT = NW / 16;
  const int tid = threadIdx.x;
  const int cg = tid % 16, eg = tid / 16;  // channel group, edge group
  const T* kv = static_cast<const T*>(a.kv);
  const T* q = static_cast<const T*>(a.q);
  T* k_s = static_cast<T*>(a.k_s);
  const int hid = a.hidden, ch = a.ch;
  const int c0 = nt * NW + cg * CPT, left = ch - c0;  // this thread's channels
  const bool vec =
      ch % CPT == 0 &&
      (reinterpret_cast<uintptr_t>(kv) | reinterpret_cast<uintptr_t>(q) |
       reinterpret_cast<uintptr_t>(k_s)) % (sizeof(T) * CPT) == 0 &&
      reinterpret_cast<uintptr_t>(a.g) % (sizeof(float) * CPT) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = eg * 4 + i, j = e0 + r;
    const bool valid = j < hi;
    long long row = j;  // Span: the kv row, -1 for a dead edge (none read)
    if constexpr (Span) row = (valid && a.mask2[j] > 0.f) ? a.src[j] : -1;
    const int n_ok = valid ? left : 0;
    const int n_kv = (Span ? row >= 0 : valid) ? left : 0;
    const size_t kvb =
        static_cast<size_t>(row < 0 ? 0 : row) * 2 * hid + h * ch + c0;
    const size_t tb =
        static_cast<size_t>(valid ? a.dst[j] : 0) * hid + h * ch + c0;
    float kx[CPT], vx[CPT], qx[CPT], gx[CPT], kr[CPT];
    load_n<T, CPT>(kx, kv + kvb, vec, n_kv);
    load_n<T, CPT>(vx, kv + kvb + hid, vec, n_kv);
    load_n<T, CPT>(qx, q + tb, vec, n_ok);
    load_n<float, CPT>(gx, a.g + tb, vec, n_ok);
    if (nt == 0) pl[i] = pu[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const float e = round_to<T>(load_f(e_s + r * ld_e + cg * CPT + c));
      kr[c] = round_to<T>(kx[c] + e);
      const float v = round_to<T>(vx[c] + e);
      if (c < n_ok) {
        pl[i] = fmaf(qx[c], kr[c], pl[i]);
        pu[i] = fmaf(round_to<T>(gx[c]), v, pu[i]);
      }
    }
    store_n<T, CPT>(k_s + static_cast<size_t>(j) * hid + h * ch + c0, kr, vec,
                    n_ok);
    if (nt == a.ntiles - 1) {
      float l = pl[i], u = pu[i];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        l += __shfl_xor_sync(kFull, l, o);
        u += __shfl_xor_sync(kFull, u, o);
      }
      if (valid && cg == 0) {
        const size_t hj = static_cast<size_t>(h) * a.e_total + j;
        a.logit_s[hj] = l * a.inv_sqrt_ch;
        a.u_s[hj] = u;
      }
    }
  }
}

// NW: the column tile (16, 32, 64 or 128; `tile_width`); Resident: W_e's
// head slice resident in phase 1 (Fe <= kResidentFe, one column tile)
template <typename T, int NW, bool Span, bool Resident>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    attn_eproj_bwd_attn_kernel(Args a) {
  constexpr int NT = NW / 16;                // n8 tiles of a warp's NW/2 columns
  constexpr int CPP = (NW / 2 + 31) / 32;    // phase 2: channel pairs a lane
  using L = Layout<T, NW>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float dl_w[kWarps][32];
  __shared__ float al_w[kWarps][32];
  // per edge of a warp's batch: 0 if dead; else 1, or with Span the kv
  // row + 1
  __shared__ int live_w[kWarps][32];
  const int h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;  // the warp's tile in M and N
  const int ch = a.ch, hid = a.hidden, fe = a.fe;
  // column tiles of the head (one wherever W_e is resident)
  const int ntiles = Resident ? 1 : a.ntiles;

  const int t0 = a.tile_ptr[blockIdx.x], t1 = a.tile_ptr[blockIdx.x + 1];
  // the dummy row n-1 is never walked; its dq is zero
  if (blockIdx.x == gridDim.x - 1) {
    T* dq = static_cast<T*>(a.dq);
    for (int c = tid; c < ch; c += kThreads)
      store_t(dq + static_cast<size_t>(a.n - 1) * hid + h * ch + c, 0.f);
  }
  if (t0 >= t1) return;
  const int lo = a.row_ptr[t0], hi = a.row_ptr[t1];
  const T* ea = static_cast<const T*>(a.ea);

  // phase 1: logit, u and k of the tile's edges, 64 at a time
  {
    float pl[4], pu[4];
    // one projection chunk per tile (MT 1), so one set of partial sums
    auto epi = [&](int, int e0, int, int nt, const auto* e_s, int ld_e) {
      bwd_epilogue<T, NW, Span>(a, e0, hi, h, nt, e_s, ld_e, pl, pu);
    };
    if constexpr (Resident) {
      // W_e's head slice [fe_pad][NW] resident, ea slices through the ring
      constexpr int S = kP1Resident<T>;
      const int fe_pad = (fe + kKs - 1) / kKs * kKs;
      T* w_s = reinterpret_cast<T*>(smem_raw);
      T* a_s = w_s + static_cast<size_t>(fe_pad) * L::kLdW;
      float* e_s = reinterpret_cast<float*>(a_s + S * L::kA1);
      stage<T, NW>(w_s, L::kLdW, fe_pad, static_cast<const T*>(a.w_edge),
                   hid, 0, fe, h * ch, h * ch + ch, AllRows{});
      cp_async_commit();
      const int nks = fe_pad / kKs;
      const int steps = (hi - lo + kChunk - 1) / kChunk * nks;
      float acc[1][NT][4];
      pipeline<S>(
          steps,
          [&](int s) {
            stage<T, kKs>(a_s + s % S * L::kA1, L::kLdA1, kChunk, ea, fe,
                          lo + (s / nks) * kChunk, hi, (s % nks) * kKs, fe,
                          AllRows{});
          },
          [&](int s) {
            const int ks = s % nks;
            slice_mma<T, 1, NT, kKs, true, false>(
                acc, ks == 0, a_s + s % S * L::kA1, L::kLdA1, 16 * wm,
                w_s + ks * kKs * L::kLdW, L::kLdW, wn * (NW / 2));
            if (ks != nks - 1) return;
            const int g = lane >> 2, t = lane & 3;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const int r = 16 * wm + g, c = wn * (NW / 2) + 8 * nt + 2 * t;
              e_s[r * L::kLdE + c] = acc[0][nt][0];
              e_s[r * L::kLdE + c + 1] = acc[0][nt][1];
              e_s[(r + 8) * L::kLdE + c] = acc[0][nt][2];
              e_s[(r + 8) * L::kLdE + c + 1] = acc[0][nt][3];
            }
            __syncthreads();
            epi(0, lo + (s / nks) * kChunk, h, 0, e_s, L::kLdE);
          });
    } else {
      // W_e streamed over Fe with ea
      project<T, NW, 1, kP1, true>(
          smem_raw, ea, static_cast<const T*>(a.w_edge), fe, hid, ch, lo, hi,
          h, ntiles, epi);
    }
  }
  __syncthreads();  // phase 1's scratch writes are visible to the block

  // phase 2: one warp per target; a head wider than NW in passes of NW
  // channels, dl and alpha recomputed in each pass by the same
  // instructions from the same values
  const T* q = static_cast<const T*>(a.q);
  const T* k_s = static_cast<const T*>(a.k_s);
  T* dkv = static_cast<T*>(a.dkv);
  T* de_s = static_cast<T*>(a.de_s);
  T* dq = static_cast<T*>(a.dq);
  const float* logit = a.logit_s + static_cast<size_t>(h) * a.e_total;
  const float* u_h = a.u_s + static_cast<size_t>(h) * a.e_total;
  const float* scale = a.scale_t + static_cast<size_t>(h) * a.e_total;
  const bool vec = (ch & 1) == 0;
  for (int t = t0 + warp; t < t1; t += kWarps) {
    const int rlo = a.row_ptr[t], rhi = a.row_ptr[t + 1];
    const float m = a.stats_max[static_cast<size_t>(t) * a.heads + h];
    const float den = a.stats_den[static_cast<size_t>(t) * a.heads + h];
    const size_t tb = static_cast<size_t>(t) * hid + h * ch;
    float inner = 0.f;
    for (int j = rlo + lane; j < rhi; j += 32) {
      if (a.mask2[j] > 0.f) {
        const float s = expf(logit[j] - m) / den;
        inner = fmaf(s * scale[j], u_h[j], inner);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) inner += __shfl_xor_sync(kFull, inner, o);

    for (int pass = 0; pass < ntiles; ++pass) {
      // this lane's channel pairs: pass · NW + 2 (lane + 32 i), below NW
      float2 qr[CPP], gr[CPP], dqa[CPP];
#pragma unroll
      for (int i = 0; i < CPP; ++i) {
        const int cc = 2 * (lane + 32 * i);
        const int c = cc < NW ? pass * NW + cc : ch;
        qr[i] = load2(q + tb, c, ch, vec);
        gr[i] = load2(a.g + tb, c, ch, vec);
        gr[i] = make_float2(round_to<T>(gr[i].x), round_to<T>(gr[i].y));
        dqa[i] = make_float2(0.f, 0.f);
      }
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
        // kUnroll edges at a time: their k rows are loaded before any is
        // used
        const int cnt = min(32, rhi - j0);
        for (int u0 = 0; u0 < cnt; u0 += kUnroll) {
          float2 kf[kUnroll][CPP];
#pragma unroll
          for (int v = 0; v < kUnroll; ++v) {
            const int u = u0 + v;
            const bool ok = u < cnt && live_w[warp][u];
            const T* krow = k_s + static_cast<size_t>(j0 + u) * hid + h * ch;
#pragma unroll
            for (int i = 0; i < CPP; ++i) {
              const int cc = 2 * (lane + 32 * i);
              kf[v][i] = ok && cc < NW ? load2(krow, pass * NW + cc, ch, vec)
                                       : make_float2(0.f, 0.f);
            }
          }
#pragma unroll
          for (int v = 0; v < kUnroll; ++v) {
            const int u = u0 + v;
            if (u >= cnt || !live_w[warp][u]) continue;
            const size_t jj = static_cast<size_t>(j0 + u);
            const float dlu = dl_w[warp][u], alu = al_w[warp][u];
#pragma unroll
            for (int i = 0; i < CPP; ++i) {
              const int cc = 2 * (lane + 32 * i), c = pass * NW + cc;
              if (cc >= NW || c >= ch) continue;
              const float dk0 = dlu * qr[i].x * a.inv_sqrt_ch;
              const float dk1 = dlu * qr[i].y * a.inv_sqrt_ch;
              const float dv0 = alu * gr[i].x, dv1 = alu * gr[i].y;
              if constexpr (Span) {
                float* acc = a.dkvn_acc +
                             static_cast<size_t>(live_w[warp][u] - 1) * 2 *
                                 hid +
                             h * ch + c;
                atomicAdd(acc, round_to<T>(dk0));
                atomicAdd(acc + hid, round_to<T>(dv0));
                if (c + 1 < ch) {
                  atomicAdd(acc + 1, round_to<T>(dk1));
                  atomicAdd(acc + hid + 1, round_to<T>(dv1));
                }
              } else {
                store2(dkv + jj * 2 * hid + h * ch, c, ch, vec, dk0, dk1);
                store2(dkv + jj * 2 * hid + hid + h * ch, c, ch, vec, dv0,
                       dv1);
              }
              store2(de_s + jj * hid + h * ch, c, ch, vec, dk0 + dv0,
                     dk1 + dv1);
              dqa[i].x = fmaf(dlu, kf[v][i].x, dqa[i].x);
              dqa[i].y = fmaf(dlu, kf[v][i].y, dqa[i].y);
            }
          }
        }
        __syncwarp();
      }
#pragma unroll
      for (int i = 0; i < CPP; ++i) {
        const int cc = 2 * (lane + 32 * i);
        if (cc < NW)
          store2(dq + tb, pass * NW + cc, ch, vec, dqa[i].x * a.inv_sqrt_ch,
                 dqa[i].y * a.inv_sqrt_ch);
      }
    }
  }
  __syncthreads();  // phase 2's de rows are visible; phase 1's memory free

  // phase 3: dW_e[:, h] += sum over the tile's live edges of ea_jᵀ de_j,
  // for each pass of 128 Fe rows and each column tile of the head
  {
    T* ea3 = reinterpret_cast<T*>(smem_raw);   // kP3 × [32][kLdEa3]
    T* de3 = ea3 + kP3 * L::kEa3;              // kP3 × [32][kLdDe3]
    const int slices = (hi - lo + kEdges3 - 1) / kEdges3;
    const int outer = ntiles * slices;
    const int steps = (fe + kRows3 - 1) / kRows3 * outer;
    float acc[2][NT][4];
    pipeline<kP3>(
        steps,
        [&](int s) {
          const int f0 = s / outer * kRows3, nt = s % outer / slices;
          const int e0 = lo + s % slices * kEdges3;
          stage<T, kRows3>(ea3 + s % kP3 * L::kEa3, L::kLdEa3, kEdges3, ea,
                           fe, e0, hi, f0, fe, AllRows{});
          // a dead edge's de row is staged as zero
          stage<T, NW>(de3 + s % kP3 * L::kDe3, L::kLdDe3, kEdges3,
                       static_cast<const T*>(a.de_s), hid, e0, hi,
                       h * ch + nt * NW, h * ch + ch, LiveRows{a.mask2});
        },
        [&](int s) {
          const int f0 = s / outer * kRows3, nt = s % outer / slices;
          const int sl = s % slices;
          if (f0 + 32 * wm >= fe) return;  // rows past Fe: nothing to add
          slice_mma<T, 2, NT, kEdges3, false, false>(
              acc, sl == 0, ea3 + s % kP3 * L::kEa3, L::kLdEa3, 32 * wm,
              de3 + s % kP3 * L::kDe3, L::kLdDe3, wn * (NW / 2));
          if (sl != slices - 1) return;
          const int g = lane >> 2, t = lane & 3;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int n8 = 0; n8 < NT; ++n8)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int f = f0 + 32 * wm + 16 * mt + g + (i >> 1) * 8;
                const int c = nt * NW + wn * (NW / 2) + 8 * n8 + 2 * t + (i & 1);
                const float v = acc[mt][n8][i];
                if (f < fe && c < ch && v != 0.f)
                  atomicAdd(a.dw + static_cast<size_t>(f) * hid + h * ch + c,
                            v);
              }
        });
  }
}

template <typename T, bool Span>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    attn_eproj_bwd_dea_kernel(Args a) {
  using L = DeaLayout<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int S = kDeaStages;
  T* a_s = reinterpret_cast<T*>(smem_raw);  // S × [64][kLd] de slices
  T* b_s = a_s + S * L::kA;                 // S × [128][kLd] W_e slices
  __shared__ int live_s[kChunk];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;
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
    for (int r = warp; r < rows; r += kWarps)  // a warp per dead row
      if (!live_s[r])
        for (int i = lane; i < 2 * hid; i += 32)
          store_t(dkv + static_cast<size_t>(e0 + r) * 2 * hid + i, 0.f);
  }
  const int nks = (hid + kKs - 1) / kKs;
  const int steps = (fe + kCols - 1) / kCols * nks;
  const bool vec = (fe & 1) == 0;
  float acc[1][8][4];
  pipeline<S>(
      steps,
      [&](int s) {
        const int f0 = s / nks * kCols, k0 = s % nks * kKs;
        stage<T, kKs>(a_s + s % S * L::kA, L::kLd, kChunk, de_s, hid, e0,
                      a.e_total, k0, hid, SharedLive{live_s, e0});
        stage<T, kKs>(b_s + s % S * L::kB, L::kLd, kCols, w_edge, hid, f0,
                      fe, k0, hid, AllRows{});
      },
      [&](int s) {
        const int f0 = s / nks * kCols, ks = s % nks;
        if (f0 + 64 * wn >= fe) return;  // columns past Fe
        slice_mma<T, 1, 8, kKs, true, true>(
            acc, ks == 0, a_s + s % S * L::kA, L::kLd, 16 * wm,
            b_s + s % S * L::kB, L::kLd, 64 * wn);
        if (ks != nks - 1) return;
        // dead rows were staged as zero, so their acc is 0
        const int g = lane >> 2, t = lane & 3;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = 16 * wm + g + 8 * half;
            if (r < rows)
              store2(dea + static_cast<size_t>(e0 + r) * fe,
                     f0 + 64 * wn + 8 * nt + 2 * t, fe, vec,
                     acc[0][nt][2 * half], acc[0][nt][2 * half + 1]);
          }
      });
}

template <typename T, int NW, bool Span, bool Resident>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = Layout<T, NW>::bytes(Resident, (a.fe + kKs - 1) / kKs * kKs);
  auto kernel = attn_eproj_bwd_attn_kernel<T, NW, Span, Resident>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.tiles, a.heads), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto dea = attn_eproj_bwd_dea_kernel<T, Span>;
  err = cudaFuncSetAttribute(dea, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(DeaLayout<T>::kBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid_dea((a.e_total + kChunk - 1) / kChunk);
  dea<<<grid_dea, kThreads, DeaLayout<T>::kBytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool Span, bool Resident>
cudaError_t dispatch_width(const Args& a, cudaStream_t stream) {
  switch (tile_width(a.ch)) {
    case 16: return launch<T, 16, Span, Resident>(a, stream);
    case 32: return launch<T, 32, Span, Resident>(a, stream);
    case 64: return launch<T, 64, Span, Resident>(a, stream);
    default: return launch<T, kMaxTile, Span, Resident>(a, stream);
  }
}

template <typename T, bool Span>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  if (a.fe <= kResidentFe && a.ntiles == 1)
    return dispatch_width<T, Span, true>(a, stream);
  return dispatch_width<T, Span, false>(a, stream);
}

// Fill the arguments both entry points share; the caller sets dkv or
// src and dkvn_acc.
Args make_args(const void* q, const void* kv, const void* ea,
               const void* w_edge, const void* scale_t, const void* mask2,
               const void* row_ptr, const void* dst, const void* g,
               const void* stats_max, const void* stats_den, void* dq,
               void* dea, void* dw, void* logit_s, void* u_s, void* k_s,
               void* de_s, int n, int e_total, int hidden, int fe, int heads,
               float inv_sqrt_ch, const void* tile_ptr, int tiles) {
  Args a;
  a.q = q;
  a.kv = kv;
  a.ea = ea;
  a.w_edge = w_edge;
  a.scale_t = static_cast<const float*>(scale_t);
  a.mask2 = static_cast<const float*>(mask2);
  a.row_ptr = static_cast<const int*>(row_ptr);
  a.tile_ptr = static_cast<const int*>(tile_ptr);
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
  a.ntiles = column_tiles(a.ch);
  a.tiles = tiles;
  a.inv_sqrt_ch = inv_sqrt_ch;
  return a;
}

}  // namespace
