// attn_span_fwd.cu: CSR graph attention with the kv gather and the edge
// projection fused in (forward), for Hopper, built for sm_90a.
//
// Replaces the TPU kernel `_attn_sp_kernel` in
// gnnep_tpu/ops/pallas/csr_attention.py (reached there through
// `_attn_sp_forward` ← `csr_attention_span` ← `fused_attention_span`). It
// computes kernel 5's function on kv = kvn[src]: kvn is the conv's
// node-space (k‖v) table [N_src, 2H] and src i64 [E] each edge's source
// row, so no edge-space kv arena [E, 2H] is ever written.
//
// Design: kernel 5's kernel (attn_eproj_fwd.cuh) with its Span flag set,
// which reads kv row src[j] of the node table, and only for a live edge.
// The TPU kernel cannot gather rows inside a kernel: it DMAs a contiguous
// node-table span [SPAN, 2H] per block and gathers from it with a one-hot
// matmul (csr_attention.py:1778-1789). On this card a thread loads row
// src[j] straight from device memory; the table (15.5 MB f32 at the
// flagship line-graph conv, each row read by about ten edges) stays in the
// 50 MB L2. The span, `span_lo` and the one-hot product have no
// counterpart here. The gathered row is exact, as the one-hot product is,
// so the result rounds as kernel 5's does.
//
// What bounds it on this card: as kernel 5, the projection's 2·E·Fe·H
// operations on the CUDA cores (f32 FMAs for both input types); its bytes
// are lower than kernel 5's by the edge-space kv arena it no longer reads.

#include "attn_eproj_fwd.cuh"

extern "C" {

// Dynamic shared memory one block needs; the wrapper refuses shapes above
// the card's per-block limit.
size_t attn_span_fwd_smem_bytes(int fe, int ch) { return smem_bytes(fe, ch); }

// Launches on `stream` and returns cudaGetLastError() (0 = launched). The
// caller guarantees what attn_eproj_fwd's does, with kvn [n_src, 2H] in
// place of kv and 0 <= src[j] < n_src for every live edge j (mask2[j] > 0).
int attn_span_fwd(const void* q, const void* kvn, const void* ea,
                  const void* w_edge, const void* scale_t, const void* mask2,
                  const void* row_ptr, const void* src, const void* dst,
                  void* out, void* stats_max, void* stats_den, void* logit_s,
                  void* v_s, int n, int e_total, int hidden, int fe,
                  int heads, float inv_sqrt_ch, int is_bf16,
                  int rows_per_block, void* stream) {
  const Args a = make_args(q, kvn, ea, w_edge, scale_t, mask2, row_ptr, dst,
                           src, out, stats_max, stats_den, logit_s, v_s, n,
                           e_total, hidden, fe, heads, inv_sqrt_ch,
                           rows_per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? dispatch<__nv_bfloat16, kFullStage, true>(a, s)
                                  : dispatch<float, kFullStage, true>(a, s);
  return static_cast<int>(err);
}

}  // extern "C"
