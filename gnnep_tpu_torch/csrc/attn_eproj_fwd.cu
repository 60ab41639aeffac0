// attn_eproj_fwd.cu: CSR graph attention with the edge projection fused in
// (forward), for Hopper, built for sm_90a. The kernel itself, its design,
// its hazards and its bound are in attn_eproj_fwd.cuh.
//
// Replaces the TPU kernel `_attn_ep_kernel` in
// gnnep_tpu/ops/pallas/csr_attention.py (reached there through
// `fused_attention_eproj`), kv an edge-space arena [E, 2H] read at row j.
//
// Also the port of the dev probe `make_kernel` in
// scripts_dev/exp_kernel_ladder.py: `attn_eproj_ladder` launches the same
// kernel cut short after one of its phases (the Stage of the header), so
// that timing each stage attributes kernel 5's time phase by phase. Its
// last stage is kernel 5's own instantiation.

#include "attn_eproj_fwd.cuh"

namespace {

template <typename T>
cudaError_t dispatch_stage(const Args& a, int stage, cudaStream_t stream) {
  switch (stage) {
    case kDma: return launch<T, 4, kDma, false>(a, stream);
    case kEproj: return launch<T, 4, kEproj, false>(a, stream);
    case kSddmm: return launch<T, 4, kSddmm, false>(a, stream);
    case kSoftmax: return launch<T, 4, kSoftmax, false>(a, stream);
    default: return launch<T, 4, kFullStage, false>(a, stream);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the wrapper refuses shapes above
// the card's per-block limit.
size_t attn_eproj_fwd_smem_bytes(int fe, int ch) { return smem_bytes(fe, ch); }

// Launches on `stream` and returns cudaGetLastError() (0 = launched). The
// caller guarantees: n >= 1, hidden = heads * ch with ch <= 128, contiguous
// tensors of the types above, row_ptr nondecreasing with row_ptr[n] <=
// e_total and dst consistent with it, rows_per_block >= 1, and scratch
// buffers logit_s f32 [heads, E] and v_s [E, H] of the input type.
// inv_sqrt_ch is 1/sqrt(ch) rounded once to f32, as the JAX kernel's
// constant is.
int attn_eproj_fwd(const void* q, const void* kv, const void* ea,
                   const void* w_edge, const void* scale_t, const void* mask2,
                   const void* row_ptr, const void* dst, void* out,
                   void* stats_max, void* stats_den, void* logit_s, void* v_s,
                   int n, int e_total, int hidden, int fe, int heads,
                   float inv_sqrt_ch, int is_bf16, int rows_per_block,
                   void* stream) {
  const Args a = make_args(q, kv, ea, w_edge, scale_t, mask2, row_ptr, dst,
                           nullptr, out, stats_max, stats_den, logit_s, v_s,
                           n, e_total, hidden, fe, heads, inv_sqrt_ch,
                           rows_per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? dispatch<__nv_bfloat16, kFullStage, false>(a, s)
                                  : dispatch<float, kFullStage, false>(a, s);
  return static_cast<int>(err);
}

// The ladder: as attn_eproj_fwd, cut short after `stage` (0 dma, 1 eproj,
// 2 sddmm, 3 softmax, 4 full = kernel 5), for head widths 33 to 64 (the
// flagship's 64) only; the wrapper refuses others.
int attn_eproj_ladder(const void* q, const void* kv, const void* ea,
                      const void* w_edge, const void* scale_t,
                      const void* mask2, const void* row_ptr, const void* dst,
                      void* out, void* stats_max, void* stats_den,
                      void* logit_s, void* v_s, int n, int e_total,
                      int hidden, int fe, int heads, float inv_sqrt_ch,
                      int is_bf16, int rows_per_block, int stage,
                      void* stream) {
  const Args a = make_args(q, kv, ea, w_edge, scale_t, mask2, row_ptr, dst,
                           nullptr, out, stats_max, stats_den, logit_s, v_s,
                           n, e_total, hidden, fe, heads, inv_sqrt_ch,
                           rows_per_block);
  if (a.ch_pad != 64) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? dispatch_stage<__nv_bfloat16>(a, stage, s)
                                  : dispatch_stage<float>(a, stage, s);
  return static_cast<int>(err);
}

}  // extern "C"
