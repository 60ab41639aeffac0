// attn_eproj_bwd.cu: backward of the CSR graph attention with the edge
// projection fused in, for Hopper, built for sm_90a. The two kernels, their
// design, hazards and bound are in attn_eproj_bwd.cuh.
//
// Replaces the TPU kernel `_attn_ep_bwd_kernel` in
// gnnep_tpu/ops/pallas/csr_attention.py (reached there through
// `_attn_ep_backward` from the custom VJP `_attn_ep_bwd`), kv an edge-space
// arena [E, 2H] and its gradient dkv [E, 2H].

#include "attn_eproj_bwd.cuh"

extern "C" {

// Dynamic shared memory one block of the first kernel needs; the wrapper
// refuses shapes above the card's per-block limit.
size_t attn_eproj_bwd_smem_bytes(int fe, int ch) { return smem_bytes(fe, ch); }

// Launches both kernels on `stream` and returns cudaGetLastError() (0 =
// launched). The caller guarantees: n >= 1, e_total >= 1, hidden = heads *
// ch with ch <= 128, contiguous tensors of the types above, row_ptr
// nondecreasing with row_ptr[n] <= e_total and dst consistent with it,
// rows_per_block >= 1, dw zeroed, and scratch buffers logit_s and u_s f32
// [heads, E], k_s and de_s [E, H] of the input type. inv_sqrt_ch is
// 1/sqrt(ch) rounded once to f32, as the JAX kernel's constant is.
int attn_eproj_bwd(const void* q, const void* kv, const void* ea,
                   const void* w_edge, const void* scale_t, const void* mask2,
                   const void* row_ptr, const void* dst, const void* g,
                   const void* stats_max, const void* stats_den, void* dq,
                   void* dkv, void* dea, void* dw, void* logit_s, void* u_s,
                   void* k_s, void* de_s, int n, int e_total, int hidden,
                   int fe, int heads, float inv_sqrt_ch, int is_bf16,
                   int rows_per_block, void* stream) {
  Args a = make_args(q, kv, ea, w_edge, scale_t, mask2, row_ptr, dst, g,
                     stats_max, stats_den, dq, dea, dw, logit_s, u_s, k_s,
                     de_s, n, e_total, hidden, fe, heads, inv_sqrt_ch,
                     rows_per_block);
  a.dkv = dkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? dispatch<__nv_bfloat16, false>(a, s)
                                  : dispatch<float, false>(a, s);
  return static_cast<int>(err);
}

}  // extern "C"
