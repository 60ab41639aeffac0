// attn_span_bwd.cu: backward of the CSR graph attention with the kv gather
// and the edge projection fused in, for Hopper, built for sm_90a.
//
// Replaces the TPU kernel `_attn_sp_bwd_kernel` in
// gnnep_tpu/ops/pallas/csr_attention.py (reached there through
// `_attn_sp_backward` from the custom VJP `_attn_sp_bwd`). It computes
// kernel 6's gradients on kv = kvn[src] and returns d(kvn) in node space:
// dkvn[s] = Σ over the live edges j with src[j] = s of (dk_j ‖ dv_j), with
// dq [N, H], dea [E, Fe] and dW_e f32 [Fe, H] as kernel 6's.
//
// Design: kernel 6's two kernels (attn_eproj_bwd.cuh) with their Span flag
// set, then, in bf16, a cast of the node-space sum.
//  - The first kernel reads kv row src[j] of the node table, only for a
//    live edge, and adds each live edge's dk and dv rows into an f32
//    accumulator [N_src, 2H] with atomicAdd: several target tiles source
//    from one node row and CUDA blocks run in no order, so the TPU kernel's
//    read-modify-write of overlapping spans over its sequential grid
//    (csr_attention.py:1993-1998) has no counterpart. The lanes of a warp
//    add to consecutive channels of one row, one L2 transaction a warp.
//  - The f32 summation order is not deterministic: the result varies in its
//    last bits from run to run, and the checks compare at a tolerance.
//  - Rounding: each live edge's dk and dv round to kvn's type before the
//    sum, as the TPU kernel rounds them (:1988-1992); de = dk + dv is formed
//    from the f32 values (:1999-2001). The TPU kernel keeps its node-space
//    accumulator in kvn's type and rounds it after each block, so its bf16
//    result depends on the block order; here the sum is f32 and rounds once
//    (cast_kernel below). This is a choice, not a fault; the bf16 tolerance
//    it needs is stated in the tests.
//  - A dead edge (masked, or owned by the dummy row n-1, never walked)
//    never reads kvn and adds nothing to it; its dea row is zero.
//
// What bounds it on this card: as kernel 6, three E·Fe·H products on the
// CUDA cores (f32 FMAs for both input types); its bytes are lower than
// kernel 6's by the edge-space kv it no longer reads and the dkv [E, 2H] it
// no longer writes.

#include "attn_eproj_bwd.cuh"

namespace {

// dkvn = the f32 accumulator rounded to bf16, 8 values a thread
__global__ void __launch_bounds__(kThreads) cast_kernel(const float* acc,
                                                        __nv_bfloat16* out,
                                                        long long count) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * 8;
  if (i0 + 8 <= count) {
    const float4 x0 = *reinterpret_cast<const float4*>(acc + i0);
    const float4 x1 = *reinterpret_cast<const float4*>(acc + i0 + 4);
    __align__(16) __nv_bfloat162 y[4] = {__floats2bfloat162_rn(x0.x, x0.y),
                           __floats2bfloat162_rn(x0.z, x0.w),
                           __floats2bfloat162_rn(x1.x, x1.y),
                           __floats2bfloat162_rn(x1.z, x1.w)};
    *reinterpret_cast<uint4*>(out + i0) = *reinterpret_cast<uint4*>(y);
  } else {
    for (long long i = i0; i < count; ++i) out[i] = __float2bfloat16(acc[i]);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the first kernel needs; the wrapper
// refuses shapes above the card's per-block limit.
size_t attn_span_bwd_smem_bytes(int fe, int ch) { return smem_bytes(fe, ch); }

// Launches the kernels on `stream` and returns cudaGetLastError() (0 =
// launched). The caller guarantees what attn_eproj_bwd's does, with kvn
// [n_src, 2H] in place of kv, 0 <= src[j] < n_src < 2^31 - 1 for every live
// edge j, dkvn_acc f32 [n_src, 2H] zeroed, and in bf16 dkvn [n_src, 2H]
// (in f32 the accumulator is the result and dkvn is not written).
int attn_span_bwd(const void* q, const void* kvn, const void* ea,
                  const void* w_edge, const void* scale_t, const void* mask2,
                  const void* row_ptr, const void* src, const void* dst,
                  const void* g, const void* stats_max, const void* stats_den,
                  void* dq, void* dkvn_acc, void* dkvn, void* dea, void* dw,
                  void* logit_s, void* u_s, void* k_s, void* de_s, int n,
                  int n_src, int e_total, int hidden, int fe, int heads,
                  float inv_sqrt_ch, int is_bf16, int rows_per_block,
                  void* stream) {
  Args a = make_args(q, kvn, ea, w_edge, scale_t, mask2, row_ptr, dst, g,
                     stats_max, stats_den, dq, dea, dw, logit_s, u_s, k_s,
                     de_s, n, e_total, hidden, fe, heads, inv_sqrt_ch,
                     rows_per_block);
  a.src = static_cast<const long long*>(src);
  a.dkvn_acc = static_cast<float*>(dkvn_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16 ? dispatch<__nv_bfloat16, true>(a, s)
                            : dispatch<float, true>(a, s);
  if (err != cudaSuccess || !is_bf16) return static_cast<int>(err);
  const long long count = static_cast<long long>(n_src) * 2 * hidden;
  const long long blocks = (count + kThreads * 8 - 1) / (kThreads * 8);
  if (blocks > 0)
    cast_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(dkvn_acc),
        static_cast<__nv_bfloat16*>(dkvn), count);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
