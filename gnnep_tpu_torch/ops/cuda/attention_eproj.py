"""CSR attention with the edge projection fused in, forward and backward:
the CUDA kernels `csrc/attn_eproj_fwd.cu` and `csrc/attn_eproj_bwd.cu`, their
ctypes wrappers, their plain PyTorch versions, their launch counts and the
`torch.autograd.Function` that joins them.

Counterpart of `fused_attention_eproj` / `csr_attention_eproj` in
`gnnep_tpu/ops/pallas/csr_attention.py` (TPU kernels `_attn_ep_kernel` and
`_attn_ep_bwd_kernel`):

    out_n = Σ_{e→n} softmax_e(q_n·(kv0_e + ea_e·W)/√c) · scale_e · (kv1_e + ea_e·W)

per head over the CSR segments of a dst-sorted edge arena, differentiable in
q, kv, ea and W. A tensor on the CPU takes the plain versions; a CUDA tensor
launches the kernels or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build
from .aggregate import softmax_aggregate_edges
from .attention import attention_bwd_f32, edge_logits

_KERNEL = "attn_eproj_fwd"
_KERNEL_BWD = "attn_eproj_bwd"

# kernel launches since the last reset, forward and backward; the chip smoke
# run sets them to 0 just before it drives a path and reads them just after
launches = 0
bwd_launches = 0


def attention_eproj_plain(q: torch.Tensor, kv: torch.Tensor, ea: torch.Tensor,
                          w_edge: torch.Tensor, scale_t: torch.Tensor,
                          mask2: torch.Tensor, dst: torch.Tensor, *, heads: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version → (out f32 [N, H], max [N, heads], denom
    [N, heads]), rounding where the TPU kernel rounds: e to the input type
    before the k/v adds, α to v's type before the aggregation, all sums f32."""
    hidden = kv.shape[1] // 2
    e = (ea.float() @ w_edge.float()).to(kv.dtype)
    k = kv[:, :hidden] + e
    v = kv[:, hidden:] + e
    return softmax_aggregate_edges(
        edge_logits(q, k, dst, heads), (mask2 > 0)[:, None], scale_t.t(), v,
        dst, q.shape[0], heads)


def attention_eproj_bwd_plain(q: torch.Tensor, kv: torch.Tensor,
                              ea: torch.Tensor, w_edge: torch.Tensor,
                              scale_t: torch.Tensor, mask2: torch.Tensor,
                              row_ptr: torch.Tensor, dst: torch.Tensor,
                              g: torch.Tensor, mx: torch.Tensor,
                              den: torch.Tensor, *, heads: int
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward → (dq [N, H], dkv [E, 2H], dea [E, Fe]) in the
    input type and dW_e f32 [Fe, H].

    The attention backward of `attention.attention_bwd_f32` (a port of the
    JAX package's edge-space fallback, `csr_attention.py:1396-1432`) on
    k = kv[:, :H] + e and v = kv[:, H:] + e, rounding where the CUDA kernel
    and the TPU kernel round: e to the input type, dq, dk, dv and de after
    their f32 sums, dea after its f32 product. A dead edge (masked, or owned
    by the dummy row n-1, whose output is unspecified) gets zero rows."""
    hidden = kv.shape[1] // 2
    dt = kv.dtype
    e = (ea.float() @ w_edge.float()).to(dt)
    dq, dk, dv = attention_bwd_f32(q, kv[:, :hidden] + e, kv[:, hidden:] + e,
                                   scale_t, mask2, row_ptr, dst, g, mx, den,
                                   heads=heads)
    de = (dk + dv).to(dt)
    dkv = torch.cat([dk.to(dt), dv.to(dt)], dim=1)
    dea = (de.float() @ w_edge.float().t()).to(ea.dtype)
    dw = ea.float().t() @ de.float()
    return dq.to(q.dtype), dkv, dea, dw


def _lib(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == _KERNEL and lib.attn_eproj_fwd.argtypes is None:
        lib.attn_eproj_fwd.argtypes = [p] * 13 + [i] * 5 + [ctypes.c_float,
                                                            i, i, p]
        lib.attn_eproj_fwd.restype = i
        lib.attn_eproj_fwd_smem_bytes.argtypes = [i, i]
        lib.attn_eproj_fwd_smem_bytes.restype = ctypes.c_size_t
    if name == _KERNEL_BWD and lib.attn_eproj_bwd.argtypes is None:
        lib.attn_eproj_bwd.argtypes = [p] * 19 + [i] * 5 + [ctypes.c_float,
                                                            i, i, p]
        lib.attn_eproj_bwd.restype = i
        lib.attn_eproj_bwd_smem_bytes.argtypes = [i, i]
        lib.attn_eproj_bwd_smem_bytes.restype = ctypes.c_size_t
    return lib


def rows_per_block(n: int, e_total: int, heads: int,
                   device: torch.device) -> int:
    """Targets per forward block: about 256 edges (four projection chunks)
    per block, but no fewer than two blocks per SM across the (rows, heads)
    grid."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    by_edges = -(-256 * n // max(e_total, 1))
    by_grid = -(-n * heads // (2 * sms))
    return int(max(1, min(by_edges, by_grid)))


def bwd_rows_per_block(n: int, heads: int, device: torch.device) -> int:
    """Targets per backward block: about two blocks per SM across the
    (rows, heads) grid. Each block adds its dW_e slice once, so larger tiles
    mean fewer atomic adds."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return int(max(1, -(-n * heads // (2 * sms))))


def _check_inputs(q, kv, ea, w_edge, scale_t, mask2, row_ptr, dst, *, heads,
                  extra=(), node_kv=False):
    """Raise on anything the kernels do not take. `extra` are further
    (name, tensor, dtype, shape) inputs; `node_kv`: kv is a node-space table
    [N_src, 2H] (the span kernels'), not an edge arena [E, 2H]."""
    n, hidden = q.shape[0], q.shape[1] if q.dim() == 2 else -1
    e_total = ea.shape[0] if node_kv and ea.dim() == 2 else kv.shape[0]
    fe = ea.shape[1] if ea.dim() == 2 else -1
    tensors = dict(q=q, kv=kv, ea=ea, w_edge=w_edge, scale_t=scale_t,
                   mask2=mask2, row_ptr=row_ptr, dst=dst)
    tensors.update({name: t for name, t, _, _ in extra})
    build.check_card_tensors(tensors)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, not {q.dtype}")
    for name in ("kv", "ea", "w_edge"):
        if tensors[name].dtype != q.dtype:
            raise TypeError(f"{name} is {tensors[name].dtype}; q, kv, ea and "
                            f"w_edge must share one type ({q.dtype})")
    if scale_t.dtype != torch.float32 or mask2.dtype != torch.float32:
        raise TypeError("scale_t and mask2 must be float32")
    if row_ptr.dtype != torch.int32 or dst.dtype != torch.int64:
        raise TypeError(f"row_ptr must be int32 and dst int64, not "
                        f"{row_ptr.dtype} and {dst.dtype}")
    ch = hidden // heads if heads > 0 else 0
    bad_extra = [name for name, t, dtype, shape in extra
                 if t.dtype != dtype or tuple(t.shape) != shape]
    kv_rows = kv.shape[0] if node_kv else e_total
    if (q.dim() != 2 or heads <= 0 or hidden % heads or ch > 128
            or tuple(kv.shape) != (kv_rows, 2 * hidden)
            or kv_rows >= 2 ** 31 - 1
            or ea.dim() != 2 or ea.shape[0] != e_total
            or tuple(w_edge.shape) != (fe, hidden)
            or tuple(scale_t.shape) != (heads, e_total)
            or tuple(mask2.shape) != (e_total,)
            or tuple(dst.shape) != (e_total,)
            or tuple(row_ptr.shape) != (n + 1,) or e_total >= 2 ** 31
            or bad_extra):
        raise ValueError(
            f"shapes the kernel does not take: q {tuple(q.shape)}, kv "
            f"{tuple(kv.shape)}, ea {tuple(ea.shape)}, w_edge "
            f"{tuple(w_edge.shape)}, scale_t {tuple(scale_t.shape)}, mask2 "
            f"{tuple(mask2.shape)}, row_ptr {tuple(row_ptr.shape)}, dst "
            f"{tuple(dst.shape)}, heads {heads} (needs hidden % heads == 0 "
            f"and a head width <= 128); wrong type or shape: {bad_extra}")
    return n, hidden, e_total, fe, ch


def _check_smem(lib_fn, fe: int, ch: int, device: torch.device) -> None:
    props = torch.cuda.get_device_properties(device)
    smem_cap = getattr(props, "shared_memory_per_block_optin", 232448)
    smem = lib_fn(fe, ch)
    if smem > smem_cap:
        raise ValueError(f"Fe={fe}, head width {ch} need {smem} bytes of "
                         f"shared memory per block; the card allows "
                         f"{smem_cap}")


def attention_eproj_cuda(q: torch.Tensor, kv: torch.Tensor, ea: torch.Tensor,
                         w_edge: torch.Tensor, scale_t: torch.Tensor,
                         mask2: torch.Tensor, row_ptr: torch.Tensor,
                         dst: torch.Tensor, *, heads: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on the current stream → (out, max, denom)
    as `attention_eproj_plain`. Raises on anything the kernel does not
    take."""
    global launches
    n, hidden, e_total, fe, ch = _check_inputs(
        q, kv, ea, w_edge, scale_t, mask2, row_ptr, dst, heads=heads)
    device = q.device
    lib = _lib(_KERNEL)
    _check_smem(lib.attn_eproj_fwd_smem_bytes, fe, ch, device)
    out = torch.empty((n, hidden), dtype=torch.float32, device=device)
    mx = torch.empty((n, heads), dtype=torch.float32, device=device)
    den = torch.empty((n, heads), dtype=torch.float32, device=device)
    if n == 0:
        return out, mx, den
    # the kernel's per-edge logits and v, written and read back by the block
    # that owns the edge
    logit_s = torch.empty((heads, e_total), dtype=torch.float32,
                          device=device)
    v_s = torch.empty((e_total, hidden), dtype=q.dtype, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.attn_eproj_fwd(
            q.data_ptr(), kv.data_ptr(), ea.data_ptr(), w_edge.data_ptr(),
            scale_t.data_ptr(), mask2.data_ptr(), row_ptr.data_ptr(),
            dst.data_ptr(), out.data_ptr(), mx.data_ptr(), den.data_ptr(),
            logit_s.data_ptr(), v_s.data_ptr(),
            n, e_total, hidden, fe, heads, 1.0 / ch ** 0.5,
            int(q.dtype == torch.bfloat16),
            rows_per_block(n, e_total, heads, device), stream)
    if rc != 0:
        raise RuntimeError(f"{_KERNEL} launch failed with CUDA error {rc}")
    launches += 1
    return out, mx, den


def attention_eproj_bwd_cuda(q: torch.Tensor, kv: torch.Tensor,
                             ea: torch.Tensor, w_edge: torch.Tensor,
                             scale_t: torch.Tensor, mask2: torch.Tensor,
                             row_ptr: torch.Tensor, dst: torch.Tensor,
                             g: torch.Tensor, mx: torch.Tensor,
                             den: torch.Tensor, *, heads: int
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor, torch.Tensor]:
    """Launch the backward kernels on the current stream → (dq, dkv, dea,
    dW_e) as `attention_eproj_bwd_plain`. `g` is the f32 cotangent of out.
    Raises on anything the kernels do not take."""
    global bwd_launches
    n = q.shape[0]
    extra = (("g", g, torch.float32, tuple(q.shape)),
             ("max", mx, torch.float32, (n, heads)),
             ("denom", den, torch.float32, (n, heads)))
    n, hidden, e_total, fe, ch = _check_inputs(
        q, kv, ea, w_edge, scale_t, mask2, row_ptr, dst, heads=heads,
        extra=extra)
    if fe > 256 or e_total == 0:
        raise ValueError(f"the backward kernel takes 1 <= E and Fe <= 256, "
                         f"not E={e_total}, Fe={fe}")
    device = q.device
    lib = _lib(_KERNEL_BWD)
    _check_smem(lib.attn_eproj_bwd_smem_bytes, fe, ch, device)
    dt = q.dtype
    dq = torch.empty((n, hidden), dtype=dt, device=device)
    dkv = torch.empty((e_total, 2 * hidden), dtype=dt, device=device)
    dea = torch.empty((e_total, fe), dtype=dt, device=device)
    dw = torch.zeros((fe, hidden), dtype=torch.float32, device=device)
    if n == 0:
        return dq, dkv, dea, dw
    # per-edge logit, u, k and de rows, written and read back by the blocks
    # that own the edge
    logit_s = torch.empty((heads, e_total), dtype=torch.float32,
                          device=device)
    u_s = torch.empty_like(logit_s)
    k_s = torch.empty((e_total, hidden), dtype=dt, device=device)
    de_s = torch.empty((e_total, hidden), dtype=dt, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.attn_eproj_bwd(
            q.data_ptr(), kv.data_ptr(), ea.data_ptr(), w_edge.data_ptr(),
            scale_t.data_ptr(), mask2.data_ptr(), row_ptr.data_ptr(),
            dst.data_ptr(), g.data_ptr(), mx.data_ptr(), den.data_ptr(),
            dq.data_ptr(), dkv.data_ptr(), dea.data_ptr(), dw.data_ptr(),
            logit_s.data_ptr(), u_s.data_ptr(), k_s.data_ptr(),
            de_s.data_ptr(), n, e_total, hidden, fe, heads, 1.0 / ch ** 0.5,
            int(dt == torch.bfloat16), bwd_rows_per_block(n, heads, device),
            stream)
    if rc != 0:
        raise RuntimeError(f"{_KERNEL_BWD} launch failed with CUDA error "
                           f"{rc}")
    bwd_launches += 1
    return dq, dkv, dea, dw


class EprojAttention(torch.autograd.Function):
    """The eproj attention as one differentiable op: forward kernel 5 and
    backward kernel 6 on the card, their plain versions on the CPU. Returns
    (out f32, max, denom); max and denom carry no gradient."""

    @staticmethod
    def forward(ctx, q, kv, ea, w_edge, scale_t, mask2, row_ptr, dst, heads):
        if q.device.type == "cpu":
            out, mx, den = attention_eproj_plain(q, kv, ea, w_edge, scale_t,
                                                 mask2, dst, heads=heads)
        else:
            out, mx, den = attention_eproj_cuda(q, kv, ea, w_edge, scale_t,
                                                mask2, row_ptr, dst,
                                                heads=heads)
        ctx.save_for_backward(q, kv, ea, w_edge, scale_t, mask2, row_ptr,
                              dst, mx, den)
        ctx.heads = heads
        ctx.mark_non_differentiable(mx, den)
        return out, mx, den

    @staticmethod
    def backward(ctx, g, _g_max, _g_den):
        q, kv, ea, w_edge, scale_t, mask2, row_ptr, dst, mx, den = \
            ctx.saved_tensors
        g = g.float().contiguous()
        if q.device.type == "cpu":
            dq, dkv, dea, dw = attention_eproj_bwd_plain(
                q, kv, ea, w_edge, scale_t, mask2, row_ptr, dst, g, mx, den,
                heads=ctx.heads)
        else:
            dq, dkv, dea, dw = attention_eproj_bwd_cuda(
                q, kv, ea, w_edge, scale_t, mask2, row_ptr, dst, g, mx, den,
                heads=ctx.heads)
        return (dq, dkv, dea, dw.to(w_edge.dtype), None, None, None, None,
                None)


def fused_attention_eproj(q: torch.Tensor, kv: torch.Tensor, ea: torch.Tensor,
                          w_edge: torch.Tensor, row_ptr: torch.Tensor,
                          dst: torch.Tensor, *, heads: int,
                          scale_t: Optional[torch.Tensor] = None,
                          mask_e: Optional[torch.Tensor] = None,
                          return_stats: bool = False):
    """Fused CSR attention, JAX argument layout: `kv` [E, 2H] is the gathered
    (k‖v)[src] arena, `ea` [E, Fe] the raw per-edge features, `w_edge`
    [Fe, H] the conv's bias-free edge projection, `row_ptr` [N+1] the CSR
    pointers of the sorted `dst` [E]. `scale_t` [heads, E] multiplies α after
    normalisation (dropout; default ones); `mask_e` [E] excludes edges
    (default none). Returns out f32 [N, H], plus (max, denom) [N, heads] with
    `return_stats`; differentiable in q, kv, ea and w_edge. The dummy row's
    (n−1) output is unspecified, and its edges carry no gradient."""
    e_total = kv.shape[0]
    if scale_t is None:
        scale_t = torch.ones((heads, e_total), dtype=torch.float32,
                             device=kv.device)
    mask2 = (torch.ones(e_total, dtype=torch.float32, device=kv.device)
             if mask_e is None
             else mask_e.to(torch.float32).reshape(e_total).contiguous())
    res = EprojAttention.apply(q, kv, ea, w_edge, scale_t.contiguous(), mask2,
                               row_ptr, dst, heads)
    return res if return_stats else res[0]
