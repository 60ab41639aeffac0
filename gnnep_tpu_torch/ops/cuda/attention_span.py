"""CSR attention with the kv gather and the edge projection fused in, forward
and backward: the CUDA kernels `csrc/attn_span_fwd.cu` and
`csrc/attn_span_bwd.cu`, their ctypes wrappers, their plain PyTorch
versions, their launch counts and the `torch.autograd.Function` that joins
them.

Counterpart of `fused_attention_span` / `csr_attention_span` in
`gnnep_tpu/ops/pallas/csr_attention.py` (TPU kernels `_attn_sp_kernel` and
`_attn_sp_bwd_kernel`): the eproj attention of `attention_eproj.py` on
kv = kvn[src], where `kvn` [N_src, 2H] is the conv's node-space (k‖v) table
and `src` [E] each edge's source row. No edge-space kv [E, 2H] exists in
either pass: the forward reads row src[j] inside the kernel, and the
backward returns d(kvn) in node space, each live edge's dk‖dv rounded to
kvn's type and summed in f32, then rounded once (the TPU kernel rounds its
node-space sum after each block; this port does not). The TPU kernels' span
bound and `span_lo` size their VMEM windows and have no counterpart here. A
tensor on the CPU takes the plain versions; a CUDA tensor launches the
kernels or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build
from .attention_eproj import (_check_inputs, attention_eproj_bwd_plain,
                              attention_eproj_plain, bwd_tile_ptr,
                              bwd_tiles, rows_per_block, _sms)

_KERNEL = "attn_span_fwd"
_KERNEL_BWD = "attn_span_bwd"

# kernel launches since the last reset, forward and backward; the chip smoke
# run sets them to 0 just before it drives a path and reads them just after
launches = 0
bwd_launches = 0


def attention_span_plain(q: torch.Tensor, kvn: torch.Tensor, ea: torch.Tensor,
                         w_edge: torch.Tensor, scale_t: torch.Tensor,
                         mask2: torch.Tensor, src: torch.Tensor,
                         dst: torch.Tensor, *, heads: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version → (out f32 [N, H], max [N, heads], denom
    [N, heads]): the eproj plain version on kvn[src], since the gathered row
    is exact."""
    return attention_eproj_plain(q, kvn[src], ea, w_edge, scale_t, mask2,
                                 dst, heads=heads)


def attention_span_bwd_plain(q: torch.Tensor, kvn: torch.Tensor,
                             ea: torch.Tensor, w_edge: torch.Tensor,
                             scale_t: torch.Tensor, mask2: torch.Tensor,
                             row_ptr: torch.Tensor, src: torch.Tensor,
                             dst: torch.Tensor, g: torch.Tensor,
                             mx: torch.Tensor, den: torch.Tensor, *,
                             heads: int
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward → (dq [N, H], dkvn [N_src, 2H], dea [E, Fe]) in
    the input type and dW_e f32 [Fe, H]: the eproj plain backward on
    kvn[src], whose edge-space dkv rows (rounded to kvn's type, zero for
    dead edges) are summed into their source rows in f32 and rounded
    once."""
    dq, dkv, dea, dw = attention_eproj_bwd_plain(
        q, kvn[src], ea, w_edge, scale_t, mask2, row_ptr, dst, g, mx, den,
        heads=heads)
    dkvn = torch.zeros(kvn.shape, dtype=torch.float32, device=kvn.device)
    dkvn.index_add_(0, src, dkv.float())
    return dq, dkvn.to(kvn.dtype), dea, dw


def _lib(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == _KERNEL and lib.attn_span_fwd.argtypes is None:
        lib.attn_span_fwd.argtypes = [p] * 14 + [i] * 5 + [ctypes.c_float,
                                                           i, i, p]
        lib.attn_span_fwd.restype = i
    if name == _KERNEL_BWD and lib.attn_span_bwd.argtypes is None:
        lib.attn_span_bwd.argtypes = [p] * 21 + [i] * 6 + [ctypes.c_float,
                                                           i, p, i, p]
        lib.attn_span_bwd.restype = i
    return lib


def _src_extra(src: torch.Tensor, e_total: int):
    return (("src", src, torch.int64, (e_total,)),)


def attention_span_cuda(q: torch.Tensor, kvn: torch.Tensor, ea: torch.Tensor,
                        w_edge: torch.Tensor, scale_t: torch.Tensor,
                        mask2: torch.Tensor, row_ptr: torch.Tensor,
                        src: torch.Tensor, dst: torch.Tensor, *, heads: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on the current stream → (out, max, denom)
    as `attention_span_plain`. Raises on anything the kernel does not
    take."""
    global launches
    e_total = ea.shape[0]
    n, hidden, e_total, fe, ch = _check_inputs(
        q, kvn, ea, w_edge, scale_t, mask2, row_ptr, dst, heads=heads,
        extra=_src_extra(src, e_total), node_kv=True)
    device = q.device
    lib = _lib(_KERNEL)
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
        rc = lib.attn_span_fwd(
            q.data_ptr(), kvn.data_ptr(), ea.data_ptr(), w_edge.data_ptr(),
            scale_t.data_ptr(), mask2.data_ptr(), row_ptr.data_ptr(),
            src.data_ptr(), dst.data_ptr(), out.data_ptr(), mx.data_ptr(),
            den.data_ptr(), logit_s.data_ptr(), v_s.data_ptr(),
            n, e_total, hidden, fe, heads, 1.0 / ch ** 0.5,
            int(q.dtype == torch.bfloat16),
            rows_per_block(n, e_total, heads, device), stream)
    if rc != 0:
        raise RuntimeError(f"{_KERNEL} launch failed with CUDA error {rc}")
    launches += 1
    return out, mx, den


def attention_span_bwd_cuda(q: torch.Tensor, kvn: torch.Tensor,
                            ea: torch.Tensor, w_edge: torch.Tensor,
                            scale_t: torch.Tensor, mask2: torch.Tensor,
                            row_ptr: torch.Tensor, src: torch.Tensor,
                            dst: torch.Tensor, g: torch.Tensor,
                            mx: torch.Tensor, den: torch.Tensor, *,
                            heads: int
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """Launch the backward kernels on the current stream → (dq, dkvn, dea,
    dW_e) as `attention_span_bwd_plain`. `g` is the f32 cotangent of out.
    Raises on anything the kernels do not take."""
    global bwd_launches
    n, e_total = q.shape[0], ea.shape[0]
    extra = _src_extra(src, e_total) + (
        ("g", g, torch.float32, tuple(q.shape)),
        ("max", mx, torch.float32, (n, heads)),
        ("denom", den, torch.float32, (n, heads)))
    n, hidden, e_total, fe, ch = _check_inputs(
        q, kvn, ea, w_edge, scale_t, mask2, row_ptr, dst, heads=heads,
        extra=extra, node_kv=True)
    if e_total == 0:
        raise ValueError("the backward kernel takes E >= 1, not E=0")
    device = q.device
    lib = _lib(_KERNEL_BWD)
    dt = q.dtype
    n_src = kvn.shape[0]
    dq = torch.empty((n, hidden), dtype=dt, device=device)
    # the node-space sum, f32; in f32 it is the result itself
    acc = torch.zeros((n_src, 2 * hidden), dtype=torch.float32,
                      device=device)
    dkvn = acc if dt == torch.float32 else torch.empty_like(acc, dtype=dt)
    dea = torch.empty((e_total, fe), dtype=dt, device=device)
    dw = torch.zeros((fe, hidden), dtype=torch.float32, device=device)
    if n == 0:
        return dq, dkvn.zero_(), dea, dw
    # per-edge logit, u, k and de rows, written and read back by the blocks
    # that own the edge
    logit_s = torch.empty((heads, e_total), dtype=torch.float32,
                          device=device)
    u_s = torch.empty_like(logit_s)
    k_s = torch.empty((e_total, hidden), dtype=dt, device=device)
    de_s = torch.empty((e_total, hidden), dtype=dt, device=device)
    tiles = bwd_tiles(n, heads, _sms(device))
    tile_ptr = bwd_tile_ptr(row_ptr, tiles)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.attn_span_bwd(
            q.data_ptr(), kvn.data_ptr(), ea.data_ptr(), w_edge.data_ptr(),
            scale_t.data_ptr(), mask2.data_ptr(), row_ptr.data_ptr(),
            src.data_ptr(), dst.data_ptr(), g.data_ptr(), mx.data_ptr(),
            den.data_ptr(), dq.data_ptr(), acc.data_ptr(), dkvn.data_ptr(),
            dea.data_ptr(), dw.data_ptr(), logit_s.data_ptr(),
            u_s.data_ptr(), k_s.data_ptr(), de_s.data_ptr(), n, n_src,
            e_total, hidden, fe, heads, 1.0 / ch ** 0.5,
            int(dt == torch.bfloat16), tile_ptr.data_ptr(), tiles, stream)
    if rc != 0:
        raise RuntimeError(f"{_KERNEL_BWD} launch failed with CUDA error "
                           f"{rc}")
    bwd_launches += 1
    return dq, dkvn, dea, dw


class CsrAttentionSpan(torch.autograd.Function):
    """The span attention as one differentiable op: forward kernel 8 and
    backward kernel 9 on the card, their plain versions on the CPU. Returns
    (out f32, max, denom); max and denom carry no gradient."""

    @staticmethod
    def forward(ctx, q, kvn, ea, w_edge, scale_t, mask2, row_ptr, src, dst,
                heads):
        if q.device.type == "cpu":
            out, mx, den = attention_span_plain(q, kvn, ea, w_edge, scale_t,
                                                mask2, src, dst, heads=heads)
        else:
            out, mx, den = attention_span_cuda(q, kvn, ea, w_edge, scale_t,
                                               mask2, row_ptr, src, dst,
                                               heads=heads)
        ctx.save_for_backward(q, kvn, ea, w_edge, scale_t, mask2, row_ptr,
                              src, dst, mx, den)
        ctx.heads = heads
        ctx.mark_non_differentiable(mx, den)
        return out, mx, den

    @staticmethod
    def backward(ctx, g, _g_max, _g_den):
        q, kvn, ea, w_edge, scale_t, mask2, row_ptr, src, dst, mx, den = \
            ctx.saved_tensors
        g = g.float().contiguous()
        run = (attention_span_bwd_plain if q.device.type == "cpu"
               else attention_span_bwd_cuda)
        dq, dkvn, dea, dw = run(q, kvn, ea, w_edge, scale_t, mask2, row_ptr,
                                src, dst, g, mx, den, heads=ctx.heads)
        return (dq, dkvn, dea, dw.to(w_edge.dtype), None, None, None, None,
                None, None)


def fused_attention_span(q: torch.Tensor, kvn: torch.Tensor, ea: torch.Tensor,
                         w_edge: torch.Tensor, row_ptr: torch.Tensor,
                         src: torch.Tensor, dst: torch.Tensor, *, heads: int,
                         scale_t: Optional[torch.Tensor] = None,
                         mask_e: Optional[torch.Tensor] = None,
                         return_stats: bool = False):
    """Span CSR attention, JAX argument layout but `span_lo` (which sizes
    only the TPU kernels' windows): `kvn` [N_src, 2H] the conv's node-space
    (k‖v) table, `src` [E] (int64) each edge's source row, `ea` [E, Fe] the
    raw per-edge features, `w_edge` [Fe, H], `row_ptr` [N+1] the CSR
    pointers of the sorted `dst` [E]. `scale_t` [heads, E] multiplies α after
    normalisation (dropout; default ones); `mask_e` [E] excludes edges
    (default none). Returns out f32 [N, H], plus (max, denom) [N, heads] with
    `return_stats`; differentiable in q, kvn, ea and w_edge. The dummy row's
    (n−1) output is unspecified, and its edges carry no gradient."""
    e_total = ea.shape[0]
    if scale_t is None:
        scale_t = torch.ones((heads, e_total), dtype=torch.float32,
                             device=ea.device)
    mask2 = (torch.ones(e_total, dtype=torch.float32, device=ea.device)
             if mask_e is None
             else mask_e.to(torch.float32).reshape(e_total).contiguous())
    res = CsrAttentionSpan.apply(q, kvn, ea, w_edge, scale_t.contiguous(),
                                 mask2, row_ptr, src, dst, heads)
    return res if return_stats else res[0]
