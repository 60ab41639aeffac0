"""Segment softmax of external per-edge logits and the weighted sum of
per-edge values, forward and backward: the CUDA kernels
`csrc/softmax_aggregate_fwd.cu` and `csrc/softmax_aggregate_bwd.cu`, their
ctypes wrappers, their plain PyTorch versions, their launch counts and the
`torch.autograd.Function` that joins them. Also the plain softmax pieces
that the attention modules' plain versions share.

Counterpart of `fused_aggregate_t` / `csr_softmax_aggregate` in
`gnnep_tpu/ops/pallas/csr_attention.py` (TPU kernels `_kernel` and
`_bwd_kernel`), the external-logits rung of the conv (`attn_fused=False`):

    out_n = Σ_{e→n} softmax_e(logits_t[h, e]) · scale_t[h, e] · v_e

per head over the CSR segments of a dst-sorted edge arena, differentiable in
logits_t and v. There is no mask stream: a masked edge carries the logit
−1e30, and an edge counts only if its logit is above −0.5e30 (the TPU
kernel's clamp). A tensor on the CPU takes the plain versions; a CUDA
tensor launches the kernels or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..segment import segment_max, segment_sum
from . import build
from .segment_sum import csr_segment_sum_plain

_NEG = -1e30
_KERNEL = "softmax_aggregate_fwd"
_KERNEL_BWD = "softmax_aggregate_bwd"

# kernel launches since the last reset, forward and backward; the chip smoke
# run sets them to 0 just before it drives a path and reads them just after
launches = 0
bwd_launches = 0


# ---------------------------------------------------- plain softmax pieces
def softmax_aggregate_edges(logits: torch.Tensor, live: torch.Tensor,
                            scale: torch.Tensor, v: torch.Tensor,
                            dst: torch.Tensor, n: int, heads: int
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Per-edge f32 `logits` and `scale` [E, heads], `live` (bool,
    broadcastable to them) → (out f32 [N, H], max [N, heads], denom
    [N, heads]): the segment softmax over the live edges, α rounded to v's
    type before the aggregation, every sum f32. A row without a live edge
    gives out 0, max −1e30, denom 1e-16."""
    e_total, hidden = v.shape
    ch = hidden // heads
    mat = torch.where(live, logits, torch.full_like(logits, _NEG))
    mx = segment_max(mat, dst, n).clamp_min(_NEG)
    ex = torch.where(live, torch.exp(mat - mx.index_select(0, dst)),
                     torch.zeros_like(mat))
    den = segment_sum(ex, dst, n).clamp_min(1e-16)
    alpha = ((ex / den.index_select(0, dst)) * scale).to(v.dtype).float()
    msg = alpha[:, :, None] * v.float().reshape(e_total, heads, ch)
    return segment_sum(msg.reshape(e_total, hidden), dst, n), mx, den


def softmax_probs(logits: torch.Tensor, live: torch.Tensor,
                  mx: torch.Tensor, den: torch.Tensor,
                  dst: torch.Tensor) -> torch.Tensor:
    """s = exp(logit − max) / denom [E, heads] from the forward's stats, 0
    where not live. Selected before the exp: an all-masked row keeps max
    −1e30."""
    safe = torch.where(live, logits, torch.zeros_like(logits))
    s = torch.exp(safe - mx.index_select(0, dst)) / den.index_select(0, dst)
    return torch.where(live, s, torch.zeros_like(s))


def softmax_logit_grad(s: torch.Tensor, scale: torch.Tensor,
                       u: torch.Tensor, row_ptr: torch.Tensor,
                       dst: torch.Tensor) -> torch.Tensor:
    """dl = s·(scale·u − inner) [E, heads] f32 with u = g·v per edge and
    inner_n = Σ_{e→n} s·scale·u, the row sums taken by the segment-sum's
    plain version."""
    inner = csr_segment_sum_plain(s * scale * u, None, row_ptr[:-1])
    return s * (scale * u - inner.index_select(0, dst))


def widen(x: torch.Tensor, ch: int) -> torch.Tensor:
    """[E, heads] → [E, heads·ch], each head's value over its channels."""
    return x.repeat_interleave(ch, dim=1)


# ----------------------------------------------------------- plain versions
def aggregate_plain(logits_t: torch.Tensor, scale_t: torch.Tensor,
                    v: torch.Tensor, row_ptr: torch.Tensor,
                    dst: torch.Tensor, *, heads: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 1 → (out f32 [N, H], max [N, heads],
    denom [N, heads])."""
    logits = logits_t.t()
    return softmax_aggregate_edges(logits, logits > 0.5 * _NEG, scale_t.t(),
                                   v, dst, row_ptr.shape[0] - 1, heads)


def aggregate_bwd_plain(logits_t: torch.Tensor, scale_t: torch.Tensor,
                        v: torch.Tensor, row_ptr: torch.Tensor,
                        dst: torch.Tensor, g: torch.Tensor, mx: torch.Tensor,
                        den: torch.Tensor, *, heads: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 2 → (dl_t f32 [heads, E], dv [E, H]
    in v's type).

    A port of the JAX package's edge-space fallback (`_bwd`,
    `csr_attention.py:373-393`) with the kernel's clamp (an edge counts
    only above −0.5e30), the segment-sum plain version in place of
    `windowed_segment_sum`, and the kernels' rounding: g to v's type before
    u and dv, α to it before dv; dl stays f32. Edges that do not count, and
    the dummy row n−1's, get zero dl and dv."""
    n = row_ptr.shape[0] - 1
    e_total, hidden = v.shape
    ch = hidden // heads
    logits = logits_t.t()
    live = (logits > 0.5 * _NEG) & (dst != n - 1)[:, None]
    s = softmax_probs(logits, live, mx, den, dst)
    sc = scale_t.t()
    g_e = g.to(v.dtype).float().index_select(0, dst)
    u = (g_e * v.float()).reshape(e_total, heads, ch).sum(-1)
    dl = softmax_logit_grad(s, sc, u, row_ptr, dst)
    dv = widen((s * sc).to(v.dtype).float(), ch) * g_e
    return dl.t().contiguous(), dv.to(v.dtype)


# ------------------------------------------------------------------ kernels
def _lib(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == _KERNEL and lib.softmax_aggregate_fwd.argtypes is None:
        lib.softmax_aggregate_fwd.argtypes = [p] * 7 + [i] * 5 + [p]
        lib.softmax_aggregate_fwd.restype = i
    if name == _KERNEL_BWD and lib.softmax_aggregate_bwd.argtypes is None:
        lib.softmax_aggregate_bwd.argtypes = [p] * 11 + [i] * 5 + [p]
        lib.softmax_aggregate_bwd.restype = i
    return lib


def _check_inputs(logits_t, scale_t, v, row_ptr, *, heads, extra=()):
    """Raise on anything the kernels do not take. `extra` are further
    (name, tensor, shape) f32 inputs of the backward → (n, hidden, E)."""
    build.check_card_tensors(dict(v=v, logits_t=logits_t, scale_t=scale_t,
                                  row_ptr=row_ptr,
                                  **{name: t for name, t, _ in extra}))
    if v.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"v must be float32 or bfloat16, not {v.dtype}")
    if any(t.dtype != torch.float32
           for t in (logits_t, scale_t, *(t for _, t, _ in extra))):
        raise TypeError("logits_t, scale_t, g and the stats must be float32")
    if row_ptr.dtype != torch.int32:
        raise TypeError(f"row_ptr must be int32, not {row_ptr.dtype}")
    e_total = v.shape[0]
    hidden = v.shape[1] if v.dim() == 2 else -1
    n = row_ptr.shape[0] - 1
    bad = [name for name, t, shape in extra
           if tuple(t.shape) != shape(n, hidden)]
    if (v.dim() != 2 or heads <= 0 or hidden % heads or e_total >= 2 ** 31
            or tuple(logits_t.shape) != (heads, e_total)
            or tuple(scale_t.shape) != (heads, e_total)
            or row_ptr.dim() != 1 or n < 0 or bad):
        raise ValueError(
            f"shapes the kernel does not take: logits_t "
            f"{tuple(logits_t.shape)}, scale_t {tuple(scale_t.shape)}, v "
            f"{tuple(v.shape)}, row_ptr {tuple(row_ptr.shape)}, heads "
            f"{heads} (needs hidden % heads == 0); wrong shape: {bad}")
    return n, hidden, e_total


def aggregate_cuda(logits_t: torch.Tensor, scale_t: torch.Tensor,
                   v: torch.Tensor, row_ptr: torch.Tensor, *, heads: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch kernel 1 on the current stream → (out, max, denom) as
    `aggregate_plain`. Raises on anything the kernel does not take."""
    global launches
    n, hidden, e_total = _check_inputs(logits_t, scale_t, v, row_ptr,
                                       heads=heads)
    device = v.device
    out = torch.empty((n, hidden), dtype=torch.float32, device=device)
    mx = torch.empty((n, heads), dtype=torch.float32, device=device)
    den = torch.empty((n, heads), dtype=torch.float32, device=device)
    if n == 0:
        return out, mx, den
    lib = _lib(_KERNEL)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.softmax_aggregate_fwd(
            logits_t.data_ptr(), scale_t.data_ptr(), v.data_ptr(),
            row_ptr.data_ptr(), out.data_ptr(), mx.data_ptr(), den.data_ptr(),
            n, e_total, hidden, heads, int(v.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"{_KERNEL} launch failed with CUDA error {rc}")
    launches += 1
    return out, mx, den


def aggregate_bwd_cuda(logits_t: torch.Tensor, scale_t: torch.Tensor,
                       v: torch.Tensor, row_ptr: torch.Tensor,
                       g: torch.Tensor, mx: torch.Tensor, den: torch.Tensor,
                       *, heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel 2 on the current stream → (dl_t, dv) as
    `aggregate_bwd_plain`. `g` is the f32 cotangent of out. Raises on
    anything the kernels do not take."""
    global bwd_launches
    extra = (("g", g, lambda n, hid: (n, hid)),
             ("max", mx, lambda n, hid: (n, heads)),
             ("denom", den, lambda n, hid: (n, heads)))
    n, hidden, e_total = _check_inputs(logits_t, scale_t, v, row_ptr,
                                       heads=heads, extra=extra)
    device = v.device
    dl_t = torch.empty((heads, e_total), dtype=torch.float32, device=device)
    dv = torch.empty((e_total, hidden), dtype=v.dtype, device=device)
    if n == 0:
        return dl_t.zero_(), dv.zero_()
    # per-edge s and u, written and read back by the warp that owns the edge
    s_s = torch.empty((heads, e_total), dtype=torch.float32, device=device)
    u_s = torch.empty_like(s_s)
    lib = _lib(_KERNEL_BWD)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.softmax_aggregate_bwd(
            logits_t.data_ptr(), scale_t.data_ptr(), v.data_ptr(),
            row_ptr.data_ptr(), g.data_ptr(), mx.data_ptr(), den.data_ptr(),
            dl_t.data_ptr(), dv.data_ptr(), s_s.data_ptr(), u_s.data_ptr(),
            n, e_total, hidden, heads, int(v.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"{_KERNEL_BWD} launch failed with CUDA error "
                           f"{rc}")
    bwd_launches += 1
    return dl_t, dv


class CsrSoftmaxAggregate(torch.autograd.Function):
    """The softmax-aggregate as one differentiable op: forward kernel 1 and
    backward kernel 2 on the card, their plain versions on the CPU. Returns
    (out f32, max, denom); max and denom carry no gradient."""

    @staticmethod
    def forward(ctx, logits_t, scale_t, v, row_ptr, dst, heads):
        if v.device.type == "cpu":
            out, mx, den = aggregate_plain(logits_t, scale_t, v, row_ptr, dst,
                                           heads=heads)
        else:
            out, mx, den = aggregate_cuda(logits_t, scale_t, v, row_ptr,
                                          heads=heads)
        ctx.save_for_backward(logits_t, scale_t, v, row_ptr, dst, mx, den)
        ctx.heads = heads
        ctx.mark_non_differentiable(mx, den)
        return out, mx, den

    @staticmethod
    def backward(ctx, g, _g_max, _g_den):
        logits_t, scale_t, v, row_ptr, dst, mx, den = ctx.saved_tensors
        g = g.float().contiguous()
        if v.device.type == "cpu":
            dl_t, dv = aggregate_bwd_plain(logits_t, scale_t, v, row_ptr, dst,
                                           g, mx, den, heads=ctx.heads)
        else:
            dl_t, dv = aggregate_bwd_cuda(logits_t, scale_t, v, row_ptr, g,
                                          mx, den, heads=ctx.heads)
        return dl_t, None, dv, None, None, None


def fused_aggregate_t(logits_t: torch.Tensor, v_j: torch.Tensor,
                      row_ptr: torch.Tensor, *, dst: torch.Tensor,
                      heads: int, scale_t: Optional[torch.Tensor] = None,
                      return_stats: bool = False):
    """Segment softmax-aggregate, JAX argument layout: `logits_t` f32
    [heads, E] (masked edges at −1e30), `v_j` [E, H], `row_ptr` [N+1] the
    CSR pointers of the sorted `dst` [E]. `scale_t` [heads, E] multiplies α
    after normalisation (dropout; default ones). Returns out f32 [N, H],
    plus (max, denom) [N, heads] with `return_stats`; differentiable in
    logits_t and v_j. The dummy row's (n−1) output is unspecified, and its
    edges carry no gradient."""
    if scale_t is None:
        scale_t = torch.ones_like(logits_t)
    res = CsrSoftmaxAggregate.apply(logits_t.contiguous(),
                                    scale_t.contiguous(), v_j.contiguous(),
                                    row_ptr, dst, heads)
    return res if return_stats else res[0]
