"""Segment softmax of external per-edge logits and the weighted sum of
per-edge values, forward and backward: the CUDA kernels
`csrc/softmax_aggregate_fwd.cu` and `csrc/softmax_aggregate_bwd.cu`, their
ctypes wrappers, their plain PyTorch versions, their launch counts and the
`torch.autograd.Function` that joins them. Also the plain softmax pieces
that the attention modules' plain versions share.

Counterpart of `fused_aggregate_t` / `csr_softmax_aggregate` in
`gnnep_tpu/ops/pallas/csr_attention.py` (TPU kernels `_kernel` and
`_bwd_kernel`), the external-logits rung of the conv (`attn_fused=False`):

    out_n = Σ_{e→n} softmax_e(logits[e, h]) · scale[e, h] · v_e

per head over the CSR segments of a dst-sorted edge arena, differentiable in
the logits and v. There is no mask stream: a masked edge carries the logit
−1e30, and an edge counts only if its logit is above −0.5e30 (the TPU
kernel's clamp). The kernels, their plain versions and `fused_aggregate`
take the logits and the scale as [E, heads], an edge's heads one
contiguous run (the TPU kernels' [heads, E] is a tiling choice; the conv
builds [E, heads] and so copies nothing); `fused_aggregate_t` keeps the JAX
function's [heads, E] arguments. A tensor on the CPU takes the plain
versions; a CUDA tensor launches the kernels or raises. The kernels share
kernels 3 and 4's layout (`csrc/attn_kv.cuh`) and planner
(`kv_layout.kv_plan`), with thresholds of their own (`aggregate_plan`).

The forward is also the custom op `gnnep_torch::softmax_aggregate_fwd`
(its CPU kernel the plain version, its CUDA kernel the launch, and a shape
function), so that `torch.export` traces it (`infer/bundle.py`);
registering it builds nothing.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.library import custom_op

from ..segment import segment_max, segment_sum
from . import build
from .kv_layout import (AttentionPlan, kv_plan, offsets, plan_args,
                        shape_of)
from .segment_sum import csr_segment_sum_plain

_NEG = -1e30
_KERNEL = "softmax_aggregate_fwd"
_KERNEL_BWD = "softmax_aggregate_bwd"

# kernel launches since the last reset, forward and backward; the chip smoke
# run sets them to 0 just before it drives a path and reads them just after
launches = 0
bwd_launches = 0

# a conv whose warps (one a target and group of heads) number fewer than
# these splits each row over 2 or 4 warps, to reach them (the flagship's
# atom conv, 768 targets): the fastest of 1, 2 and 4 warps a row there on
# an H100 (dev/attn_variants.py; PERF.md §6), measured at that one shape
SPLIT_TO = {"forward": 1536, "backward": 3072}
# warps a block holds, at most: at the flagship line graph kernel 1 was
# fastest with 4, kernel 2 with 8, on an H100 (dev/attn_variants.py;
# PERF.md §6)
BLOCK_WARPS = {"forward": 4, "backward": 8}
# slabs of heads a kernel 1 warp may hold: two let an f32 warp hold all 4
# flagship heads, faster at the line graph (dev/attn_variants.py; PERF.md
# §6); its pair lanes take windows of two groups of edges, so a warp holds
# at most 4 heads a slab
FWD_SLABS = 2


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
def _scale(scale: Optional[torch.Tensor],
           logits: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(logits) if scale is None else scale


def aggregate_plain(logits: torch.Tensor, scale: Optional[torch.Tensor],
                    v: torch.Tensor, row_ptr: torch.Tensor,
                    dst: torch.Tensor, *, heads: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 1: logits and scale f32 [E, heads]
    (None: ones) → (out f32 [N, H], max [N, heads], denom [N, heads])."""
    return softmax_aggregate_edges(logits, logits > 0.5 * _NEG,
                                   _scale(scale, logits), v, dst,
                                   row_ptr.shape[0] - 1, heads)


def aggregate_bwd_plain(logits: torch.Tensor, scale: Optional[torch.Tensor],
                        v: torch.Tensor, row_ptr: torch.Tensor,
                        dst: torch.Tensor, g: torch.Tensor, mx: torch.Tensor,
                        den: torch.Tensor, *, heads: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 2 → (dl f32 [E, heads], dv [E, H]
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
    live = (logits > 0.5 * _NEG) & (dst != n - 1)[:, None]
    s = softmax_probs(logits, live, mx, den, dst)
    sc = _scale(scale, logits)
    g_e = g.to(v.dtype).float().index_select(0, dst)
    u = (g_e * v.float()).reshape(e_total, heads, ch).sum(-1)
    dl = softmax_logit_grad(s, sc, u, row_ptr, dst)
    dv = widen((s * sc).to(v.dtype).float(), ch) * g_e
    return dl, dv.to(v.dtype)


# ------------------------------------------------------------------ kernels
def aggregate_plan(n: int, e_total: int, hidden: int, heads: int,
                   itemsize: int, v_ptr: int,
                   heads_per_warp: Optional[int] = None,
                   split: Optional[int] = None, backward: bool = False,
                   device: Optional[torch.device] = None) -> AttentionPlan:
    """The launch plan of kernel 1 (kernel 2's with `backward`) on CUDA
    `device` (None: an H100's SM count and L2); see `kv_layout.kv_plan`.
    The word divides v's base (the logits, scales, g and stats are f32
    rows read element by element); kernel 1's warps hold the heads of
    `FWD_SLABS` slabs where the conv keeps `SPLIT_TO` warps; rows are split
    below `SPLIT_TO` warps; a block holds `BLOCK_WARPS`; the kernels stream
    v (kernel 2 also dv) where two copies of it would exceed L2, as kernel
    3 streams k and v (at the flagship line graph that helps bf16's 38 MB v
    too). From the shapes,
    the type and v's alignment alone, so a captured graph replays it.
    `heads_per_warp` and `split` force a layout (the checks and the benches
    run others)."""
    sms, l2 = shape_of(device)
    way = "backward" if backward else "forward"
    return kv_plan(n, e_total, hidden, heads, itemsize, offsets((v_ptr,)),
                   heads_per_warp, split, SPLIT_TO[way], BLOCK_WARPS[way],
                   2 * e_total * hidden * itemsize > l2, sms,
                   1 if backward else FWD_SLABS, 1 if backward else 2)


def _lib(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == _KERNEL and lib.softmax_aggregate_fwd.argtypes is None:
        lib.softmax_aggregate_fwd.argtypes = [p] * 7 + [i] * 12 + [p]
        lib.softmax_aggregate_fwd.restype = i
        lib.softmax_aggregate_fwd_empty.argtypes = [i] * 10 + [p]
        lib.softmax_aggregate_fwd_empty.restype = i
    if name == _KERNEL_BWD and lib.softmax_aggregate_bwd.argtypes is None:
        lib.softmax_aggregate_bwd.argtypes = [p] * 9 + [i] * 13 + [p]
        lib.softmax_aggregate_bwd.restype = i
        lib.softmax_aggregate_bwd_empty.argtypes = [i] * 11 + [p]
        lib.softmax_aggregate_bwd_empty.restype = i
    return lib


def _check_inputs(logits, scale, v, row_ptr, *, heads, extra=()):
    """Raise on anything the kernels do not take. `scale` may be None;
    `extra` are further (name, tensor, shape) f32 inputs of the backward
    → (n, hidden, E)."""
    given = dict(v=v, logits=logits, row_ptr=row_ptr,
                 **{name: t for name, t, _ in extra})
    if scale is not None:
        given["scale"] = scale
    build.check_card_tensors(given)
    if v.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"v must be float32 or bfloat16, not {v.dtype}")
    if any(t.dtype != torch.float32 for name, t in given.items()
           if name not in ("v", "row_ptr")):
        raise TypeError("logits, scale, g and the stats must be float32")
    if row_ptr.dtype != torch.int32:
        raise TypeError(f"row_ptr must be int32, not {row_ptr.dtype}")
    e_total = v.shape[0]
    hidden = v.shape[1] if v.dim() == 2 else -1
    n = row_ptr.shape[0] - 1
    bad = [name for name, t, shape in extra
           if tuple(t.shape) != shape(n, hidden)]
    if (v.dim() != 2 or heads <= 0 or hidden % heads or e_total >= 2 ** 31
            or tuple(logits.shape) != (e_total, heads)
            or (scale is not None
                and tuple(scale.shape) != (e_total, heads))
            or row_ptr.dim() != 1 or n < 0 or bad):
        raise ValueError(
            f"shapes the kernel does not take: logits "
            f"{tuple(logits.shape)}, scale "
            f"{None if scale is None else tuple(scale.shape)}, v "
            f"{tuple(v.shape)}, row_ptr {tuple(row_ptr.shape)}, heads "
            f"{heads} (needs [E, heads] logits and scale, hidden % heads "
            f"== 0); wrong shape: {bad}")
    return n, hidden, e_total


def _own_plan(v: torch.Tensor, n: int, heads: int,
              backward: bool) -> AttentionPlan:
    e_total, hidden = v.shape
    return aggregate_plan(n, e_total, hidden, heads, v.element_size(),
                          v.data_ptr(), backward=backward, device=v.device)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def aggregate_cuda(logits: torch.Tensor, scale: Optional[torch.Tensor],
                   v: torch.Tensor, row_ptr: torch.Tensor, *, heads: int,
                   plan: Optional[AttentionPlan] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch kernel 1 on the current stream → (out, max, denom) as
    `aggregate_plain` (scale None: no scale is read), on `aggregate_plan`'s
    plan (`plan`: another, for the checks' and the dev benches' layouts).
    Raises on anything the kernel does not take."""
    global launches
    n, hidden, e_total = _check_inputs(logits, scale, v, row_ptr,
                                       heads=heads)
    device = v.device
    out = torch.empty((n, hidden), dtype=torch.float32, device=device)
    mx = torch.empty((n, heads), dtype=torch.float32, device=device)
    den = torch.empty((n, heads), dtype=torch.float32, device=device)
    if n == 0:
        return out, mx, den
    plan = plan or _own_plan(v, n, heads, False)
    lib = _lib(_KERNEL)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.softmax_aggregate_fwd(
            logits.data_ptr(), _ptr(scale), v.data_ptr(),
            row_ptr.data_ptr(), out.data_ptr(), mx.data_ptr(), den.data_ptr(),
            n, e_total, hidden, heads, int(v.dtype == torch.bfloat16),
            *plan_args(plan), int(plan.stream), stream)
    if rc != 0:
        raise RuntimeError(f"{_KERNEL} launch failed with CUDA error {rc}")
    launches += 1
    return out, mx, den


def aggregate_bwd_cuda(logits: torch.Tensor, scale: Optional[torch.Tensor],
                       v: torch.Tensor, row_ptr: torch.Tensor,
                       g: torch.Tensor, mx: torch.Tensor, den: torch.Tensor,
                       *, heads: int, plan: Optional[AttentionPlan] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel 2 on the current stream → (dl, dv) as
    `aggregate_bwd_plain`, on `aggregate_plan`'s plan (`plan`: another).
    `g` is the f32 cotangent of out. One CUDA kernel, no scratch: a row of
    more than 32 edges keeps its u in dl until the kernel overwrites it.
    Raises on anything the kernel does not take."""
    global bwd_launches
    extra = (("g", g, lambda n, hid: (n, hid)),
             ("max", mx, lambda n, hid: (n, heads)),
             ("denom", den, lambda n, hid: (n, heads)))
    n, hidden, e_total = _check_inputs(logits, scale, v, row_ptr,
                                       heads=heads, extra=extra)
    device = v.device
    dl = torch.empty((e_total, heads), dtype=torch.float32, device=device)
    dv = torch.empty((e_total, hidden), dtype=v.dtype, device=device)
    if n == 0:
        return dl.zero_(), dv.zero_()
    plan = plan or _own_plan(v, n, heads, True)
    lib = _lib(_KERNEL_BWD)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.softmax_aggregate_bwd(
            logits.data_ptr(), _ptr(scale), v.data_ptr(),
            row_ptr.data_ptr(), g.data_ptr(), mx.data_ptr(), den.data_ptr(),
            dl.data_ptr(), dv.data_ptr(), n, e_total, hidden, heads,
            int(v.dtype == torch.bfloat16), *plan_args(plan),
            plan.tail_blocks, int(plan.stream), stream)
    if rc != 0:
        raise RuntimeError(f"{_KERNEL_BWD} launch failed with CUDA error "
                           f"{rc}")
    bwd_launches += 1
    return dl, dv


def aggregate_empty_cuda(v: torch.Tensor, n: int, *, heads: int,
                         backward: bool = False,
                         plan: Optional[AttentionPlan] = None) -> None:
    """Launch an empty kernel on the grid and block that kernel 1's plan
    (kernel 2's with `backward`) gives v and n targets: the launch latency
    that a chain of calls cannot go below. Counts no launch."""
    plan = plan or _own_plan(v, n, heads, backward)
    lib = _lib(_KERNEL_BWD if backward else _KERNEL)
    args = (n, v.shape[1], heads, int(v.dtype == torch.bfloat16),
            *plan_args(plan))
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = (lib.softmax_aggregate_bwd_empty(*args, plan.tail_blocks, stream)
              if backward else lib.softmax_aggregate_fwd_empty(*args, stream))
    if rc != 0:
        raise RuntimeError(f"empty launch failed with CUDA error {rc}")


@custom_op("gnnep_torch::softmax_aggregate_fwd", mutates_args=(),
           device_types="cpu",
           schema="(Tensor logits, Tensor? scale, Tensor v, Tensor row_ptr, "
                  "Tensor dst, int heads) -> (Tensor, Tensor, Tensor)")
def softmax_aggregate_fwd(logits, scale, v, row_ptr, dst, heads):
    """Kernel 1 as an op → (out f32 [N, H], max, denom [N, heads]): the
    plain version on the CPU, the kernel on the card."""
    return aggregate_plain(logits, scale, v, row_ptr, dst, heads=heads)


@softmax_aggregate_fwd.register_kernel("cuda")
def _softmax_aggregate_fwd_cuda(logits, scale, v, row_ptr, dst, heads):
    return aggregate_cuda(logits, scale, v, row_ptr, heads=heads)


@softmax_aggregate_fwd.register_fake
def _softmax_aggregate_fwd_fake(logits, scale, v, row_ptr, dst, heads):
    n = row_ptr.shape[0] - 1
    f32 = dict(dtype=torch.float32)
    return (v.new_empty((n, v.shape[1]), **f32),
            v.new_empty((n, heads), **f32), v.new_empty((n, heads), **f32))


class CsrSoftmaxAggregate(torch.autograd.Function):
    """The softmax-aggregate as one differentiable op: forward kernel 1 and
    backward kernel 2 on the card, their plain versions on the CPU. Returns
    (out f32, max, denom); max and denom carry no gradient."""

    @staticmethod
    def forward(ctx, logits, scale, v, row_ptr, dst, heads):
        out, mx, den = softmax_aggregate_fwd(logits, scale, v, row_ptr, dst,
                                             heads)
        ctx.save_for_backward(logits, scale, v, row_ptr, dst, mx, den)
        ctx.heads = heads
        ctx.mark_non_differentiable(mx, den)
        return out, mx, den

    @staticmethod
    def backward(ctx, g, _g_max, _g_den):
        logits, scale, v, row_ptr, dst, mx, den = ctx.saved_tensors
        g = g.float().contiguous()
        if v.device.type == "cpu":
            dl, dv = aggregate_bwd_plain(logits, scale, v, row_ptr, dst, g,
                                         mx, den, heads=ctx.heads)
        else:
            dl, dv = aggregate_bwd_cuda(logits, scale, v, row_ptr, g, mx,
                                        den, heads=ctx.heads)
        return dl, None, dv, None, None, None


def fused_aggregate(logits: torch.Tensor, v_j: torch.Tensor,
                    row_ptr: torch.Tensor, *, dst: torch.Tensor, heads: int,
                    scale: Optional[torch.Tensor] = None,
                    return_stats: bool = False):
    """Segment softmax-aggregate, the port's argument layout: `logits` f32
    [E, heads] (masked edges at −1e30), `v_j` [E, H], `row_ptr` [N+1] the
    CSR pointers of the sorted `dst` [E]. `scale` [E, heads] multiplies α
    after normalisation (dropout; None: no scale). Returns out f32 [N, H],
    plus (max, denom) [N, heads] with `return_stats`; differentiable in
    logits and v_j (without a gradient to take, the op alone runs). The
    dummy row's (n−1) output is unspecified, and its edges carry no
    gradient."""
    args = (logits.contiguous(), None if scale is None else scale.contiguous(),
            v_j.contiguous(), row_ptr, dst, heads)
    res = (CsrSoftmaxAggregate.apply(*args) if build.needs_grad(logits, v_j)
           else softmax_aggregate_fwd(*args))
    return res if return_stats else res[0]


def fused_aggregate_t(logits_t: torch.Tensor, v_j: torch.Tensor,
                      row_ptr: torch.Tensor, *, dst: torch.Tensor,
                      heads: int, scale_t: Optional[torch.Tensor] = None,
                      return_stats: bool = False):
    """`fused_aggregate` in the JAX function's argument layout: `logits_t`
    and `scale_t` [heads, E] (transposed into [E, heads]; the gradient of
    logits_t comes back in its own layout)."""
    return fused_aggregate(logits_t.t(), v_j, row_ptr, dst=dst, heads=heads,
                           scale=None if scale_t is None else scale_t.t(),
                           return_stats=return_stats)
