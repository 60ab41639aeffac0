"""CSR attention over precomputed per-edge keys and values, forward and
backward: the CUDA kernels `csrc/attn_fwd.cu` and `csrc/attn_bwd.cu`, their
ctypes wrappers, their plain PyTorch versions, their launch counts and the
`torch.autograd.Function` that joins them.

Counterpart of `fused_attention` / `csr_attention` in
`gnnep_tpu/ops/pallas/csr_attention.py` (TPU kernels `_attn_kernel` and
`_attn_bwd_kernel`), the kv+e rung of the conv (`attn_eproj=False`):

    out_n = Σ_{e→n} softmax_e(q_n·k_e/√c) · scale_e · v_e

per head over the CSR segments of a dst-sorted edge arena, with `mask2`
excluding edges before the softmax; differentiable in q, k_e and v_e. A
tensor on the CPU takes the plain versions; a CUDA tensor launches the
kernels or raises.

The forward is also the custom op `gnnep_torch::attn_fwd` (its CPU kernel
the plain version, its CUDA kernel the launch, and a shape function), so
that `torch.export` traces it (`infer/bundle.py`); registering it builds
nothing.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch
from torch.library import custom_op

from ..segment import segment_sum
from . import build
from .aggregate import (softmax_aggregate_edges, softmax_logit_grad,
                        softmax_probs, widen)
from .kv_layout import (EDGES_IN_FLIGHT, L2_BYTES, MAX_WARPS,  # noqa: F401
                        SMS, AttentionPlan, kv_plan, offsets, plan_args,
                        shape_of)

_KERNEL = "attn_fwd"
_KERNEL_BWD = "attn_bwd"

# kernel launches since the last reset, forward and backward; the chip smoke
# run sets them to 0 just before it drives a path and reads them just after
launches = 0
bwd_launches = 0


# kernel 4's blocks hold at most 4 warps: at the flagship line graph 4 beat
# 8 by 1.5 % (f32) and 2.6 % (bf16) on an H100, while kernel 3 loses 10-15 %
# with 4 (dev/attn_variants.py; PERF.md §6)
MAX_WARPS_BWD = 4
# a conv whose warps (one a target and group of heads) number fewer than
# these splits each row over 2 or 4 warps, to reach them: its time is then
# each warp's chain of loads over the longest rows, not the card's
# bandwidth (the flagship's atom conv, 768 targets). The counts are the
# fastest of 1, 2 and 4 warps a row there, forward and backward, f32 and
# bf16, on an H100 (dev/attn_variants.py; PERF.md §6). They were measured
# at that one shape only: other target counts near them are untimed
SPLIT_TO = {"forward": 3072, "backward": 1536}


def attention_plan(n: int, e_total: int, hidden: int, heads: int,
                   itemsize: int, q_ptr: int, k_ptr: int, v_ptr: int,
                   heads_per_warp: Optional[int] = None,
                   split: Optional[int] = None,
                   backward: bool = False,
                   device: Optional[torch.device] = None) -> AttentionPlan:
    """The launch plan of kernel 3 (kernel 4's with `backward`) on CUDA
    `device` (None: an H100's SM count and L2); see `kv_layout.kv_plan`.
    The word divides the three bases; rows are split below `SPLIT_TO`
    warps; a block holds 8 warps (kernel 4: 4); kernel 3 streams k and v
    where together they exceed L2. Only the bases' alignment to 16 bytes
    enters it, so it is worked out once per shape, alignment and card."""
    sms, l2 = shape_of(device)
    return kv_plan(n, e_total, hidden, heads, itemsize,
                   offsets((q_ptr, k_ptr, v_ptr)), heads_per_warp, split,
                   SPLIT_TO["backward" if backward else "forward"],
                   MAX_WARPS_BWD if backward else MAX_WARPS,
                   not backward and 2 * e_total * hidden * itemsize > l2, sms)


def inv_sqrt(ch: int) -> float:
    """1/√ch rounded once to f32, as the kernels' constant is."""
    return float(np.float32(1.0 / ch ** 0.5))


def edge_logits(q: torch.Tensor, k: torch.Tensor, dst: torch.Tensor,
                heads: int) -> torch.Tensor:
    """q_dst·k/√c per edge and head → f32 [E, heads]: the products of the
    input type summed in f32, as the kernels' f32-accumulated products."""
    e_total, hidden = k.shape
    ch = hidden // heads
    return (q.float().index_select(0, dst) * k.float()).reshape(
        e_total, heads, ch).sum(-1) * inv_sqrt(ch)


def attention_plain(q: torch.Tensor, k_e: torch.Tensor, v_e: torch.Tensor,
                    scale_t: torch.Tensor, mask2: torch.Tensor,
                    dst: torch.Tensor, *, heads: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 3 → (out f32 [N, H], max [N, heads],
    denom [N, heads]), rounding where the TPU kernel rounds: f32 logits from
    f32-accumulated products, α to v's type before the aggregation, all
    sums f32."""
    return softmax_aggregate_edges(
        edge_logits(q, k_e, dst, heads), (mask2 > 0)[:, None], scale_t.t(),
        v_e, dst, q.shape[0], heads)


def attention_bwd_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale_t: torch.Tensor, mask2: torch.Tensor,
                      row_ptr: torch.Tensor, dst: torch.Tensor,
                      g: torch.Tensor, mx: torch.Tensor, den: torch.Tensor,
                      *, heads: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The attention backward before its last rounding → f32 (dq [N, H],
    dk [E, H], dv [E, H]), for kernel 4's plain version and kernel 6's.

    A port of the JAX package's edge-space fallback (`_attn_bwd`,
    `csr_attention.py:851-883`), with the segment-sum plain version in
    place of `windowed_segment_sum`, rounding where the kernels round: g to
    the input type before u and dv, dl and α to it before their products.
    A dead edge (masked, or owned by the dummy row n−1, whose output is
    unspecified) gets zero rows; so does the dummy row's dq."""
    n = q.shape[0]
    ch = k.shape[1] // heads
    dt = k.dtype
    inv = inv_sqrt(ch)
    live = ((mask2 > 0) & (dst != n - 1))[:, None]
    s = softmax_probs(edge_logits(q, k, dst, heads), live, mx, den, dst)
    sc = scale_t.t()
    q_e = q.float().index_select(0, dst)
    g_e = g.to(dt).float().index_select(0, dst)
    u = (g_e * v.float()).reshape(k.shape[0], heads, ch).sum(-1)
    dl = widen(softmax_logit_grad(s, sc, u, row_ptr, dst).to(dt).float(), ch)
    dq = segment_sum(dl * k.float(), dst, n) * inv
    dk = dl * q_e * inv
    dv = widen((s * sc).to(dt).float(), ch) * g_e
    return dq, dk, dv


def attention_bwd_plain(q: torch.Tensor, k_e: torch.Tensor, v_e: torch.Tensor,
                        scale_t: torch.Tensor, mask2: torch.Tensor,
                        row_ptr: torch.Tensor, dst: torch.Tensor,
                        g: torch.Tensor, mx: torch.Tensor, den: torch.Tensor,
                        *, heads: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 4 → (dq [N, H], dk [E, H], dv [E, H])
    in the input type (see `attention_bwd_f32`)."""
    dq, dk, dv = attention_bwd_f32(q, k_e, v_e, scale_t, mask2, row_ptr, dst,
                                   g, mx, den, heads=heads)
    return dq.to(q.dtype), dk.to(k_e.dtype), dv.to(v_e.dtype)


def _lib(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == _KERNEL and lib.attn_fwd.argtypes is None:
        lib.attn_fwd.argtypes = ([p] * 10 + [i] * 4 + [ctypes.c_float]
                                 + [i] * 8 + [p])
        lib.attn_fwd.restype = i
        lib.attn_fwd_empty.argtypes = [i] * 10 + [p]
        lib.attn_fwd_empty.restype = i
    if name == _KERNEL_BWD and lib.attn_bwd.argtypes is None:
        lib.attn_bwd.argtypes = ([p] * 14 + [i] * 4 + [ctypes.c_float]
                                 + [i] * 8 + [p])
        lib.attn_bwd.restype = i
        lib.attn_bwd_empty.argtypes = [i] * 11 + [p]
        lib.attn_bwd_empty.restype = i
    return lib


def _check_inputs(q, k_e, v_e, scale_t, mask2, row_ptr, *, heads, extra=()):
    """Raise on anything the kernels do not take. `extra` are further
    (name, tensor, shape) f32 inputs of the backward → (n, hidden, E)."""
    build.check_card_tensors(dict(q=q, k_e=k_e, v_e=v_e, scale_t=scale_t,
                                  mask2=mask2, row_ptr=row_ptr,
                                  **{name: t for name, t, _ in extra}))
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, not {q.dtype}")
    if k_e.dtype != q.dtype or v_e.dtype != q.dtype:
        raise TypeError(f"k_e is {k_e.dtype} and v_e {v_e.dtype}; q, k_e "
                        f"and v_e must share one type ({q.dtype})")
    if any(t.dtype != torch.float32
           for t in (scale_t, mask2, *(t for _, t, _ in extra))):
        raise TypeError("scale_t, mask2, g and the stats must be float32")
    if row_ptr.dtype != torch.int32:
        raise TypeError(f"row_ptr must be int32, not {row_ptr.dtype}")
    n = q.shape[0]
    hidden = q.shape[1] if q.dim() == 2 else -1
    e_total = k_e.shape[0]
    bad = [name for name, t, shape in extra if tuple(t.shape) != shape]
    if (q.dim() != 2 or heads <= 0 or hidden % heads or e_total >= 2 ** 31
            or tuple(k_e.shape) != (e_total, hidden)
            or tuple(v_e.shape) != (e_total, hidden)
            or tuple(scale_t.shape) != (heads, e_total)
            or tuple(mask2.shape) != (e_total,)
            or tuple(row_ptr.shape) != (n + 1,) or bad):
        raise ValueError(
            f"shapes the kernel does not take: q {tuple(q.shape)}, k_e "
            f"{tuple(k_e.shape)}, v_e {tuple(v_e.shape)}, scale_t "
            f"{tuple(scale_t.shape)}, mask2 {tuple(mask2.shape)}, row_ptr "
            f"{tuple(row_ptr.shape)}, heads {heads} (needs hidden % heads "
            f"== 0); wrong shape: {bad}")
    return n, hidden, e_total


def attention_cuda(q: torch.Tensor, k_e: torch.Tensor, v_e: torch.Tensor,
                   scale_t: torch.Tensor, mask2: torch.Tensor,
                   row_ptr: torch.Tensor, *, heads: int,
                   plan: Optional[AttentionPlan] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch kernel 3 on the current stream → (out, max, denom) as
    `attention_plain`, on `attention_plan`'s plan (`plan`: another, for
    the dev benches' variants). Raises on anything the kernel does not
    take."""
    global launches
    n, hidden, e_total = _check_inputs(q, k_e, v_e, scale_t, mask2, row_ptr,
                                       heads=heads)
    device = q.device
    out = torch.empty((n, hidden), dtype=torch.float32, device=device)
    mx = torch.empty((n, heads), dtype=torch.float32, device=device)
    den = torch.empty((n, heads), dtype=torch.float32, device=device)
    if n == 0:
        return out, mx, den
    plan = plan or attention_plan(n, e_total, hidden, heads, q.element_size(),
                                  q.data_ptr(), k_e.data_ptr(),
                                  v_e.data_ptr(), device=device)
    # the logits of rows of more than 32 edges, written and read back by the
    # warp that owns the row (shorter rows keep theirs on chip)
    logit_s = torch.empty((heads, e_total), dtype=torch.float32,
                          device=device)
    lib = _lib(_KERNEL)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.attn_fwd(
            q.data_ptr(), k_e.data_ptr(), v_e.data_ptr(), scale_t.data_ptr(),
            mask2.data_ptr(), row_ptr.data_ptr(), out.data_ptr(),
            mx.data_ptr(), den.data_ptr(), logit_s.data_ptr(), n, e_total,
            hidden, heads, inv_sqrt(hidden // heads),
            int(q.dtype == torch.bfloat16), *plan_args(plan),
            int(plan.stream), stream)
    if rc != 0:
        raise RuntimeError(f"{_KERNEL} launch failed with CUDA error {rc}")
    launches += 1
    return out, mx, den


def attention_bwd_cuda(q: torch.Tensor, k_e: torch.Tensor, v_e: torch.Tensor,
                       scale_t: torch.Tensor, mask2: torch.Tensor,
                       row_ptr: torch.Tensor, g: torch.Tensor,
                       mx: torch.Tensor, den: torch.Tensor, *, heads: int,
                       plan: Optional[AttentionPlan] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch kernel 4 on the current stream → (dq, dk, dv) as
    `attention_bwd_plain`, on `attention_plan`'s plan (`plan`: another,
    for the dev benches' variants). `g` is the f32 cotangent of out.
    Raises on anything the kernel does not take."""
    global bwd_launches
    n = q.shape[0]
    extra = (("g", g, tuple(q.shape)), ("max", mx, (n, heads)),
             ("denom", den, (n, heads)))
    n, hidden, e_total = _check_inputs(q, k_e, v_e, scale_t, mask2, row_ptr,
                                       heads=heads, extra=extra)
    device = q.device
    dq = torch.empty((n, hidden), dtype=q.dtype, device=device)
    dk = torch.empty((e_total, hidden), dtype=q.dtype, device=device)
    dv = torch.empty((e_total, hidden), dtype=q.dtype, device=device)
    if n == 0:
        return dq, dk.zero_(), dv.zero_()
    plan = plan or attention_plan(n, e_total, hidden, heads, q.element_size(),
                                  q.data_ptr(), k_e.data_ptr(),
                                  v_e.data_ptr(), backward=True,
                                  device=device)
    # s and u of rows of more than 32 edges, written and read back by the
    # warp that owns the row (shorter rows keep theirs on chip)
    s_s = torch.empty((heads, e_total), dtype=torch.float32, device=device)
    u_s = torch.empty_like(s_s)
    lib = _lib(_KERNEL_BWD)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.attn_bwd(
            q.data_ptr(), k_e.data_ptr(), v_e.data_ptr(), scale_t.data_ptr(),
            mask2.data_ptr(), row_ptr.data_ptr(), g.data_ptr(), mx.data_ptr(),
            den.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            s_s.data_ptr(), u_s.data_ptr(), n, e_total, hidden, heads,
            inv_sqrt(hidden // heads), int(q.dtype == torch.bfloat16),
            *plan_args(plan), plan.tail_blocks, stream)
    if rc != 0:
        raise RuntimeError(f"{_KERNEL_BWD} launch failed with CUDA error "
                           f"{rc}")
    bwd_launches += 1
    return dq, dk, dv


def attention_empty_cuda(q: torch.Tensor, k_e: torch.Tensor,
                         v_e: torch.Tensor, *, heads: int,
                         backward: bool = False,
                         plan: Optional[AttentionPlan] = None) -> None:
    """Launch an empty kernel on the grid and block that kernel 3's plan
    (kernel 4's with `backward`) gives these inputs: the launch latency
    that a chain of calls cannot go below. Counts no launch."""
    n, hidden = q.shape
    plan = plan or attention_plan(n, k_e.shape[0], hidden, heads,
                                  q.element_size(), q.data_ptr(),
                                  k_e.data_ptr(), v_e.data_ptr(),
                                  backward=backward, device=q.device)
    lib = _lib(_KERNEL_BWD if backward else _KERNEL)
    args = (n, hidden, heads, int(q.dtype == torch.bfloat16),
            *plan_args(plan))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = (lib.attn_bwd_empty(*args, plan.tail_blocks, stream) if backward
              else lib.attn_fwd_empty(*args, stream))
    if rc != 0:
        raise RuntimeError(f"empty launch failed with CUDA error {rc}")


@custom_op("gnnep_torch::attn_fwd", mutates_args=(), device_types="cpu",
           schema="(Tensor q, Tensor k_e, Tensor v_e, Tensor scale_t, "
                  "Tensor mask2, Tensor row_ptr, Tensor dst, int heads) -> "
                  "(Tensor, Tensor, Tensor)")
def attn_fwd(q, k_e, v_e, scale_t, mask2, row_ptr, dst, heads):
    """Kernel 3 as an op → (out f32 [N, H], max, denom [N, heads]): the
    plain version on the CPU, the kernel on the card."""
    return attention_plain(q, k_e, v_e, scale_t, mask2, dst, heads=heads)


@attn_fwd.register_kernel("cuda")
def _attn_fwd_cuda(q, k_e, v_e, scale_t, mask2, row_ptr, dst, heads):
    return attention_cuda(q, k_e, v_e, scale_t, mask2, row_ptr, heads=heads)


@attn_fwd.register_fake
def _attn_fwd_fake(q, k_e, v_e, scale_t, mask2, row_ptr, dst, heads):
    n = q.shape[0]
    f32 = dict(dtype=torch.float32)
    return (q.new_empty((n, q.shape[1]), **f32),
            q.new_empty((n, heads), **f32), q.new_empty((n, heads), **f32))


class CsrAttention(torch.autograd.Function):
    """The attention as one differentiable op: forward kernel 3 and backward
    kernel 4 on the card, their plain versions on the CPU. Returns (out f32,
    max, denom); max and denom carry no gradient."""

    @staticmethod
    def forward(ctx, q, k_e, v_e, scale_t, mask2, row_ptr, dst, heads):
        out, mx, den = attn_fwd(q, k_e, v_e, scale_t, mask2, row_ptr, dst,
                                heads)
        ctx.save_for_backward(q, k_e, v_e, scale_t, mask2, row_ptr, dst, mx,
                              den)
        ctx.heads = heads
        ctx.mark_non_differentiable(mx, den)
        return out, mx, den

    @staticmethod
    def backward(ctx, g, _g_max, _g_den):
        q, k_e, v_e, scale_t, mask2, row_ptr, dst, mx, den = ctx.saved_tensors
        g = g.float().contiguous()
        if q.device.type == "cpu":
            dq, dk, dv = attention_bwd_plain(q, k_e, v_e, scale_t, mask2,
                                             row_ptr, dst, g, mx, den,
                                             heads=ctx.heads)
        else:
            dq, dk, dv = attention_bwd_cuda(q, k_e, v_e, scale_t, mask2,
                                            row_ptr, g, mx, den,
                                            heads=ctx.heads)
        return dq, dk, dv, None, None, None, None, None


def fused_attention(q: torch.Tensor, k_e: torch.Tensor, v_e: torch.Tensor,
                    row_ptr: torch.Tensor, dst: torch.Tensor, *, heads: int,
                    scale_t: Optional[torch.Tensor] = None,
                    mask_e: Optional[torch.Tensor] = None,
                    return_stats: bool = False):
    """Fused CSR attention, JAX argument layout: `k_e`, `v_e` [E, H] the
    per-edge keys and values, `row_ptr` [N+1] the CSR pointers of the sorted
    `dst` [E]. `scale_t` [heads, E] multiplies α after normalisation
    (dropout; default ones); `mask_e` [E] excludes edges before the softmax
    (default none). Returns out f32 [N, H], plus (max, denom) [N, heads]
    with `return_stats`; differentiable in q, k_e and v_e (without a
    gradient to take, the op alone runs). The dummy row's (n−1) output is
    unspecified, and its edges carry no gradient."""
    e_total = k_e.shape[0]
    if scale_t is None:
        scale_t = torch.ones((heads, e_total), dtype=torch.float32,
                             device=k_e.device)
    mask2 = (torch.ones(e_total, dtype=torch.float32, device=k_e.device)
             if mask_e is None
             else mask_e.to(torch.float32).reshape(e_total).contiguous())
    args = (q.contiguous(), k_e.contiguous(), v_e.contiguous(),
            scale_t.contiguous(), mask2, row_ptr, dst, heads)
    res = (CsrAttention.apply(*args) if build.needs_grad(q, k_e, v_e)
           else attn_fwd(*args))
    return res if return_stats else res[0]
