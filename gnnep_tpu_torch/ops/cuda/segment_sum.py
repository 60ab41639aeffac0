"""Sum over contiguous CSR segments: the CUDA kernel `csrc/csr_segment_sum.cu`,
its launch plan, its ctypes wrapper, its plain PyTorch version, its launch
count, and the two gathers whose backward it is.

Counterpart of `windowed_segment_sum`, `csr_gather` and `csr_gather_ordered`
in `gnnep_tpu/ops/pallas/csr_attention.py` (TPU kernel `_sum_kernel`):

    out[n] = Σ_{j ∈ [seg_starts[n], seg_starts[n+1])} values[order[j]]

(`order` None: the identity), accumulated in f32 and returned in f32 or in
the values' type (rounded once: the gathers' backward returns the
cotangent's type, as the JAX package's `dx.astype(g.dtype)`). The last
segment is the dummy row's, which owns the arena's tail padding; its sum is
unspecified by the JAX package's contract (whose `windowed_segment_sum` ends
it at `e_total_end`) and is written here as zeros, without walking its rows
(their cotangents are zero in both gathers' backward). A tensor on the CPU
takes the plain version; a CUDA tensor launches the kernel or raises.

A row window whose last row is real (the edge-sharded formulation's,
`parallel.edge_shard`) passes its R row pointers and the end of its last
segment, R + 1 bounds: the kernel then sums all R rows and the zeroed
segment is the one after them, dropped (`csr_window_sum`, and `csr_gather`
with `closed`). The kernel and its existing callers are unchanged.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from . import build

_KERNEL = "csr_segment_sum"

# kernel launches since the last reset; the chip smoke run sets it to 0 just
# before it drives a path and reads it just after
launches = 0

# csr_segment_sum.cu's block: kThreads / 32 warps
WARPS_PER_BLOCK = 4


@dataclass(frozen=True)
class SegsumPlan:
    """How the kernel covers [N, W]: warp w of the grid owns segment
    w // slices and its column slice w % slices; lane l of it owns word
    32 (w % slices) + l of each row, `vec` consecutive columns loaded at
    once (words past W / vec idle)."""
    vec: int
    slices: int
    blocks: int


def segsum_plan(n: int, width: int, in_dtype: torch.dtype,
                out_dtype: torch.dtype, values_ptr: int,
                out_ptr: int) -> SegsumPlan:
    """The launch plan from the shape, the types and the two base
    addresses alone (never the data, so a captured graph can replay it):
    the widest load of at most 16 bytes (4 f32 or 8 bf16 columns) that
    divides the width and both bases' alignment (each output word is
    stored in chunks of at most 16 bytes), narrower words otherwise."""
    item, out_item = in_dtype.itemsize, out_dtype.itemsize
    vec = 16 // item
    while vec > 1 and (width % vec or values_ptr % (vec * item)
                       or out_ptr % min(16, vec * out_item)):
        vec //= 2
    slices = -(-(width // vec) // 32)
    return SegsumPlan(vec, slices, -(-(n * slices) // WARPS_PER_BLOCK))


def csr_segment_sum_plain(values: torch.Tensor, order: Optional[torch.Tensor],
                          seg_starts: torch.Tensor,
                          out_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """Plain PyTorch version → [N, W] in `out_dtype`: the rows of the
    permuted arena `values[order]` (`order` None: the identity) summed per
    segment in f32 (float64 values in float64: the CPU's gradient checks),
    in row order, then cast; the last segment zeros."""
    n = seg_starts.shape[0]
    acc = torch.promote_types(values.dtype, torch.float32)
    out = torch.zeros((n,) + tuple(values.shape[1:]), dtype=acc,
                      device=values.device)
    if n == 0:
        return out.to(out_dtype)
    starts = seg_starts.long()
    rows = torch.arange(values.shape[0], device=values.device)
    seg = torch.searchsorted(starts, rows, right=True) - 1
    # rows before the first segment and rows of the last one are added as
    # zeros (a mask multiply, not a boolean index, so the device never
    # waits on the host)
    keep = ((seg >= 0) & (seg < n - 1)).reshape(
        (-1,) + (1,) * (values.dim() - 1))
    picked = rows if order is None else order.long()
    vals = values.index_select(0, picked).to(acc) * keep
    return out.index_add_(0, seg.clamp_min(0), vals).to(out_dtype)


def _lib() -> ctypes.CDLL:
    lib = build.load(_KERNEL)
    fn = lib.csr_segment_sum
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 4 + [i] * 5 + [p]
        fn.restype = i
        lib.csr_segment_sum_empty.argtypes = [i] * 3 + [p]
        lib.csr_segment_sum_empty.restype = i
    return lib


def _checked(values, order, seg_starts, out_dtype):
    """Raise on anything the kernel does not take → (device, n, width)."""
    tensors = {"values": values, "seg_starts": seg_starts}
    if order is not None:
        tensors["order"] = order
    device = build.check_card_tensors(tensors)
    if values.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"values must be float32 or bfloat16, not "
                        f"{values.dtype}")
    if seg_starts.dtype != torch.int32 or (order is not None
                                           and order.dtype != torch.int32):
        raise TypeError("seg_starts and order must be int32")
    e_total = values.shape[0]
    n = seg_starts.shape[0]
    if (values.dim() != 2 or seg_starts.dim() != 1 or e_total >= 2 ** 31
            or (order is not None and tuple(order.shape) != (e_total,))):
        raise ValueError(
            f"shapes the kernel does not take: values {tuple(values.shape)}, "
            f"order {None if order is None else tuple(order.shape)}, "
            f"seg_starts {tuple(seg_starts.shape)}")
    if out_dtype not in (torch.float32, values.dtype):
        raise TypeError(f"the output is float32 or the values' type, not "
                        f"{out_dtype}")
    width = values.shape[1]
    if n * -(-width // 32) >= 2 ** 31:
        raise ValueError(f"{n} segments of width {width} are more warps "
                         "than the kernel's grid indexes")
    return device, n, width


def csr_segment_sum_cuda(values: torch.Tensor, order: Optional[torch.Tensor],
                         seg_starts: torch.Tensor,
                         out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Launch the kernel on the current stream → [N, W] in `out_dtype`
    (float32 or the values' type) as `csr_segment_sum_plain`. Raises on
    anything the kernel does not take."""
    global launches
    device, n, width = _checked(values, order, seg_starts, out_dtype)
    out = torch.empty((n, width), dtype=out_dtype, device=device)
    if n == 0 or width == 0:
        return out
    plan = segsum_plan(n, width, values.dtype, out_dtype, values.data_ptr(),
                       out.data_ptr())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _lib().csr_segment_sum(
            values.data_ptr(), None if order is None else order.data_ptr(),
            seg_starts.data_ptr(), out.data_ptr(), n, width,
            int(values.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), plan.vec, stream)
    if rc != 0:
        raise RuntimeError(f"{_KERNEL} launch failed with CUDA error {rc}")
    launches += 1
    return out


def empty_launch_cuda(values: torch.Tensor, order: Optional[torch.Tensor],
                      seg_starts: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32) -> None:
    """Launch an empty kernel on the grid and block that
    `csr_segment_sum_cuda` would launch for these inputs: the floor of
    launch latency under a chain of its launches (timing only; not
    counted)."""
    device, n, width = _checked(values, order, seg_starts, out_dtype)
    if n == 0 or width == 0:
        return
    out = torch.empty((n, width), dtype=out_dtype, device=device)
    plan = segsum_plan(n, width, values.dtype, out_dtype, values.data_ptr(),
                       out.data_ptr())
    with torch.cuda.device(device):
        rc = _lib().csr_segment_sum_empty(
            n, width, plan.vec, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{_KERNEL} empty launch failed with CUDA error "
                           f"{rc}")


def csr_segment_sum(values: torch.Tensor, order: Optional[torch.Tensor],
                    seg_starts: torch.Tensor,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if values.device.type == "cpu":
        return csr_segment_sum_plain(values, order, seg_starts, out_dtype)
    return csr_segment_sum_cuda(values, order, seg_starts, out_dtype)


class CsrGatherOrdered(torch.autograd.Function):
    """`x[idx]`, whose backward permutes the cotangent by `order` (a
    permutation that sorts `idx` into contiguous segments, one per row of
    x, starting at `seg_starts`; None where `idx` is sorted already) and
    sums each segment. `closed`: `seg_starts` holds one bound more than x
    has rows, the end of the last row's segment, so the last row is summed
    too (the segment after it is the kernel's zeroed one, dropped)."""

    @staticmethod
    def forward(ctx, x, idx, order, seg_starts, closed=False):
        ctx.save_for_backward(order, seg_starts)
        ctx.closed = closed
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        order, seg_starts = ctx.saved_tensors
        # in the cotangent's type, rounded once from the f32 sum (the
        # kernel writes it so: no separate cast launch)
        dx = csr_segment_sum(g.contiguous(), order, seg_starts, g.dtype)
        return (dx[:-1] if ctx.closed else dx), None, None, None, None


def csr_gather_ordered(x: torch.Tensor, idx: torch.Tensor, order: torch.Tensor,
                       seg_starts: torch.Tensor) -> torch.Tensor:
    """`x[idx]` [E, ·] with the segment-sum backward; `order` [E] and
    `seg_starts` [N] int32 are the packer's source-sorted CSR index
    (`GraphBatch.edge_src_order` / `edge_src_starts`)."""
    if not build.needs_grad(x):
        return x.index_select(0, idx)
    return CsrGatherOrdered.apply(x, idx, order, seg_starts)


def csr_gather(x: torch.Tensor, idx: torch.Tensor, seg_starts: torch.Tensor,
               closed: bool = False) -> torch.Tensor:
    """`x[idx]` [E, ·] with the segment-sum backward, for the arena's own
    sort key: the gather of q by dst, with `seg_starts` = row_ptr[:-1] (x's
    last row, the dummy, gets a zero gradient). `closed`: `seg_starts` is
    a row window's R + 1 bounds (its row pointers and the end of its last
    segment, x [R, ·]), and every row's gradient is summed, the last
    included: the JAX package's `csr_gather` with its `e_total` end."""
    if not build.needs_grad(x):
        return x.index_select(0, idx)
    return CsrGatherOrdered.apply(x, idx, None, seg_starts, closed)


class CsrWindowSum(torch.autograd.Function):
    """Σ of `values`' rows over a row window's CSR segments (kernel 7 on
    the window's R + 1 bounds, the last row included) → [R, W] in f32;
    the backward broadcasts each row's cotangent over its segment,
    `g[dst]`, a plain gather."""

    @staticmethod
    def forward(ctx, values, bounds, dst):
        ctx.save_for_backward(dst)
        ctx.dtype = values.dtype
        acc = torch.promote_types(values.dtype, torch.float32)
        return csr_segment_sum(values.contiguous(), None, bounds, acc)[:-1]

    @staticmethod
    def backward(ctx, g):
        dst, = ctx.saved_tensors
        return g.index_select(0, dst).to(ctx.dtype), None, None


def csr_window_sum(values: torch.Tensor, bounds: torch.Tensor,
                   dst: torch.Tensor) -> torch.Tensor:
    """The JAX package's differentiable `csr_segment_sum`: `values` [E, W]
    sorted by target row, `bounds` [R + 1] int32 the window's row pointers
    and the end of its last segment, `dst` [E] each row's window row →
    [R, W], f32 (float64 stays float64 on the CPU). Kernel 7 forward,
    gather backward: no scatter in either pass."""
    return CsrWindowSum.apply(values, bounds, dst)
