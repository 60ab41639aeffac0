"""Sum over contiguous CSR segments: the CUDA kernel `csrc/csr_segment_sum.cu`,
its ctypes wrapper, its plain PyTorch version, its launch count, and the two
gathers whose backward it is.

Counterpart of `windowed_segment_sum`, `csr_gather` and `csr_gather_ordered`
in `gnnep_tpu/ops/pallas/csr_attention.py` (TPU kernel `_sum_kernel`):

    out[n] = Σ_{j ∈ [seg_starts[n], seg_starts[n+1])} values[order[j]]

(`order` None: the identity), accumulated and returned in f32. The last
segment is the dummy row's, which owns the arena's tail padding; its sum is
unspecified by the JAX package's contract (whose `windowed_segment_sum` ends
it at `e_total_end`) and is written here as zeros, without walking its rows
(their cotangents are zero in both gathers' backward). A tensor on the CPU
takes the plain version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

_KERNEL = "csr_segment_sum"

# kernel launches since the last reset; the chip smoke run sets it to 0 just
# before it drives a path and reads it just after
launches = 0


def csr_segment_sum_plain(values: torch.Tensor, order: Optional[torch.Tensor],
                          seg_starts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version → f32 [N, W]: the rows of the permuted arena
    `values[order]` (`order` None: the identity) summed per segment, in row
    order; the last segment zeros."""
    n = seg_starts.shape[0]
    out = torch.zeros((n,) + tuple(values.shape[1:]), dtype=torch.float32,
                      device=values.device)
    if n == 0:
        return out
    starts = seg_starts.long()
    rows = torch.arange(values.shape[0], device=values.device)
    seg = torch.searchsorted(starts, rows, right=True) - 1
    # rows before the first segment and rows of the last one are added as
    # zeros (a mask multiply, not a boolean index, so the device never
    # waits on the host)
    keep = ((seg >= 0) & (seg < n - 1)).reshape(
        (-1,) + (1,) * (values.dim() - 1))
    picked = rows if order is None else order.long()
    vals = values.index_select(0, picked).float() * keep
    return out.index_add_(0, seg.clamp_min(0), vals)


def _lib() -> ctypes.CDLL:
    lib = build.load(_KERNEL)
    fn = lib.csr_segment_sum
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 4 + [i] * 3 + [p]
        fn.restype = i
    return lib


def csr_segment_sum_cuda(values: torch.Tensor, order: Optional[torch.Tensor],
                         seg_starts: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream → f32 [N, W] as
    `csr_segment_sum_plain`. Raises on anything the kernel does not take."""
    global launches
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
    width = values.shape[1]
    out = torch.empty((n, width), dtype=torch.float32, device=device)
    if n == 0 or width == 0:
        return out
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.csr_segment_sum(
            values.data_ptr(), None if order is None else order.data_ptr(),
            seg_starts.data_ptr(), out.data_ptr(), n, width,
            int(values.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"{_KERNEL} launch failed with CUDA error {rc}")
    launches += 1
    return out


def csr_segment_sum(values: torch.Tensor, order: Optional[torch.Tensor],
                    seg_starts: torch.Tensor) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if values.device.type == "cpu":
        return csr_segment_sum_plain(values, order, seg_starts)
    return csr_segment_sum_cuda(values, order, seg_starts)


class CsrGatherOrdered(torch.autograd.Function):
    """`x[idx]`, whose backward permutes the cotangent by `order` (a
    permutation that sorts `idx` into contiguous segments, one per row of
    x, starting at `seg_starts`; None where `idx` is sorted already) and
    sums each segment."""

    @staticmethod
    def forward(ctx, x, idx, order, seg_starts):
        ctx.save_for_backward(order, seg_starts)
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        order, seg_starts = ctx.saved_tensors
        dx = csr_segment_sum(g.contiguous(), order, seg_starts)
        return dx.to(g.dtype), None, None, None


def csr_gather_ordered(x: torch.Tensor, idx: torch.Tensor, order: torch.Tensor,
                       seg_starts: torch.Tensor) -> torch.Tensor:
    """`x[idx]` [E, ·] with the segment-sum backward; `order` [E] and
    `seg_starts` [N] int32 are the packer's source-sorted CSR index
    (`GraphBatch.edge_src_order` / `edge_src_starts`)."""
    return CsrGatherOrdered.apply(x, idx, order, seg_starts)


def csr_gather(x: torch.Tensor, idx: torch.Tensor,
               seg_starts: torch.Tensor) -> torch.Tensor:
    """`x[idx]` [E, ·] with the segment-sum backward, for the arena's own
    sort key: the gather of q by dst, with `seg_starts` = row_ptr[:-1]."""
    return CsrGatherOrdered.apply(x, idx, None, seg_starts)
