"""Segment reductions, the gather/scatter primitives of message passing.

Counterpart of `gnnep_tpu.ops.segment`. Every function takes the number of
segments explicitly, as the JAX functions do, and keeps their fills: an empty
segment's max is −inf (then floored to −1e30 by the softmax), an empty
segment's mean is 0, and a softmax denominator never drops below 1e-16.
"""
from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`x[idx]` over the leading axis."""
    return x.index_select(0, idx)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Mean over segments; empty segments yield 0."""
    total = segment_sum(data, segment_ids, num_segments)
    ones = data.new_ones(data.shape[:1])
    count = segment_sum(ones, segment_ids, num_segments).clamp_min(1.0)
    return total / count.reshape((num_segments,) + (1,) * (data.dim() - 1))


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Max over segments; empty segments yield −inf."""
    out = data.new_full((num_segments,) + tuple(data.shape[1:]),
                        float("-inf"))
    idx = segment_ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce(0, idx, data, reduce="amax", include_self=True)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Numerically stable softmax within segments.

    `logits` is [E, ...] with segment ids over the leading axis; `mask`
    ([E], 1.0 = valid) zeroes masked entries' probability. Segments with no
    valid entries produce zeros."""
    if mask is not None:
        m = mask.reshape(mask.shape + (1,) * (logits.dim() - mask.dim()))
        logits = torch.where(m > 0, logits, logits.new_tensor(_NEG_INF))
    seg_max = segment_max(logits.detach(), segment_ids, num_segments)
    seg_max = seg_max.clamp_min(_NEG_INF)
    expd = torch.exp(logits - gather_rows(seg_max, segment_ids))
    if mask is not None:
        # mask in the compute dtype, as the JAX function does
        expd = expd * m.to(expd.dtype)
    denom = segment_sum(expd, segment_ids, num_segments).clamp_min(1e-16)
    return expd / gather_rows(denom, segment_ids)
