"""The transformer conv as the serving and training paths run it.

Counterpart of `gnnep_tpu.ops.dense_attention.transformer_conv_table`:

- one [H_in, 4H] projection for q/k/v/skip;
- kv = (k‖v)[src]: a plain gather in the forward, whose backward runs over
  the packer's source-sorted index (`src_order`, `src_starts`) through the
  CSR segment-sum kernel (`ops/cuda/segment_sum.py`), as the JAX package's
  `csr_gather_ordered` (on every rung but span);
- the attention, on one of four rungs of the JAX package's fused-kernel
  ladder, each a pair of CUDA kernels on the card (forward and gradient) or
  their plain versions on the CPU:
  - span (`attn_span` with the conv's span bound measured, and the batch's
    `span_lo`): the eproj kernel reading kv row src[j] of the node-space
    (k‖v) table itself, so no edge-space kv exists and the backward returns
    d(k‖v) in node space (`ops/cuda/attention_span.py`);
  - eproj (default): the edge projection, logits, masked segment softmax
    and aggregation in one kernel (`ops/cuda/attention_eproj.py`);
  - kv+e (`attn_eproj=False`): e = edge_attr·W_e as a plain product, then
    the attention over k = kv[:, :H] + e and v = kv[:, H:] + e
    (`ops/cuda/attention.py`);
  - external logits (`attn_fused=False`): q gathered by dst (`csr_gather`,
    whose backward is the segment-sum kernel over the identity order), the
    [heads, E] logits and their mask as plain tensor ops, then the segment
    softmax-aggregate (`ops/cuda/aggregate.py`);
- attention dropout as a [heads, E] scale on α, drawn from a generator;
- the β blend.

As in the JAX package, the rung flags act only under `fused` (the
checkpoint's `conv_impl == 'fused'`); 'table' and 'coo' run the eproj rung:
every rung computes the same function.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .cuda.aggregate import fused_aggregate_t
from .cuda.attention import fused_attention
from .cuda.attention_eproj import fused_attention_eproj
from .cuda.attention_span import fused_attention_span
from .cuda.segment_sum import csr_gather, csr_gather_ordered
from .graph_attention import TransformerConvParams, beta_blend

_NEG = -1e30


def transformer_conv_table(params: TransformerConvParams, x: torch.Tensor,
                           src: torch.Tensor, dst: torch.Tensor,
                           edge_attr: torch.Tensor, row_ptr: torch.Tensor,
                           src_order: torch.Tensor, src_starts: torch.Tensor,
                           *, heads: int,
                           edge_mask: Optional[torch.Tensor] = None,
                           fused: bool = False,
                           attn_fused: bool = True,
                           attn_eproj: bool = True,
                           attn_span: bool = False,
                           span_lo: Optional[torch.Tensor] = None,
                           dropout_rate: float = 0.0,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """β-gated transformer conv over the dst-sorted arena (`row_ptr` [N+1]
    int32 CSR pointers of `dst`); `src_order` [E] / `src_starts` [N] (int32)
    index the edges by source for the kv gather's backward. `fused` lets
    `attn_fused` / `attn_eproj` / `attn_span` pick the rung; `attn_span`
    means the conv's span bound was measured, and the span rung takes
    effect on the eproj rung where the batch carries its `span_lo` (the
    packer's per-target span starts, which only the TPU kernels read). With
    a `generator` and `dropout_rate` > 0, α is scaled by
    bernoulli(1−p)/(1−p) per (head, edge), as in the JAX package."""
    use_attn = not fused or attn_fused
    use_eproj = use_attn and (not fused or attn_eproj)
    use_span = fused and use_eproj and attn_span and span_lo is not None
    hidden = params.w_query.shape[1]
    w_all = torch.cat([params.w_query, params.w_key, params.w_value,
                       params.w_skip], dim=1)
    b_all = torch.cat([params.b_query, params.b_key, params.b_value,
                       params.b_skip])
    proj = x @ w_all + b_all
    q = proj[:, :hidden].contiguous()
    r = proj[:, 3 * hidden:]
    scale_t = None
    if generator is not None and dropout_rate > 0.0:
        keep = torch.rand((heads, src.shape[0]), generator=generator,
                          device=x.device) < 1.0 - dropout_rate
        scale_t = keep.to(torch.float32) / (1.0 - dropout_rate)
    if use_span:
        # no kv gather: the kernel reads the node-space table itself
        msg = fused_attention_span(q, proj[:, hidden:3 * hidden].contiguous(),
                                   edge_attr.contiguous(), params.w_edge,
                                   row_ptr, src, dst, heads=heads,
                                   scale_t=scale_t, mask_e=edge_mask)
        return beta_blend(params.w_beta, r, msg.to(x.dtype))
    kv = csr_gather_ordered(proj[:, hidden:3 * hidden], src, src_order,
                            src_starts)
    if use_eproj:
        msg = fused_attention_eproj(q, kv, edge_attr.contiguous(),
                                    params.w_edge, row_ptr, dst, heads=heads,
                                    scale_t=scale_t, mask_e=edge_mask)
        return beta_blend(params.w_beta, r, msg.to(x.dtype))
    e = edge_attr @ params.w_edge                       # [E, H]
    k_j = kv[:, :hidden] + e
    v_j = kv[:, hidden:] + e
    if use_attn:
        msg = fused_attention(q, k_j, v_j, row_ptr, dst, heads=heads,
                              scale_t=scale_t, mask_e=edge_mask)
        return beta_blend(params.w_beta, r, msg.to(x.dtype))
    # the external [heads, E] logits: the product q_dst·k_j in the compute
    # type, summed per head in f32 (the JAX package's block-sum GEMM)
    ch = hidden // heads
    q_dst = csr_gather(q, dst, row_ptr[:-1])
    logits_t = ((q_dst * k_j).float().reshape(-1, heads, ch).sum(-1).t()
                / math.sqrt(ch))
    if edge_mask is not None:
        logits_t = torch.where(edge_mask[None, :] > 0, logits_t,
                               torch.full_like(logits_t, _NEG))
    msg = fused_aggregate_t(logits_t, v_j, row_ptr, dst=dst, heads=heads,
                            scale_t=scale_t)
    return beta_blend(params.w_beta, r, msg.to(x.dtype))
