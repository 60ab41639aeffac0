"""The transformer conv as the serving and training paths run it.

Counterpart of `gnnep_tpu.ops.dense_attention.transformer_conv_table` on its
default fused rung (`attn_fused=True`, `attn_eproj=True`):

- one [H_in, 4H] projection for q/k/v/skip;
- kv = (k‖v)[src]: a plain gather in the forward, whose backward runs over
  the packer's source-sorted index (`src_order`, `src_starts`) through the
  CSR segment-sum kernel (`ops/cuda/segment_sum.py`), as the JAX package's
  `csr_gather_ordered`;
- the eproj attention kernels (`ops/cuda/attention_eproj.py`), which form the
  edge projection, the logits, the masked segment softmax and the aggregation
  in one launch on the card, and its gradient in one more, or their plain
  versions on the CPU;
- attention dropout as a [heads, E] scale on α, drawn from a generator;
- the β blend.

On the TPU, 'table', 'coo' and 'fused' were three formulations of one
function; on the card all three run this kernel. The other ladder rungs
(`attn_fused=False`: external logits, TPU kernel `_kernel`; `attn_eproj=False`:
the kv+e boundary, `_attn_kernel`) are not ported yet, and on the card they
raise rather than substitute another formulation.
"""
from __future__ import annotations

from typing import Optional

import torch

from .cuda.attention_eproj import fused_attention_eproj
from .cuda.segment_sum import csr_gather_ordered
from .graph_attention import TransformerConvParams, beta_blend


def transformer_conv_table(params: TransformerConvParams, x: torch.Tensor,
                           src: torch.Tensor, dst: torch.Tensor,
                           edge_attr: torch.Tensor, row_ptr: torch.Tensor,
                           src_order: torch.Tensor, src_starts: torch.Tensor,
                           *, heads: int,
                           edge_mask: Optional[torch.Tensor] = None,
                           attn_fused: bool = True,
                           attn_eproj: bool = True,
                           dropout_rate: float = 0.0,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """β-gated transformer conv over the dst-sorted arena (`row_ptr` [N+1]
    int32 CSR pointers of `dst`); `src_order` [E] / `src_starts` [N] (int32)
    index the edges by source for the kv gather's backward. With a
    `generator` and `dropout_rate` > 0, α is scaled by
    bernoulli(1−p)/(1−p) per (head, edge), as in the JAX package."""
    if x.device.type == "cuda" and not (attn_fused and attn_eproj):
        rung = "_kernel" if not attn_fused else "_attn_kernel"
        raise NotImplementedError(
            f"attn_fused={attn_fused}, attn_eproj={attn_eproj} selects the "
            f"TPU ladder rung of `{rung}`, which has no CUDA kernel yet "
            "(ROADMAP.md, Queue B); only the default eproj rung runs on "
            "the card")
    hidden = params.w_query.shape[1]
    w_all = torch.cat([params.w_query, params.w_key, params.w_value,
                       params.w_skip], dim=1)
    b_all = torch.cat([params.b_query, params.b_key, params.b_value,
                       params.b_skip])
    proj = x @ w_all + b_all
    q = proj[:, :hidden].contiguous()
    r = proj[:, 3 * hidden:]
    kv = csr_gather_ordered(proj[:, hidden:3 * hidden], src, src_order,
                            src_starts)
    scale_t = None
    if generator is not None and dropout_rate > 0.0:
        keep = torch.rand((heads, src.shape[0]), generator=generator,
                          device=x.device) < 1.0 - dropout_rate
        scale_t = keep.to(torch.float32) / (1.0 - dropout_rate)
    msg = fused_attention_eproj(q, kv, edge_attr.contiguous(), params.w_edge,
                                row_ptr, dst, heads=heads, scale_t=scale_t,
                                mask_e=edge_mask).to(x.dtype)
    return beta_blend(params.w_beta, r, msg)
