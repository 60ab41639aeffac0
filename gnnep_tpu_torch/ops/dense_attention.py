"""The transformer conv as the serving path runs it.

Counterpart of `gnnep_tpu.ops.dense_attention.transformer_conv_table` on its
default fused rung (`attn_fused=True`, `attn_eproj=True`):

- one [H_in, 4H] projection for q/k/v/skip;
- kv = (k‖v)[src], a plain gather in the forward;
- the eproj attention kernel (`ops/cuda/attention_eproj.py`), which forms the
  edge projection, the logits, the masked segment softmax and the aggregation
  in one launch on the card, or its plain version on the CPU;
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
from .graph_attention import TransformerConvParams, beta_blend
from .segment import gather_rows


def transformer_conv_table(params: TransformerConvParams, x: torch.Tensor,
                           src: torch.Tensor, dst: torch.Tensor,
                           edge_attr: torch.Tensor, row_ptr: torch.Tensor, *,
                           heads: int,
                           edge_mask: Optional[torch.Tensor] = None,
                           attn_fused: bool = True,
                           attn_eproj: bool = True) -> torch.Tensor:
    """β-gated transformer conv over the dst-sorted arena (`row_ptr` [N+1]
    int32 CSR pointers of `dst`). Eval only: no dropout."""
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
    kv = gather_rows(proj[:, hidden:3 * hidden], src)
    msg = fused_attention_eproj(q, kv, edge_attr.contiguous(), params.w_edge,
                                row_ptr, dst, heads=heads,
                                mask_e=edge_mask).to(x.dtype)
    return beta_blend(params.w_beta, r, msg)
