"""Multi-head graph transformer convolution (UniMP-style, β-gated).

Counterpart of `gnnep_tpu.ops.graph_attention`:

    q_i = x_i W_q + b_q            (target node / bond)
    k_j = x_j W_k + b_k            (source)
    v_j = x_j W_v + b_v
    e   = edge_attr W_e            (no bias)
    α_e = softmax_{e: dst(e)=i} ( q_i · (k_j + e) / √C )   per head
    m_i = Σ_e α_e (v_j + e)
    r_i = x_i W_skip + b_skip
    β_i = σ([r_i ‖ m_i ‖ r_i − m_i] W_β)                   (no bias, scalar)
    out = β_i r_i + (1 − β_i) m_i

Weights keep the JAX layout, `[in, out]`, so checkpoints carry across
unchanged. `transformer_conv` is the readable COO reference; the serving path
runs `ops.dense_attention.transformer_conv_table`.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from .segment import gather_rows, segment_softmax, segment_sum


class TransformerConvParams(NamedTuple):
    w_query: torch.Tensor  # [H_in, H]
    b_query: torch.Tensor  # [H]
    w_key: torch.Tensor
    b_key: torch.Tensor
    w_value: torch.Tensor
    b_value: torch.Tensor
    w_edge: torch.Tensor   # [F_e, H]  (bias-free, PyG convention)
    w_skip: torch.Tensor   # [H_in, H]
    b_skip: torch.Tensor
    w_beta: torch.Tensor   # [3H, 1]   (bias-free)


class TransformerConv(nn.Module):
    """The conv's parameters, named and ordered as `TransformerConvParams`."""

    def __init__(self, in_dim: int, hidden: int, edge_dim: int):
        super().__init__()
        shapes = {"w_query": (in_dim, hidden), "b_query": (hidden,),
                  "w_key": (in_dim, hidden), "b_key": (hidden,),
                  "w_value": (in_dim, hidden), "b_value": (hidden,),
                  "w_edge": (edge_dim, hidden),
                  "w_skip": (in_dim, hidden), "b_skip": (hidden,),
                  "w_beta": (3 * hidden, 1)}
        for name in TransformerConvParams._fields:
            self.register_parameter(name,
                                    nn.Parameter(torch.zeros(shapes[name])))

    def params(self) -> TransformerConvParams:
        return TransformerConvParams(*(getattr(self, f)
                                       for f in TransformerConvParams._fields))


def beta_blend(w_beta: torch.Tensor, r: torch.Tensor,
               msg: torch.Tensor) -> torch.Tensor:
    """β-gated skip blend, in the JAX package's split form:
    `sigmoid(r @ (w₁+w₃) + msg @ (w₂−w₃))` equals the reference's
    `sigmoid([r ‖ msg ‖ r−msg] @ w_beta)` without the [·, 3H] concat."""
    h = r.shape[-1]
    w1, w2, w3 = w_beta[:h], w_beta[h:2 * h], w_beta[2 * h:]
    beta = torch.sigmoid(r @ (w1 + w3) + msg @ (w2 - w3))
    return beta * r + (1.0 - beta) * msg


def transformer_conv(params: TransformerConvParams, x: torch.Tensor,
                     src: torch.Tensor, dst: torch.Tensor,
                     edge_attr: torch.Tensor, *, heads: int,
                     edge_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """COO reference conv (eval: no dropout)."""
    n = x.shape[0]
    hidden = params.w_query.shape[1]
    ch = hidden // heads

    q = (x @ params.w_query + params.b_query).reshape(n, heads, ch)
    k = (x @ params.w_key + params.b_key).reshape(n, heads, ch)
    v = (x @ params.w_value + params.b_value).reshape(n, heads, ch)
    e = (edge_attr @ params.w_edge).reshape(-1, heads, ch)

    k_j = gather_rows(k, src) + e
    v_j = gather_rows(v, src) + e
    logits = (gather_rows(q, dst) * k_j).sum(-1) / math.sqrt(ch)  # [E, heads]
    alpha = segment_softmax(logits, dst, n, mask=edge_mask)
    msg = segment_sum(alpha[..., None] * v_j, dst, n).reshape(n, hidden)

    r = x @ params.w_skip + params.b_skip
    return beta_blend(params.w_beta, r, msg)
