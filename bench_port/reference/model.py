"""Plain PyTorch ALIGNN: the heteroscedastic regressor's published equations.

Written from the model's description (the reference trainer's
`scripts/train.py` and the port's module docstrings), with no kernel, no
capture and no batching of its own. It runs in float32 with the GEMMs either
exact or with their operands rounded to TF32 (`Numerics`), the control.

- 2-layer MLP encoders relu(x·w0 + b0)·w1 + b1 for atoms, bonds, angles;
- L blocks: line-graph conv over bonds with angle features, then the atom
  conv fed by projected bond states; each block LayerNorm → residual
  `state + dropout(relu(out))`;
- the transformer conv: q, k, v, skip projections, e = ea·W_e,
  α = softmax over each target's live in-edges of q_i·(k_j + e)/√C per head,
  α dropped out per (head, edge), m_i = Σ α (v_j + e),
  β = σ([r ‖ m ‖ r − m]·w_β), out = β r + (1 − β) m;
- mean pooling per graph, concat globals and the space-group one-hot,
  dropout, feat_proj, relu, dropout, mean and log-variance heads.

Every random draw goes through one generator in the order the trainer takes
them (jitter on atoms then globals; per block the line-graph conv's α mask,
the bond residual mask, the atom conv's α mask, the atom residual mask; then
the two readout masks), over the padded arenas that `packing` lays out, so
the same seed gives the same masks.

The initial weights are a frozen copy of the port's initializer: every
weight and bias U(±1/√fan_in) from a numpy generator in parameter order,
LayerNorm scale 1 and bias 0.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

N_SG = 230
LN_EPS = 1e-5
CONV = ("w_query", "b_query", "w_key", "b_key", "w_value", "b_value",
        "w_edge", "w_skip", "b_skip", "w_beta")


class Numerics:
    """The reference's products: float32 (`tf32=False`), or with both
    operands of every GEMM rounded to TF32's 10-bit mantissa, forward and
    backward, as a TF32 GEMM reads them (the control)."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _Tf32Mm.apply(a, b) if self.tf32 else a @ b


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even of f32 to 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    bias = torch.bitwise_and(torch.bitwise_right_shift(bits, 13), 1) + 0xFFF
    return torch.bitwise_and(bits + bias, ~0x1FFF).view(torch.float32)


class _Tf32Mm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ra, rb = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = round_tf32(g)
        return rg @ rb.t(), ra.t() @ rg


def param_shapes(m: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter in the port's parameter order, which
    is also the order the initializer draws in. `m` is the configuration's
    `model` block."""
    h, t = m["hidden"], m["target_dim"]

    def mlp(p, d):
        return [(f"{p}.b0", (h,)), (f"{p}.b1", (h,)), (f"{p}.w0", (d, h)),
                (f"{p}.w1", (h, h))]

    def conv(p):
        shapes = dict(w_query=(h, h), b_query=(h,), w_key=(h, h), b_key=(h,),
                      w_value=(h, h), b_value=(h,), w_edge=(h, h),
                      w_skip=(h, h), b_skip=(h,), w_beta=(3 * h, 1))
        return [(f"{p}.conv.{f}", shapes[f]) for f in CONV]

    out = mlp("angle_enc", m["angle_dim"])
    # a module's own parameters come before its children's
    for i in range(m["layers"]):
        out += [(f"edge_blocks.{i}.ln_bias", (h,)),
                (f"edge_blocks.{i}.ln_scale", (h,))] + conv(f"edge_blocks.{i}")
    out += mlp("edge_enc", m["edge_dim"])
    out += [("feat_proj.b", (h,)), ("feat_proj.w", (h + m["global_dim"], h)),
            ("logvar_head.b", (t,)), ("logvar_head.w", (h, t)),
            ("mean_head.b", (t,)), ("mean_head.w", (h, t))]
    for i in range(m["layers"]):
        p = f"node_blocks.{i}"
        out += [(f"{p}.edge_proj_b", (h,)), (f"{p}.edge_proj_w", (h, h)),
                (f"{p}.ln_bias", (h,)), (f"{p}.ln_scale", (h,))] + conv(p)
    return out + mlp("node_enc", m["node_dim"])


def _weight_of(bias: str) -> str:
    head, leaf = bias.rsplit(".", 1)
    if leaf == "edge_proj_b":
        return f"{head}.edge_proj_w"
    return f"{head}.w{leaf[1:]}"


def init_params(seed: int, m: Dict, device) -> Dict[str, torch.Tensor]:
    """The member's initial weights from `seed`."""
    rng = np.random.default_rng(seed)
    shapes = dict(param_shapes(m))
    out = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[1]
        if leaf.startswith("ln_"):
            arr = (np.ones if leaf == "ln_scale" else np.zeros)(shape,
                                                                np.float32)
        else:
            fan_in = shape[0] if len(shape) == 2 else \
                shapes[_weight_of(name)][0]
            bound = 1.0 / math.sqrt(fan_in)
            arr = rng.uniform(-bound, bound, shape).astype(np.float32)
        out[name] = torch.from_numpy(arr).to(device)
    return out


def _dropout(x, rate, gen):
    if gen is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _layer_norm(x, scale, bias):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * scale + bias


def _segment_sum(x, ids, n):
    return x.new_zeros((n,) + tuple(x.shape[1:])).index_add_(0, ids, x)


def conv(p: Dict, pre: str, x, src, dst, ea, mask, heads: int, rate: float,
         gen, num: Numerics):
    """The β-gated transformer conv of block parameters `pre` over edges
    src → dst (`mask` 1 for live edges, None: all live)."""
    n, h = x.shape[0], p[f"{pre}.w_query"].shape[1]
    c = h // heads

    def lin(w, b=None):
        y = num.mm(x, p[f"{pre}.{w}"])
        return y if b is None else y + p[f"{pre}.{b}"]

    q, k, v = lin("w_query", "b_query"), lin("w_key", "b_key"), \
        lin("w_value", "b_value")
    r = lin("w_skip", "b_skip")
    scale = None
    if gen is not None and rate > 0.0:
        keep = torch.rand((heads, src.shape[0]), generator=gen,
                          device=x.device) < 1.0 - rate
        scale = keep.to(torch.float32).t() / (1.0 - rate)
    e = num.mm(ea, p[f"{pre}.w_edge"])
    kj = (k.index_select(0, src) + e).reshape(-1, heads, c)
    vj = (v.index_select(0, src) + e).reshape(-1, heads, c)
    logits = (q.index_select(0, dst).reshape(-1, heads, c) * kj).sum(-1) \
        / math.sqrt(c)
    live = torch.ones_like(logits) if mask is None else \
        (mask > 0).to(logits.dtype)[:, None].expand_as(logits)
    logits = torch.where(live > 0, logits, torch.full_like(logits, -1e30))
    top = torch.full((n, heads), -1e30, device=x.device).scatter_reduce(
        0, dst[:, None].expand(-1, heads), logits.detach(), "amax",
        include_self=True)
    ex = torch.exp(logits - top.index_select(0, dst)) * live
    alpha = ex / _segment_sum(ex, dst, n).clamp_min(1e-16).index_select(0,
                                                                         dst)
    if scale is not None:
        alpha = alpha * scale
    msg = _segment_sum((alpha[..., None] * vj).reshape(-1, h), dst, n)
    beta = torch.sigmoid(num.mm(torch.cat([r, msg, r - msg], dim=-1),
                                p[f"{pre}.w_beta"]))
    return beta * r + (1.0 - beta) * msg


def forward(p: Dict, a: Dict, m: Dict, num: Numerics, *,
            gen: Optional[torch.Generator] = None,
            jitter: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, logvar) of the graphs of arena `a` (tensors on one device:
    nodes, node_graph, edge_*, lg_*, globals_, sg_num; the masks may be
    absent where every row is live). With `gen`, the training forward:
    jitter and dropout drawn from it."""
    heads = m["heads"]
    rate = m["dropout"] if gen is not None else 0.0
    nodes, globals_ = a["nodes"], a["globals_"]
    if gen is not None and jitter > 0.0:
        nodes = nodes + jitter * torch.randn(nodes.shape, generator=gen,
                                             device=nodes.device)
        globals_ = globals_ + jitter * torch.randn(
            globals_.shape, generator=gen, device=nodes.device)

    def mlp(pre, x):
        hid = torch.relu(num.mm(x, p[f"{pre}.w0"]) + p[f"{pre}.b0"])
        return num.mm(hid, p[f"{pre}.w1"]) + p[f"{pre}.b1"]

    node = mlp("node_enc", nodes)
    bond = mlp("edge_enc", a["edge_attr"])
    angle = mlp("angle_enc", a["lg_attr"])
    for i in range(m["layers"]):
        pre = f"edge_blocks.{i}"
        out = conv(p, f"{pre}.conv", bond, a["lg_src"], a["lg_dst"], angle,
                   a.get("lg_mask"), heads, rate, gen, num)
        out = _layer_norm(out, p[f"{pre}.ln_scale"], p[f"{pre}.ln_bias"])
        bond = bond + _dropout(torch.relu(out), rate, gen)
        pre = f"node_blocks.{i}"
        feat = num.mm(bond, p[f"{pre}.edge_proj_w"]) + p[f"{pre}.edge_proj_b"]
        out = conv(p, f"{pre}.conv", node, a["edge_src"], a["edge_dst"], feat,
                   a.get("edge_mask"), heads, rate, gen, num)
        out = _layer_norm(out, p[f"{pre}.ln_scale"], p[f"{pre}.ln_bias"])
        node = node + _dropout(torch.relu(out), rate, gen)
    g = globals_.shape[0]
    total = _segment_sum(node, a["node_graph"], g + 1)
    count = _segment_sum(torch.ones_like(node[:, 0]), a["node_graph"], g + 1)
    pooled = (total / count.clamp_min(1.0)[:, None])[:g]
    sg = a["sg_num"]
    valid = (sg >= 1) & (sg <= N_SG)
    onehot = (torch.arange(1, N_SG + 1, device=sg.device)[None, :]
              == torch.where(valid, sg, 0)[:, None]).to(pooled.dtype)
    feats = _dropout(torch.cat([pooled, globals_, onehot], dim=-1), rate, gen)
    shared = _dropout(torch.relu(num.mm(feats, p["feat_proj.w"])
                                 + p["feat_proj.b"]), rate, gen)
    return (num.mm(shared, p["mean_head.w"]) + p["mean_head.b"],
            num.mm(shared, p["logvar_head.w"]) + p["logvar_head.b"])


def hetero_loss(mean, logvar, a: Dict, log_means, log_stds, floor: float,
                log_sigma_l2: float):
    """(objective, Σ per-graph NLL): the heteroscedastic Gaussian NLL of the
    log-standardized targets, averaged over valid targets and real graphs,
    plus λ·mean((½ logvar)²) over real graphs and targets."""
    y_z = (torch.log(torch.clamp_min(a["y"], 1e-12)) - log_means) / log_stds
    logvar = torch.clamp_min(logvar, floor)
    nll = 0.5 * (logvar + (mean - y_z) ** 2 / torch.exp(logvar))
    nll = nll * a["weight"][:, None]
    ym, gm = a["y_mask"], a["graph_mask"]
    per_graph = (nll * ym).sum(1) / torch.clamp_min(ym.sum(1), 1.0) * gm
    n_real = torch.clamp_min(gm.sum(), 1.0)
    loss = per_graph.sum() / n_real
    if log_sigma_l2 > 0.0:
        loss = loss + log_sigma_l2 * ((0.5 * logvar) ** 2 * gm[:, None]).sum() \
            / (n_real * y_z.shape[1])
    return loss, per_graph.sum()
