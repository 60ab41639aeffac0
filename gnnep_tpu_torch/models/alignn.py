"""Heteroscedastic ALIGNN regressor as an `nn.Module` (eval and train
forwards).

Counterpart of `gnnep_tpu.models.alignn`, with the same architecture and
parameter layout (weights `[in, out]`, as JAX stores them):

- 2-layer MLP encoders for node(206)→H, edge(36)→H, angle(11)→H
- L interleaved blocks: EdgeUpdate = β-gated transformer conv over the LINE
  graph with angle embeddings as edge features, then NodeUpdate = projection
  of the updated bond states + transformer conv over the ATOM graph
- each block: LayerNorm → residual `state + dropout(relu(out))`
- segment-mean pooling over graphs, concat with 59 standardized global
  scalars + 230-way space-group one-hot, feat_proj
- per-target mean and log-variance heads

Batches arrive as the packer's padded arenas (`data.batching.GraphBatch`),
moved to the device once with `DeviceBatch.from_batch`. The train forward
draws every dropout mask (block outputs, pooled features, the shared
embedding, and α inside each conv) from one explicit `torch.Generator` on
the batch's device; its streams differ from `jax.random`'s.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..data.featurize import N_SG
from ..ops.graph_attention import (TransformerConv, TransformerConvParams,
                                   transformer_conv)
from ..ops.segment import segment_mean

LN_EPS = 1e-5  # torch.nn.LayerNorm default


@dataclasses.dataclass(frozen=True)
class AlignnConfig:
    """The JAX package's `AlignnConfig`, field for field, so the config JSON
    embedded in a checkpoint round-trips between the packages. The win64
    and `scan_layers` fields are TPU kernel and compile choices; the port
    carries them and does not read them. Of the span bounds it reads only
    whether they were measured (> 0)."""

    node_dim: int
    edge_dim: int
    angle_dim: int
    global_dim: int          # scalar globals + space-group one-hot (59 + 230)
    target_dim: int = 2
    hidden: int = 256
    layers: int = 4
    heads: int = 4
    dropout: float = 0.15
    # 'table' / 'fused' / 'coo': on the card all three run the kernels;
    # on the CPU the eval forward of 'coo' runs the readable COO conv, every
    # other forward the kernels' plain versions
    conv_impl: str = "table"
    edge_win64: int = 0
    lg_win64: int = 0
    edge_src_win64: int = 0
    lg_src_win64: int = 0
    scan_layers: bool = False
    # fused-kernel ladder, read only under conv_impl='fused' (as the JAX
    # package reads it): attn_fused=False is the external-logits rung,
    # attn_eproj=False the kv+e rung; attn_span with a conv's bound measured
    # (`data.batching.measure_span64`) is the span rung on that conv, where
    # the batch carries its span_lo; each rung has its CUDA kernels
    attn_fused: bool = True
    attn_eproj: bool = True
    force_fused: bool = False
    attn_span: bool = False
    edge_span64: int = 0
    lg_span64: int = 0

    def __post_init__(self):
        if self.heads <= 0:
            raise ValueError("heads must be positive")
        if self.target_dim <= 0:
            raise ValueError("target_dim must be positive")
        if self.hidden % self.heads != 0:
            raise ValueError("hidden size must be divisible by number of heads")


class MLP(nn.Module):
    """relu(x·w0 + b0)·w1 + b1."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.b0 = nn.Parameter(torch.zeros(hidden))
        self.b1 = nn.Parameter(torch.zeros(hidden))
        self.w0 = nn.Parameter(torch.zeros(in_dim, hidden))
        self.w1 = nn.Parameter(torch.zeros(hidden, hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x @ self.w0 + self.b0) @ self.w1 + self.b1


class Dense(nn.Module):
    """x·w + b."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.b = nn.Parameter(torch.zeros(out_dim))
        self.w = nn.Parameter(torch.zeros(in_dim, out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class EdgeBlock(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.conv = TransformerConv(hidden, hidden, edge_dim=hidden)
        self.ln_bias = nn.Parameter(torch.zeros(hidden))
        self.ln_scale = nn.Parameter(torch.ones(hidden))


class NodeBlock(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.conv = TransformerConv(hidden, hidden, edge_dim=hidden)
        self.edge_proj_b = nn.Parameter(torch.zeros(hidden))
        self.edge_proj_w = nn.Parameter(torch.zeros(hidden, hidden))
        self.ln_bias = nn.Parameter(torch.zeros(hidden))
        self.ln_scale = nn.Parameter(torch.ones(hidden))


class Alignn(nn.Module):
    """Parameters of one ensemble member; the forward is `alignn_apply`."""

    def __init__(self, cfg: AlignnConfig):
        super().__init__()
        h = cfg.hidden
        self.cfg = cfg
        self.angle_enc = MLP(cfg.angle_dim, h)
        self.edge_blocks = nn.ModuleList(EdgeBlock(h)
                                         for _ in range(cfg.layers))
        self.edge_enc = MLP(cfg.edge_dim, h)
        self.feat_proj = Dense(h + cfg.global_dim, h)
        self.logvar_head = Dense(h, cfg.target_dim)
        self.mean_head = Dense(h, cfg.target_dim)
        self.node_blocks = nn.ModuleList(NodeBlock(h)
                                         for _ in range(cfg.layers))
        self.node_enc = MLP(cfg.node_dim, h)

    def forward(self, batch: "DeviceBatch", *, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return alignn_apply(self, batch, train=train, generator=generator)


def leaf_names(cfg: AlignnConfig) -> List[str]:
    """Parameter names in the JAX package's `tree_leaves` order of the
    `init_alignn` pytree: dict keys sorted at every level, lists in order,
    `TransformerConvParams` in field order. A checkpoint's `leaf_{i:05d}`
    arrays follow this order."""
    def mlp(p):
        return [f"{p}.{k}" for k in ("b0", "b1", "w0", "w1")]

    def dense(p):
        return [f"{p}.b", f"{p}.w"]

    def conv(p):
        return [f"{p}.conv.{f}" for f in TransformerConvParams._fields]

    names = mlp("angle_enc")
    for i in range(cfg.layers):
        p = f"edge_blocks.{i}"
        names += conv(p) + [f"{p}.ln_bias", f"{p}.ln_scale"]
    names += mlp("edge_enc") + dense("feat_proj") + dense("logvar_head") \
        + dense("mean_head")
    for i in range(cfg.layers):
        p = f"node_blocks.{i}"
        names += conv(p) + [f"{p}.edge_proj_b", f"{p}.edge_proj_w",
                            f"{p}.ln_bias", f"{p}.ln_scale"]
    return names + mlp("node_enc")


def init_alignn(rng: np.random.Generator, cfg: AlignnConfig) -> Alignn:
    """Random member from a numpy generator: every weight and bias
    U(±1/√fan_in) as torch.nn.Linear initializes them, LayerNorm scale 1 and
    bias 0. (The JAX package draws from jax.random; the streams differ.)"""
    model = Alignn(cfg)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in params.items():
            if name.rsplit(".", 1)[1].startswith("ln_"):
                continue
            weight = p if p.dim() == 2 else params[_weight_of(name)]
            bound = 1.0 / math.sqrt(weight.shape[0])
            p.copy_(torch.from_numpy(rng.uniform(
                -bound, bound, tuple(p.shape)).astype(np.float32)))
    return model


def _weight_of(bias_name: str) -> str:
    """The weight whose fan-in sizes a bias: b→w, b0→w0, b_query→w_query,
    edge_proj_b→edge_proj_w."""
    head, leaf = bias_name.rsplit(".", 1)
    if leaf == "edge_proj_b":
        return f"{head}.edge_proj_w"
    return f"{head}.w{leaf[1:]}"


def _layer_norm(x: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * scale + bias


def _dropout(x: torch.Tensor, rate: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """`where(bernoulli(1−rate), x / (1−rate), 0)`, as the JAX package's
    `_dropout`; identity without a generator or at rate 0."""
    if generator is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator,
                      device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


@dataclasses.dataclass
class DeviceBatch:
    """The fields of a `GraphBatch` that the forwards and the loss read, as
    tensors on one device: features, targets and masks f32, index arrays
    int64, CSR pointers, the source-sorted CSR index and the span starts
    int32 (the span starts None where the `GraphBatch` has none).

    `from_batch` moves one batch to the device in new tensors. A captured
    program needs fixed addresses instead: `allocate` makes a batch
    budget's buffers once, and `copy_from` refills them with each batch of
    that budget (every batch one budget packs has the same shapes)."""

    nodes: torch.Tensor
    node_graph: torch.Tensor
    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    edge_attr: torch.Tensor
    edge_mask: torch.Tensor
    lg_src: torch.Tensor
    lg_dst: torch.Tensor
    lg_attr: torch.Tensor
    lg_mask: torch.Tensor
    globals_: torch.Tensor
    sg_num: torch.Tensor
    edge_row_ptr: torch.Tensor
    lg_row_ptr: torch.Tensor
    edge_src_order: torch.Tensor
    edge_src_starts: torch.Tensor
    lg_src_order: torch.Tensor
    lg_src_starts: torch.Tensor
    y: torch.Tensor
    y_mask: torch.Tensor
    weight: torch.Tensor
    graph_mask: torch.Tensor
    n_graphs: int
    node_span_lo: Optional[torch.Tensor] = None
    bond_span_lo: Optional[torch.Tensor] = None
    # pinned host copies of the fields for `copy_from` (two sets, used in
    # turn) and the event after each set's last copy to the card
    _staging: Optional[list] = dataclasses.field(default=None, init=False,
                                                 repr=False, compare=False)

    _FLOAT = ("nodes", "edge_attr", "edge_mask", "lg_attr", "lg_mask",
              "globals_", "y", "y_mask", "weight", "graph_mask")
    _INDEX = ("node_graph", "edge_src", "edge_dst", "lg_src", "lg_dst",
              "sg_num")
    _INT32 = ("edge_row_ptr", "lg_row_ptr", "edge_src_order",
              "edge_src_starts", "lg_src_order", "lg_src_starts")
    _SPAN = ("node_span_lo", "bond_span_lo")

    @classmethod
    def _dtypes(cls, batch):
        """(name, dtype) of every tensor field `batch` carries."""
        out = [(n, torch.float32) for n in cls._FLOAT]
        out += [(n, torch.int64) for n in cls._INDEX]
        out += [(n, torch.int32) for n in cls._INT32]
        return out + [(n, torch.int32) for n in cls._SPAN
                      if getattr(batch, n, None) is not None]

    @classmethod
    def from_batch(cls, batch, device) -> "DeviceBatch":
        def put(name, dtype):
            arr = np.ascontiguousarray(getattr(batch, name),
                                       dtype=_NUMPY[dtype])
            return torch.from_numpy(arr).to(device, non_blocking=True)

        fields = {n: put(n, dt) for n, dt in cls._dtypes(batch)}
        return cls(**fields, n_graphs=int(np.asarray(batch.y).shape[0]))

    @classmethod
    def allocate(cls, like, device) -> "DeviceBatch":
        """Uninitialised buffers on `device` for the batches of `like`'s
        budget (a `GraphBatch` or a `DeviceBatch`), span fields where it
        has them."""
        fields = {n: torch.empty(tuple(getattr(like, n).shape), dtype=dt,
                                 device=device)
                  for n, dt in cls._dtypes(like)}
        return cls(**fields, n_graphs=int(like.y.shape[0]))

    def copy_from(self, batch) -> None:
        """Fill the buffers with `batch` in place, every `data_ptr()` kept:
        a `GraphBatch` through pinned host copies (on a CUDA device) with
        asynchronous copies on the current stream, a `DeviceBatch` by device
        copies. Raises where `batch` is not of this budget."""
        names = self._dtypes(batch)
        if (len(names) != len(self._dtypes(self))
                or int(batch.y.shape[0]) != self.n_graphs
                or any(tuple(getattr(batch, n).shape)
                       != tuple(getattr(self, n).shape) for n, _ in names)):
            raise ValueError("the batch is not of this buffer's budget: its "
                             "shapes or span fields differ")
        if isinstance(batch, DeviceBatch):
            for n, _ in names:
                getattr(self, n).copy_(getattr(batch, n))
            return
        if self.nodes.device.type != "cuda":
            for n, dt in names:
                getattr(self, n).copy_(torch.from_numpy(np.ascontiguousarray(
                    getattr(batch, n), dtype=_NUMPY[dt])))
            return
        if self._staging is None:
            self._staging = [({n: torch.empty(tuple(getattr(self, n).shape),
                                              dtype=dt, pin_memory=True)
                               for n, dt in names}, torch.cuda.Event())
                             for _ in range(2)]
        host, done = self._staging[0]
        self._staging.reverse()
        # this set's previous copies to the card must have read it
        done.synchronize()
        for n, _ in names:
            np.copyto(host[n].numpy(), getattr(batch, n), casting="unsafe")
            getattr(self, n).copy_(host[n], non_blocking=True)
        done.record()


_NUMPY = {torch.float32: np.float32, torch.int64: np.int64,
          torch.int32: np.int32}


def _shared_trunk(model: Alignn, batch: DeviceBatch,
                  tap: Optional[Callable[[str, torch.Tensor], None]] = None,
                  *, train: bool = False,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Encoders → interleaved LG/atom convs → pooling → feat_proj → [G, H].
    `tap(name, tensor)` records intermediate activations. `train` with a
    `generator` applies dropout at `cfg.dropout` where the JAX package
    does."""
    cfg = model.cfg
    drop = cfg.dropout if train else 0.0
    gen = generator if train else None
    node_state = model.node_enc(batch.nodes)
    edge_state = model.edge_enc(batch.edge_attr)
    angle_emb = model.angle_enc(batch.lg_attr)
    if tap is not None:
        tap("node_enc", node_state)
        tap("edge_enc", edge_state)
        tap("angle_enc", angle_emb)

    has_lg = batch.lg_mask.sum() > 0
    has_edges = batch.edge_mask.sum() > 0

    # training always takes the kernel path (its plain versions on the CPU):
    # 'coo' is only the readable eval reference
    if (cfg.conv_impl == "coo" and batch.nodes.device.type == "cpu"
            and not train):
        def lg_conv(conv, state, feats):
            return transformer_conv(conv.params(), state, batch.lg_src,
                                    batch.lg_dst, feats, heads=cfg.heads,
                                    edge_mask=batch.lg_mask)

        def atom_conv(conv, state, feats):
            return transformer_conv(conv.params(), state, batch.edge_src,
                                    batch.edge_dst, feats, heads=cfg.heads,
                                    edge_mask=batch.edge_mask)
    else:
        from ..ops.dense_attention import transformer_conv_table

        rung = conv_rung(cfg, drop, gen)

        def lg_conv(conv, state, feats):
            return transformer_conv_table(
                conv.params(), state, batch.lg_src, batch.lg_dst, feats,
                batch.lg_row_ptr, batch.lg_src_order, batch.lg_src_starts,
                edge_mask=batch.lg_mask,
                attn_span=cfg.attn_span and cfg.lg_span64 > 0,
                span_lo=batch.bond_span_lo, **rung)

        def atom_conv(conv, state, feats):
            return transformer_conv_table(
                conv.params(), state, batch.edge_src, batch.edge_dst, feats,
                batch.edge_row_ptr, batch.edge_src_order,
                batch.edge_src_starts, edge_mask=batch.edge_mask,
                attn_span=cfg.attn_span and cfg.edge_span64 > 0,
                span_lo=batch.node_span_lo, **rung)

    node_state, edge_state = interaction_blocks(
        model, node_state, edge_state, angle_emb, lg_conv, atom_conv,
        has_lg, has_edges, drop, gen, tap)
    g = batch.n_graphs
    pooled = segment_mean(node_state, batch.node_graph, g + 1)[:g]
    return readout(model, pooled, batch.globals_, batch.sg_num, drop, gen,
                   tap)


def conv_rung(cfg: AlignnConfig, drop: float,
              gen: Optional[torch.Generator]) -> dict:
    """The keyword arguments that pick `transformer_conv_table`'s rung and
    its attention dropout under `cfg`."""
    return dict(heads=cfg.heads, fused=cfg.conv_impl == "fused",
                attn_fused=cfg.attn_fused, attn_eproj=cfg.attn_eproj,
                dropout_rate=drop, generator=gen)


ConvFn = Callable[[TransformerConv, torch.Tensor, torch.Tensor], torch.Tensor]


def interaction_blocks(model: Alignn, node_state: torch.Tensor,
                       edge_state: torch.Tensor, angle_emb: torch.Tensor,
                       lg_conv: ConvFn, atom_conv: ConvFn,
                       has_lg: torch.Tensor, has_edges: torch.Tensor,
                       drop: float, gen: Optional[torch.Generator],
                       tap: Optional[Callable[[str, torch.Tensor], None]]
                       = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The L interleaved blocks → (node_state, edge_state); `lg_conv` and
    `atom_conv(conv, state, feats)` run the two convs over whatever layout
    the caller holds (the packed arenas, or a rank's boundary arena)."""
    for li, (eb, nb) in enumerate(zip(model.edge_blocks, model.node_blocks)):
        # EdgeUpdate: line-graph conv with angle features
        out = lg_conv(eb.conv, edge_state, angle_emb).to(edge_state.dtype)
        out = _layer_norm(out, eb.ln_scale, eb.ln_bias)
        edge_state = torch.where(
            has_lg, edge_state + _dropout(torch.relu(out), drop, gen),
            edge_state)
        # NodeUpdate: atom conv fed by projected bond states
        edge_feat = edge_state @ nb.edge_proj_w + nb.edge_proj_b
        out = atom_conv(nb.conv, node_state, edge_feat).to(node_state.dtype)
        out = _layer_norm(out, nb.ln_scale, nb.ln_bias)
        node_state = torch.where(
            has_edges, node_state + _dropout(torch.relu(out), drop, gen),
            node_state)
        if tap is not None:
            tap(f"layer{li}_edge", edge_state)
            tap(f"layer{li}_node", node_state)
    return node_state, edge_state


def readout(model: Alignn, pooled: torch.Tensor, globals_: torch.Tensor,
            sg_num: torch.Tensor, drop: float,
            gen: Optional[torch.Generator],
            tap: Optional[Callable[[str, torch.Tensor], None]] = None
            ) -> torch.Tensor:
    """Pooled [G, H] ‖ globals ‖ space-group one-hot → feat_proj → the
    shared embedding [G, H]."""
    # jax.nn.one_hot gives a zero row for sg_num 0 (index −1);
    # torch.nn.functional.one_hot would raise, so build it directly
    valid = (sg_num >= 1) & (sg_num <= N_SG)
    sg_one_hot = (torch.arange(1, N_SG + 1, device=sg_num.device)[None, :]
                  == torch.where(valid, sg_num, 0)[:, None]).to(pooled.dtype)
    feats = _dropout(torch.cat([pooled, globals_, sg_one_hot], dim=-1),
                     drop, gen)
    shared = _dropout(torch.relu(model.feat_proj(feats)), drop, gen)
    if tap is not None:
        tap("pooled", pooled)
        tap("shared", shared)
    return shared


def alignn_apply(model: Alignn, batch: DeviceBatch, *, train: bool = False,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward → (mean [G,T], logvar [G,T]) in transformed target space;
    eval unless `train` (dropout from `generator`)."""
    shared = _shared_trunk(model, batch, train=train, generator=generator)
    return model.mean_head(shared), model.logvar_head(shared)


def alignn_embed(model: Alignn, batch: DeviceBatch) -> torch.Tensor:
    """Penultimate embedding [G, H] (reference train.py:576-577), the eval
    trunk under the member's own config (its rung) and `inference_mode`;
    used by KNN density weighting and `--save-embeddings`."""
    with torch.inference_mode():
        return _shared_trunk(model, batch)


def alignn_activations(model: Alignn, batch: DeviceBatch
                       ) -> Dict[str, torch.Tensor]:
    """Eval forward recording every intermediate activation: {node_enc,
    edge_enc, angle_enc, layer{i}_edge, layer{i}_node, pooled, shared, mean,
    logvar}, the names `gnnep_tpu.models.alignn.alignn_activations` uses."""
    acts: Dict[str, torch.Tensor] = {}
    shared = _shared_trunk(model, batch, tap=acts.__setitem__)
    acts["mean"] = model.mean_head(shared)
    acts["logvar"] = model.logvar_head(shared)
    return acts
