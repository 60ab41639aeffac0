"""Multi-device train steps and forwards: the counterpart of
`gnnep_tpu.parallel.train_step` (its graph-aligned and boundary-exchange
formulations, which every entry point reaches; the edge-sharded one,
which only the JAX package's bench reaches, is ROADMAP.md's next item).

1. **Graph-aligned** (`AlignedTrainStep`). A packed batch is a
   block-diagonal graph, so cutting a step's union batch at graph
   boundaries leaves every aggregation segment on one rank: each of the
   D·E slots takes one complete packed sub-batch and runs the unmodified
   single-device forward and backward (the rung's kernels). One sum
   all-reduce carries the gradients, the loss and graph counts and the
   `StepMetrics` sums, a max all-reduce carries `max_var`, and the
   gradients are divided by the global real-graph count: the
   single-device mean-loss gradient over the union batch. Every rank
   then runs the same optimizer tail, so the parameters stay bitwise
   equal across ranks.
2. **Boundary exchange** (`BoundaryTrainStep`, `parallel.boundary_shard`):
   a giant graph partitioned over the edge axis. Every edge rank computes
   the same loss from the all-reduced pooling partials, and the backward
   of that all-reduce sums the cotangents again, so each edge rank's
   gradient holds E times its own share of the partitioned path plus the
   replicated tail's: the edge axis averages, the data axis sums (the JAX
   package's `pmean` over edge, `psum` over data).

A collective of gloo cannot be captured in a CUDA graph, so on the card a
mesh step is three parts: a captured local loss + backward that flattens
the gradients and metrics into one static buffer, the collective on that
buffer outside any graph (the same code for NCCL and gloo), and a
captured tail that unflattens, clips and runs Adam (`train.loop.
apply_update`). The boundary step's forward holds collectives (one
exchange a conv), so it runs eagerly. Each slot draws its dropout and
jitter from its own generator (the member's seed offset by its slot),
the counterpart of the JAX package's `fold_in` of the slot index; the
streams differ from JAX's.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.batching import GraphBatch
from ..models.alignn import Alignn, DeviceBatch
from ..ops.cuda.graphs import CountedGraph, launch_counts
from ..train.loop import (WARMUP_STEPS, Forward, StepMetrics, TrainHyper,
                          TrainStep, _on_device, _on_side, _release_pools,
                          apply_update, collect_predictions, nll_loss_sums,
                          prediction_rows, step_metrics, target_z,
                          train_outputs)
from .boundary_shard import (BoundaryBatch, BoundaryPlan, BoundaryTables,
                             RankBoundaryBatch, boundary_outputs)
from .mesh import EDGE_AXIS, Rank, all_reduce_max, all_reduce_sum

_N_SUMS = 6   # StepMetrics' summed fields, max_var apart


def inert_batch(proto: GraphBatch) -> GraphBatch:
    """A fully padded batch of `proto`'s budget (the JAX package's pad
    slot): every graph masked out, every edge on the dummy rows, so it adds
    nothing to the loss, the counts or the gradients."""
    empty = GraphBatch(*[np.zeros_like(np.asarray(f)) for f in proto])
    dummy_node = proto.nodes.shape[0] - 1
    dummy_edge = proto.edge_src.shape[0] - 1
    dummy_lg = proto.lg_src.shape[0] - 1
    n_tab = np.asarray(proto.node_in_edges)
    l_tab = np.asarray(proto.lg_in_edges)
    return empty._replace(
        edge_src=np.full_like(np.asarray(proto.edge_src), dummy_node),
        edge_dst=np.full_like(np.asarray(proto.edge_dst), dummy_node),
        lg_src=np.full_like(np.asarray(proto.lg_src), dummy_edge),
        lg_dst=np.full_like(np.asarray(proto.lg_dst), dummy_edge),
        node_graph=np.full_like(np.asarray(proto.node_graph),
                                proto.y.shape[0]),
        y=np.ones_like(np.asarray(proto.y)),
        sample_index=np.full_like(np.asarray(proto.sample_index), -1),
        node_in_edges=np.full_like(n_tab, dummy_edge),
        edge_table_pos=np.full_like(np.asarray(proto.edge_table_pos),
                                    n_tab.shape[0] * n_tab.shape[1] - 1),
        lg_in_edges=np.full_like(l_tab, dummy_lg),
        lg_table_pos=np.full_like(np.asarray(proto.lg_table_pos),
                                  l_tab.shape[0] * l_tab.shape[1] - 1),
        node_out_edges=np.full_like(np.asarray(proto.node_out_edges),
                                    dummy_edge),
        lg_out_edges=np.full_like(np.asarray(proto.lg_out_edges), dummy_lg),
        edge_src_order=np.arange(dummy_edge + 1, dtype=np.int32),
        lg_src_order=np.arange(dummy_lg + 1, dtype=np.int32),
        edge_src_starts=np.zeros_like(np.asarray(proto.edge_src_starts)),
        lg_src_starts=np.zeros_like(np.asarray(proto.lg_src_starts)))


def stack_for_mesh(batches: Sequence[GraphBatch], n_slots: int
                   ) -> List[GraphBatch]:
    """`n_slots` same-budget batches, slot r's for rank r; fewer batches
    are padded with inert ones (the JAX package stacks them on a leading
    axis; here each rank takes its own)."""
    batches = list(batches)
    if len(batches) > n_slots:
        raise ValueError(f"got {len(batches)} batches for {n_slots} slots")
    if len(batches) < n_slots:
        batches += [inert_batch(batches[0])] * (n_slots - len(batches))
    return batches


class _FlatGrads:
    """The gradients of `params` and a step's metric sums in one f32
    buffer [Σ numel + 6] (what one sum all-reduce carries), `max_var`
    beside it."""

    def __init__(self, params: Sequence[torch.Tensor], device):
        self.params = list(params)
        self.numels = [p.numel() for p in self.params]
        self.n = sum(self.numels)
        self.buf = torch.zeros(self.n + _N_SUMS, dtype=torch.float32,
                               device=device)
        self.vmax = torch.zeros(1, dtype=torch.float32, device=device)

    @torch.no_grad()
    def fill(self, metrics: torch.Tensor, weight: float = 1.0
             ) -> torch.Tensor:
        """Copy the parameters' `.grad` and `metrics` [7] (its sums times
        `weight`) into the buffers; returns the buffer."""
        self.buf[:self.n].copy_(torch.cat([p.grad.reshape(-1)
                                           for p in self.params]))
        self.buf[self.n:].copy_(metrics[:_N_SUMS] * weight)
        self.vmax.copy_(metrics[_N_SUMS:])
        return self.buf

    def reduce(self, rank: Rank) -> None:
        all_reduce_sum(rank, self.buf)
        all_reduce_max(rank, self.vmax)

    def grads(self, divisor: torch.Tensor) -> List[torch.Tensor]:
        """The summed gradients over `divisor`, shaped as the params."""
        return [g.view_as(p) / divisor for g, p in zip(
            self.buf[:self.n].split(self.numels), self.params)]

    def n_global(self) -> torch.Tensor:
        return torch.clamp_min(self.buf[self.n + 1], 1.0)

    def metrics(self) -> torch.Tensor:
        return torch.cat([self.buf[self.n:], self.vmax])


class AlignedTrainStep(TrainStep):
    """One graph-aligned optimizer step on this rank's slot: `step(batch,
    generator)` with this rank's sub-batch → the global `StepMetrics`
    (sums over every slot, `max_var` their max), the same on every rank.
    On the card the local part and the tail are captured graphs (the
    first `WARMUP_STEPS` steps run eagerly), the all-reduce runs between
    them; on the CPU all three run eagerly. `last_grads` are the reduced
    gradients the last step's tail clipped and applied."""

    def __init__(self, model: Alignn, hyper: TrainHyper,
                 log_means: np.ndarray, log_stds: np.ndarray, rank: Rank):
        super().__init__(model, hyper, log_means, log_stds)
        self.rank = rank
        self.flat = _FlatGrads(self.params, self.device)
        self.last_grads: List[torch.Tensor] = []
        self.static: Optional[DeviceBatch] = None
        self.graphs: Optional[tuple] = None
        self.out: Optional[torch.Tensor] = None
        self.generator: Optional[torch.Generator] = None
        self.eager_steps = 0

    def _local(self, batch: DeviceBatch,
               generator: Optional[torch.Generator]) -> torch.Tensor:
        for p in self.params:
            p.grad = None
        mean, logvar = train_outputs(self.model, self.hyper, batch,
                                     generator)
        loss_sum, sample_loss = nll_loss_sums(
            mean, logvar, batch, target_z(batch, self.mu, self.sd),
            self.hyper)
        loss_sum.backward()
        # the raw logvar in the diagnostics, as the JAX package's mesh step
        return self.flat.fill(step_metrics(mean, logvar, sample_loss, batch,
                                           self.mu, self.sd))

    def _tail(self) -> torch.Tensor:
        self.last_grads = self.flat.grads(self.flat.n_global())
        apply_update(self.params, self.last_grads, self.state,
                     self.is_sigma, self.lr_mean, self.lr_sigma, self.hyper)
        return self.flat.metrics()

    def _one(self, batch, generator: Optional[torch.Generator]
             ) -> torch.Tensor:
        if self.device.type != "cuda":
            self._local(_on_device(batch, self.device), generator)
            self.flat.reduce(self.rank)
            return self._tail()
        if self.static is None:
            self.static = DeviceBatch.allocate(batch, self.device)
            self.generator = generator
            self._side = torch.cuda.Stream(self.device)
        elif generator is not self.generator:
            raise ValueError("a captured train step draws from the one "
                             "generator it started with")
        self.static.copy_from(batch)
        if self.graphs is None and self.eager_steps < WARMUP_STEPS:
            self.eager_steps += 1
            _on_side(self._side, lambda: self._local(self.static, generator))
            self.flat.reduce(self.rank)
            return _on_side(self._side, self._tail)
        if self.graphs is None:
            local, tail = CountedGraph("train"), CountedGraph(None)
            local.capture(lambda: self._local(self.static, generator),
                          generator)
            self.graphs = (local, tail)
        local, tail = self.graphs
        local.replay()
        self.flat.reduce(self.rank)
        if self.out is None:
            self.out = tail.capture(self._tail)
        tail.replay()
        return self.out

    def close(self) -> None:
        captured = self.graphs is not None
        for g in self.graphs or ():
            g.reset()
        self.graphs = self.out = self.static = None
        self.last_grads = []
        for p in self.params:
            p.grad = None
        if captured:
            _release_pools()


def make_aligned_train_step(rank: Rank, model: Alignn, hyper: TrainHyper,
                            log_means: np.ndarray, log_stds: np.ndarray
                            ) -> AlignedTrainStep:
    """The graph-aligned step of `model` on `rank`'s device (the model
    moves there)."""
    return AlignedTrainStep(model.to(rank.device), hyper, log_means,
                            log_stds, rank)


class BoundaryTrainStep:
    """One optimizer step on a boundary-partitioned giant, sharing `base`'s
    parameters, Adam state and LR tensors (the member's packed-batch
    step): `step(rb, generator, shared_generator)` with this rank's
    `RankBoundaryBatch` → the global `StepMetrics` (sums over the data
    axis: the metric inputs are replicated over the edge axis). Eager on
    every device. `last_grads` are the last step's reduced gradients."""

    def __init__(self, base: TrainStep, rank: Rank, plan: BoundaryPlan):
        self.base = base
        self.rank = rank
        self.plan = plan
        self.flat = _FlatGrads(base.params, base.device)
        self.dtype = {"float32": torch.float32,
                      "bfloat16": torch.bfloat16}[base.hyper.compute_dtype]
        self.last_grads: List[torch.Tensor] = []

    def __call__(self, rb: RankBoundaryBatch,
                 generator: Optional[torch.Generator] = None,
                 shared_generator: Optional[torch.Generator] = None
                 ) -> StepMetrics:
        b, hyper = self.base, self.base.hyper
        for p in b.params:
            p.grad = None
        if hyper.feature_jitter_std > 0.0 and generator is not None:
            # node rows are this rank's; the globals are replicated, so
            # their jitter comes from the edge axis' shared stream
            std = hyper.feature_jitter_std
            rb = dataclasses.replace(
                rb,
                nodes=rb.nodes + std * torch.randn(
                    rb.nodes.shape, generator=generator,
                    device=rb.nodes.device),
                globals_=rb.globals_ + std * torch.randn(
                    rb.globals_.shape,
                    generator=shared_generator or generator,
                    device=rb.globals_.device))
        mean, logvar = boundary_outputs(b.model, rb, self.plan, self.rank,
                                        self.dtype, train=True,
                                        generator=generator,
                                        shared_generator=shared_generator)
        loss_sum, sample_loss = nll_loss_sums(
            mean, logvar, rb, target_z(rb, b.mu, b.sd), hyper)
        loss_sum.backward()
        # one edge rank of each data slot counts the replicated metrics
        self.flat.fill(step_metrics(mean, logvar, sample_loss, rb, b.mu,
                                    b.sd),
                       weight=1.0 if self.rank.edge == 0 else 0.0)
        self.flat.reduce(self.rank)
        self.last_grads = self.flat.grads(
            self.flat.n_global() * self.rank.axis_size(EDGE_AXIS))
        apply_update(b.params, self.last_grads, b.state, b.is_sigma,
                     b.lr_mean, b.lr_sigma, hyper)
        return StepMetrics(*self.flat.metrics().clone())


def make_boundary_forward(rank: Rank, plan: BoundaryPlan, floor: float,
                          compute_dtype: str = "float32"):
    """Eval forward on the boundary partition: `fwd(model, rb)` →
    (mean [G, T], logvar [G, T] floored at `floor`), f32, replicated over
    the edge axis. `model` is on the rank's device, already cast to
    `compute_dtype` (`train.loop.cast_model`)."""
    dtype = {"float32": torch.float32,
             "bfloat16": torch.bfloat16}[compute_dtype]

    def fwd(model: Alignn, rb: RankBoundaryBatch):
        with torch.inference_mode():
            mean, logvar = boundary_outputs(model, rb, plan, rank, dtype)
            return mean, torch.clamp_min(logvar, floor)

    return fwd


class AlignedForward:
    """The JAX package's `make_aligned_forward`: the eval forward fanned
    out over devices: batch i runs on device
    i mod D through one `train.loop.Forward` (captured per device on the
    card), each device with its own copy of a member, made once and kept
    until the forward closes. A forward needs no collective, so this runs
    in the calling process; its results equal the single-device loop's.
    `devices` None: every visible card where the member is on one, else
    the member's device."""

    def __init__(self, forward: Forward, devices: Optional[Sequence] = None):
        self.forward = forward
        self.devices = devices
        self._copies: Dict[tuple, Alignn] = {}

    def devices_for(self, model: Alignn) -> List[torch.device]:
        if self.devices is not None:
            return [torch.device(d) for d in self.devices]
        dev = next(model.parameters()).device
        if dev.type != "cuda":
            return [dev]
        return [torch.device(f"cuda:{i}")
                for i in range(torch.cuda.device_count())]

    def copy_on(self, model: Alignn, device: torch.device,
                slot: int) -> Alignn:
        if slot == 0 and next(model.parameters()).device == device:
            return model
        key = (id(model), slot)
        if key not in self._copies:
            self._copies[key] = copy.deepcopy(model).to(device)
        return self._copies[key]

    def __call__(self, model: Alignn, batches: Sequence):
        devices = self.devices_for(model)
        if len(devices) <= 1 or len(batches) <= 1:
            return collect_predictions(self.forward, model, batches)
        copies = [self.copy_on(model, d, i) for i, d in enumerate(devices)]
        outs = [torch.stack(self.forward(copies[i % len(copies)], b))
                for i, b in enumerate(batches)]
        # every device's forwards are queued before the first readback
        host = torch.cat([o.cpu() for o in outs], dim=1).numpy()
        return prediction_rows(batches, host)

    def close(self) -> None:
        self.forward.close()
        self._copies.clear()


# ---------------------------------------------------------------------------
# rank bodies that drive a few steps from a given state (the parity tests
# and the chip smoke run use them)
# ---------------------------------------------------------------------------

def _model_on(rank: Rank, cfg, state: Dict[str, np.ndarray]) -> Alignn:
    model = Alignn(cfg)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in state.items()})
    return model.to(rank.device)


def _host_state(model: Alignn) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def aligned_steps_rank(rank: Rank, state: Dict[str, np.ndarray], cfg,
                       hyper: TrainHyper, log_means, log_stds,
                       slots: Sequence[Sequence[GraphBatch]], lrs,
                       seed: Optional[int] = None) -> dict:
    """Aligned steps from `state`: step t takes `slots[t][rank]` at LRs
    `lrs[t]` = (mean, sigma), dropout and jitter from a generator seeded
    `seed + rank` (none where `seed` is None) → this rank's {'params',
    'metrics' [steps, 7], 'grads' (the last step's reduced gradients),
    'counts' (kernel launches)}."""
    model = _model_on(rank, cfg, state)
    step = make_aligned_train_step(rank, model, hyper, log_means, log_stds)
    gen = None
    if seed is not None:
        gen = torch.Generator(device=rank.device)
        gen.manual_seed(int(seed) + rank.rank)
    rows = [torch.stack(list(step(group[rank.rank], gen, *lr)))
            for group, lr in zip(slots, lrs)]
    out = {"params": _host_state(model),
           "metrics": torch.stack(rows).cpu().numpy(),
           "grads": {n: g.detach().cpu().numpy()
                     for n, g in zip(step.names, step.last_grads)},
           "counts": launch_counts()}
    step.close()
    return out


def boundary_steps_rank(rank: Rank, state: Dict[str, np.ndarray], cfg,
                        hyper: TrainHyper, log_means, log_stds,
                        plan: BoundaryPlan,
                        groups: Sequence[Sequence[BoundaryBatch]],
                        tables: Sequence[Sequence[BoundaryTables]], lrs,
                        floor: float, seed: Optional[int] = None) -> dict:
    """The boundary forward of `groups[0]`, then one boundary step per
    group from `state` (data slot d takes each group's batch d) → this
    rank's {'forward': (mean, logvar floored), 'params', 'metrics',
    'grads' (the first step's reduced gradients), 'counts', 'sent_bytes'
    (what this rank sent through the exchange, forward and backward)}."""
    from . import mesh

    mesh.sent_bytes = 0
    model = _model_on(rank, cfg, state)
    base = TrainStep(model, hyper, log_means, log_stds)
    step = BoundaryTrainStep(base, rank, plan)
    gens = [None, None]
    if seed is not None:
        gens = [torch.Generator(device=rank.device) for _ in range(2)]
        gens[0].manual_seed(int(seed) + rank.rank)
        gens[1].manual_seed(int(seed) + rank.mesh.size + rank.data)

    def rb_of(k):
        return RankBoundaryBatch.from_boundary(
            groups[k][rank.data], tables[k][rank.data], rank.edge,
            rank.device)

    fwd = make_boundary_forward(rank, plan, floor, hyper.compute_dtype)
    from ..train.loop import cast_model

    mean, logvar = fwd(cast_model(model, hyper.compute_dtype), rb_of(0))
    forward = (mean.cpu().numpy(), logvar.cpu().numpy())
    rows, grads = [], None
    for k, (lr_mean, lr_sigma) in enumerate(lrs):
        base.set_lr(lr_mean, lr_sigma)
        rows.append(torch.stack(list(step(rb_of(k), *gens))))
        if grads is None:
            grads = {n: g.detach().cpu().numpy()
                     for n, g in zip(base.names, step.last_grads)}
    return {"forward": forward, "params": _host_state(model),
            "metrics": torch.stack(rows).cpu().numpy() if rows else None,
            "grads": grads, "counts": launch_counts(),
            "sent_bytes": mesh.sent_bytes}
