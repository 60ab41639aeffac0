"""Multi-device train steps and forwards: the counterpart of
`gnnep_tpu.parallel.train_step`, all three of its formulations.

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
   equal across ranks. `TrainStep.run` on it is the JAX package's
   `make_aligned_scan_step` (K steps, metrics read back once).
2. **Edge-sharded** (`ShardedTrainStep`, `parallel.edge_shard`): the bond
   and line-graph arenas of one batch cut mid-segment over the edge axis
   (`edge_slice`), states replicated, each conv's partials combined over
   the axis (kernel 7 on the windowed formulation). It stays correct when
   one graph's edges exceed a card; slower than the aligned step. No CLI
   reaches it, as in the JAX package: `make_sharded_train_step` and
   `make_sharded_forward` are its entry points.
3. **Boundary exchange** (`BoundaryTrainStep`, `parallel.boundary_shard`):
   a giant graph partitioned over the edge axis; `run` takes K steps
   (`make_boundary_scan_step`), `boundary_grads` the gradients alone
   (`make_boundary_grads`).

In 2 and 3 every edge rank computes the same loss from its all-reduced
partials, and the backward of each such all-reduce sums the cotangents
again, so each edge rank's gradient holds E times its own share of the
partitioned path plus the replicated path's: the edge axis averages, the
data axis sums (the JAX package's `pmean` over edge, `psum` over data).

A collective of gloo cannot be captured in a CUDA graph, so on the card a
mesh step is three parts: a captured local loss + backward that flattens
the gradients and metrics into one static buffer, the collective on that
buffer outside any graph (the same code for NCCL and gloo), and a
captured tail that unflattens, clips and runs Adam (`train.loop.
apply_update`). The edge-sharded and boundary steps' forwards hold
collectives (in every conv), so they run eagerly. Each slot draws its
dropout and jitter from its own generator (the member's seed offset by
its slot), the counterpart of the JAX package's `fold_in` of the slot
index; in 2 and 3 what acts on replicated values draws from a second
generator that the data slot's edge ranks share. The streams differ from
JAX's.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.batching import GraphBatch
from ..models.alignn import Alignn, DeviceBatch
from ..ops.cuda.graphs import CountedGraph, launch_counts
from ..train.loop import (_DTYPES, WARMUP_STEPS, Forward, StepMetrics,
                          TrainHyper, TrainStep, _on_device, _on_side,
                          _release_pools, apply_update, collect_predictions,
                          nll_loss_sums, prediction_rows, step_metrics,
                          target_z, train_outputs)
from .boundary_shard import (BoundaryBatch, BoundaryPlan, BoundaryTables,
                             RankBoundaryBatch, boundary_outputs)
from .edge_shard import sharded_apply
from .mesh import (DATA_AXIS, EDGE_AXIS, Rank, all_gather, all_reduce_max,
                   all_reduce_sum)

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


# the fields whose leading axis is a bond or line-graph arena, cut over the
# edge axis (the JAX package's `_EDGE_FIELDS`); every other one replicated
EDGE_FIELDS = frozenset({
    "edge_src", "edge_dst", "edge_attr", "edge_mask", "lg_src", "lg_dst",
    "lg_attr", "lg_mask", "edge_table_pos", "lg_in_edges", "lg_in_mask",
    "lg_table_pos", "lg_out_edges", "lg_out_mask", "edge_src_order",
    "lg_src_order", "lg_src_starts"})


def edge_slice(batch: GraphBatch, e: int, n_edge: int) -> GraphBatch:
    """Edge rank `e`'s share of `batch` for the edge-sharded step: each of
    `EDGE_FIELDS` cut to its rows [e·L, (e+1)·L), L = its arena / n_edge,
    every other field whole. Raises ValueError where an arena is not a
    multiple of `n_edge`."""
    fields = {}
    for name in GraphBatch._fields:
        a = getattr(batch, name)
        if name in EDGE_FIELDS and a is not None:
            a = np.asarray(a)
            if a.shape[0] % n_edge:
                raise ValueError(f"{name}: its arena of {a.shape[0]} rows "
                                 f"does not split over {n_edge} edge ranks")
            rows = a.shape[0] // n_edge
            a = a[e * rows:(e + 1) * rows]
        fields[name] = a
    return GraphBatch(**fields)


def measure_table_widths(batches: Sequence[GraphBatch]) -> tuple:
    """(atom_w, lg_w): the longest CSR row span over the REAL rows of every
    batch (the dummy row's tail span left out), as the JAX package measures
    them (its windowed kernel's bound on the rows a segment reads; kernel 7
    walks every segment whole, so the port's steps take it and do not read
    it)."""
    aw = lw = 1
    for b in batches:
        e_rp = np.asarray(b.edge_row_ptr, dtype=np.int64)
        l_rp = np.asarray(b.lg_row_ptr, dtype=np.int64)
        if e_rp.size > 2:
            aw = max(aw, int(np.diff(e_rp)[:-1].max()))
        if l_rp.size > 2:
            lw = max(lw, int(np.diff(l_rp)[:-1].max()))
    return aw, lw


def measure_row_windows(batches: Sequence[GraphBatch], n_edge_shards: int
                        ) -> tuple:
    """(atom_R, lg_R): the rows any rank's CSR-contiguous edge slice
    reaches (from a 128-aligned start, rounded up to 128), over every batch
    and shard, as the JAX package measures them: each rank's windowed
    reductions then run on R rows instead of all N
    (`edge_shard._windowed_conv`)."""
    aw = lw = 128
    s = max(int(n_edge_shards), 1)
    for b in batches:
        for which, rp, e_arena, n_rows in (
                ("atom", np.asarray(b.edge_row_ptr, np.int64),
                 b.edge_src.shape[0], b.nodes.shape[0]),
                ("lg", np.asarray(b.lg_row_ptr, np.int64),
                 b.lg_src.shape[0], b.edge_src.shape[0])):
            e_loc = e_arena // s
            for r in range(s):
                e0, e1 = r * e_loc, (r + 1) * e_loc
                lo = max(int(np.searchsorted(rp, e0, side="right")) - 1, 0)
                lo = (lo // 128) * 128
                hi = max(int(np.searchsorted(rp, e1 - 1, side="right")) - 1,
                         lo)
                R = min(((hi - lo) // 128 + 1) * 128, n_rows)
                if which == "atom":
                    aw = max(aw, R)
                else:
                    lw = max(lw, R)
    return aw, lw


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


class _EagerMeshStep:
    """An eager optimizer step whose forward holds collectives, sharing
    `base`'s parameters, Adam state and LR tensors (the member's
    packed-batch step): `step(batch, generator, shared_generator, lr_mean,
    lr_sigma)` with this rank's batch → the global `StepMetrics` (sums over
    the data axis: the metric inputs are replicated over the edge axis),
    the same on every rank. `generator` is this rank's stream,
    `shared_generator` the data slot's edge ranks' (`generator` where
    None). `run` takes K steps, their metrics in one [K, 7] device buffer
    read back once by the caller. `last_grads` are the last step's reduced
    gradients."""

    def __init__(self, base: TrainStep, rank: Rank):
        self.base = base
        self.rank = rank
        self.flat = _FlatGrads(base.params, base.device)
        self.last_grads: List[torch.Tensor] = []

    def _outputs(self, batch, generator, shared_generator):
        """→ (mean, logvar, the batch the loss reads) of this rank."""
        raise NotImplementedError

    def _one(self, batch, generator: Optional[torch.Generator],
             shared_generator: Optional[torch.Generator]) -> torch.Tensor:
        b, hyper = self.base, self.base.hyper
        for p in b.params:
            p.grad = None
        mean, logvar, batch = self._outputs(batch, generator,
                                            shared_generator)
        loss_sum, sample_loss = nll_loss_sums(
            mean, logvar, batch, target_z(batch, b.mu, b.sd), hyper)
        loss_sum.backward()
        # one edge rank of each data slot counts the replicated metrics
        self.flat.fill(step_metrics(mean, logvar, sample_loss, batch, b.mu,
                                    b.sd),
                       weight=1.0 if self.rank.edge == 0 else 0.0)
        self.flat.reduce(self.rank)
        self.last_grads = self.flat.grads(
            self.flat.n_global() * self.rank.axis_size(EDGE_AXIS))
        apply_update(b.params, self.last_grads, b.state, b.is_sigma,
                     b.lr_mean, b.lr_sigma, hyper)
        return self.flat.metrics()

    def __call__(self, batch, generator: Optional[torch.Generator] = None,
                 shared_generator: Optional[torch.Generator] = None,
                 lr_mean: Optional[float] = None,
                 lr_sigma: Optional[float] = None) -> StepMetrics:
        if lr_mean is not None:
            self.base.set_lr(lr_mean, lr_sigma)
        return StepMetrics(*self._one(batch, generator,
                                      shared_generator).clone())

    def run(self, batches: Sequence,
            generator: Optional[torch.Generator] = None,
            shared_generator: Optional[torch.Generator] = None,
            lr_mean: Optional[float] = None,
            lr_sigma: Optional[float] = None) -> StepMetrics:
        """K steps over `batches` → StepMetrics of [K] tensors."""
        if lr_mean is not None:
            self.base.set_lr(lr_mean, lr_sigma)
        rows = torch.empty((len(batches), len(StepMetrics._fields)),
                           dtype=torch.float32, device=self.base.device)
        for i, b in enumerate(batches):
            rows[i].copy_(self._one(b, generator, shared_generator))
        return StepMetrics(*rows.unbind(1))


class BoundaryTrainStep(_EagerMeshStep):
    """One optimizer step on a boundary-partitioned giant: the batch is
    this rank's `RankBoundaryBatch`; `run` over K of them is the JAX
    package's `make_boundary_scan_step`."""

    def __init__(self, base: TrainStep, rank: Rank, plan: BoundaryPlan):
        super().__init__(base, rank)
        self.plan = plan
        self.dtype = _DTYPES[base.hyper.compute_dtype]

    def _outputs(self, rb: RankBoundaryBatch, generator, shared_generator):
        hyper = self.base.hyper
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
        mean, logvar = boundary_outputs(self.base.model, rb, self.plan,
                                        self.rank, self.dtype, train=True,
                                        generator=generator,
                                        shared_generator=shared_generator)
        return mean, logvar, rb


class ShardedTrainStep(_EagerMeshStep):
    """One optimizer step of the edge-sharded formulation: the batch is
    this rank's `edge_slice` of its data slot's batch (a `GraphBatch` or
    `DeviceBatch`). Node and global features are replicated, so their
    jitter draws from the shared stream. f32 only: the JAX package's
    sharded step never casts for compute."""

    def __init__(self, base: TrainStep, rank: Rank, impl: str = "coo",
                 row_windows: Optional[tuple] = None):
        if base.hyper.compute_dtype != "float32":
            raise ValueError("the edge-sharded step runs in float32 only, "
                             f"not {base.hyper.compute_dtype}")
        super().__init__(base, rank)
        self.layout = dict(impl=impl, row_windows=row_windows)

    def _outputs(self, batch, generator, shared_generator):
        batch = _on_device(batch, self.base.device)
        std = self.base.hyper.feature_jitter_std
        shared = shared_generator or generator
        if std > 0.0 and shared is not None:
            batch = dataclasses.replace(
                batch,
                nodes=batch.nodes + std * torch.randn(
                    batch.nodes.shape, generator=shared,
                    device=batch.nodes.device),
                globals_=batch.globals_ + std * torch.randn(
                    batch.globals_.shape, generator=shared,
                    device=batch.globals_.device))
        mean, logvar = sharded_apply(self.base.model, batch, self.rank,
                                     train=True, generator=generator,
                                     shared_generator=shared_generator,
                                     **self.layout)
        return mean, logvar, batch


def make_sharded_train_step(rank: Rank, model: Alignn, hyper: TrainHyper,
                            log_means: np.ndarray, log_stds: np.ndarray,
                            comm_chunks: int = 4,
                            table_widths: Optional[tuple] = None,
                            impl: str = "coo",
                            row_windows: Optional[tuple] = None
                            ) -> ShardedTrainStep:
    """The edge-sharded step of `model` on `rank`'s device (the model moves
    there), the JAX package's `make_sharded_train_step`: `impl` selects the
    formulation ('windowed' runs kernel 7), `row_windows`
    (`measure_row_windows`) bounds each rank's target rows. `comm_chunks`
    and `table_widths` are the JAX package's and not read
    (`parallel.edge_shard`'s docstring)."""
    base = TrainStep(model.to(rank.device), hyper, log_means, log_stds)
    return ShardedTrainStep(base, rank, impl, row_windows)


def make_sharded_forward(rank: Rank, floor: float, comm_chunks: int = 1,
                         table_widths: Optional[tuple] = None,
                         impl: str = "coo",
                         row_windows: Optional[tuple] = None):
    """Eval forward of the edge-sharded formulation: `fwd(model, batch)`
    with this rank's `edge_slice` → (mean [D, G, T], logvar [D, G, T]
    floored at `floor`), f32, every data slot's rows in slot order, the
    same on every rank (the JAX package's `make_sharded_forward`)."""

    def fwd(model: Alignn, batch):
        device = next(model.parameters()).device
        with torch.inference_mode():
            mean, logvar = sharded_apply(model, _on_device(batch, device),
                                         rank, impl=impl,
                                         row_windows=row_windows)
            return tuple(torch.stack(all_gather(rank, t, DATA_AXIS))
                         for t in (mean.float(),
                                   torch.clamp_min(logvar.float(), floor)))

    return fwd


def boundary_grads(rank: Rank, model: Alignn, rb: RankBoundaryBatch,
                   plan: BoundaryPlan, hyper: TrainHyper,
                   log_means: np.ndarray, log_stds: np.ndarray
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The boundary step's gradient pipeline without the optimizer (the
    JAX package's `make_boundary_grads`): the eval forward (no dropout, no
    jitter) in `hyper.compute_dtype` with f32 pooling partials, the
    sum-form loss, the gradients averaged over the edge axis and summed
    over data, over the global real-graph count → (loss, {parameter name:
    gradient}), loss the data slots' loss sums over that count; the same
    on every rank. Leaves the parameters' `.grad` set to this rank's own
    gradients."""
    names, params = zip(*model.named_parameters())
    device = params[0].device
    for p in params:
        p.grad = None
    mu = torch.as_tensor(np.asarray(log_means, np.float32), device=device)
    sd = torch.as_tensor(np.asarray(log_stds, np.float32), device=device)
    mean, logvar = boundary_outputs(model, rb, plan, rank,
                                    _DTYPES[hyper.compute_dtype])
    loss_sum, _ = nll_loss_sums(mean, logvar, rb, target_z(rb, mu, sd),
                                hyper)
    loss_sum.backward()
    flat = _FlatGrads(params, device)
    # the loss and the graph count are replicated over the edge axis: one
    # edge rank of each data slot adds them
    sums = torch.stack([loss_sum.detach(), rb.graph_mask.sum()])
    flat.fill(torch.cat([sums, sums.new_zeros(_N_SUMS + 1 - 2)]),
              weight=1.0 if rank.edge == 0 else 0.0)
    flat.reduce(rank)
    n_global = flat.n_global()
    grads = flat.grads(n_global * rank.axis_size(EDGE_AXIS))
    return flat.buf[flat.n] / n_global, dict(zip(names, grads))


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

