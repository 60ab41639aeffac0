"""Giant-graph routing: graphs beyond the batch budget train and predict
through the boundary-exchange edge partition instead of raising in the
packer (the counterpart of `gnnep_tpu.parallel.giant`).

- `find_giants` / `classify_giants`: the graphs the packer would reject,
  found by the JAX package's fixpoint (a huge giant inflates the
  typical-statistics budget and can hide smaller giants from one pass);
- `build_giant_set`: one covering single-graph budget over all giants, one
  shared `BoundaryPlan`, one `BoundaryBatch` and one `BoundaryTables` per
  giant;
- `GiantSet.groups` / `inert_like`: giants `n_data` at a time for the
  mesh's data axis, short groups padded with inert (all-masked) copies;
- `giant_outputs`: the boundary forward over such groups on a rank;
- `make_giant_collector`: the validated (1 × n_shards) mesh and a
  per-member collection with `train.loop.collect_predictions`'s return
  contract;
- `MemberRows`: one member's rows over packed batches (fanned out over
  the visible cards) and then over giant ids, shared by evaluate, predict
  and calibration.

Enabled by `TrainConfig.giant_graphs = "boundary"` (`cli.train
--giant-graphs boundary --edge-shards S`) and `--giant-shards N` in
predict and evaluate.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.batching import BatchBudget, epoch_batches
from ..data.store import GraphStore
from ..models.alignn import Alignn
from .boundary_shard import (BoundaryBatch, BoundaryPlan, BoundaryTables,
                             RankBoundaryBatch, build_boundary_tables,
                             plan_boundary_batches)
from .mesh import (Rank, WorldPool, gather_objects, make_mesh, slot_devices,
                   visible_cards)
from ..train.loop import make_forward
from .train_step import AlignedForward, make_boundary_forward


def fits_budget(store: GraphStore, g: int, budget: BatchBudget) -> bool:
    """The predicate the packer enforces (BatchPacker.pack)."""
    n, e, l = store.counts(int(g))
    return (n <= budget.n_nodes - 1 and e <= budget.n_edges - 1
            and l <= budget.n_lg_edges)


def find_giants(store: GraphStore, indices: Sequence[int],
                budget: BatchBudget) -> List[int]:
    """Graph ids in `indices` that the packer would reject for `budget`."""
    return [int(g) for g in indices if not fits_budget(store, g, budget)]


def classify_giants(store: GraphStore, indices: Sequence[int], plan_budget
                    ) -> Tuple[List[int], List[int], BatchBudget]:
    """Fixpoint giant classification shared by train, evaluate and
    predict: re-plan over the surviving population until the giant set is
    stable. `plan_budget(population, cover_all)` builds a BatchBudget.
    Returns `(normal, giants, budget)`: `normal` in order, `giants` sorted,
    and `budget` the final plan over the normal population (cover-all
    whenever a giant was split off)."""
    normal = [int(g) for g in indices]
    giants: List[int] = []
    budget = plan_budget(normal, False)
    while normal:
        grown = set(find_giants(store, normal, budget))
        if not grown:
            break
        giants.extend(grown)
        normal = [g for g in normal if g not in grown]
        if normal:
            budget = plan_budget(normal, False)
    if giants and normal:
        budget = plan_budget(normal, True)
    return normal, sorted(giants), budget


@dataclasses.dataclass
class GiantSet:
    """All giant graphs' boundary-partitioned batches under one shared
    plan, and each one's CSR tables."""

    indices: List[int]                  # giant graph ids, sorted
    budget: BatchBudget                 # single-graph covering budget
    plan: BoundaryPlan
    n_shards: int
    bbs: Dict[int, BoundaryBatch]       # graph id → its BoundaryBatch
    tables: Dict[int, BoundaryTables]   # graph id → its CSR tables

    def __contains__(self, g: int) -> bool:
        return int(g) in self.bbs

    def split(self, indices: Sequence[int]) -> Tuple[List[int], List[int]]:
        """(normal, giant) partition of `indices`, order-preserving."""
        normal, giant = [], []
        for g in indices:
            (giant if int(g) in self.bbs else normal).append(int(g))
        return normal, giant

    def inert_like(self, bb: BoundaryBatch) -> BoundaryBatch:
        """An all-masked copy: zero loss, count and gradient (graph_mask,
        y_mask and weight are the authorities everywhere)."""
        return bb._replace(
            graph_mask=np.zeros_like(np.asarray(bb.graph_mask)),
            y_mask=np.zeros_like(np.asarray(bb.y_mask)),
            weight=np.zeros_like(np.asarray(bb.weight)))

    def groups(self, ids: Sequence[int], n_data: int,
               weight_arr: Optional[np.ndarray] = None
               ) -> List[List[BoundaryBatch]]:
        """`ids` (repeats allowed: bootstrap duplicates step again) in
        `n_data`-sized lists of BoundaryBatches, the last short one padded
        with inert copies; per-graph loss weights grafted as the packer
        grafts them onto GraphBatches."""
        bbs = []
        for g in ids:
            bb = self.bbs[int(g)]
            if weight_arr is not None:
                w = np.asarray(bb.graph_mask) * float(weight_arr[int(g)])
                bb = bb._replace(weight=w.astype(np.float32))
            bbs.append(bb)
        out: List[List[BoundaryBatch]] = []
        for at in range(0, len(bbs), n_data):
            group = bbs[at:at + n_data]
            while len(group) < n_data:
                group.append(self.inert_like(group[0]))
            out.append(group)
        return out

    def group_tables(self, ids: Sequence[int], n_data: int
                     ) -> List[List[BoundaryTables]]:
        """The tables of `groups(ids, n_data)`, slot for slot (an inert
        copy shares its group's first giant's tables)."""
        tabs = [self.tables[int(g)] for g in ids]
        out = []
        for at in range(0, len(tabs), n_data):
            group = tabs[at:at + n_data]
            out.append(group + [group[0]] * (n_data - len(group)))
        return out


def build_giant_set(store: GraphStore, giant_idx: Sequence[int],
                    n_shards: int) -> GiantSet:
    """Pack every giant alone (one covering budget, so one set of arena
    shapes) and boundary-partition them under one shared plan."""
    giant_idx = sorted(int(g) for g in giant_idx)
    if not giant_idx:
        raise ValueError("build_giant_set called with no giant graphs")
    budget = BatchBudget.plan(store, giant_idx, batch_size=1, slack=1.0,
                              cover_all=True)
    batches = []
    for g in giant_idx:
        bs = epoch_batches(store, [g], budget, shuffle=False)
        if len(bs) != 1:
            raise RuntimeError("a single-graph budget packed "
                               f"{len(bs)} batches")
        batches.append(bs[0])
    bbs, plan = plan_boundary_batches(batches, n_shards)
    tables = build_boundary_tables(bbs, plan)
    return GiantSet(indices=giant_idx, budget=budget, plan=plan,
                    n_shards=int(n_shards),
                    bbs=dict(zip(giant_idx, bbs)),
                    tables=dict(zip(giant_idx, tables)))


def giant_outputs(rank: Rank, model: Alignn, giant: GiantSet,
                  ids: Sequence[int], floor: float,
                  compute_dtype: str = "float32"
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """The boundary forward over `ids` on this rank, `n_data` giants at a
    time (data slot d takes the group's giant d) → on every rank, (mean
    [n_groups, D, G, T], logvar floored at `floor`), f32 host arrays.
    `model` is on the rank's device, already cast to `compute_dtype`
    (`train.loop.cast_model`). Every rank of the mesh calls it."""
    n_data = rank.mesh.n_data
    fwd = make_boundary_forward(rank, giant.plan, floor, compute_dtype)
    outs = []
    for group, tabs in zip(giant.groups(ids, n_data),
                           giant.group_tables(ids, n_data)):
        rb = RankBoundaryBatch.from_boundary(
            group[rank.data], tabs[rank.data], rank.edge, rank.device)
        outs.append(torch.stack(fwd(model, rb)))
    mine = torch.stack(outs).cpu().numpy() if outs else None
    every = gather_objects(rank, mine)
    if mine is None:
        t = int(np.asarray(next(iter(giant.bbs.values())).y).shape[-1])
        empty = np.zeros((0, n_data, 0, t), np.float32)
        return empty, empty
    # edge rank 0 of each data slot holds that slot's outputs
    per_slot = np.stack([every[d * rank.mesh.n_edge] for d in range(n_data)],
                        axis=2)                    # [n_groups, 2, D, G, T]
    return per_slot[:, 0], per_slot[:, 1]


def giant_rows(giant: GiantSet, ids: Sequence[int], n_data: int,
               mean: np.ndarray, logvar: np.ndarray):
    """`giant_outputs`' arrays → (mean_z [N,T], sigma_z [N,T], y_linear
    [N,T] with NaN where y_mask is 0, sample_index [N]) over the real
    graphs of `ids`, in order: `collect_predictions`' contract."""
    ids = [int(g) for g in ids]
    means, sigmas, ys, idxs = [], [], [], []
    for k, group in enumerate(giant.groups(ids, n_data)):
        for d, g in enumerate(ids[k * n_data:(k + 1) * n_data]):
            bb = group[d]
            mask = np.asarray(bb.graph_mask) > 0
            means.append(mean[k, d][mask])
            sigmas.append(np.sqrt(np.exp(logvar[k, d]))[mask])
            yv = np.where(np.asarray(bb.y_mask) > 0, np.asarray(bb.y),
                          np.nan)
            ys.append(yv[mask])
            idxs.append(np.full(int(mask.sum()), g, dtype=np.int32))
    if not means:
        t = int(np.asarray(next(iter(giant.bbs.values())).y).shape[-1])
        return (np.zeros((0, t)), np.zeros((0, t)), np.zeros((0, t)),
                np.zeros(0, np.int32))
    return (np.concatenate(means), np.concatenate(sigmas),
            np.concatenate(ys), np.concatenate(idxs))


def _collect_rank(rank: Rank, state: dict, cfg, giant: GiantSet,
                  ids: List[int], floor: float, compute_dtype: str):
    from ..train.loop import cast_model

    model = Alignn(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    model = cast_model(model.to(rank.device), compute_dtype)
    return giant_outputs(rank, model, giant, ids, floor, compute_dtype)


class GiantCollector:
    """`collect(model, ids)` → one member's giant rows over a (1 ×
    n_shards) mesh (`giant_rows`' contract), the member in f32 or already
    cast, its config reconciled by the caller. The mesh's world starts at the first call
    and lives in `pool` (the caller closes it)."""

    def __init__(self, gset: GiantSet, floor: float, compute_dtype: str,
                 device, pool: WorldPool):
        self.gset, self.floor, self.dtype = gset, floor, compute_dtype
        self.pool = pool
        self.mesh = make_mesh(1, gset.n_shards,
                              devices=slot_devices(gset.n_shards, device))

    def __call__(self, model: Alignn, ids: Sequence[int]):
        ids = [int(g) for g in ids]
        # a member already cast to bf16 travels as f32 (exact) and is cast
        # again on the ranks
        state = {k: v.detach().float().cpu().numpy()
                 for k, v in model.state_dict().items()}
        mean, logvar = self.pool.get(self.mesh).run(
            _collect_rank, state, model.cfg, self.gset, ids, self.floor,
            self.dtype)
        return giant_rows(self.gset, ids, 1, mean, logvar)


def make_giant_collector(gset: GiantSet, floor: float,
                         compute_dtype: str = "float32", device="cuda",
                         pool: Optional[WorldPool] = None
                         ) -> GiantCollector:
    """The validated boundary mesh and per-member giant collection,
    raising the JAX package's `ValueError` where fewer cards are visible
    than edge shards."""
    cards = visible_cards(device)
    if cards is not None and gset.n_shards > cards:
        raise ValueError(f"giant boundary routing needs {gset.n_shards} "
                         f"edge-shard devices, have {cards} visible")
    return GiantCollector(gset, floor, compute_dtype, device,
                          pool if pool is not None else WorldPool())


class MemberRows:
    """`rows(model, batches, giant_ids)` → one member's (mean_z, sigma_z,
    y, sample_index) over real graphs: `batches` fanned out over the
    visible cards (`train_step.AlignedForward`), then `giant_ids` through
    the boundary forward of `gset` (`GiantCollector`), in that order for
    every member. The giants' world lives in `pool`, or in a pool of its
    own that `close` ends; `close` also frees the captured forwards."""

    def __init__(self, floor: float, compute_dtype: str = "float32",
                 device="cuda", gset: Optional[GiantSet] = None,
                 pool: Optional[WorldPool] = None):
        self.fan = AlignedForward(make_forward(floor, compute_dtype))
        self.pool = None
        self.giants = None
        if gset is not None:
            self.pool = WorldPool() if pool is None else None
            self.giants = make_giant_collector(gset, floor, compute_dtype,
                                               device, pool or self.pool)

    def __call__(self, model: Alignn, batches: Sequence,
                 giant_ids: Sequence[int] = ()):
        rows = []
        if batches:
            rows.append(self.fan(model, list(batches)))
        if len(giant_ids):
            rows.append(self.giants(model, giant_ids))
        return tuple(np.concatenate([r[i] for r in rows]) for i in range(4))

    def close(self) -> None:
        self.fan.close()
        if self.pool is not None:
            self.pool.close()

    def __enter__(self) -> "MemberRows":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
