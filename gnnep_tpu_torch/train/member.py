"""Ensemble-member training: epoch loop, best-state selection with the
reference's tie-break cascade, early stopping, optional KNN density
weighting (the counterpart of `gnnep_tpu.train.member`), on one device or
over a (data × edge) mesh of rank processes, with giant graphs through the
boundary-exchange partition.

Selection semantics track the reference trainer
(`scripts/train.py:1712-1804`): candidates are epochs whose val MAE is
within `delta_mae` of the global best; ties break by coverage-gap → ECE
→ Spearman → earlier epoch; patience counts epochs without a *significant*
(> delta_mae_reset) MAE improvement after a 5-epoch grace period.

Each epoch's batches are packed on a background thread while the device
trains the previous epoch; the shuffle permutation is drawn on the calling
thread, so the draw order is that of a synchronous loop. Per-sample loss
weights (inverse frequency, KNN density, or both multiplied) are grafted
onto the packed batches' `weight` field, which reaches the captured step
through its static buffers (`DeviceBatch.copy_from`).

Mid-training resume (`checkpoint_every`, `resume`): every N epochs the
member's state goes to `resume_member_{seed}.npz` (`RESUME_LAYOUT`), and a
resumed member writes it back into its step's own tensors and its
generator, so it goes on as the uninterrupted run would have; as in the
JAX package, KNN weights are not saved (a resumed member recomputes them
at its first eligible epoch), and the file goes when the member finishes.

Each phase of the member is a span (`utils.profiling.span`, recorded only
while a torch profiler records): `member.setup`, then each epoch's
`member.pack_wait`, `member.steps`, `member.val`, `member.select` and
`member.epoch_end`, then `member.finish`; `--profile-dir` traces the first
epoch whole.
"""
from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.batching import BatchBudget, epoch_batches
from ..data.store import GraphStore
from ..data.transforms import LogTransformer
from ..models.alignn import Alignn, AlignnConfig, init_alignn, leaf_names
from ..parallel.boundary_shard import RankBoundaryBatch
from ..parallel.giant import giant_outputs, giant_rows
from ..parallel.mesh import (Mesh, Rank, WorldPool, broadcast_object,
                             gather_objects, make_mesh, slot_devices,
                             visible_cards)
from ..parallel.train_step import (BoundaryTrainStep,
                                   make_aligned_train_step, stack_for_mesh)
from ..utils.profiling import ThroughputMeter, maybe_trace, span
from .artifacts import (count_pytree_leaves, load_pytree, load_pytree_meta,
                        save_pytree)
from .config import TrainConfig
from .knn_weights import compute_knn_weights
from .loop import (TrainHyper, cast_model, collect_predictions, cosine_lr,
                   make_forward, make_train_step)
from .metrics import eval_metrics

_GRACE_EPOCHS = 5  # reference warmup_epochs for early stopping (train.py:1561)
# the resume archive's leaves, after the JAX package's meta keys: the
# parameters, the best parameters, Adam's mu and nu (each in the
# checkpoint's leaf order), Adam's count, then the member generator's state
# (whose size depends on the device type, hence the suffix)
RESUME_LAYOUT = "torch:params,best,mu,nu,count,generator:v1"


def _fmt(v: float) -> str:
    if not isinstance(v, (int, float)) or not math.isfinite(float(v)):
        return "n/a"
    return f"{float(v):.4f}"


class BestSelector:
    """Best-epoch bookkeeping with the reference's tie-break cascade."""

    def __init__(self, cfg: TrainConfig):
        self.mae_tie = max(cfg.delta_mae, 0.0)
        self.mae_reset = max(cfg.delta_mae_reset, 0.0)
        self.ece_tie = max(cfg.delta_ece, 0.0)
        self.cov_tie = max(cfg.delta_coverage, 0.0)
        self.coverage_target = 1.0 - cfg.conformal_alpha
        self.best_mae_global = float("inf")
        self.best_mae_reference = float("inf")
        self.best: Optional[Dict[str, float]] = None
        self.best_epoch: Optional[int] = None
        self.significant_improve = False

    def consider(self, epoch: int, m: Dict[str, float]) -> bool:
        mae = m["mae"] if math.isfinite(m["mae"]) else float("inf")
        ece = m["ece"] if math.isfinite(m["ece"]) else float("inf")
        cov = m["coverage"]
        cov_gap = (abs(cov - self.coverage_target) if math.isfinite(cov)
                   else float("inf"))
        spear = (m["spearman"] if math.isfinite(m["spearman"])
                 else float("-inf"))

        if math.isfinite(mae):
            self.best_mae_global = min(self.best_mae_global, mae)
        self.significant_improve = math.isfinite(mae) and (
            not math.isfinite(self.best_mae_reference)
            or (self.best_mae_reference - mae) > self.mae_reset)
        if math.isfinite(mae):
            if (self.significant_improve
                    or not math.isfinite(self.best_mae_reference)):
                self.best_mae_reference = mae
            else:
                self.best_mae_reference = min(self.best_mae_reference, mae)

        if not (math.isfinite(mae)
                and mae <= self.best_mae_global + self.mae_tie):
            return False
        update = False
        if self.best is None:
            update = True
        else:
            d = mae - self.best["mae"]
            if d < -self.mae_tie:
                update = True
            elif d > self.mae_tie:
                update = False
            elif cov_gap + self.cov_tie < self.best["cov_gap"]:
                update = True
            elif self.best["cov_gap"] + self.cov_tie < cov_gap:
                update = False
            elif ece + self.ece_tie < self.best["ece"]:
                update = True
            elif self.best["ece"] + self.ece_tie < ece:
                update = False
            elif spear > self.best["spearman"]:
                update = True
            elif spear < self.best["spearman"]:
                update = False
            else:
                update = epoch < (self.best_epoch or epoch)
        if update:
            self.best = {"mae": mae, "ece": ece, "cov_gap": cov_gap,
                         "spearman": spear, **m}
            self.best_epoch = epoch
        return update


def bootstrap_indices(train_indices: List[int], cfg: TrainConfig,
                      member_seed: int) -> List[int]:
    """Resample with replacement (train.py:1586-1624), seeded as the JAX
    package seeds it."""
    effective = list(train_indices)
    if cfg.bootstrap and effective:
        ratio = cfg.bootstrap_ratio if cfg.bootstrap_ratio > 0 else 1.0
        count = max(1, int(round(len(effective) * ratio)))
        rng_boot = np.random.default_rng(member_seed)
        effective = rng_boot.choice(np.asarray(effective, dtype=np.int64),
                                    size=count, replace=True).tolist()
        if cfg.verbose:
            print(f"[Bootstrap] Member {member_seed}: sampled {count} / "
                  f"{len(train_indices)} training graphs "
                  f"(ratio={count / max(len(train_indices), 1):.2f})")
    return effective


def _graft_weights(batches, weight_arr: Optional[np.ndarray]):
    if weight_arr is None:
        return batches
    out = []
    for b in batches:
        idx = np.asarray(b.sample_index)
        w = np.where(idx >= 0, weight_arr[np.maximum(idx, 0)], 0.0)
        out.append(b._replace(weight=w.astype(np.float32)))
    return out


def _knn_snapshot(model: Alignn, store: GraphStore, cfg: TrainConfig,
                  budget: BatchBudget, effective: List[int], epoch: int
                  ) -> Optional[Dict[int, float]]:
    """KNN density weights over the member's current embeddings of its
    UNIQUE train ids, or None when the coverage guard (or the audit) finds
    a train id without a weight (reference train.py:1874-1903).

    `effective` is the bootstrap resample with duplicates, and duplicated
    embeddings sit at distance 0 of each other, inflating KNN density (hence
    down-weighting) for multiply-drawn samples; the reference snapshots the
    train set once (train.py:930-1010)."""
    snap_ids = sorted({int(g) for g in effective})
    snap = epoch_batches(store, snap_ids, budget, shuffle=False)
    weights = compute_knn_weights(
        model, snap, store, k=cfg.knn_k, eps=cfg.knn_eps,
        alpha=cfg.knn_alpha, beta=cfg.knn_beta,
        clip_min=cfg.knn_weight_min if cfg.knn_weight_min > 0 else None,
        clip_max=cfg.knn_weight_max if cfg.knn_weight_max > 0 else None)
    # every effective train id must have a weight — a silent
    # default-to-1.0 would skew the loss unnoticed
    missing = sorted(set(snap_ids) - set(weights.keys()))
    if missing:
        print(f"[Weights] Coverage failure: KNN weights missing "
              f"{len(missing)} train ids; examples: {missing[:5]}")
        return None
    if cfg.knn_coverage_audit:
        total = miss = 0
        max_b = int(cfg.knn_coverage_max_batches)
        for b_idx, b in enumerate(epoch_batches(store, snap_ids, budget,
                                                shuffle=False)):
            ids = np.asarray(b.sample_index)
            real = ids[ids >= 0]
            total += int(real.size)
            miss += int(sum(1 for ti in real.tolist()
                            if int(ti) not in weights))
            if max_b > 0 and (b_idx + 1) >= max_b:
                break
        pct = ((total - miss) / total * 100.0) if total else float("nan")
        print(f"[Weights] Coverage audit: total={total}, "
              f"covered={total - miss} ({pct:.2f}%), missing={miss}")
        if miss > 0:
            print("[Weights] Coverage failure: audit detected missing train "
                  "ids; skipping activation.")
            return None
    if cfg.verbose:
        vals = list(weights.values())
        print(f"[Weights] Epoch {epoch}: KNN weights for {len(vals)} "
              f"samples | mean={np.mean(vals):.3f}, "
              f"min={np.min(vals):.3f}, max={np.max(vals):.3f}")
    return weights


def _metric_sums(ms) -> np.ndarray:
    """[loss, graphs, abs_err, sq_err, logvar, n_elements] summed over the
    steps of `ms` (StepMetrics of 0-d or [K] tensors), read back once."""
    fields = (ms.loss_sum, ms.n_graphs, ms.abs_err_sum, ms.sq_err_sum,
              ms.logvar_sum, ms.n_elements)
    with span("step.readback"):
        return torch.stack([f.sum() for f in fields]).double().cpu().numpy()


def resume_path(cfg: TrainConfig, member_seed: int) -> Path:
    return Path(cfg.save_dir) / f"resume_member_{member_seed}.npz"


def _layout(device: torch.device, n_generators: int = 1) -> str:
    """The archive's layout key: the device type, and the number of
    generator states where a mesh member saves more than one (each slot's
    stream, and the edge axis' shared one)."""
    key = f"{RESUME_LAYOUT}:{device.type}"
    return key if n_generators == 1 else f"{key}:generators{n_generators}"


def _resume_leaves(step, names: List[str], best_state,
                   generator_states: list) -> list:
    """The archive's leaves (`RESUME_LAYOUT`) of the step's current state,
    then the generator states."""
    st = step.read_state()
    best = best_state if best_state is not None else st["params"]
    return ([st["params"][n] for n in names] + [best[n] for n in names]
            + [st["mu"][n] for n in names] + [st["nu"][n] for n in names]
            + [st["count"]["count"], *generator_states])


def _check_layout(path: Path, member_seed: int, layout: str,
                  n_leaves: int) -> None:
    """Raise before any fallback where the archive was written by another
    layout (a JAX package archive has no port layout key) or holds another
    number of leaves: restarting from scratch would silently discard real
    progress."""
    meta = load_pytree_meta(path)
    got, count = meta.get("layout"), count_pytree_leaves(path)
    if got != layout or count != n_leaves:
        raise RuntimeError(
            f"[Member {member_seed}] resume checkpoint {path} holds layout "
            f"{got!r} with {count} leaves, but this run writes "
            f"{layout!r} with {n_leaves}; the states are "
            "incompatible. Delete the resume file to deliberately restart "
            "the member.")


def member_mesh(cfg: TrainConfig, device) -> Optional[Mesh]:
    """The (data × edge) mesh a member trains over, None for one slot.
    On the card each slot takes its own card (the JAX package's
    `ValueError` where fewer are visible)."""
    n_data = max(int(cfg.data_shards), 1)
    n_edge = max(int(cfg.edge_shards), 1)
    n_slots = n_data * n_edge
    if n_slots == 1:
        return None
    cards = visible_cards(device)
    if cards is not None and cards < n_slots:
        raise ValueError(
            f"--data-shards {n_data} × --edge-shards {n_edge} = "
            f"{n_slots} device slots, but only {cards} devices are "
            "visible. Reduce the shard counts or run on more cards "
            "(on the CPU, --device cpu runs any number of slots).")
    return make_mesh(n_data, n_edge, devices=slot_devices(n_slots, device))


def _check_giants(cfg: TrainConfig, giant, n_edge: int,
                  indices: List[int]) -> None:
    """The JAX package's refusals of a member with giants among `indices`:
    `--flat-opt`, and a GiantSet planned for another edge axis."""
    if giant is None or not giant.split(indices)[1]:
        return
    if cfg.flat_opt:
        raise ValueError(
            "giant_graphs='boundary' does not compose with --flat-opt: "
            "the boundary step runs the per-leaf optimizer tail and its "
            "state layout must match the packed-batch step's.")
    if n_edge != giant.n_shards:
        raise ValueError(
            f"GiantSet was planned for {giant.n_shards} edge shards but "
            f"the training mesh has edge axis {n_edge}; re-run prepare "
            "with matching --edge-shards.")


def _member_rank(rank: Rank, *args):
    """`train_member` on one slot of its mesh; rank 0 returns (best state
    as host arrays, best val metrics, optimizer steps)."""
    model, metrics, n_steps = train_member(*args, rank=rank)
    if rank.rank != 0:
        return None
    return ({k: v.numpy() for k, v in model.state_dict().items()}, metrics,
            n_steps)


def train_member_on_mesh(mesh: Mesh, pool: Optional[WorldPool],
                         store: GraphStore, cfg: TrainConfig,
                         model_cfg: AlignnConfig,
                         transformer: LogTransformer, budget: BatchBudget,
                         member_seed: int, train_indices: List[int],
                         val_indices: List[int], freq_weights=None,
                         giant=None) -> Tuple[Alignn, Dict[str, float], int]:
    """`train_member` over `mesh` (`member_mesh`): one rank process a slot
    in `pool`'s world for the mesh (a pool of its own where None), every
    optimizer step taking D·E packed sub-batches through the graph-aligned
    step (`parallel.train_step`) → rank 0's (best model on the CPU, best
    val metrics, optimizer steps)."""
    args = (store, cfg, model_cfg, transformer, budget, member_seed,
            list(train_indices), list(val_indices or []), freq_weights)
    _check_giants(cfg, giant, mesh.n_edge, args[6] + args[7])
    own = pool is None
    pool = pool or WorldPool()
    try:
        state, metrics, n_steps = pool.get(mesh).run(_member_rank, *args,
                                                     None, giant)
    finally:
        if own:
            pool.close()
    best = Alignn(model_cfg)
    best.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return best, metrics, n_steps


def train_member(
    store: GraphStore,
    cfg: TrainConfig,
    model_cfg: AlignnConfig,
    transformer: LogTransformer,
    budget: BatchBudget,
    member_seed: int,
    train_indices: List[int],
    val_indices: List[int],
    freq_weights: Optional[np.ndarray] = None,
    device=None,
    giant=None,
    rank: Optional[Rank] = None,
) -> Tuple[Alignn, Dict[str, float], int]:
    """Train one member on `device` (None: CUDA, which must then be
    available) → (best model on the CPU, best val metrics, optimizer steps
    taken).

    `freq_weights`: optional [n_graphs] per-sample inverse-frequency loss
    weights (active when --freq-gamma > 0; `train.bins.freq_sample_weights`).
    Composed multiplicatively with KNN density weights when both are on.

    `rank`: this process's slot of the member's mesh
    (`train_member_on_mesh` starts one a slot); rank 0 validates, selects,
    saves and broadcasts the stop decision and the KNN weights, so every
    rank leaves the epoch loop together. `giant` (`parallel.giant.GiantSet`):
    train and val graphs in it step through the boundary-exchange partition
    over the mesh's edge axis, D at a time, sharing the member's
    parameters and Adam state; they step after the packed batches each
    epoch, in the epoch's shuffled order."""
    with span("member.setup"):
        _check_giants(cfg, giant, rank.mesh.n_edge if rank else 1,
                      list(train_indices) + list(val_indices or []))
        distributed = rank is not None and rank.mesh.size > 1
        lead = rank is None or rank.rank == 0
        hyper = TrainHyper(weight_decay=cfg.weight_decay,
                           log_sigma_l2=cfg.log_sigma_l2,
                           feature_jitter_std=cfg.feature_jitter_std,
                           min_logvar_floor=cfg.min_logvar_floor,
                           optimizer=cfg.optimizer,
                           compute_dtype=cfg.compute_dtype)
        scan_k = max(int(cfg.scan_steps), 0)
        model = init_alignn(np.random.default_rng(member_seed), model_cfg)
        if distributed:
            step = make_aligned_train_step(rank, model, hyper,
                                           transformer.means,
                                           transformer.stds)
        else:
            step = make_train_step(model, hyper, transformer.means,
                                   transformer.stds,
                                   rank.device if rank else device)
        device = step.params[0].device
        # each slot its own dropout and jitter stream: the member's seed offset
        # by the slot index
        generator = torch.Generator(device=device)
        generator.manual_seed(member_seed + (rank.rank if rank else 0))
        generators = [generator]
        forward = make_forward(cfg.min_logvar_floor)

        # the giant-graph boundary path over the mesh's edge axis (one slot
        # without a mesh): its step shares the member's parameters and state
        g_step = g_rank = shared_gen = None
        if giant is not None:
            g_train_all = giant.split(train_indices)[1]
            val_norm, g_val = giant.split(list(val_indices or []))
        else:
            g_train_all, g_val = [], []
            val_norm = list(val_indices or [])
        if g_train_all or g_val:
            g_rank = rank or Rank(make_mesh(1, 1, devices=[str(device)]), 0)
            g_step = BoundaryTrainStep(step, g_rank, giant.plan)
            if g_rank.mesh.n_edge > 1:
                # the replicated tail's stream, one per data slot
                shared_gen = torch.Generator(device=device)
                shared_gen.manual_seed(member_seed + g_rank.mesh.size
                                       + g_rank.data)
                generators.append(shared_gen)

        if not lead:
            cfg = dataclasses.replace(cfg, verbose=False)
        effective = bootstrap_indices(train_indices, cfg, member_seed)
        base_lr = cfg.lr
        sigma_base = cfg.sigma_lr_max if cfg.sigma_lr_max > 0 else base_lr
        mean_sched = cosine_lr(cfg.epochs, cfg.warmup_epochs, base_lr,
                               cfg.lr_min)
        sigma_sched = cosine_lr(cfg.epochs, cfg.sigma_warmup_epochs,
                                sigma_base, cfg.lr_min)

        names = leaf_names(model_cfg)
        val_batches = (epoch_batches(store, val_norm, budget, shuffle=False)
                       if val_norm and lead else [])
        selector = BestSelector(cfg)
        best_state: Optional[Dict[str, torch.Tensor]] = None
        patience = max(cfg.early_stop, 0)
        stale = 0
        n_steps = 0
        start_epoch = 1
        shuffle_rng = np.random.default_rng(member_seed + 17)
        pack_workers = max(int(cfg.pack_workers), 1)
        # KNN density-weighting state (opt-in; reference train.py:1822-1916)
        weights_by_index: Optional[Dict[int, float]] = None
        weights_active_epoch: Optional[int] = None
        last_snapshot_epoch: Optional[int] = None
        t0 = time.time()

        def snapshot() -> Dict[str, torch.Tensor]:
            return {n: p.detach().to("cpu", copy=True)
                    for n, p in model.named_parameters()}

        def generator_states() -> list:
            """Every slot's generator states, in rank order."""
            mine = [g.get_state() for g in generators]
            if not distributed:
                return mine
            return [st for per_rank in gather_objects(rank, mine)
                    for st in per_rank]

        # mid-training resume (a framework extension: the reference restarts a
        # crashed member from scratch)
        rpath = resume_path(cfg, member_seed)
        n_gens = len(generators) * (rank.mesh.size if distributed else 1)
        layout = _layout(device, n_gens)
        if cfg.resume and rpath.exists():
            template = _resume_leaves(step, names, None, generator_states())
            _check_layout(rpath, member_seed, layout, len(template))
            try:
                leaves, meta = load_pytree(rpath, template)
                n = len(names)
                parts = [dict(zip(names, leaves[i * n:(i + 1) * n]))
                         for i in range(4)]
                resumed_at, resumed_stale = int(meta["epoch"]) + 1, \
                    int(meta["stale"])
                best_maes = meta["best_mae_global"], meta["best_mae_reference"]
                # written into the step's own tensors and the generators in
                # place: a capture made later reads them where they are
                step.load_state(parts[0], parts[2], parts[3],
                                int(leaves[4 * n]))
                mine = leaves[4 * n + 1:]
                if distributed:
                    k = len(generators)
                    mine = mine[rank.rank * k:(rank.rank + 1) * k]
                for g, st in zip(generators, mine):
                    g.set_state(torch.from_numpy(st))
                start_epoch, stale = resumed_at, resumed_stale
                (selector.best_mae_global,
                 selector.best_mae_reference) = best_maes
                selector.best = meta.get("best") or None
                selector.best_epoch = meta.get("best_epoch")
                if meta.get("has_best"):
                    best_state = {k: torch.from_numpy(v)
                                  for k, v in parts[1].items()}
                # keep the shuffle stream aligned
                for _ in range(start_epoch - 1):
                    shuffle_rng.permutation(max(len(effective), 1))
                if cfg.verbose:
                    print(f"[Member {member_seed}] resumed at epoch "
                          f"{start_epoch}")
            except Exception as exc:
                print(f"[Member {member_seed}] resume failed ({exc}); "
                      "starting fresh")
        meter = ThroughputMeter()
        n_slots = rank.mesh.size if distributed else 1

        pipeline = ThreadPoolExecutor(max_workers=1)

        def submit_pack():
            """(pack future, the epoch's giant ids): the permutation is
            drawn here, and the giants ride the same draw."""
            order = np.asarray(effective, dtype=np.int64)
            order = order[shuffle_rng.permutation(order.size)]
            giant_order: List[int] = []
            if giant is not None:
                order, giant_order = giant.split(order.tolist())
            return pipeline.submit(epoch_batches, store, order, budget,
                                   shuffle=False,
                                   workers=pack_workers), giant_order

        next_batches, next_giants = submit_pack()

    with pipeline:
        for epoch in range(start_epoch, cfg.epochs + 1):
            with maybe_trace(cfg.profile_dir if epoch == start_epoch and lead
                             else None):
                step.set_lr(mean_sched(epoch - 1), sigma_sched(epoch - 1))
                use_weights = (cfg.enable_density_weighting
                               and weights_by_index is not None
                               and weights_active_epoch is not None
                               and epoch >= weights_active_epoch)
                weight_arr = None
                if use_weights or freq_weights is not None:
                    weight_arr = (
                        np.asarray(freq_weights, dtype=np.float32).copy()
                        if freq_weights is not None
                        else np.ones(store.n_graphs, dtype=np.float32))
                    if use_weights:  # compose KNN density × inverse-frequency
                        for gi, w in weights_by_index.items():
                            weight_arr[gi] *= w
                with span("member.pack_wait", epoch=epoch):
                    batches = _graft_weights(next_batches.result(),
                                             weight_arr)
                with span("member.steps", epoch=epoch):
                    giant_epoch = list(next_giants)
                    if epoch < cfg.epochs:
                        next_batches, next_giants = submit_pack()
                    for b in batches:
                        meter.count_batch(b)
                    # an optimizer step's operand: one batch, or on the mesh
                    # this slot's sub-batch of the next D·E (the epoch's
                    # last group padded with inert batches)
                    units = batches if n_slots == 1 else [
                        stack_for_mesh(batches[i:i + n_slots],
                                       n_slots)[rank.rank]
                        for i in range(0, len(batches), n_slots)]
                    sums = np.zeros(6)   # loss, graphs, abs, sq, logvar, n_el
                    # full K-unit chunks read their metrics back once; the
                    # remainder step by step. No padded steps either way.
                    n_scan = ((len(units) // scan_k) * scan_k if scan_k > 1
                              else 0)
                    for i in range(0, n_scan, max(scan_k, 1)):
                        sums += _metric_sums(step.run(units[i:i + scan_k],
                                                      generator))
                    for b in units[n_scan:]:
                        sums += _metric_sums(step(b, generator))
                    n_steps += len(units)
                    # giants: one boundary step per D of them (bootstrap
                    # duplicates step again)
                    if giant_epoch and g_step is not None:
                        nd = g_rank.mesh.n_data
                        for group, tabs in zip(
                                giant.groups(giant_epoch, nd, weight_arr),
                                giant.group_tables(giant_epoch, nd)):
                            rb = RankBoundaryBatch.from_boundary(
                                group[g_rank.data], tabs[g_rank.data],
                                g_rank.edge, device)
                            sums += _metric_sums(g_step(rb, generator,
                                                        shared_gen))
                            n_steps += 1
                            for bb in group:
                                meter.edges += float(
                                    np.asarray(bb.a_mask).sum()
                                    + np.asarray(bb.l_mask).sum())
                                meter.graphs += float(
                                    np.asarray(bb.graph_mask).sum())
                train_loss = sums[0] / max(sums[1], 1.0)
                train_mae = sums[2] / max(sums[1], 1.0)
                train_rmse = math.sqrt(sums[3] / max(sums[5], 1.0))
                train_logvar = sums[4] / max(sums[5], 1.0)

                with span("member.val", epoch=epoch):
                    # the giants' val forward needs every rank; the rest is
                    # rank 0's
                    g_rows = None
                    if g_val:
                        mean, logvar = giant_outputs(g_rank, cast_model(
                            model, cfg.compute_dtype), giant, g_val,
                            cfg.min_logvar_floor, cfg.compute_dtype)
                        g_rows = giant_rows(giant, g_val, g_rank.mesh.n_data,
                                            mean, logvar)[:3]
                    parts = []
                    if lead and val_batches:
                        parts.append(collect_predictions(
                            forward, model, val_batches)[:3])
                    if lead and g_rows is not None:
                        parts.append(g_rows)
                    if parts:
                        mean_z, sigma_z, y_val = (
                            np.concatenate([p[i] for p in parts])
                            for i in range(3))
                        with span("val.metrics"):
                            vm = eval_metrics(mean_z, sigma_z, y_val,
                                              transformer)
                    else:
                        vm = {"nll": train_loss, "mae": train_mae,
                              "rmse": train_rmse, "mae_log": float("nan"),
                              "coverage": float("nan"), "ece": float("nan"),
                              "spearman": float("nan"),
                              "logvar_mean": train_logvar,
                              "sigma_max": float("nan")}

                if lead:
                    with span("member.select", epoch=epoch):
                        if selector.consider(epoch, vm):
                            best_state = snapshot()

                with span("member.epoch_end", epoch=epoch):
                    stop = False
                    if lead:
                        if cfg.verbose:
                            print(f"[Member {member_seed}] Epoch {epoch:03d} "
                                  f"| train_loss={_fmt(train_loss)} "
                                  f"train_mae={_fmt(train_mae)} "
                                  f"train_rmse={_fmt(train_rmse)} "
                                  f"train_logvar={_fmt(train_logvar)} | "
                                  f"val_loss={_fmt(vm['nll'])} "
                                  f"val_mae={_fmt(vm['mae'])} "
                                  f"val_rmse={_fmt(vm['rmse'])} "
                                  f"val_cov={_fmt(vm['coverage'])} "
                                  f"val_ece={_fmt(vm['ece'])} "
                                  f"val_spear={_fmt(vm['spearman'])}",
                                  flush=True)

                        if epoch > _GRACE_EPOCHS:
                            if selector.significant_improve:
                                stale = 0
                            else:
                                stale += 1
                                if stale >= patience:
                                    if cfg.verbose:
                                        print("Early stopping at epoch "
                                              f"{epoch:03d} (mae plateau)")
                                    stop = True
                        else:
                            stale = 0
                    if distributed:
                        stop = broadcast_object(rank, stop)
                    if stop:
                        next_batches.cancel()
                        break

                    if (cfg.checkpoint_every > 0
                            and epoch % cfg.checkpoint_every == 0):
                        states = generator_states()
                        if lead:
                            save_pytree(
                                rpath, _resume_leaves(step, names,
                                                      best_state, states),
                                meta={"epoch": epoch, "stale": stale,
                                      "best_mae_global":
                                          selector.best_mae_global,
                                      "best_mae_reference":
                                          selector.best_mae_reference,
                                      "best": selector.best,
                                      "best_epoch": selector.best_epoch,
                                      "has_best": best_state is not None,
                                      "flat_opt": bool(cfg.flat_opt),
                                      "layout": layout})

                    # KNN weight refresh after warmup (activated next
                    # epoch); the giants stay out of the snapshot (their
                    # weights stay 1.0)
                    if (cfg.enable_density_weighting
                            and epoch >= cfg.weight_warmup_epochs
                            and (weights_by_index is None
                                 or (cfg.knn_refresh > 0
                                     and (last_snapshot_epoch is None
                                          or epoch - last_snapshot_epoch
                                          >= cfg.knn_refresh)))):
                        if lead:
                            weights_by_index = _knn_snapshot(
                                model, store, cfg, budget,
                                [g for g in effective
                                 if giant is None or g not in giant], epoch)
                        if distributed:
                            weights_by_index = broadcast_object(
                                rank, weights_by_index)
                        if weights_by_index is None:
                            last_snapshot_epoch = weights_active_epoch = None
                        else:
                            last_snapshot_epoch = epoch
                            weights_active_epoch = epoch + 1

    # this member's captured programs and their pools go before the next
    # member starts
    with span("member.finish"):
        step.close()
        forward.close()
        best = Alignn(model_cfg)
        best.load_state_dict(best_state if best_state is not None
                             else snapshot())
    if lead and rpath.exists():  # member finished: resume state not needed
        try:
            rpath.unlink()
        except OSError:
            pass
    best_metrics = dict(selector.best or {})
    if cfg.verbose and selector.best is not None:
        print(f"[Member {member_seed}] Best epoch {selector.best_epoch:03d} | "
              f"val_mae={_fmt(best_metrics['mae'])} "
              f"val_cov={_fmt(best_metrics.get('coverage', float('nan')))} "
              f"val_ece={_fmt(best_metrics['ece'])} | steps={n_steps} | "
              f"throughput: {meter.summary()} | "
              f"time={time.time() - t0:.1f}s")
    return best, best_metrics, n_steps
