"""Member-parallel ensemble training, `vmap` (one device) or `shard` (one
member per slot): the counterpart of `gnnep_tpu.parallel.ensemble_vmap`.

- ``vmap``: the M members step in lock-step on one device, each on its
  own bootstrap stream, through `StackedTrainStep`: on the card the M
  members' loss, backward and Adam tail are one captured CUDA graph
  (every member's convs on the rung's kernels, each member's generator
  registered), replayed once a step; on the CPU the same steps run
  eagerly. The JAX package vmaps the stacked step and so drops to its
  dense-table path with a warning; the port keeps the kernels.
  `torch.func.vmap` cannot batch through the kernels' autograd Functions
  without a vmap rule for each, which would loop over the members anyway.
- ``shard``: member i trains alone on slot i of an M-slot mesh (its own
  card, or gloo processes on the CPU), with no communication, as the
  sequential trainer trains it (`train.member.train_member`), and its
  rank writes `model_{i}.npz`.

In ``vmap`` early stopping runs per member on the host: a member whose
patience ran out keeps stepping (lock-step) with its selected parameters
frozen, so selection matches sequential training's; the wall-clock cost
is the slowest member's. Each member has its own [M] dropout rate and
[M, 2] (mean, sigma) LR row.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.batching import epoch_batches
from ..models.alignn import Alignn, DeviceBatch, init_alignn
from ..ops.cuda.graphs import CountedGraph
from ..train.config import TrainConfig
from ..train.loop import (WARMUP_STEPS, TrainHyper, TrainStep, _on_device,
                          _on_side, _release_pools, collect_predictions,
                          cosine_lr, make_forward)
from ..train.metrics import eval_metrics
from ..utils.device import resolve_device
from .mesh import Rank, WorldPool, make_mesh, slot_devices, visible_cards


class StackedTrainStep:
    """The M members' optimizer steps as one program: `step(batches,
    generators)` with one batch and one generator per member → [M, 7]
    `StepMetrics` rows. Each member keeps its own parameters, Adam state
    and LR pair (rows of the [M, 2] `lrs`). On the card the first
    `WARMUP_STEPS` steps run eagerly; the next captures all M members'
    steps in one graph, and every later step replays it."""

    def __init__(self, models: Sequence[Alignn], hyper: TrainHyper,
                 log_means: np.ndarray, log_stds: np.ndarray, device):
        self.device = torch.device(device)
        self.members = [TrainStep(m.to(self.device), hyper, log_means,
                                  log_stds) for m in models]
        self.lrs = torch.zeros((len(models), 2), dtype=torch.float32,
                               device=self.device)
        for i, st in enumerate(self.members):
            st.lr_mean, st.lr_sigma = self.lrs[i, 0], self.lrs[i, 1]
        self.static: Optional[List[DeviceBatch]] = None
        self.graph: Optional[CountedGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.generators: Optional[list] = None
        self.eager_steps = 0

    def set_lrs(self, lr_vec: np.ndarray) -> None:
        """[M, 2] (mean, sigma) LRs, written outside any captured program."""
        self.lrs.copy_(torch.as_tensor(np.asarray(lr_vec, np.float32)))

    def _steps(self, batches, generators) -> torch.Tensor:
        return torch.stack([st._step(b, g) for st, b, g
                            in zip(self.members, batches, generators)])

    def __call__(self, batches: Sequence, generators: Sequence
                 ) -> torch.Tensor:
        if self.device.type != "cuda":
            return self._steps([_on_device(b, self.device) for b in batches],
                               generators)
        if self.static is None:
            self.static = [DeviceBatch.allocate(b, self.device)
                           for b in batches]
            self.generators = list(generators)
            self._side = torch.cuda.Stream(self.device)
        elif list(generators) != self.generators:
            raise ValueError("a captured stacked step draws from the "
                             "generators it started with")
        for buf, b in zip(self.static, batches):
            buf.copy_from(b)
        if self.graph is None and self.eager_steps < WARMUP_STEPS:
            self.eager_steps += 1
            return _on_side(self._side, lambda: self._steps(self.static,
                                                            generators))
        if self.graph is None:
            self.graph = CountedGraph("train")
            self.out = self.graph.capture(
                lambda: self._steps(self.static, generators),
                self.generators)
        self.graph.replay()
        return self.out

    def close(self) -> None:
        captured = self.graph is not None
        if captured:
            self.graph.reset()
        self.graph = self.out = self.static = None
        for st in self.members:
            for p in st.params:
                p.grad = None
        if captured:
            _release_pools()


def _check_modes(setup, cfg: TrainConfig, mode: str) -> None:
    if cfg.member_hiddens is not None and len(set(cfg.member_hiddens)) > 1:
        raise ValueError(f"{mode} member-parallel training requires "
                         "homogeneous hidden sizes; use "
                         "member_parallel='sequential'.")
    if cfg.enable_density_weighting:
        raise ValueError(f"KNN density weighting is not supported in {mode} "
                         "mode; use member_parallel='sequential'.")
    if getattr(setup, "giant", None) is not None:
        raise ValueError(f"giant graphs train through the boundary step of "
                         f"sequential members, not in {mode} mode; use "
                         "member_parallel='sequential'.")


def _shard_rank(rank: Rank, setup, cfg: TrainConfig, freq_weights):
    """Member `rank.rank`, trained alone on this slot; writes its
    checkpoint → (its optimizer steps, launch counts)."""
    from ..ops.cuda.graphs import launch_counts
    from ..train.artifacts import save_member
    from ..train.ensemble import member_plan
    from ..train.member import train_member

    i = rank.rank
    seed_i, _, train_i, holdout, mc, member_cfg = member_plan(cfg, setup, i)
    model, _, n_steps = train_member(
        setup.store, member_cfg, mc, setup.transformer, setup.budget, seed_i,
        train_i, holdout, freq_weights=freq_weights, device=rank.device)
    save_member(Path(cfg.save_dir) / f"model_{i}.npz", model)
    return n_steps, launch_counts()


def _train_sharded(setup, cfg: TrainConfig, freq_weights, device, pool
                   ) -> Tuple[List[Alignn], List[int]]:
    m = cfg.ensemble_size
    cards = visible_cards(device)
    if cards is not None and m > cards:
        raise ValueError(
            f"member_parallel='shard' places one member per device: "
            f"{m} members > {cards} devices. Use 'vmap' or 'sequential'.")
    mesh = make_mesh(m, 1, devices=slot_devices(m, device))
    own = pool is None
    pool = pool or WorldPool()
    try:
        out = pool.get(mesh).run(_shard_rank, setup, cfg, freq_weights,
                                 every_rank=True)
    finally:
        if own:
            pool.close()
    from ..train.artifacts import load_member

    return ([load_member(Path(cfg.save_dir) / f"model_{i}.npz", "cpu")
             for i in range(m)], [n for n, _ in out])


def train_members_vmapped(setup, cfg: TrainConfig, mode: str = "vmap",
                          freq_weights=None, device=None,
                          pool: Optional[WorldPool] = None
                          ) -> Tuple[List[Alignn], List[int]]:
    """The M members in `mode` → (each member's selected model on the CPU,
    each one's optimizer steps). `vmap` steps them in lock-step on
    `device`; `shard` trains member i on slot i (one card each on the
    card, the JAX package's `ValueError` where fewer are visible), its
    world from `pool`, each rank writing `model_{i}.npz` to
    `cfg.save_dir`."""
    if mode not in ("vmap", "shard"):
        raise ValueError(f"member-parallel mode must be 'vmap' or 'shard', "
                         f"not {mode!r}")
    _check_modes(setup, cfg, mode)
    if mode == "shard":
        return _train_sharded(setup, cfg, freq_weights,
                              resolve_device(device), pool)
    from ..train.bins import freq_weights_for_store
    from ..train.ensemble import model_config
    from ..train.member import BestSelector

    dev = resolve_device(device)
    s = setup.store
    m = cfg.ensemble_size
    if freq_weights is None and cfg.freq_gamma > 0.0:
        freq_weights = freq_weights_for_store(s.y, setup.bin_edges,
                                              setup.bin_weights)
    num_folds = len(setup.folds)
    full_train = set(setup.train_idx)
    hidden = cfg.member_hiddens[0] if cfg.member_hiddens else cfg.hidden
    dropouts = [float(cfg.member_override(cfg.member_dropouts, i,
                                          cfg.dropout)) for i in range(m)]
    lrs = [float(cfg.member_override(cfg.member_lrs, i, cfg.lr))
           for i in range(m)]
    mcs = [model_config(cfg, s, hidden=hidden, dropout=dropouts[i],
                        budget=setup.budget) for i in range(m)]
    hyper = TrainHyper(weight_decay=cfg.weight_decay,
                       log_sigma_l2=cfg.log_sigma_l2,
                       feature_jitter_std=cfg.feature_jitter_std,
                       min_logvar_floor=cfg.min_logvar_floor,
                       optimizer=cfg.optimizer,
                       compute_dtype=cfg.compute_dtype)
    seeds = [cfg.seed + i * 1007 for i in range(m)]
    models = [init_alignn(np.random.default_rng(sd), mc)
              for sd, mc in zip(seeds, mcs)]
    step = StackedTrainStep(models, hyper, setup.transformer.means,
                            setup.transformer.stds, dev)

    # per-member data streams (fold assignment + bootstrap)
    member_train_idx: List[List[int]] = []
    for i in range(m):
        train_i = sorted(full_train - set(setup.folds[i % num_folds])) \
            if num_folds > 1 else list(setup.train_idx)
        if cfg.bootstrap and train_i:
            ratio = cfg.bootstrap_ratio if cfg.bootstrap_ratio > 0 else 1.0
            count = max(1, int(round(len(train_i) * ratio)))
            rng_boot = np.random.default_rng(seeds[i])
            train_i = rng_boot.choice(np.asarray(train_i, dtype=np.int64),
                                      size=count, replace=True).tolist()
        member_train_idx.append(train_i)

    mean_sched = cosine_lr(cfg.epochs, cfg.warmup_epochs, 1.0,
                           cfg.lr_min / cfg.lr)
    sigma_base = cfg.sigma_lr_max if cfg.sigma_lr_max > 0 else cfg.lr
    sigma_sched = cosine_lr(cfg.epochs, cfg.sigma_warmup_epochs, 1.0,
                            cfg.lr_min / sigma_base)

    forward = make_forward(cfg.min_logvar_floor)
    selectors = [BestSelector(cfg) for _ in range(m)]
    best: List[Optional[dict]] = [None] * m
    stale = [0] * m
    stopped = [False] * m
    patience = max(cfg.early_stop, 0)
    shuffle_rngs = [np.random.default_rng(sd + 17) for sd in seeds]
    generators = []
    for sd in seeds:
        g = torch.Generator(device=dev)
        g.manual_seed(sd)
        generators.append(g)
    val_batches = [epoch_batches(s, setup.folds[i % num_folds],
                                 setup.budget, shuffle=False)
                   for i in range(m)]
    steps = [0] * m

    def snapshot(i):
        return {n: p.detach().to("cpu", copy=True)
                for n, p in step.members[i].model.named_parameters()}

    for epoch in range(1, cfg.epochs + 1):
        step.set_lrs(np.asarray([
            [lrs[i] * mean_sched(epoch - 1),
             sigma_base * sigma_sched(epoch - 1)] for i in range(m)]))
        streams = [epoch_batches(s, member_train_idx[i], setup.budget,
                                 shuffle=True, rng=shuffle_rngs[i],
                                 weights=freq_weights,
                                 workers=max(int(cfg.pack_workers), 1))
                   for i in range(m)]
        n_steps = min(len(st) for st in streams)
        sums = torch.zeros((m, 2), dtype=torch.float64, device=dev)
        for t in range(n_steps):
            rows = step([streams[i][t] for i in range(m)], generators)
            sums += rows[:, :2].double()
        steps = [k + n_steps for k in steps]
        sums = sums.cpu().numpy()

        all_stopped = True
        for i in range(m):
            if stopped[i]:
                continue
            mean_z, sigma_z, y_val, _ = collect_predictions(
                forward, step.members[i].model, val_batches[i])
            vm = eval_metrics(mean_z, sigma_z, y_val, setup.transformer)
            if selectors[i].consider(epoch, vm):
                best[i] = snapshot(i)
            if epoch > 5:
                if selectors[i].significant_improve:
                    stale[i] = 0
                else:
                    stale[i] += 1
                    if stale[i] >= patience:
                        stopped[i] = True
            if not stopped[i]:
                all_stopped = False
            if cfg.verbose:
                print(f"[vmap member {i}] epoch {epoch:03d} "
                      f"train_loss={sums[i, 0] / max(sums[i, 1], 1):.4f} "
                      f"val_mae={vm['mae']:.4f} val_ece={vm['ece']:.4f}"
                      + (" [stopped]" if stopped[i] else ""), flush=True)
        if all_stopped:
            break
    step.close()
    forward.close()
    out = []
    for i, mc in enumerate(mcs):
        model = Alignn(mc)
        model.load_state_dict(best[i] if best[i] is not None
                              else snapshot(i))
        out.append(model)
    return out, steps
