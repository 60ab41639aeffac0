"""Single ensemble-member training on one device: epoch loop, best-state
selection with the reference's tie-break cascade, early stopping (the
counterpart of `gnnep_tpu.train.member`).

Selection semantics track the reference trainer
(`scripts/train.py:1712-1804`): candidates are epochs whose val MAE is
within `delta_mae` of the global best; ties break by coverage-gap → ECE
→ Spearman → earlier epoch; patience counts epochs without a *significant*
(> delta_mae_reset) MAE improvement after a 5-epoch grace period.

Each epoch's batches are packed on a background thread while the device
trains the previous epoch; the shuffle permutation is drawn on the calling
thread, so the draw order is that of a synchronous loop.
"""
from __future__ import annotations

import math
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.batching import BatchBudget, epoch_batches
from ..data.store import GraphStore
from ..data.transforms import LogTransformer
from ..models.alignn import Alignn, AlignnConfig, init_alignn
from .config import TrainConfig
from .loop import (TrainHyper, collect_predictions, cosine_lr, make_forward,
                   make_train_step)
from .metrics import eval_metrics

_GRACE_EPOCHS = 5  # reference warmup_epochs for early stopping (train.py:1561)


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


def _metric_sums(ms) -> np.ndarray:
    """[loss, graphs, abs_err, sq_err, logvar, n_elements] summed over the
    steps of `ms` (StepMetrics of 0-d or [K] tensors), read back once."""
    fields = (ms.loss_sum, ms.n_graphs, ms.abs_err_sum, ms.sq_err_sum,
              ms.logvar_sum, ms.n_elements)
    return torch.stack([f.sum() for f in fields]).double().cpu().numpy()


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
) -> Tuple[Alignn, Dict[str, float], int]:
    """Train one member on `device` (None: CUDA, which must then be
    available) → (best model on the CPU, best val metrics, optimizer steps
    taken).

    `freq_weights`: optional [n_graphs] per-sample inverse-frequency loss
    weights (active when --freq-gamma > 0; `train.bins.freq_sample_weights`)."""
    hyper = TrainHyper(weight_decay=cfg.weight_decay,
                       log_sigma_l2=cfg.log_sigma_l2,
                       feature_jitter_std=cfg.feature_jitter_std,
                       min_logvar_floor=cfg.min_logvar_floor,
                       optimizer=cfg.optimizer,
                       compute_dtype=cfg.compute_dtype)
    scan_k = max(int(cfg.scan_steps), 0)
    model = init_alignn(np.random.default_rng(member_seed), model_cfg)
    step = make_train_step(model, hyper, transformer.means, transformer.stds,
                           device)
    device = step.params[0].device
    generator = torch.Generator(device=device)
    generator.manual_seed(member_seed)
    forward = make_forward(cfg.min_logvar_floor)

    effective = bootstrap_indices(train_indices, cfg, member_seed)
    base_lr = cfg.lr
    sigma_base = cfg.sigma_lr_max if cfg.sigma_lr_max > 0 else base_lr
    mean_sched = cosine_lr(cfg.epochs, cfg.warmup_epochs, base_lr, cfg.lr_min)
    sigma_sched = cosine_lr(cfg.epochs, cfg.sigma_warmup_epochs, sigma_base,
                            cfg.lr_min)

    val_idx = list(val_indices or [])
    val_batches = (epoch_batches(store, val_idx, budget, shuffle=False)
                   if val_idx else [])
    selector = BestSelector(cfg)
    best_state: Optional[Dict[str, torch.Tensor]] = None
    patience = max(cfg.early_stop, 0)
    stale = 0
    n_steps = 0
    shuffle_rng = np.random.default_rng(member_seed + 17)
    pack_workers = max(int(cfg.pack_workers), 1)
    t0 = time.time()

    def snapshot() -> Dict[str, torch.Tensor]:
        return {n: p.detach().to("cpu", copy=True)
                for n, p in model.named_parameters()}

    with ThreadPoolExecutor(max_workers=1) as pipeline:
        def submit_pack():
            order = np.asarray(effective, dtype=np.int64)
            order = order[shuffle_rng.permutation(order.size)]
            return pipeline.submit(epoch_batches, store, order, budget,
                                   shuffle=False, workers=pack_workers)

        next_batches = submit_pack()
        for epoch in range(1, cfg.epochs + 1):
            step.set_lr(mean_sched(epoch - 1), sigma_sched(epoch - 1))
            weight_arr = (np.asarray(freq_weights, dtype=np.float32)
                          if freq_weights is not None else None)
            batches = _graft_weights(next_batches.result(), weight_arr)
            if epoch < cfg.epochs:
                next_batches = submit_pack()
            sums = np.zeros(6)   # loss, graphs, abs, sq, logvar, n_el
            # full K-batch chunks read their metrics back once; the
            # remainder step by step. No padded steps either way.
            n_scan = (len(batches) // scan_k) * scan_k if scan_k > 1 else 0
            for i in range(0, n_scan, scan_k):
                sums += _metric_sums(step.run(batches[i:i + scan_k],
                                              generator))
            for b in batches[n_scan:]:
                sums += _metric_sums(step(b, generator))
            n_steps += len(batches)
            train_loss = sums[0] / max(sums[1], 1.0)
            train_mae = sums[2] / max(sums[1], 1.0)
            train_rmse = math.sqrt(sums[3] / max(sums[5], 1.0))
            train_logvar = sums[4] / max(sums[5], 1.0)

            if val_batches:
                mean_z, sigma_z, y_val, _ = collect_predictions(
                    forward, model, val_batches)
                vm = eval_metrics(mean_z, sigma_z, y_val, transformer)
            else:
                vm = {"nll": train_loss, "mae": train_mae,
                      "rmse": train_rmse, "mae_log": float("nan"),
                      "coverage": float("nan"), "ece": float("nan"),
                      "spearman": float("nan"),
                      "logvar_mean": train_logvar, "sigma_max": float("nan")}

            if selector.consider(epoch, vm):
                best_state = snapshot()

            if cfg.verbose:
                print(f"[Member {member_seed}] Epoch {epoch:03d} | "
                      f"train_loss={_fmt(train_loss)} "
                      f"train_mae={_fmt(train_mae)} "
                      f"train_rmse={_fmt(train_rmse)} "
                      f"train_logvar={_fmt(train_logvar)} | "
                      f"val_loss={_fmt(vm['nll'])} val_mae={_fmt(vm['mae'])} "
                      f"val_rmse={_fmt(vm['rmse'])} "
                      f"val_cov={_fmt(vm['coverage'])} "
                      f"val_ece={_fmt(vm['ece'])} "
                      f"val_spear={_fmt(vm['spearman'])}", flush=True)

            if epoch > _GRACE_EPOCHS:
                if selector.significant_improve:
                    stale = 0
                else:
                    stale += 1
                    if stale >= patience:
                        if cfg.verbose:
                            print(f"Early stopping at epoch {epoch:03d} "
                                  "(mae plateau)")
                        next_batches.cancel()
                        break
            else:
                stale = 0

    # this member's captured programs and their pools go before the next
    # member starts
    step.close()
    forward.close()

    best = Alignn(model_cfg)
    best.load_state_dict(best_state if best_state is not None
                         else snapshot())
    best_metrics = dict(selector.best or {})
    if cfg.verbose and selector.best is not None:
        print(f"[Member {member_seed}] Best epoch {selector.best_epoch:03d} | "
              f"val_mae={_fmt(best_metrics['mae'])} "
              f"val_cov={_fmt(best_metrics.get('coverage', float('nan')))} "
              f"val_ece={_fmt(best_metrics['ece'])} | steps={n_steps} | "
              f"time={time.time() - t0:.1f}s")
    return best, best_metrics, n_steps
