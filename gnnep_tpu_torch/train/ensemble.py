"""Deep-ensemble training: setup → members → calibration → artifacts
(the counterpart of `gnnep_tpu.train.ensemble`, members trained one after
another on one device).

Orchestration parity with the reference trainer's `main`
(`scripts/train.py:1948-2163`): grouped splits + K-fold member validation,
per-member seeds `seed + i*1007`, bootstrap resampling, per-member
hidden/dropout/LR overrides, mixture aggregation on the calibration split,
affine debias, scaled conformal quantiles, and the artifacts `model_{i}.npz`,
`scaler_state.npz`, `conformal.json` and `train_summary.json`, in the JAX
package's formats.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.batching import BatchBudget, epoch_batches
from ..data.splits import derive_splits
from ..data.store import GraphStore
from ..data.transforms import FeatureScaler, LogTransformer
from ..models.alignn import Alignn, AlignnConfig, DeviceBatch, alignn_embed
from ..utils.device import resolve_device
from .artifacts import save_conformal, save_member, save_scaler_state
from .bins import compute_bin_statistics
from .calibrate import (apply_conformal_intervals, conformal_calibration,
                        ensemble_mixture, fit_affine_debias)
from .config import TrainConfig
from .loop import collect_predictions, make_forward
from .member import train_member
from .metrics import error_stats

N_SG_ONE_HOT = 230


def check_supported(cfg: TrainConfig) -> None:
    """Raise NotImplementedError for every option that selects a path the
    port does not run yet, on any device; none of them runs something else
    in its place. The rung flags (`--no-attn-fused`, `--no-attn-eproj`) run
    their own kernels."""
    unported = []
    if cfg.member_parallel in ("vmap", "shard"):
        unported.append(f"--member-parallel {cfg.member_parallel}")
    if max(int(cfg.data_shards), 1) * max(int(cfg.edge_shards), 1) > 1:
        unported.append(f"--data-shards {cfg.data_shards} / --edge-shards "
                        f"{cfg.edge_shards}")
    if cfg.giant_graphs == "boundary":
        unported.append("--giant-graphs boundary")
    if cfg.member_isolation == "process":
        unported.append("--member-isolation process")
    if cfg.resume or cfg.checkpoint_every > 0:
        unported.append("--resume / --checkpoint-every")
    if cfg.profile_dir:
        unported.append("--profile-dir")
    if unported:
        raise NotImplementedError(
            "not ported to gnnep_tpu_torch yet (see ROADMAP.md): "
            + "; ".join(unported))


@dataclasses.dataclass
class TrainingSetup:
    """Everything derived from the dataset before member training starts."""

    store: GraphStore            # standardized
    scaler: FeatureScaler
    transformer: LogTransformer
    budget: BatchBudget
    train_idx: List[int]
    val_idx: List[int]
    calib_idx: List[int]
    test_idx: List[int]
    folds: List[List[int]]
    bin_edges: np.ndarray
    bin_weights: np.ndarray


def prepare(cfg: TrainConfig, store: Optional[GraphStore] = None
            ) -> TrainingSetup:
    """Load/standardize the dataset and derive splits (train.py:1300-1447)."""
    if store is None:
        store = GraphStore.load_dir(cfg.data_dir)
    if not cfg.use_mat2vec and store.node_dim > 6:
        store = dataclasses.replace(store,
                                    node_feats=store.node_feats[:, :6].copy())

    train_idx, val_idx, calib_idx, test_idx, folds = derive_splits(
        store.group_keys(), cfg.seed, cfg.val_frac, cfg.calib_frac,
        cfg.test_frac, cfg.ensemble_size)
    if not train_idx:
        raise ValueError("Training split is empty; adjust fractions or seed.")

    scaler = FeatureScaler.fit(store, train_idx)
    std_store = scaler.apply(store)
    train_targets = store.y[np.asarray(train_idx, dtype=np.int64)]
    transformer = LogTransformer.fit(train_targets)
    bin_edges, bin_weights, _, _ = compute_bin_statistics(
        train_targets, cfg.freq_bins, cfg.freq_gamma, eps=cfg.relative_eps)
    budget = BatchBudget.plan(std_store, range(std_store.n_graphs),
                              cfg.batch_size, slack=cfg.batch_slack,
                              quantile=cfg.batch_quantile, cover_all=True)
    return TrainingSetup(std_store, scaler, transformer, budget, train_idx,
                         val_idx, calib_idx, test_idx, folds, bin_edges,
                         bin_weights)


def model_config(cfg: TrainConfig, store: GraphStore, *,
                 hidden: Optional[int] = None,
                 dropout: Optional[float] = None,
                 budget: Optional[BatchBudget] = None) -> AlignnConfig:
    h = int(hidden if hidden is not None else cfg.hidden)
    if h % cfg.heads != 0:
        raise ValueError(f"Hidden dimension {h} must be divisible by heads "
                         f"({cfg.heads})")
    return AlignnConfig(
        node_dim=store.node_dim, edge_dim=store.edge_dim,
        angle_dim=store.angle_dim,
        global_dim=store.global_scalar_dim + N_SG_ONE_HOT,
        target_dim=store.target_dim, hidden=h, layers=cfg.layers,
        heads=cfg.heads,
        dropout=float(dropout if dropout is not None else cfg.dropout),
        conv_impl=cfg.conv_impl, scan_layers=cfg.scan_layers,
        attn_fused=cfg.attn_fused, attn_eproj=cfg.attn_eproj,
        # the packer's window bounds, carried in the checkpoint as the JAX
        # package carries them (the CUDA kernels read whole CSR ranges)
        edge_win64=budget.edge_win64 if budget else 0,
        lg_win64=budget.lg_win64 if budget else 0,
        edge_src_win64=budget.edge_src_win64 if budget else 0,
        lg_src_win64=budget.lg_src_win64 if budget else 0)


def collect_ensemble(members: Sequence[Alignn], batches, floor: float,
                     device: torch.device):
    """Member forwards on one device → ([M,N,T] means, [M,N,T] vars, [N,T]
    targets)."""
    forward = make_forward(floor)
    means, variances, targets = [], [], None
    for model in members:
        mean_z, sigma_z, targets, _ = collect_predictions(
            forward, model.to(device), batches)
        means.append(mean_z)
        variances.append(sigma_z ** 2)
    forward.close()
    return np.stack(means), np.stack(variances), targets


def compute_freq_weights(cfg: TrainConfig, setup: TrainingSetup):
    """Per-graph inverse-frequency loss weights (None when --freq-gamma 0)."""
    if cfg.freq_gamma <= 0.0:
        return None
    from .bins import freq_weights_for_store

    return freq_weights_for_store(setup.store.y, setup.bin_edges,
                                  setup.bin_weights)


def member_plan(cfg: TrainConfig, setup: TrainingSetup, i: int):
    """Everything member i's training needs, derived deterministically from
    (cfg, setup). Returns (seed_i, fold_idx, train_i, holdout, model_cfg,
    member_cfg)."""
    full_train = set(setup.train_idx)
    num_folds = len(setup.folds)
    seed_i = cfg.seed + i * 1007
    fold_idx = i % num_folds
    holdout = setup.folds[fold_idx]
    train_i = sorted(full_train - set(holdout)) if num_folds > 1 \
        else setup.train_idx
    ratio = min(max(cfg.train_subset_ratio, 0.0) or 1.0, 1.0)
    if 0.0 < ratio < 1.0 and train_i:
        rng_sub = np.random.default_rng(seed_i)
        keep = max(1, int(round(len(train_i) * ratio)))
        perm = rng_sub.permutation(len(train_i))[:keep]
        train_i = sorted(train_i[j] for j in np.sort(perm))
    mc = model_config(
        cfg, setup.store,
        hidden=cfg.member_override(cfg.member_hiddens, i, cfg.hidden),
        dropout=cfg.member_override(cfg.member_dropouts, i, cfg.dropout),
        budget=setup.budget)
    member_cfg = dataclasses.replace(
        cfg, lr=float(cfg.member_override(cfg.member_lrs, i, cfg.lr)))
    return seed_i, fold_idx, train_i, holdout, mc, member_cfg


def run_training(cfg: TrainConfig, store: Optional[GraphStore] = None,
                 device=None) -> Dict:
    """Full training pipeline; returns the summary dict (test stats, and the
    optimizer steps each member took). `device` None means CUDA, which must
    then be available."""
    dev = resolve_device(device)
    check_supported(cfg)
    t_start = time.time()
    setup = prepare(cfg, store)
    s = setup.store
    save_dir = Path(cfg.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)

    if cfg.verbose:
        print(f"Dataset: {s.n_graphs} graphs | node_dim={s.node_dim} "
              f"edge_dim={s.edge_dim} angle_dim={s.angle_dim}")
        print(f"Splits: train={len(setup.train_idx)} val={len(setup.val_idx)} "
              f"calib={len(setup.calib_idx)} test={len(setup.test_idx)}")
        print(f"Batch budget: {setup.budget}")
        print(f"Device: {dev}")

    num_folds = len(setup.folds)
    members: List[Alignn] = []
    steps: List[int] = []
    freq_weights = compute_freq_weights(cfg, setup)
    if freq_weights is not None and cfg.verbose:
        tw = freq_weights[np.asarray(setup.train_idx, dtype=np.int64)]
        print(f"[Weights] freq-gamma={cfg.freq_gamma}: bin weights over "
              f"{len(setup.train_idx)} train samples | "
              f"mean={tw.mean():.3f} min={tw.min():.3f} max={tw.max():.3f}")
    for i in range(cfg.ensemble_size):
        (seed_i, fold_idx, train_i, holdout, mc,
         member_cfg) = member_plan(cfg, setup, i)
        if cfg.verbose:
            print(f"Training ensemble member {i + 1}/{cfg.ensemble_size} "
                  f"(fold {fold_idx + 1}/{num_folds}) with seed {seed_i} | "
                  f"train={len(train_i)} fold_val={len(holdout)}")
        model, _, n_steps = train_member(
            s, member_cfg, mc, setup.transformer, setup.budget, seed_i,
            train_i, holdout, freq_weights=freq_weights, device=dev)
        save_member(save_dir / f"model_{i}.npz", model)
        members.append(model)
        steps.append(n_steps)

    dims = {"node_dim": s.node_dim, "edge_dim": s.edge_dim,
            "angle_dim": s.angle_dim, "global_scalar_dim": s.global_scalar_dim,
            "sg_dim": N_SG_ONE_HOT, "target_dim": s.target_dim,
            "heads": cfg.heads, "seed": cfg.seed, "val_frac": cfg.val_frac,
            "calib_frac": cfg.calib_frac, "test_frac": cfg.test_frac,
            "ensemble_size": cfg.ensemble_size}
    save_scaler_state(save_dir / "scaler_state.npz", setup.scaler,
                      setup.transformer, dims)

    # --- conformal calibration on the dedicated calib split ----------------
    if not setup.calib_idx:
        raise ValueError("Calibration split is empty; set calib_frac > 0 and "
                         "rerun.")
    calib_batches = epoch_batches(s, setup.calib_idx, setup.budget,
                                  shuffle=False)
    m_means, m_vars, calib_y = collect_ensemble(
        members, calib_batches, cfg.min_logvar_floor, dev)
    mean_z, var_z = ensemble_mixture(m_means, m_vars)
    std_z = np.sqrt(var_z)
    target_z = setup.transformer.transform(calib_y)
    a, b = fit_affine_debias(mean_z, target_z)
    mean_z_cal = mean_z * a + b
    conf = conformal_calibration(
        mean_z_cal, std_z if cfg.conformal_method == "scaled" else None,
        calib_y, setup.transformer, cfg.conformal_alpha, cfg.conformal_method)
    save_conformal(save_dir / "conformal.json", conf, a, b)

    if cfg.save_embeddings:
        _save_embeddings(save_dir, members, s, setup, dev)

    # --- final test report -------------------------------------------------
    summary: Dict = {"members": len(members),
                     "optimizer_steps": int(sum(steps)),
                     "member_optimizer_steps": steps,
                     "device": str(dev),
                     "train_time_s": time.time() - t_start}
    if setup.test_idx:
        test_batches = epoch_batches(s, setup.test_idx, setup.budget,
                                     shuffle=False)
        tm, tv, test_y = collect_ensemble(members, test_batches,
                                          cfg.min_logvar_floor, dev)
        mean_zt, var_zt = ensemble_mixture(tm, tv)
        mean_zt = mean_zt * a + b
        std_zt = np.sqrt(var_zt)
        mean_orig, lower, upper = apply_conformal_intervals(
            mean_zt, std_zt if cfg.conformal_method == "scaled" else None,
            conf, setup.transformer)
        stats = error_stats(mean_orig, test_y)
        covered = ((test_y >= lower) & (test_y <= upper)).astype(float)
        summary["test_stats"] = stats
        summary["conformal_coverage"] = {
            "per_target": covered.mean(axis=0).tolist(),
            "overall": float(covered.mean()),
            "target": 1.0 - cfg.conformal_alpha,
        }
        if cfg.verbose:
            print("Test diagnostics (ensemble mean):")
            for label, v in stats.items():
                print(f"  {label}: rmse={v['rmse']:.4f}, mae={v['mae']:.4f}, "
                      f"std={v['std']:.4f}, mean_err={v['mean_error']:.4f}")
            print("Conformal PI coverage:")
            for t, c in enumerate(covered.mean(axis=0)):
                print(f"  target_{t}: {c:.4f}")
            print(f"  overall: {covered.mean():.4f} "
                  f"(target={1.0 - cfg.conformal_alpha:.4f})")
    elif cfg.verbose:
        print("No test split; skipping final evaluation.")

    (save_dir / "train_summary.json").write_text(
        json.dumps(summary, indent=2, default=float))
    return summary


def _save_embeddings(save_dir: Path, members: Sequence[Alignn],
                     store: GraphStore, setup: TrainingSetup,
                     device: torch.device) -> None:
    """Ensemble-mean penultimate embeddings per split (reference
    train.py:2125-2131): `embeddings_{split}.npz` with `z` [n_split, H]."""
    splits = {"train": setup.train_idx, "val": setup.val_idx,
              "calib": setup.calib_idx, "test": setup.test_idx}
    for name, idx in splits.items():
        if not idx:
            continue
        accum = []
        for batch in epoch_batches(store, idx, setup.budget, shuffle=False):
            db = DeviceBatch.from_batch(batch, device)
            z_mean = torch.stack([alignn_embed(m.to(device), db)
                                  for m in members]).mean(dim=0)
            mask = np.asarray(batch.graph_mask) > 0
            accum.append(z_mean.cpu().numpy()[mask])
        np.savez(save_dir / f"embeddings_{name}.npz", z=np.concatenate(accum))
