"""Evaluation runner: reconstruct splits, collect member predictions, compute
the full metric suite + plots, write metrics.json (the counterpart of
`gnnep_tpu.evaluate.runner`, with the same `metrics.json`).

Orchestration parity with reference `evaluate.py:502-1047`: checkpoints are
the architecture contract, splits re-derive deterministically from
(seed, fracs), member σ is debiased by |a| alongside the means, conformal
coverage/width use the saved q, and sharpness curves recompute conformity
scores on the calibration split.

Members run on one device through the eval forward (`train.loop.Forward`),
as `infer.predict` serves them. The run uses one `Forward` for both of its
splits, which are packed to one budget, so on the card each member captures
its forward once and replays it on every later batch of either split.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from ..data.batching import BatchBudget, epoch_batches, verify_win64
from ..data.splits import derive_splits
from ..data.store import GraphStore
from ..infer.predict import Ensemble
from ..models.alignn import Alignn
from ..train.artifacts import load_conformal
from ..train.calibrate import apply_conformal_intervals
from ..train.loop import (MIN_LOGVAR_FLOOR, Forward, collect_predictions,
                          make_forward)
from ..train.metrics import TARGET_NAMES, error_stats
from . import metrics as M


@dataclasses.dataclass
class EvalConfig:
    ensemble_dir: str = "artifacts/ensemble"
    data_dir: str = "data/mp_gnn"
    output_dir: str = "artifacts/eval"
    batch_size: int = 64
    seed: int = 42
    val_frac: float = 0.1
    calib_frac: float = 0.05
    test_frac: float = 0.1
    ensemble_size: int = 5
    eval_split: str = "test"   # train | val | calib | test | fold
    fold_index: int = 0
    min_logvar_floor: float = MIN_LOGVAR_FLOOR
    coverage_grid: str = "0.5,0.6,0.7,0.8,0.9,0.95"
    make_plots: bool = True
    # 'float32' (default, reference-parity numerics) or 'bfloat16' (the
    # trunk in bf16, as `cli.predict --compute-dtype bfloat16`)
    compute_dtype: str = "float32"
    # graphs beyond the batch budget through the boundary-exchange edge
    # partition over N device ranks: not ported yet, values > 0 raise
    giant_shards: int = 0


def _collect_members(forward: Forward, runs: Sequence[Alignn], batches):
    """[M, N, T] member means and σ and [N, T] targets over `batches`."""
    means, stds, targets = [], [], None
    for run in runs:
        mean_z, sigma_z, targets, _ = collect_predictions(forward, run,
                                                          batches)
        means.append(mean_z)
        stds.append(sigma_z)
    means, stds = np.stack(means), np.stack(stds)
    # the metric suite assumes fully-targeted samples (stores load with
    # require_target=True); the collectors surface invalid targets as NaN,
    # so a partially-targeted store slipping through would silently poison
    # every aggregate metric — drop such rows loudly instead
    ok = np.isfinite(targets).all(axis=1)
    if not ok.all():
        print(f"[evaluate] dropping {int((~ok).sum())} samples with "
              "missing/partial targets from the metric suite")
        means, stds, targets = means[:, ok], stds[:, ok], targets[ok]
    return means, stds, targets


def run_evaluation(cfg: EvalConfig, store: Optional[GraphStore] = None,
                   device=None) -> Dict:
    """Evaluate the ensemble in `cfg.ensemble_dir` on `device` (None: CUDA,
    which must then be available) → the metrics dict, also written to
    `{output_dir}/{split}/metrics.json`."""
    if cfg.giant_shards > 0:
        raise NotImplementedError(
            "giant_shards > 0 (the boundary-exchange path for graphs beyond "
            "the batch budget) waits for the giant-graph slice; see "
            "ROADMAP.md")
    ensemble = Ensemble.load(cfg.ensemble_dir, device)
    transformer = ensemble.transformer
    conf = None
    conf_path = Path(cfg.ensemble_dir) / "conformal.json"
    if conf_path.exists():
        conf = load_conformal(conf_path)

    if store is None:
        store = GraphStore.load_dir(cfg.data_dir)
    node_dim = ensemble.cfgs[0].node_dim
    if store.node_dim != node_dim:  # dim reconciliation (evaluate.py:549-564)
        x = store.node_feats
        if store.node_dim > node_dim:
            x = x[:, :node_dim].copy()
        else:
            x = np.concatenate([x, np.zeros((x.shape[0], node_dim - store.node_dim),
                                            x.dtype)], axis=1)
        store = dataclasses.replace(store, node_feats=x)
    std_store = ensemble.scaler.apply(store)

    train_idx, val_idx, calib_idx, test_idx, folds = derive_splits(
        store.group_keys(), cfg.seed, cfg.val_frac, cfg.calib_frac,
        cfg.test_frac, cfg.ensemble_size)
    split_map = {"train": train_idx, "val": val_idx, "calib": calib_idx,
                 "test": test_idx}
    if cfg.eval_split == "fold":
        if not 0 <= cfg.fold_index < len(folds):
            raise ValueError(f"fold_index {cfg.fold_index} outside 0..{len(folds) - 1}")
        eval_idx = folds[cfg.fold_index]
        split_tag = f"fold{cfg.fold_index}"
    else:
        eval_idx = split_map[cfg.eval_split]
        split_tag = cfg.eval_split
    if not eval_idx:
        raise ValueError(f"Evaluation split '{split_tag}' is empty.")

    budget = BatchBudget.plan(std_store, range(std_store.n_graphs),
                              cfg.batch_size, cover_all=True)
    eval_batches = epoch_batches(std_store, eval_idx, budget, shuffle=False)
    calib_batches = (epoch_batches(std_store, calib_idx, budget,
                                   shuffle=False) if calib_idx else [])
    runs = ensemble.runs(budget, cfg.compute_dtype)
    verify_win64(eval_batches, runs[0].cfg)
    forward = make_forward(cfg.min_logvar_floor, cfg.compute_dtype)
    try:
        means_m, stds_m, targets = _collect_members(forward, runs,
                                                    eval_batches)
        calib = (_collect_members(forward, runs, calib_batches)
                 if calib_batches else None)
    finally:
        forward.close()
    t_dim = targets.shape[1]
    target_names = [TARGET_NAMES.get(t, f"target_{t}") for t in range(t_dim)]

    # affine debias: means via a·x+b, member σ scaled by |a| (evaluate.py:684-696)
    if conf is not None:
        a, b = conf["affine_a"], conf["affine_b"]
    else:
        a, b = np.ones(t_dim), np.zeros(t_dim)
    means_m = means_m * a + b
    stds_m = stds_m * np.abs(a)
    mean_z = means_m.mean(axis=0)
    var_z = (stds_m ** 2).mean(axis=0) + (means_m ** 2).mean(axis=0) - mean_z ** 2
    var_z = np.clip(var_z, 1e-12, None)
    std_z = np.sqrt(var_z)

    mean_orig = transformer.inverse(mean_z)
    targets_z = transformer.transform(targets)

    # calibration-split conformity scores for sharpness curves
    calib_scores = None
    use_scaled = bool(conf and conf.get("method") == "scaled")
    if calib is not None:
        cm, cs, cy = calib
        cm = cm * a + b
        cs = cs * np.abs(a)
        mu_c = cm.mean(axis=0)
        var_c = np.clip((cs ** 2).mean(axis=0) + (cm ** 2).mean(axis=0)
                        - mu_c ** 2, 1e-12, None)
        y_c_z = transformer.transform(cy)
        if use_scaled:
            calib_scores = np.abs(y_c_z - mu_c) / np.clip(np.sqrt(var_c), 1e-12, None)
        else:
            calib_scores = np.abs(y_c_z - mu_c)

    stats = error_stats(mean_orig, targets)
    r2 = M.r2_score(mean_orig, targets)
    residuals = mean_orig - targets
    res_std = residuals.std(axis=0, ddof=0)
    res_skew = M.residual_skewness(residuals)
    nll = M.gaussian_nll(mean_z, std_z, targets_z)
    spearman_t = M.spearman_per_target(np.abs(targets_z - mean_z), std_z)
    # on tiny splits every per-target Spearman can be NaN (constant ranks);
    # guard so np.nanmean below never warns "Mean of empty slice"
    spearman_mean = (float(np.nanmean(spearman_t))
                     if np.isfinite(spearman_t).any() else float("nan"))
    coverages = [float(x) for x in cfg.coverage_grid.split(",") if x.strip()]
    nom, emp = M.reliability_curve(mean_z, std_z, targets_z, coverages)
    ece_t = [M.scalar_ece(nom, emp[t].tolist()) for t in range(t_dim)]
    cov90_t = [float("nan")] * t_dim
    near90 = np.where(np.isclose(np.asarray(nom), 0.9, atol=1e-6))[0]
    if near90.size:
        cov90_t = [float(v) for v in emp[:, int(near90[0])]]

    conformal_cov = conformal_width = None
    conformal_cov_t = conformal_width_t = None
    if conf is not None:
        _, lo, hi = apply_conformal_intervals(
            mean_z, std_z if use_scaled else None, conf, transformer)
        inside = (targets >= lo) & (targets <= hi)
        conformal_cov = float(inside.mean())
        conformal_width = float((hi - lo).mean())
        conformal_cov_t = inside.mean(axis=0)
        conformal_width_t = (hi - lo).mean(axis=0)

    sharp_w = sharp_c = np.empty((t_dim, 0))
    if calib_scores is not None:
        sharp_w, sharp_c = M.sharpness_vs_coverage(
            calib_scores, mean_z, targets, transformer, coverages,
            std_z=std_z, scaled=use_scaled)

    div = M.diversity_metrics(means_m, stds_m, var_z, targets, transformer, stats)

    out_dir = Path(cfg.output_dir) / split_tag
    out_dir.mkdir(parents=True, exist_ok=True)
    if cfg.make_plots:
        # matplotlib is optional: only a run that plots imports it, and
        # there a missing matplotlib raises
        from . import plots as P

        P.plot_parity(targets, mean_orig, target_names, out_dir / "parity.png")
        P.plot_residuals(mean_orig, residuals, target_names,
                         out_dir / "residuals_vs_pred.png")
        P.plot_reliability(nom, emp, target_names,
                           out_dir / "reliability_gaussian.png",
                           "Reliability (Gaussian)")
        if sharp_w.size:
            P.plot_sharpness_coverage(sharp_w, sharp_c, target_names,
                                      out_dir / "sharpness_vs_coverage.png")
        P.plot_error_variance((targets_z - mean_z) ** 2, var_z, target_names,
                              out_dir / "error_variance.png")
        P.plot_corr_heatmap(div["member_preds_orig"], out_dir / "corr_heatmap.png")

    result: Dict = {
        "split": split_tag,
        "overall": {
            "rmse": stats["overall"]["rmse"],
            "mae": stats["overall"]["mae"],
            "r2": float(r2.mean()),
            "residual_std": float(res_std.mean()),
            "residual_skew": float(res_skew.mean()),
            "gaussian_nll": float(nll.mean()),
            "ece_gaussian": M.scalar_ece(nom, emp.mean(axis=0).tolist()),
            "conformal_coverage": conformal_cov,
            "conformal_width": conformal_width,
            "diversity_member_var_mean": div["pairwise_var"],
            "spearman_error_uncertainty": spearman_mean,
            "epistemic_fraction_mean": div["epistemic_fraction_mean"],
            "member_rmse_mean": div["member_rmse_mean"],
            "member_rmse_std": div["member_rmse_std"],
            "member_mae_mean": div["member_mae_mean"],
            "member_mae_std": div["member_mae_std"],
            "member_nll_mean": div["member_nll_mean"],
            "member_nll_std": div["member_nll_std"],
            "ensemble_gain_percent": div["ensemble_gain_percent"],
            "q_statistic_mean": div["q_statistic_mean"],
            "double_fault_mean": div["double_fault_mean"],
            "kendall_w": div["kendall_w"],
            "kendall_w_reference_convention": div["kendall_w_reference_convention"],
            "member_correlation_matrix": div["member_correlation_matrix"].tolist(),
        },
        "per_target": {},
    }
    for t, name in enumerate(target_names):
        entry = {
            "rmse": stats[name]["rmse"], "mae": stats[name]["mae"],
            "r2": float(r2[t]),
            "residual_std": float(res_std[t]),
            "residual_skew": float(res_skew[t]),
            "gaussian_nll": float(nll[t]),
            "spearman_error_uncertainty": spearman_t[t],
            "epistemic_fraction_mean": float(div["epistemic_fraction_per_target"][t]),
            "member_rmse_mean": float(div["member_rmse_per_target_mean"][t]),
            "member_rmse_std": float(div["member_rmse_per_target_std"][t]),
            "member_mae_mean": float(div["member_mae_per_target_mean"][t]),
            "member_mae_std": float(div["member_mae_per_target_std"][t]),
            "member_nll_mean": float(div["member_nll_per_target_mean"][t]),
            "member_nll_std": float(div["member_nll_per_target_std"][t]),
            "ensemble_gain_percent": float(div["ensemble_gain_per_target"][t]),
            "ece_gaussian": float(ece_t[t]),
            "coverage_gaussian_90": float(cov90_t[t]),
        }
        if conformal_cov_t is not None:
            entry["conformal_coverage"] = float(conformal_cov_t[t])
            entry["conformal_width"] = float(conformal_width_t[t])
        result["per_target"][name] = entry

    (out_dir / "metrics.json").write_text(json.dumps(result, indent=2,
                                                     default=float))
    print(f"Saved ensemble evaluation for {split_tag} split to {out_dir}:")
    print(f"  Metrics -> {out_dir / 'metrics.json'}")
    return result
