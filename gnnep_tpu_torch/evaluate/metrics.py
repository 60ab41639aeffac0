"""Full evaluation metric suite: accuracy, calibration, and ensemble
diversity (reference `evaluate.py:269-325,755-938`); the port's own copy
of `gnnep_tpu.evaluate.metrics`.

All functions are pure numpy over collected prediction arrays:
    member_means_z / member_stds_z : [M, N, T]   (z = log-standardized space)
    mean_z / std_z                 : [N, T]      mixture aggregate
    targets                        : [N, T]      original units
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    from scipy.stats import spearmanr as _spearmanr
except ImportError:  # pragma: no cover
    _spearmanr = None

from ..data.transforms import LogTransformer
from ..train.metrics import TARGET_NAMES


def _nanmean_or_nan(values) -> float:
    """np.nanmean that returns NaN silently on empty/all-NaN input instead
    of emitting a 'Mean of empty slice' RuntimeWarning (small eval splits
    can make every pairwise Q-statistic denominator zero)."""
    arr = np.asarray(values, dtype=float)
    finite = arr[np.isfinite(arr)]
    return float(finite.mean()) if finite.size else float("nan")


def r2_score(pred: np.ndarray, target: np.ndarray) -> np.ndarray:
    ss_res = ((pred - target) ** 2).sum(axis=0)
    ss_tot = np.clip(((target - target.mean(axis=0)) ** 2).sum(axis=0), 1e-12, None)
    return 1.0 - ss_res / ss_tot


def residual_skewness(residual: np.ndarray) -> np.ndarray:
    mu = residual.mean(axis=0, keepdims=True)
    std = np.clip(residual.std(axis=0, ddof=0, keepdims=True), 1e-12, None)
    return (((residual - mu) / std) ** 3).mean(axis=0)


def gaussian_nll(mean_z: np.ndarray, std_z: np.ndarray,
                 targets_z: np.ndarray) -> np.ndarray:
    """Full NLL with the 2π constant (per-target mean), evaluate.py:287-290."""
    var = np.clip(std_z ** 2, 1e-12, None)
    return (0.5 * (np.log(2 * np.pi * var) + (targets_z - mean_z) ** 2 / var)
            ).mean(axis=0)


def reliability_curve(mean_z: np.ndarray, std_z: np.ndarray,
                      targets_z: np.ndarray, coverages: Sequence[float]
                      ) -> Tuple[List[float], np.ndarray]:
    """Nominal vs empirical two-sided Gaussian coverage; empirical is [T, K]."""
    try:
        from scipy.special import erfinv
    except ImportError:  # pragma: no cover
        def erfinv(x):
            a = 0.147
            ln = np.log(1 - np.asarray(x) ** 2)
            t = 2 / (np.pi * a) + ln / 2
            return np.sign(x) * np.sqrt(np.sqrt(t ** 2 - ln / a) - t)
    nominals, empirical = [], []
    for p in coverages:
        z = math.sqrt(2.0) * float(erfinv(2 * (1.0 - (1.0 - p) / 2.0) - 1.0))
        covered = ((targets_z >= mean_z - z * std_z)
                   & (targets_z <= mean_z + z * std_z)).mean(axis=0)
        nominals.append(float(p))
        empirical.append(covered)
    return nominals, np.stack(empirical, axis=0).T


def scalar_ece(nominals: Sequence[float], empirical: Sequence[float]) -> float:
    pairs = [(a, b) for a, b in zip(nominals, empirical)
             if math.isfinite(a) and math.isfinite(b)]
    if not pairs:
        return float("nan")
    return float(np.mean([abs(a - b) for a, b in pairs]))


def spearman_per_target(errors_z: np.ndarray, std_z: np.ndarray) -> List[float]:
    out = []
    for t in range(errors_z.shape[1]):
        if _spearmanr is None or errors_z.shape[0] <= 1:
            out.append(float("nan"))
            continue
        r = _spearmanr(errors_z[:, t], std_z[:, t])
        out.append(float(getattr(r, "statistic", r[0])))
    return out


def sharpness_vs_coverage(calib_scores: np.ndarray, mean_z: np.ndarray,
                          targets: np.ndarray, transformer: LogTransformer,
                          coverages: Sequence[float],
                          std_z: Optional[np.ndarray] = None,
                          scaled: bool = False
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Width/coverage per nominal level from recomputed conformal quantiles
    (evaluate.py:827-846). Returns ([T, K] widths, [T, K] coverages)."""
    widths, covers = [], []
    n = calib_scores.shape[0]
    for p in coverages:
        alpha = 1.0 - p
        q_level = min(max(math.ceil((n + 1) * (1 - alpha)) / n, 0.0), 1.0)
        q = np.quantile(calib_scores, q_level, axis=0)
        if scaled and std_z is not None:
            lower_z, upper_z = mean_z - q * std_z, mean_z + q * std_z
        else:
            lower_z, upper_z = mean_z - q, mean_z + q
        lower_o = transformer.inverse(lower_z)
        upper_o = transformer.inverse(upper_z)
        widths.append((upper_o - lower_o).mean(axis=0))
        covers.append(((targets >= lower_o) & (targets <= upper_o)).mean(axis=0))
    return np.stack(widths, axis=0).T, np.stack(covers, axis=0).T


def diversity_metrics(member_means_z: np.ndarray, member_stds_z: np.ndarray,
                      var_z: np.ndarray, targets: np.ndarray,
                      transformer: LogTransformer,
                      ensemble_stats: Dict) -> Dict:
    """Ensemble-diversity diagnostics (evaluate.py:848-951)."""
    M = member_means_z.shape[0]
    t_dim = targets.shape[1]
    target_names = [TARGET_NAMES.get(t, f"target_{t}") for t in range(t_dim)]
    member_preds = transformer.inverse(member_means_z)      # [M, N, T]

    pairwise_var = float(member_preds.var(axis=0, ddof=0).mean())
    epistemic_var = member_means_z.var(axis=0, ddof=0)
    var_fraction = epistemic_var / np.clip(var_z, 1e-12, None)

    diff = member_preds - targets[None]
    rmse_m_t = np.sqrt((diff ** 2).mean(axis=1))            # [M, T]
    rmse_m_all = np.sqrt((diff.reshape(M, -1) ** 2).mean(axis=1))
    mae_m_t = np.abs(diff).mean(axis=1)
    mae_m_all = np.abs(diff).reshape(M, -1).mean(axis=1)

    targets_z = transformer.transform(targets)
    mvar = np.clip(member_stds_z ** 2, 1e-12, None)
    member_nll = 0.5 * (np.log(2 * np.pi * mvar)
                        + (targets_z[None] - member_means_z) ** 2 / mvar)
    nll_m_all = member_nll.mean(axis=(1, 2))
    nll_m_t = member_nll.mean(axis=1)

    ens_rmse = float(ensemble_stats["overall"]["rmse"])
    mm = float(rmse_m_all.mean())
    gain = ((mm - ens_rmse) / max(mm, 1e-12) * 100.0) if mm > 0 else float("nan")
    ens_rmse_t = np.array([ensemble_stats.get(n, {}).get("rmse", np.nan)
                           for n in target_names])
    mm_t = rmse_m_t.mean(axis=0)
    gain_t = np.where(mm_t > 0, (mm_t - ens_rmse_t) / np.clip(mm_t, 1e-12, None) * 100.0,
                      np.nan)

    # pairwise Q-statistic / double-fault on over/under-prediction agreement
    over = member_preds >= targets[None]
    qs, dfs = [], []
    for i in range(M):
        for j in range(i + 1, M):
            tt = np.logical_and(over[i], over[j]).sum()
            ff = np.logical_and(~over[i], ~over[j]).sum()
            tf = np.logical_and(over[i], ~over[j]).sum()
            ft = np.logical_and(~over[i], over[j]).sum()
            denom = tt * ff + tf * ft
            qs.append((tt * ff - tf * ft) / denom if denom > 0 else np.nan)
            total = tt + ff + tf + ft
            dfs.append(ff / total if total > 0 else np.nan)

    # Kendall's W: members are the judges, flattened predictions the ranked
    # items. NOTE: deliberate fix relative to the reference, whose
    # formulation transposes judges/items (evaluate.py:926-936) and thus
    # cannot reach 1 even for perfectly concordant members.
    flat = member_preds.reshape(M, -1)
    n_items = flat.shape[1]
    if n_items > 1 and M > 1:
        order = np.argsort(flat, axis=1)
        ranks = np.empty_like(order, dtype=float)
        np.put_along_axis(ranks, order,
                          np.broadcast_to(np.arange(1, n_items + 1, dtype=float),
                                          (M, n_items)), axis=1)
        rank_sums = ranks.sum(axis=0)                 # per item, over judges
        mean_rs = M * (n_items + 1) / 2.0
        denom_w = M ** 2 * (n_items ** 3 - n_items)
        kendall_w = float(12.0 * np.sum((rank_sums - mean_rs) ** 2) / denom_w) \
            if denom_w > 0 else float("nan")
        # reference-convention value alongside (evaluate.py:926-936):
        # ranks within each item's member column, W over per-member rank
        # sums — emitted under its own key so metrics.json consumers
        # comparing against reference outputs get a like-for-like number
        order_r = np.argsort(flat, axis=0)
        ranks_r = np.empty_like(order_r, dtype=float)
        ranks_r[order_r, np.arange(n_items)] = \
            np.arange(1, M + 1, dtype=float)[:, None]
        rank_sums_r = ranks_r.sum(axis=1)
        mean_rs_r = n_items * (M + 1) / 2.0
        denom_r = M ** 2 * (n_items ** 3 - n_items)
        kendall_w_ref = float(12.0 * np.sum((rank_sums_r - mean_rs_r) ** 2)
                              / denom_r) if denom_r > 0 else float("nan")
    else:
        kendall_w = float("nan")
        kendall_w_ref = float("nan")

    corr = np.corrcoef(flat) if M > 1 else np.ones((1, 1))
    return {
        "pairwise_var": pairwise_var,
        "epistemic_fraction_mean": float(np.nanmean(var_fraction)),
        "epistemic_fraction_per_target": np.nanmean(var_fraction, axis=0),
        "member_rmse_mean": mm, "member_rmse_std": float(rmse_m_all.std(ddof=0)),
        "member_mae_mean": float(mae_m_all.mean()),
        "member_mae_std": float(mae_m_all.std(ddof=0)),
        "member_nll_mean": float(nll_m_all.mean()),
        "member_nll_std": float(nll_m_all.std(ddof=0)),
        "ensemble_gain_percent": float(gain),
        "ensemble_gain_per_target": gain_t,
        "member_rmse_per_target_mean": mm_t,
        "member_rmse_per_target_std": rmse_m_t.std(axis=0, ddof=0),
        "member_mae_per_target_mean": mae_m_t.mean(axis=0),
        "member_mae_per_target_std": mae_m_t.std(axis=0, ddof=0),
        "member_nll_per_target_mean": nll_m_t.mean(axis=0),
        "member_nll_per_target_std": nll_m_t.std(axis=0, ddof=0),
        "q_statistic_mean": _nanmean_or_nan(qs),
        "double_fault_mean": _nanmean_or_nan(dfs),
        "kendall_w": kendall_w,
        "kendall_w_reference_convention": kendall_w_ref,
        "member_correlation_matrix": corr,
        "member_preds_orig": member_preds,
    }
