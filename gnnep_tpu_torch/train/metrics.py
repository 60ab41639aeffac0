"""Evaluation metrics computed on host from collected predictions (the
port's copy of `gnnep_tpu.train.metrics`).

Mirrors the reference trainer's eval pass (`scripts/train.py:726-846`)
and error-stat report (`train.py:481-525`): heteroscedastic NLL, linear/log
MAE & RMSE, 1σ z-space coverage, 9-level Gaussian ECE, Spearman(|err|, σ),
and the per-target RMSE/MAE/percentile table.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

try:
    from scipy.stats import spearmanr as _spearmanr
except ImportError:  # pragma: no cover
    _spearmanr = None

from ..data.transforms import LogTransformer

# Φ⁻¹((1+p)/2) for p in 0.1..0.9 — the reference materializes these via
# torch.distributions.Normal.icdf (train.py:794-801)
_PROB_LEVELS = np.linspace(0.1, 0.9, 9)
try:
    from scipy.stats import norm as _norm

    _Z_THRESH = _norm.ppf((1.0 + _PROB_LEVELS) / 2.0)
except ImportError:  # pragma: no cover
    _Z_THRESH = np.array([0.1257, 0.2533, 0.3853, 0.5244, 0.6745,
                          0.8416, 1.0364, 1.2816, 1.6449])


def eval_metrics(mean_z: np.ndarray, sigma_z: np.ndarray, y: np.ndarray,
                 transformer: LogTransformer) -> Dict[str, float]:
    """Scalar eval metrics over one split; z = log-standardized space.

    Non-finite targets (NaN from `collect_predictions` for y_mask==0
    components — partially-targeted samples) are excluded element-wise, so
    fold-val model selection stays well-defined on partial-target stores.
    Numerically identical to the unmasked formulas when every target is
    finite (the reference's case — it filters to fully-targeted samples)."""
    valid = np.isfinite(y)                       # [N, T] element validity
    n_valid = valid.sum()
    y_z = np.where(valid, transformer.transform(np.where(valid, y, 1.0)), np.nan)
    var = sigma_z ** 2
    logvar = np.log(np.maximum(var, 1e-30))
    diff = np.where(valid, mean_z - y_z, 0.0)
    nll = 0.5 * (logvar + diff ** 2 / np.maximum(var, 1e-30)) * valid
    pred = transformer.inverse(mean_z)
    abs_lin = np.where(valid, np.abs(pred - y), 0.0)
    n = y.shape[0]

    abs_z = np.abs(diff)
    covered = (abs_z <= sigma_z) & valid
    coverage = float(covered.sum() / n_valid) if n_valid else float("nan")
    if n_valid:
        cov_levels = ((abs_z[None] <= _Z_THRESH[:, None, None] * sigma_z[None])
                      & valid[None]).sum(axis=(1, 2)) / n_valid
        ece = float(np.abs(cov_levels - _PROB_LEVELS).mean())
    else:
        ece = float("nan")

    spear = float("nan")
    if _spearmanr is not None and abs_z.size > 1:
        flat_e = np.where(valid, abs_z, np.nan).ravel()
        flat_s = np.clip(sigma_z.ravel(), 1e-6, None)
        ok = np.isfinite(flat_e) & np.isfinite(flat_s)
        if ok.sum() > 1:
            r = _spearmanr(flat_e[ok], flat_s[ok])
            spear = float(getattr(r, "statistic", r[0]))

    eps = 1e-6
    mae_log = float((np.abs(np.log(np.clip(pred, eps, None))
                            - np.log(np.clip(np.where(valid, y, 1.0), eps,
                                             None))) * valid).sum() / n)
    # per-sample mean NLL over valid targets, averaged over samples with at
    # least one valid target (matches masked_sample_nll's convention)
    per_sample_valid = np.maximum(valid.sum(axis=1), 1)
    return {
        "nll": float((nll.sum(axis=1) / per_sample_valid).sum() / n),
        "mae": float(abs_lin.sum() / n),            # per-sample sum across targets
        "rmse": float(np.sqrt((np.where(valid, pred - y, 0.0) ** 2).sum()
                              / n_valid)) if n_valid else float("nan"),
        "mae_log": mae_log,
        "coverage": coverage,
        "ece": ece,
        "spearman": spear,
        "logvar_mean": float(logvar.mean()),
        "sigma_max": float(sigma_z.max()) if sigma_z.size else float("nan"),
    }


TARGET_NAMES = {0: "bulk_modulus", 1: "shear_modulus"}


def error_stats(preds: np.ndarray, targets: np.ndarray) -> Dict[str, Dict[str, float]]:
    """Per-target + overall error table (reference compute_error_stats)."""
    if preds.shape != targets.shape:
        raise ValueError(f"Preds shape {preds.shape} != targets {targets.shape}")
    err = preds - targets
    if err.ndim == 1:
        err = err[:, None]
    abs_err = np.abs(err)
    out: Dict[str, Dict[str, float]] = {}

    def block(e: np.ndarray, a: np.ndarray) -> Dict[str, float]:
        return {
            "rmse": float(np.sqrt((e ** 2).mean())),
            "mae": float(a.mean()),
            "std": float(e.std(ddof=0)),
            "mean_error": float(e.mean()),
            "abs_p50": float(np.quantile(a, 0.5)),
            "abs_p90": float(np.quantile(a, 0.9)),
            "abs_p95": float(np.quantile(a, 0.95)),
            "max_abs": float(a.max()),
        }

    for t in range(err.shape[1]):
        out[TARGET_NAMES.get(t, f"target_{t}")] = block(err[:, t], abs_err[:, t])
    out["overall"] = block(err.ravel(), abs_err.ravel())
    return out
