"""Ensemble aggregation, affine debias and split-conformal calibration (the
port's copy of `gnnep_tpu.train.calibrate`).

Numerics follow the reference trainer (`scripts/train.py:849-904,
1013-1076`): mixture-of-Gaussians aggregation across members, per-target
least-squares debias fitted on the calibration split, and the finite-sample
conformal quantile with scaled (σ-normalized) or absolute residual scores.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

from ..data.transforms import LogTransformer


def ensemble_mixture(member_means: np.ndarray, member_vars: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """[M,N,T] member stats → mixture mean and variance (law of total variance):
    var = E[var] + E[mean²] − (E[mean])²."""
    mean = member_means.mean(axis=0)
    var = (member_vars.mean(axis=0) + (member_means ** 2).mean(axis=0)
           - mean ** 2)
    return mean, np.clip(var, 1e-12, None)


def fit_affine_debias(pred_z: np.ndarray, target_z: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-target least squares y_z ≈ a·ŷ_z + b (train.py:1013-1026)."""
    t_dim = pred_z.shape[1]
    a = np.zeros(t_dim)
    b = np.zeros(t_dim)
    for t in range(t_dim):
        X = np.stack([pred_z[:, t], np.ones_like(pred_z[:, t])], axis=1)
        sol, *_ = np.linalg.lstsq(X, target_z[:, t], rcond=None)
        a[t], b[t] = sol[0], sol[1]
    return a, b


def conformal_calibration(mean_z: np.ndarray, std_z: Optional[np.ndarray],
                          targets: np.ndarray, transformer: Optional[LogTransformer],
                          alpha: float, method: str) -> Dict:
    """Finite-sample conformal quantile q at ⌈(n+1)(1−α)⌉/n (train.py:1029-1051)."""
    if transformer is not None:
        targets_z = (np.log(np.clip(targets, 1e-12, None)) - transformer.means) \
            / transformer.stds
    else:
        targets_z = targets
    if method == "scaled" and std_z is not None:
        s = np.abs(targets_z - mean_z) / np.clip(std_z, 1e-12, None)
    else:
        s = np.abs(targets_z - mean_z)
        method = "absolute"
    n = s.shape[0]
    q_level = min(max(math.ceil((n + 1) * (1 - alpha)) / n, 0.0), 1.0)
    q = np.quantile(s, q_level, axis=0)
    return {"q": q, "method": method, "alpha": float(alpha)}


def apply_conformal_intervals(mean_z: np.ndarray, std_z: Optional[np.ndarray],
                              conf: Dict, transformer: Optional[LogTransformer]
                              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(mean, lower, upper) in original units (train.py:1054-1076)."""
    q = np.asarray(conf["q"])
    if conf.get("method") == "scaled" and std_z is not None:
        lower_z, upper_z = mean_z - q * std_z, mean_z + q * std_z
    else:
        lower_z, upper_z = mean_z - q, mean_z + q
    if transformer is not None:
        return (transformer.inverse(mean_z), transformer.inverse(lower_z),
                transformer.inverse(upper_z))
    return mean_z, lower_z, upper_z
