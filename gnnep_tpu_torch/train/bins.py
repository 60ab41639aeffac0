"""Target-bin statistics (quantile bins over log targets): the port's copy
of `gnnep_tpu.train.bins`.

Parity port of the reference's `_compute_bin_statistics`
(the reference trainer's `scripts/train.py:425-478`) plus its per-sample gather
(`_gather_bin_values`, train.py:404-421). When `freq_gamma > 0` the
inverse-frequency bin weights are folded into the per-sample training loss
(mean across targets → one scalar per sample, composed multiplicatively with
any active KNN density weights); the scales/probs are carried for
diagnostics. The flag's intent follows the reference's help text
("set >0 to enable weighting", train.py:1106).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def compute_bin_statistics(values: np.ndarray, num_bins: int, gamma: float,
                           eps: float = 1e-6
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    if values.ndim != 2:
        raise ValueError(f"Expected 2D targets, got {values.shape}")
    if np.any(values <= 0):
        raise ValueError("Targets must be strictly positive for bin statistics.")
    total, t_dim = values.shape
    if total == 0:
        raise ValueError("Cannot compute bin statistics from an empty array.")
    bins = max(int(num_bins), 1)
    logv = np.log(values)
    edges = np.empty((t_dim, bins + 1))
    weights = np.empty((t_dim, bins))
    scales = np.empty((t_dim, bins))
    probs = np.empty((t_dim, bins))
    for d in range(t_dim):
        dim_log, dim_vals = logv[:, d], values[:, d]
        global_median = float(np.median(dim_vals))
        if bins == 1 or np.allclose(dim_log, dim_log[0]):
            edges[d, :2] = [-np.inf, np.inf]
            probs[d, :1], weights[d, :1] = 1.0, 1.0
            scales[d, :1] = max(global_median, eps)
            if bins > 1:  # degenerate distribution: collapse remaining bins
                edges[d, 2:] = np.inf
                probs[d, 1:] = weights[d, 1:] = 0.0
                scales[d, 1:] = max(global_median, eps)
            continue
        q = np.quantile(dim_log, np.linspace(0.0, 1.0, bins + 1))
        if not np.all(np.diff(q) > 0):
            q = np.linspace(dim_log.min(), dim_log.max(), bins + 1)
        q[0], q[-1] = -np.inf, np.inf
        edges[d] = q
        idx = np.digitize(dim_log, q[1:-1], right=False)
        counts = np.bincount(idx, minlength=bins).astype(float)
        p = np.clip(counts / max(counts.sum(), 1.0), eps, None)
        p /= p.sum()
        probs[d] = p
        inv = np.power(1.0 / p, gamma) if gamma != 0.0 else np.ones_like(p)
        weights[d] = inv / inv.mean()
        for b in range(bins):
            m = idx == b
            scales[d, b] = max(float(np.median(dim_vals[m])) if m.any()
                               else global_median, eps)
    return edges, weights, scales, probs


def gather_bin_values(values: np.ndarray, bin_edges: np.ndarray,
                      bin_values: np.ndarray) -> np.ndarray:
    """Per-target bin lookup: values [N, T] (linear space, positive) →
    [N, T] of each sample's bin value, binned over log-targets.

    Mirrors the reference's `_gather_bin_values`
    (the reference trainer's `scripts/train.py:404-421`): bucketize against the
    interior edges (edges[d, 1:-1], right-open), index into the bin values.
    """
    logv = np.log(np.maximum(np.asarray(values, dtype=np.float64), 1e-300))
    n, t_dim = logv.shape
    out = np.empty((n, t_dim), dtype=np.float64)
    for d in range(t_dim):
        idx = np.digitize(logv[:, d], bin_edges[d, 1:-1], right=False)
        out[:, d] = bin_values[d][idx]
    return out


def freq_sample_weights(values: np.ndarray, bin_edges: np.ndarray,
                        bin_weights: np.ndarray) -> np.ndarray:
    """One loss weight per sample: mean across targets of the sample's
    inverse-frequency bin weights. Applied to the per-sample NLL exactly as
    KNN density weights are (composed multiplicatively when both are
    active)."""
    return gather_bin_values(values, bin_edges, bin_weights).mean(
        axis=1).astype(np.float32)


def freq_weights_for_store(y: np.ndarray, bin_edges: np.ndarray,
                           bin_weights: np.ndarray) -> np.ndarray:
    """[n_graphs] per-sample loss weights over a whole store's targets,
    defaulting to 1.0 wherever a target is missing or non-positive (such
    samples never reach the training loss anyway)."""
    out = np.ones(y.shape[0], dtype=np.float32)
    finite = np.isfinite(y).all(axis=1) & (y > 0).all(axis=1)
    if finite.any():
        out[finite] = freq_sample_weights(y[finite], bin_edges, bin_weights)
    return out
