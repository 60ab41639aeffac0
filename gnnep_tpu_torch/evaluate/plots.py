"""Diagnostic plots (matplotlib Agg), mirroring the reference's six PNGs
(reference `evaluate.py:328-425`); the port's own copy of
`gnnep_tpu.evaluate.plots`.

matplotlib is optional: `evaluate.runner` imports this module only when it
makes plots, and then a missing matplotlib raises.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Sequence

import numpy as np

try:
    import matplotlib
except ImportError as exc:
    raise ImportError(
        "evaluation plots need matplotlib, which is not installed; pass "
        "--no-plots (EvalConfig.make_plots=False) to evaluate without "
        "them") from exc

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def _axes(fig_axes, t_dim: int):
    if t_dim == 1:
        return [fig_axes]
    return list(np.atleast_1d(fig_axes))


def plot_parity(y_true, y_pred, names: List[str], out: Path) -> None:
    t_dim = y_true.shape[1]
    fig, axes = plt.subplots(1, t_dim, figsize=(5.5 * t_dim, 5.0))
    for t, ax in enumerate(_axes(axes, t_dim)):
        ax.scatter(y_true[:, t], y_pred[:, t], s=10, alpha=0.5)
        lo = float(min(y_true[:, t].min(), y_pred[:, t].min()))
        hi = float(max(y_true[:, t].max(), y_pred[:, t].max()))
        ax.plot([lo, hi], [lo, hi], "k--", linewidth=1)
        ax.set_xlabel("True")
        ax.set_ylabel("Predicted")
        ax.set_title(f"{names[t]} Parity")
    fig.tight_layout()
    fig.savefig(out, dpi=180)
    plt.close(fig)


def plot_residuals(y_pred, residuals, names: List[str], out: Path) -> None:
    t_dim = y_pred.shape[1]
    fig, axes = plt.subplots(1, t_dim, figsize=(6 * t_dim, 4.0))
    for t, ax in enumerate(_axes(axes, t_dim)):
        ax.scatter(y_pred[:, t], residuals[:, t], s=8, alpha=0.5)
        ax.axhline(0.0, color="k", linewidth=1)
        ax.set_xlabel("Predicted")
        ax.set_ylabel("Residual (pred - true)")
        ax.set_title(f"{names[t]} Residuals")
    fig.tight_layout()
    fig.savefig(out, dpi=180)
    plt.close(fig)


def plot_reliability(nominals: Sequence[float], empirical: np.ndarray,
                     names: List[str], out: Path, title: str) -> None:
    xs = np.asarray(nominals)
    t_dim = empirical.shape[0]
    fig, axes = plt.subplots(1, t_dim, figsize=(5 * t_dim, 5.0))
    for t, ax in enumerate(_axes(axes, t_dim)):
        ax.plot(xs, xs, "k--", label="Ideal")
        ax.plot(xs, empirical[t], marker="o", label="Empirical")
        ax.set_xlabel("Nominal coverage")
        ax.set_ylabel("Empirical coverage")
        ax.set_title(f"{title} ({names[t]})")
        ax.legend()
    fig.tight_layout()
    fig.savefig(out, dpi=180)
    plt.close(fig)


def plot_corr_heatmap(member_preds: np.ndarray, out: Path) -> None:
    m = member_preds.shape[0]
    corr = np.corrcoef(member_preds.reshape(m, -1))
    plt.figure(figsize=(max(4, m * 0.6), max(3.5, m * 0.6)))
    im = plt.imshow(corr, cmap="coolwarm", vmin=-1, vmax=1)
    plt.colorbar(im, fraction=0.046, pad=0.04)
    plt.title("Ensemble Member Correlation")
    plt.xlabel("Member")
    plt.ylabel("Member")
    for i in range(m):
        for j in range(m):
            color = "white" if abs(corr[i, j]) > 0.5 else "black"
            plt.text(j, i, f"{corr[i, j]:.2f}", ha="center", va="center",
                     color=color, fontsize=8)
    plt.tight_layout()
    plt.savefig(out, dpi=180)
    plt.close()


def plot_error_variance(se2: np.ndarray, var: np.ndarray, names: List[str],
                        out: Path) -> None:
    t_dim = se2.shape[1]
    fig, axes = plt.subplots(1, t_dim, figsize=(5.5 * t_dim, 4.5))
    for t, ax in enumerate(_axes(axes, t_dim)):
        ax.scatter(var[:, t], se2[:, t], s=8, alpha=0.5)
        ax.set_xlabel("Predicted variance (z-space)")
        ax.set_ylabel("Squared error (z-space)")
        ax.set_title(f"{names[t]} Error-Variance")
    fig.tight_layout()
    fig.savefig(out, dpi=180)
    plt.close(fig)


def plot_sharpness_coverage(widths: np.ndarray, coverages: np.ndarray,
                            names: List[str], out: Path) -> None:
    t_dim = widths.shape[0]
    fig, axes = plt.subplots(1, t_dim, figsize=(5 * t_dim, 4.5))
    for t, ax in enumerate(_axes(axes, t_dim)):
        ax.plot(coverages[t], widths[t], marker="o")
        ax.set_xlabel("Coverage")
        ax.set_ylabel("Avg interval width")
        ax.set_title(f"{names[t]} Sharpness")
        ax.invert_xaxis()
    fig.tight_layout()
    fig.savefig(out, dpi=180)
    plt.close(fig)
