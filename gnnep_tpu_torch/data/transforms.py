"""Feature standardization and log-target transform (the port's own copy of
`gnnep_tpu.data.transforms`).

Numerics match the reference exactly: per-node z-scoring of the 6 element
scalars and the mat2vec block accumulated in float64 over the train split
(reference `train.py:1329-1377`), per-graph z-scoring of the 59
global scalars (space-group one-hot left untouched), and the fitted
log-standardization of targets (`train.py:219-300`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from .store import GraphStore

SCALAR_DIM = 6  # element scalars precede the mat2vec block (train.py:102)
_EPS = 1e-12


@dataclasses.dataclass
class FeatureScaler:
    """Train-split z-score statistics for node & global features."""

    scalar_mean: Optional[np.ndarray] = None  # [6]
    scalar_std: Optional[np.ndarray] = None
    embed_mean: Optional[np.ndarray] = None   # [m2v]
    embed_std: Optional[np.ndarray] = None
    global_mean: Optional[np.ndarray] = None  # [59]
    global_std: Optional[np.ndarray] = None

    @classmethod
    def fit(cls, store: GraphStore, train_idx: Sequence[int]) -> "FeatureScaler":
        node_dim = store.node_dim
        scalar_dim = min(SCALAR_DIM, node_dim)
        m2v_dim = max(0, node_dim - scalar_dim)
        g_dim = store.global_scalar_dim

        node_rows = [store.node_feats[store.node_off[g]:store.node_off[g + 1]]
                     for g in train_idx]
        x = (np.concatenate(node_rows, axis=0).astype(np.float64)
             if node_rows else np.zeros((0, node_dim)))
        total_nodes = x.shape[0]

        def _stats(block: np.ndarray, count: int):
            mean = block.sum(axis=0) / count
            var = (block ** 2).sum(axis=0) / count - mean ** 2
            return (mean.astype(np.float32),
                    np.sqrt(np.clip(var, _EPS, None)).astype(np.float32))

        sc_mean = sc_std = em_mean = em_std = gl_mean = gl_std = None
        if total_nodes > 0 and scalar_dim > 0:
            sc_mean, sc_std = _stats(x[:, :scalar_dim], total_nodes)
        if total_nodes > 0 and m2v_dim > 0:
            em_mean, em_std = _stats(x[:, scalar_dim:], total_nodes)
        if len(train_idx) > 0 and g_dim > 0:
            gl = store.global_scalars[np.asarray(train_idx, dtype=np.int64)].astype(np.float64)
            gl_mean, gl_std = _stats(gl, len(train_idx))
        return cls(sc_mean, sc_std, em_mean, em_std, gl_mean, gl_std)

    def apply(self, store: GraphStore) -> GraphStore:
        """Return a store with standardized node/global features (copies columns)."""
        node_dim = store.node_dim
        scalar_dim = min(SCALAR_DIM, node_dim)
        x = store.node_feats.astype(np.float32, copy=True)
        if self.scalar_mean is not None and scalar_dim > 0:
            x[:, :scalar_dim] = (x[:, :scalar_dim] - self.scalar_mean[:scalar_dim]) \
                / self.scalar_std[:scalar_dim]
        if self.embed_mean is not None and node_dim > scalar_dim:
            x[:, scalar_dim:] = (x[:, scalar_dim:] - self.embed_mean) / self.embed_std
        g = store.global_scalars.astype(np.float32, copy=True)
        if self.global_mean is not None:
            g = (g - self.global_mean) / self.global_std
        return dataclasses.replace(store, node_feats=x, global_scalars=g)

    # ------------------------------------------------------------- state io
    def state_dict(self) -> Dict[str, Optional[np.ndarray]]:
        return {
            "scalar_mean": self.scalar_mean, "scalar_std": self.scalar_std,
            "embed_mean": self.embed_mean, "embed_std": self.embed_std,
            "global_mean": self.global_mean, "global_std": self.global_std,
        }

    @classmethod
    def from_state_dict(cls, state: Dict) -> "FeatureScaler":
        def arr(v):
            return None if v is None else np.asarray(v, dtype=np.float32)
        return cls(arr(state.get("scalar_mean")), arr(state.get("scalar_std")),
                   arr(state.get("embed_mean")), arr(state.get("embed_std")),
                   arr(state.get("global_mean")), arr(state.get("global_std")))


@dataclasses.dataclass
class LogTransformer:
    """y → (log y − μ)/σ fitted on train targets (train.py:219-300)."""

    means: Optional[np.ndarray] = None
    stds: Optional[np.ndarray] = None

    @classmethod
    def fit(cls, values: np.ndarray) -> "LogTransformer":
        values = np.asarray(values, dtype=np.float64)
        if values.ndim != 2:
            raise ValueError(f"Expected 2D targets, got {values.shape}")
        if not np.isfinite(values).all():
            raise ValueError("Targets contain non-finite values.")
        if np.any(values <= 0.0):
            raise ValueError("Log transform requires strictly positive targets.")
        logged = np.log(values)
        means = logged.mean(axis=0)
        stds = logged.std(axis=0, ddof=0)
        stds = np.where(np.isfinite(stds) & (stds > _EPS), stds, 1.0)
        return cls(means.astype(np.float64), stds.astype(np.float64))

    def _fitted(self):
        if self.means is None or self.stds is None:
            raise RuntimeError("LogTransformer must be fitted before use.")
        return self.means, self.stds

    def transform(self, y):
        means, stds = self._fitted()
        y = np.asarray(y)
        if np.any(y <= 0):
            raise ValueError("Log transform encountered non-positive targets.")
        return (np.log(y) - means) / stds

    def to_log(self, z):
        """z-space → log-space (no exp)."""
        means, stds = self._fitted()
        return np.asarray(z) * stds + means

    def inverse(self, z):
        return np.exp(self.to_log(z))

    def state_dict(self) -> Dict[str, np.ndarray]:
        means, stds = self._fitted()
        return {"means": means.copy(), "stds": stds.copy()}

    @classmethod
    def from_state_dict(cls, state: Dict) -> "LogTransformer":
        means = np.asarray(state["means"], dtype=np.float64).reshape(-1)
        stds = np.asarray(state["stds"], dtype=np.float64).reshape(-1)
        stds = np.where(np.isfinite(stds) & (stds > _EPS), stds, 1.0)
        return cls(means, stds)
