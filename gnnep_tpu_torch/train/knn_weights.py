"""KNN density weighting over penultimate embeddings (opt-in): the
counterpart of `gnnep_tpu.train.knn_weights`.

Re-implements the reference's inverse-density sample weighting
(reference `train.py:930-1010`): snapshot embeddings of the train set,
z-score them, estimate local density via k-NN distances (ρ = k / Σd), weight
ρ^−α, downweight by local label variance (÷ (1 + β·var)), clip, and
mean-normalize. Weights are keyed by global dataset index and activate the
epoch after they are computed.

The embeddings are the member's eval trunk (`models.alignn.alignn_embed`) on
its device, run eagerly between epochs, outside any captured step. The
neighbour search picks its backend as the JAX package does: the `backend`
argument, else `GNNEP_KNN_BACKEND`, else `device` from `_DEVICE_KNN_MIN_N`
rows on and `host` below; the host backend is sklearn where it is installed,
else numpy.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.alignn import Alignn, DeviceBatch, alignn_embed
from ..utils.device import resolve_device

_DEVICE_KNN_MIN_N = 4096  # below this, exact host kNN is faster


def _device_knn(Zs: np.ndarray, k_eff: int, chunk: int,
                device: torch.device) -> Tuple[np.ndarray, np.ndarray]:
    """Chunked brute-force kNN on `device`: ‖a−b‖² = ‖a‖²+‖b‖²−2a·b in f32
    (TF32 off, `utils.device`; the JAX package's HIGHEST precision), self
    distances +inf, `torch.topk` per query chunk. Each row's k results are
    ordered by (distance, index), as `lax.top_k` orders ties."""
    Z = torch.as_tensor(np.ascontiguousarray(Zs, np.float32), device=device)
    n = Z.shape[0]
    sq = (Z * Z).sum(dim=1)
    dists, idxs = [], []
    for start in range(0, n, chunk):
        q = Z[start:start + chunk]
        rows = torch.arange(q.shape[0], device=device)
        d2 = sq[start:start + chunk, None] + sq[None, :] - 2.0 * (q @ Z.T)
        d2[rows, rows + start] = float("inf")
        neg, idx = torch.topk(-d2, k_eff, dim=1)
        # ties in index order, then distances ascending (both sorts stable)
        by_idx = torch.argsort(idx, dim=1, stable=True)
        neg, idx = neg.gather(1, by_idx), idx.gather(1, by_idx)
        by_dist = torch.argsort(-neg, dim=1, stable=True)
        neg, idx = neg.gather(1, by_dist), idx.gather(1, by_dist)
        dists.append(torch.sqrt(torch.clamp_min(-neg, 0.0)))
        idxs.append(idx)
    return (torch.cat(dists).cpu().numpy(),
            torch.cat(idxs).cpu().numpy())


def knn_neighbors(Zs: np.ndarray, k_eff: int,
                  backend: Optional[str] = None, device=None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(dists [n,k], indices [n,k]) of each row's k nearest OTHER rows.

    backend: 'device' (chunked GEMM + top-k on `device`, None meaning CUDA),
    'host' (sklearn, numpy fallback — exact, matches the reference's
    sklearn/torch.cdist path), or None = auto (device for large n).
    GNNEP_KNN_BACKEND overrides."""
    n, d = Zs.shape
    backend = backend or os.environ.get("GNNEP_KNN_BACKEND") or (
        "device" if n >= _DEVICE_KNN_MIN_N else "host")
    if backend == "device":
        return _device_knn(Zs, int(k_eff), min(1024, max(128, n // 8)),
                           resolve_device(device))
    try:
        from sklearn.neighbors import NearestNeighbors

        nbrs = NearestNeighbors(n_neighbors=k_eff + 1,
                                metric="euclidean").fit(Zs)
        dists, ind = nbrs.kneighbors(Zs, n_neighbors=k_eff + 1)
        return dists[:, 1:], ind[:, 1:]
    except Exception:  # numpy fallback (reference uses torch.cdist)
        D = np.linalg.norm(Zs[:, None] - Zs[None], axis=-1)
        np.fill_diagonal(D, np.inf)
        ind = np.argsort(D, axis=1)[:, :k_eff]
        return np.take_along_axis(D, ind, axis=1), ind


def snapshot_embeddings(model: Alignn, batches
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(embeddings [n, H], targets [n, T], dataset indices [n]) of the real
    graphs of the packed host `batches`, embedded on the model's device."""
    device = next(model.parameters()).device
    zs: List[torch.Tensor] = []
    ys: List[np.ndarray] = []
    idxs: List[np.ndarray] = []
    for b in batches:
        mask = np.asarray(b.graph_mask) > 0
        zs.append(alignn_embed(model, DeviceBatch.from_batch(b, device))
                  [torch.from_numpy(mask).to(device)])
        ys.append(np.asarray(b.y)[mask])
        idxs.append(np.asarray(b.sample_index)[mask])
    if not zs:
        raise ValueError("No batches produced embeddings for KNN weighting.")
    return (torch.cat(zs).float().cpu().numpy(), np.concatenate(ys),
            np.concatenate(idxs))


def zscore(Z: np.ndarray) -> np.ndarray:
    """The embeddings standardized per column, f32."""
    mean = Z.mean(axis=0)
    std = np.clip(Z.std(axis=0, ddof=0), 1e-8, None)
    return ((Z - mean) / std).astype(np.float32)


def density_weights(Z: np.ndarray, Y: np.ndarray, I: np.ndarray, *, k: int,
                    eps: float, alpha: float, beta: float,
                    clip_min: Optional[float], clip_max: Optional[float],
                    backend: Optional[str] = None, device=None
                    ) -> Dict[int, float]:
    """{dataset index: weight} from the embeddings Z [n, H], targets Y
    [n, T] and dataset indices I [n] of one snapshot; `backend` and
    `device` as in `knn_neighbors`."""
    Zs = zscore(Z)
    n = Zs.shape[0]
    k_eff = max(1, min(int(k), n - 1))
    dists, ind = knn_neighbors(Zs, k_eff, backend, device)

    rho = k_eff / (dists.sum(axis=1) + float(eps))
    w = np.power(rho, -float(alpha))
    neigh_y = Y[ind]                                    # [n, k, T]
    var_local = neigh_y.var(axis=1, ddof=0).mean(axis=1)
    w = w / (1.0 + float(beta) * var_local)
    if clip_min is not None:
        w = np.clip(w, clip_min, None)
    if clip_max is not None:
        w = np.clip(w, None, clip_max)
    w = w / (w.mean() + 1e-12)
    return {int(i): float(wi) for i, wi in zip(I, w)}


def compute_knn_weights(model: Alignn, snapshot_batches, store, *, k: int,
                        eps: float, alpha: float, beta: float,
                        clip_min: Optional[float], clip_max: Optional[float]
                        ) -> Dict[int, float]:
    """KNN density weights of the real graphs of `snapshot_batches`, their
    embeddings and the neighbour search on the model's device."""
    Z, Y, I = snapshot_embeddings(model, snapshot_batches)
    return density_weights(Z, Y, I, k=k, eps=eps, alpha=alpha, beta=beta,
                           clip_min=clip_min, clip_max=clip_max,
                           device=next(model.parameters()).device)
