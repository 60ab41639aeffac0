"""Eval forward and prediction collection (the serving part of
`gnnep_tpu.train.loop`).

The train step (loss, optimizer, dropout) waits for the training slice.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from ..models.alignn import Alignn, AlignnConfig, DeviceBatch, alignn_apply

MIN_LOGVAR_FLOOR = -2.9  # reference train.py:39

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# The JAX package's `_cast_for_compute` in two halves: the member is cast once
# per prediction run, the batch once per batch.
def cast_model(model: Alignn, compute_dtype: str) -> Alignn:
    """The member with every f32 parameter in `compute_dtype` (a copy,
    unless that is float32)."""
    dtype = _DTYPES[compute_dtype]
    if dtype == torch.float32:
        return model
    return copy.deepcopy(model).to(dtype)


def cast_batch(batch: DeviceBatch, dtype: torch.dtype) -> DeviceBatch:
    """The batch with its four feature arrays in `dtype` (masks stay f32)."""
    if dtype == torch.float32:
        return batch
    return dataclasses.replace(
        batch, nodes=batch.nodes.to(dtype), edge_attr=batch.edge_attr.to(dtype),
        lg_attr=batch.lg_attr.to(dtype), globals_=batch.globals_.to(dtype))


def make_forward(floor: float = MIN_LOGVAR_FLOOR,
                 compute_dtype: str = "float32"
                 ) -> Callable[[Alignn, DeviceBatch],
                               Tuple[torch.Tensor, torch.Tensor]]:
    """Eval forward → (mean_z f32, logvar f32 floored at `floor`).

    `compute_dtype='bfloat16'` expects a member already cast with
    `cast_model` (cast once per member, not per batch) and casts the batch's
    features; the heads' outputs return as f32."""
    dtype = _DTYPES[compute_dtype]

    def forward(model: Alignn, batch: DeviceBatch):
        with torch.inference_mode():
            mean, logvar = alignn_apply(model, cast_batch(batch, dtype))
            return (mean.float(),
                    torch.clamp_min(logvar.float(), floor))

    return forward


def collect_predictions(forward, model: Alignn, batches: Sequence, device
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
    """Run `forward` over the packed batches → per-real-graph host arrays
    (mean_z [N,T], sigma_z [N,T], y_linear [N,T], sample_index [N])."""
    means, sigmas, ys, idxs = [], [], [], []
    for b in batches:
        mean, logvar = forward(model, DeviceBatch.from_batch(b, device))
        mask = np.asarray(b.graph_mask) > 0
        means.append(mean.cpu().numpy()[mask])
        sigmas.append(np.sqrt(np.exp(logvar.cpu().numpy()))[mask])
        # invalid targets (y_mask 0) surface as NaN, never as y's inert fill
        yv = np.where(np.asarray(b.y_mask) > 0, np.asarray(b.y), np.nan)
        ys.append(yv[mask])
        idxs.append(np.asarray(b.sample_index)[mask])
    return (np.concatenate(means), np.concatenate(sigmas),
            np.concatenate(ys), np.concatenate(idxs))


def reconcile_win64(cfg: AlignnConfig, budget) -> AlignnConfig:
    """The checkpoint config with its packer window bounds replaced by the
    active batch budget's, and the span bounds cleared, as the JAX package
    does before every eval forward (those bounds size the TPU kernels'
    windows; the CUDA kernel reads whole CSR ranges and needs none)."""
    return dataclasses.replace(
        cfg,
        edge_win64=int(budget.edge_win64), lg_win64=int(budget.lg_win64),
        edge_src_win64=int(budget.edge_src_win64),
        lg_src_win64=int(budget.lg_src_win64),
        edge_span64=0, lg_span64=0)
