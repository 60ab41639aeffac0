"""Leakage-safe grouped splits + group K-fold (the port's copy of
`gnnep_tpu.data.splits`).

Bit-exact re-derivation of the reference's seeded split machinery
(the reference trainer's `scripts/train.py:1235-1297`): groups shuffled with
`np.random.default_rng(seed)`, floor+remainder allocation into
train/val/calib/test, and round-robin group K-fold over the train split.
Evaluate/predict re-derive the identical split from (seed, fractions), so
these must stay deterministic across processes.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np


def group_indices(group_keys: Sequence[str]) -> Dict[str, List[int]]:
    """Group id → sample indices, insertion-ordered by first appearance."""
    out: Dict[str, List[int]] = {}
    for idx, key in enumerate(group_keys):
        out.setdefault(key, []).append(idx)
    return out


def group_split_four(
    group_to_indices: Dict[str, List[int]],
    seed: int,
    val_frac: float,
    calib_frac: float,
    test_frac: float,
) -> Tuple[List[int], List[int], List[int], List[int]]:
    """Grouped 4-way split (train/val/calib/test), reference train.py:1235-1275."""
    train_frac = 1.0 - val_frac - calib_frac - test_frac
    if train_frac < 0:
        raise ValueError("val_frac + calib_frac + test_frac must be <= 1.0")
    rng = np.random.default_rng(seed)
    group_ids = list(group_to_indices.keys())
    rng.shuffle(group_ids)
    total = len(group_ids)
    desired = {
        "train": max(train_frac, 0.0) * total,
        "val": max(val_frac, 0.0) * total,
        "calib": max(calib_frac, 0.0) * total,
        "test": max(test_frac, 0.0) * total,
    }
    counts = {k: int(math.floor(v)) for k, v in desired.items()}
    remaining = total - sum(counts.values())
    for k in ("train", "val", "calib", "test"):
        if remaining <= 0:
            break
        counts[k] += 1
        remaining -= 1
    splits: Dict[str, List[int]] = {}
    start = 0
    for k in ("train", "val", "calib", "test"):
        members: List[int] = []
        for gid in group_ids[start:start + counts[k]]:
            members.extend(group_to_indices[gid])
        splits[k] = members
        start += counts[k]
    return splits["train"], splits["val"], splits["calib"], splits["test"]


def group_kfold(
    group_to_indices: Dict[str, List[int]],
    eligible_indices: Sequence[int],
    folds: int,
    seed: int,
) -> List[List[int]]:
    """Round-robin group K-fold within the train split, reference train.py:1278-1297."""
    if folds <= 1:
        raise ValueError("Number of folds must be greater than 1")
    eligible = set(int(i) for i in eligible_indices)
    group_keys = [k for k, idxs in group_to_indices.items()
                  if any(i in eligible for i in idxs)]
    if len(group_keys) < folds:
        raise ValueError(
            f"Not enough groups ({len(group_keys)}) to create {folds} folds")
    rng = np.random.default_rng(seed)
    rng.shuffle(group_keys)
    fold_indices: List[List[int]] = [[] for _ in range(folds)]
    for position, key in enumerate(group_keys):
        members = [i for i in group_to_indices[key] if i in eligible]
        if members:
            fold_indices[position % folds].extend(members)
    for fid, members in enumerate(fold_indices):
        if not members:
            raise ValueError(f"Fold {fid} is empty; adjust seed or configuration.")
        fold_indices[fid] = sorted(members)
    return fold_indices


def derive_splits(group_keys: Sequence[str], seed: int, val_frac: float,
                  calib_frac: float, test_frac: float, ensemble_size: int):
    """One-call split derivation shared by train / evaluate / predict."""
    g2i = group_indices(group_keys)
    train_idx, val_idx, calib_idx, test_idx = group_split_four(
        g2i, seed, val_frac, calib_frac, test_frac)
    train_idx, val_idx = sorted(train_idx), sorted(val_idx)
    folds = (group_kfold(g2i, train_idx, ensemble_size, seed)
             if ensemble_size > 1 else [sorted(train_idx)])
    return train_idx, val_idx, sorted(calib_idx), sorted(test_idx), folds
