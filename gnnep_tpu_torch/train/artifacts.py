"""Artifact persistence: member checkpoints and scaler state.

Counterpart of `gnnep_tpu.train.artifacts`, in the same `.npz` formats, so
an ensemble written by either package loads in the other:

- `model_{i}.npz`: `leaf_{i:05d}` arrays in the JAX package's tree-flatten
  order of the parameter pytree (`models.alignn.leaf_names`), weights
  `[in, out]`, plus `config_json`;
- `scaler_state.npz`: the feature scaler's arrays, `log_means`/`log_stds`
  and `meta_json`;
- `conformal.json`: the conformal quantiles and the affine debias;
- `resume_member_{seed}.npz`: a member's mid-training state
  (`save_pytree`), `leaf_{i:05d}` arrays plus `meta_json`, the JAX
  package's container with the port's leaves (`train.member`).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.transforms import FeatureScaler, LogTransformer
from ..models.alignn import Alignn, AlignnConfig, leaf_names
from ..utils.device import resolve_device


def params_from_leaves(leaves: Sequence[np.ndarray], cfg: AlignnConfig
                       ) -> Alignn:
    """Build a member from arrays in the JAX flatten order of its pytree."""
    model = Alignn(cfg)
    names = leaf_names(cfg)
    if len(leaves) != len(names):
        raise ValueError(f"{len(leaves)} arrays given; the architecture "
                         f"expects {len(names)}")
    params = dict(model.named_parameters())
    with torch.no_grad():
        for i, (name, leaf) in enumerate(zip(names, leaves)):
            p = params[name]
            arr = np.array(leaf, dtype=np.float32)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"leaf {i} ({name}): shape {arr.shape} != "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr))
    return model


def leaves_from_params(model: Alignn) -> List[np.ndarray]:
    """The member's arrays in the JAX flatten order (inverse of
    `params_from_leaves`)."""
    params = dict(model.named_parameters())
    return [params[n].detach().to("cpu", torch.float32).numpy()
            for n in leaf_names(model.cfg)]


def save_member(path: str | Path, model: Alignn) -> None:
    payload = {f"leaf_{i:05d}": leaf
               for i, leaf in enumerate(leaves_from_params(model))}
    payload["config_json"] = np.array(json.dumps(dataclasses.asdict(
        model.cfg)))
    np.savez(path, **payload)


def load_member(path: str | Path, device=None) -> Alignn:
    """Rebuild a member from its checkpoint: the embedded config names the
    architecture, the leaves fill it in flatten order. `device` None means
    CUDA, which must then be available."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        cfg = AlignnConfig(**json.loads(str(data["config_json"])))
        leaves = [data[k] for k in sorted(k for k in data.files
                                          if k.startswith("leaf_"))]
    try:
        model = params_from_leaves(leaves, cfg)
    except ValueError as exc:
        raise ValueError(f"Checkpoint {path}: {exc}") from None
    return model.to(device)


def save_scaler_state(path: str | Path, scaler: FeatureScaler,
                      transformer: Optional[LogTransformer],
                      dims: Optional[Dict] = None) -> None:
    payload = {}
    for key, val in scaler.state_dict().items():
        if val is not None:
            payload[key] = np.asarray(val)
    meta = {"target_transform": "log" if transformer is not None else "none"}
    if dims:
        meta["dims"] = dims
    payload["meta_json"] = np.array(json.dumps(meta))
    if transformer is not None:
        state = transformer.state_dict()
        payload["log_means"] = state["means"]
        payload["log_stds"] = state["stds"]
    np.savez(path, **payload)


def load_scaler_state(path: str | Path) -> Tuple[FeatureScaler,
                                                 Optional[LogTransformer],
                                                 Dict]:
    with np.load(path, allow_pickle=False) as data:
        meta = (json.loads(str(data["meta_json"]))
                if "meta_json" in data.files else {})
        state = {k: data[k] for k in
                 ("scalar_mean", "scalar_std", "embed_mean", "embed_std",
                  "global_mean", "global_std") if k in data.files}
        scaler = FeatureScaler.from_state_dict(state)
        transformer = None
        if "log_means" in data.files:
            transformer = LogTransformer.from_state_dict(
                {"means": data["log_means"], "stds": data["log_stds"]})
    return scaler, transformer, meta


def save_conformal(path: str | Path, conf: Dict,
                   affine_a: np.ndarray, affine_b: np.ndarray) -> None:
    Path(path).write_text(json.dumps({
        "q": np.asarray(conf["q"]).tolist(),
        "method": conf["method"],
        "alpha": conf["alpha"],
        "affine_a": np.asarray(affine_a).tolist(),
        "affine_b": np.asarray(affine_b).tolist(),
    }, indent=2))


def load_conformal(path: str | Path) -> Dict:
    raw = json.loads(Path(path).read_text())
    return {
        "q": np.asarray(raw["q"], dtype=np.float64),
        "method": raw["method"],
        "alpha": float(raw["alpha"]),
        "affine_a": np.asarray(raw["affine_a"], dtype=np.float64),
        "affine_b": np.asarray(raw["affine_b"], dtype=np.float64),
    }


def save_pytree(path: str | Path, leaves: Sequence, meta: Optional[Dict] = None
                ) -> None:
    """Persist arrays (tensors or numpy) in order plus a JSON metadata blob,
    written to `<path>.tmp.npz` and then moved over `path`: the mid-training
    resume state."""
    payload = {f"leaf_{i:05d}": (leaf.detach().cpu().numpy()
                                 if isinstance(leaf, torch.Tensor)
                                 else np.asarray(leaf))
               for i, leaf in enumerate(leaves)}
    payload["meta_json"] = np.array(json.dumps(meta or {}, default=float))
    tmp = Path(str(path) + ".tmp.npz")  # np.savez appends .npz otherwise
    np.savez(tmp, **payload)
    tmp.replace(path)


def load_pytree_meta(path: str | Path) -> Dict:
    """Only the JSON metadata of a `save_pytree` archive (empty for an
    archive without it), to check the layout before loading."""
    with np.load(path, allow_pickle=False) as data:
        if "meta_json" not in data.files:
            return {}
        return json.loads(str(data["meta_json"]))


def count_pytree_leaves(path: str | Path) -> int:
    with np.load(path, allow_pickle=False) as data:
        return sum(1 for k in data.files if k.startswith("leaf_"))


def load_pytree(path: str | Path, template: Sequence
                ) -> Tuple[List[np.ndarray], Dict]:
    """The arrays of a `save_pytree` archive, each in the type of the
    template's array at its place, and the metadata. Raises ValueError
    where the counts differ."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["meta_json"]))
        leaves = [data[k] for k in sorted(k for k in data.files
                                          if k.startswith("leaf_"))]
    if len(leaves) != len(template):
        raise ValueError(f"{path}: {len(leaves)} leaves != template "
                         f"{len(template)}")
    dtypes = [torch.empty((), dtype=t.dtype).numpy().dtype
              if isinstance(t, torch.Tensor) else np.asarray(t).dtype
              for t in template]
    return [np.asarray(leaf, dtype=dt) for leaf, dt in zip(leaves, dtypes)], \
        meta


def member_paths(save_dir: str | Path) -> List[Path]:
    """Sorted model_{i}.npz checkpoints under an ensemble directory."""
    d = Path(save_dir)
    out = []
    i = 0
    while (d / f"model_{i}.npz").exists():
        out.append(d / f"model_{i}.npz")
        i += 1
    return out
