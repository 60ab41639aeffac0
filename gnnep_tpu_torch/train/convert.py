"""Convert reference (PyTorch/PyG) artifacts into the checkpoint schema both
packages read (the counterpart of `gnnep_tpu.train.convert`):

- ``scaler_state.pt``  → ``scaler_state.npz``  (feature scaler + log transform)
- ``conformal.pt``     → ``conformal.json``    (q, method, α, affine debias)
- ``model_{i}.pt``     → ``model_{i}.npz``     (HeteroAlignnRegressor state
  dict → an `Alignn`; weights transposed to [in, out], PyG
  ``TransformerConv`` linears mapped onto the conv's parameters)

The `.pt` files are read with ``torch.load(weights_only=True)``: tensors,
numbers, strings and containers of them, nothing else is unpickled. The
architecture is inferred from tensor shapes, as the reference's own
evaluate/predict do; ``heads`` is the one hyperparameter not recoverable
from shapes and must be supplied.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from ..data.transforms import FeatureScaler, LogTransformer
from ..models.alignn import Alignn, AlignnConfig
from .artifacts import save_conformal, save_member, save_scaler_state


def _load_pt(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t.astype(np.float32)
    return np.asarray(t.detach().float().cpu().numpy(), dtype=np.float32)


def convert_scaler_state(pt_path: str | Path, out_path: str | Path
                         ) -> Tuple[FeatureScaler, LogTransformer]:
    """scaler_state.pt → scaler_state.npz (keys match 1:1, train.py:1421-1435)."""
    raw = _load_pt(pt_path)
    state = {k: _np(raw[k]) for k in ("scalar_mean", "scalar_std",
                                      "embed_mean", "embed_std",
                                      "global_mean", "global_std")
             if raw.get(k) is not None}
    scaler = FeatureScaler.from_state_dict(state)
    transformer = None
    if raw.get("target_transform") == "log" and "log_transform" in raw:
        transformer = LogTransformer.from_state_dict(
            {"means": _np(raw["log_transform"]["means"]),
             "stds": _np(raw["log_transform"]["stds"])})
    save_scaler_state(out_path, scaler, transformer)
    return scaler, transformer


def convert_conformal(pt_path: str | Path, out_path: str | Path) -> Dict:
    """conformal.pt → conformal.json ({q, method, alpha, affine_a/b})."""
    raw = _load_pt(pt_path)
    conf = {"q": _np(raw["q"]), "method": str(raw["method"]),
            "alpha": float(raw["alpha"])}
    save_conformal(out_path, conf, _np(raw["affine_a"]), _np(raw["affine_b"]))
    conf["affine_a"] = _np(raw["affine_a"])
    conf["affine_b"] = _np(raw["affine_b"])
    return conf


# PyG TransformerConv linears (torch [out, in]) → the conv's parameters
# ([in, out]); lin_edge and lin_beta are bias-free (train.py:308,326)
_CONV = (("w_query", "lin_query.weight"), ("b_query", "lin_query.bias"),
         ("w_key", "lin_key.weight"), ("b_key", "lin_key.bias"),
         ("w_value", "lin_value.weight"), ("b_value", "lin_value.bias"),
         ("w_edge", "lin_edge.weight"),
         ("w_skip", "lin_skip.weight"), ("b_skip", "lin_skip.bias"),
         ("w_beta", "lin_beta.weight"))


def convert_member_state(state: Dict, *, heads: int,
                         dropout: float = 0.15) -> Tuple[Alignn, AlignnConfig]:
    """HeteroAlignnRegressor state dict → (member, AlignnConfig).

    `state` maps reference parameter names (train.py:303-401,528-586) to
    arrays or tensors. The base model's unused `output_heads` (the hetero
    wrapper never calls them, train.py:579-586) are dropped."""
    sd = {k: _np(v) for k, v in state.items()}

    def T(k):
        return sd[k].T.copy()

    node_dim, hidden = T("base.node_encoder.0.weight").shape
    edge_dim = sd["base.edge_encoder.0.weight"].shape[1]
    angle_dim = sd["base.angle_encoder.0.weight"].shape[1]
    layers = 1 + max(int(m.group(1)) for k in sd
                     if (m := re.match(r"base\.edge_blocks\.(\d+)\.", k)))
    global_dim = sd["base.feat_proj.0.weight"].shape[1] - hidden
    target_dim = 1 + max(int(m.group(1)) for k in sd
                         if (m := re.match(r"mean_heads\.(\d+)\.", k)))

    named: Dict[str, np.ndarray] = {}
    for ours, ref in (("node_enc", "base.node_encoder"),
                      ("edge_enc", "base.edge_encoder"),
                      ("angle_enc", "base.angle_encoder")):
        named.update({f"{ours}.w0": T(f"{ref}.0.weight"),
                      f"{ours}.b0": sd[f"{ref}.0.bias"],
                      f"{ours}.w1": T(f"{ref}.2.weight"),
                      f"{ours}.b1": sd[f"{ref}.2.bias"]})
    named["feat_proj.w"] = T("base.feat_proj.0.weight")
    named["feat_proj.b"] = sd["base.feat_proj.0.bias"]
    for ours, ref in (("mean_head", "mean_heads"),
                      ("logvar_head", "logvar_heads")):
        named[f"{ours}.w"] = np.concatenate(
            [T(f"{ref}.{t}.weight") for t in range(target_dim)], axis=1)
        named[f"{ours}.b"] = np.concatenate(
            [sd[f"{ref}.{t}.bias"] for t in range(target_dim)])
    for i in range(layers):
        for ours, ref in ((f"edge_blocks.{i}", f"base.edge_blocks.{i}"),
                          (f"node_blocks.{i}", f"base.node_blocks.{i}")):
            for field, lin in _CONV:
                key = f"{ref}.conv.{lin}"
                named[f"{ours}.conv.{field}"] = (
                    T(key) if field.startswith("w_") else sd[key])
            named[f"{ours}.ln_scale"] = sd[f"{ref}.norm.weight"]
            named[f"{ours}.ln_bias"] = sd[f"{ref}.norm.bias"]
        named[f"node_blocks.{i}.edge_proj_w"] = T(
            f"base.node_blocks.{i}.edge_proj.weight")
        named[f"node_blocks.{i}.edge_proj_b"] = sd[
            f"base.node_blocks.{i}.edge_proj.bias"]
    cfg = AlignnConfig(node_dim=node_dim, edge_dim=edge_dim,
                       angle_dim=angle_dim, global_dim=global_dim,
                       target_dim=target_dim, hidden=hidden, layers=layers,
                       heads=heads, dropout=dropout)
    model = Alignn(cfg)
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in named.items()})
    return model, cfg


def convert_ensemble(ref_dir: str | Path, out_dir: str | Path, *,
                     heads: int = 4, dropout: float = 0.15,
                     verbose: bool = True) -> int:
    """Convert a full reference ensemble directory. Returns the number of
    member checkpoints converted (0 if none present)."""
    ref_dir, out_dir = Path(ref_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if (ref_dir / "scaler_state.pt").exists():
        convert_scaler_state(ref_dir / "scaler_state.pt",
                             out_dir / "scaler_state.npz")
        if verbose:
            print(f"converted scaler_state.pt -> {out_dir/'scaler_state.npz'}")
    if (ref_dir / "conformal.pt").exists():
        convert_conformal(ref_dir / "conformal.pt", out_dir / "conformal.json")
        if verbose:
            print(f"converted conformal.pt -> {out_dir/'conformal.json'}")
    n = 0
    while (ref_dir / f"model_{n}.pt").exists():
        state = _load_pt(ref_dir / f"model_{n}.pt")
        model, cfg = convert_member_state(state, heads=heads, dropout=dropout)
        save_member(out_dir / f"model_{n}.npz", model)
        if verbose:
            print(f"converted model_{n}.pt -> {out_dir/f'model_{n}.npz'} "
                  f"(hidden={cfg.hidden} layers={cfg.layers})")
        n += 1
    return n
