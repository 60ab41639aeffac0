"""Ensemble inference: `random`, `materials` and `custom` modes.

Counterpart of `gnnep_tpu.infer.predict`: checkpoints alone rebuild the
architecture; `random` samples cached graphs, `materials` selects by MP id,
and `custom` runs the dataset-free path on pymatgen structure dicts
(featurized on the fly) or precomputed raw graph arrays. Uncertainty is the
log-normal linear-space σ with a 90 % Gaussian CI clipped at zero.

Not yet ported: `giant_shards > 0` (the giant-graph slice) raises
`NotImplementedError`.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.batching import BatchBudget, epoch_batches, verify_win64
from ..data.featurize import (BasisConfig, GraphSample, build_graph,
                               load_mat2vec)
from ..data.store import GraphStore
from ..data.structure import Structure
from ..data.transforms import FeatureScaler, LogTransformer
from ..models.alignn import Alignn
from ..train.artifacts import load_member, load_scaler_state, member_paths
from ..train.calibrate import ensemble_mixture
from ..train.loop import (MIN_LOGVAR_FLOOR, cast_model, collect_predictions,
                          make_forward, reconcile_win64, with_config)
from ..utils.device import resolve_device

Z_SCORE_90 = 1.6449  # Φ⁻¹(0.95)
# featurization defaults of a custom structure entry
DEFAULT_NN_METHOD = "crystalnn"
DEFAULT_CUTOFF = 5.0
DEFAULT_FALLBACK_CUTOFF = 7.5


class Ensemble:
    """Loaded ensemble: members on one device + scaler/transformer."""

    def __init__(self, members: List[Alignn], scaler: FeatureScaler,
                 transformer: LogTransformer, meta: Dict,
                 device: torch.device):
        self.members = members
        self.scaler = scaler
        self.transformer = transformer
        self.meta = meta
        self.device = device

    @property
    def cfgs(self):
        return [m.cfg for m in self.members]

    @property
    def dims(self) -> Dict:
        return self.meta.get("dims", {})

    @classmethod
    def load(cls, ensemble_dir: str | Path, device=None) -> "Ensemble":
        """`device` None means CUDA, which must then be available."""
        dev = resolve_device(device)
        d = Path(ensemble_dir)
        if not d.exists():
            raise FileNotFoundError(f"Ensemble directory not found: {d}")
        paths = member_paths(d)
        if not paths:
            raise FileNotFoundError(f"No ensemble checkpoints found under {d}")
        members = [load_member(p, dev) for p in paths]
        scaler, transformer, meta = load_scaler_state(d / "scaler_state.npz")
        if transformer is None:
            raise ValueError("scaler_state.npz lacks log-transform statistics.")
        return cls(members, scaler, transformer, meta, dev)

    def runs(self, budget: BatchBudget, compute_dtype: str) -> List[Alignn]:
        """Each member cast to `compute_dtype` and put under its config
        reconciled to `budget`: the checkpoints embed training-time window
        and span bounds, and served batches are packed to a fresh budget
        (the JAX package's contract: a span member serves on the eproj
        rung). Build them once per run, so that a captured forward keyed
        by the member serves every batch of the run."""
        return [with_config(cast_model(m, compute_dtype),
                            reconcile_win64(m.cfg, budget))
                for m in self.members]

    def predict(self, store: GraphStore, indices: Sequence[int],
                batch_size: int = 32,
                min_logvar_floor: float = MIN_LOGVAR_FLOOR,
                giant_shards: int = 0,
                compute_dtype: str = "float32") -> List[Dict[str, Any]]:
        """Mixture predictions for `indices` of an already-standardized store.
        `compute_dtype='bfloat16'` runs the trunk in bf16; the default f32
        matches the reference's inference numerics."""
        if giant_shards > 0:
            raise NotImplementedError(
                "giant_shards > 0 (the boundary-exchange path for graphs "
                "beyond the batch budget) waits for the giant-graph slice; "
                "see ROADMAP.md")
        budget, batches = pack_batches(store, indices, batch_size)
        runs = self.runs(budget, compute_dtype)
        verify_win64(batches, runs[0].cfg)
        forward = make_forward(min_logvar_floor, compute_dtype)
        member_means, member_vars = [], []
        order = ys = None
        for run in runs:
            mean_z, sigma_z, ys, order = collect_predictions(
                forward, run, batches)
            member_means.append(mean_z)
            member_vars.append(sigma_z ** 2)
        forward.close()
        return format_mixture_results(member_means, member_vars, order, ys,
                                      self.transformer, store)


def pack_batches(store: GraphStore, indices: Sequence[int], batch_size: int):
    """(budget, batches) that `Ensemble.predict` serves `indices` in: one
    budget planned to cover them all, batches in request order."""
    idx = [int(i) for i in indices]
    budget = BatchBudget.plan(store, idx, min(batch_size, len(idx)),
                              cover_all=True)
    return budget, epoch_batches(store, idx, budget, shuffle=False)


def format_mixture_results(member_means, member_vars, order, ys, transformer,
                           store: GraphStore) -> List[Dict[str, Any]]:
    """Mixture aggregation + lognormal linear-space σ + clipped 90 % CI →
    the per-material result dicts."""
    mean_z, var_z = ensemble_mixture(np.stack(member_means),
                                     np.stack(member_vars))
    std_z = np.sqrt(var_z)

    t = transformer
    mean_orig = t.inverse(mean_z)
    log_mean = t.to_log(mean_z)
    log_std = std_z * t.stds
    var_lin = (np.exp(log_std ** 2) - 1.0) * np.exp(2 * log_mean + log_std ** 2)
    std_lin = np.sqrt(np.clip(var_lin, 0.0, None))
    lower = mean_orig - Z_SCORE_90 * std_lin
    upper = mean_orig + Z_SCORE_90 * std_lin

    results = []
    for row, g in enumerate(order):
        mid = store.material_ids[g] if 0 <= g < store.n_graphs else f"sample_{row}"
        y_row = ys[row]
        entry: Dict[str, Any] = {
            "material_id": mid,
            "mu": mean_orig[row].tolist(),
            "sigma": std_lin[row].tolist(),
            "ci90": [{"lower": max(float(lo), 0.0), "upper": float(hi)}
                     for lo, hi in zip(lower[row], upper[row])],
            "prediction": mean_orig[row].tolist(),
            "uncertainty": std_lin[row].tolist(),
        }
        # presence of a target is decided by finiteness; missing components
        # serialize as JSON null, not the non-standard NaN token
        if np.isfinite(y_row).any():
            entry["target"] = [float(v) if np.isfinite(v) else None
                               for v in y_row]
        results.append(entry)
    return results


def load_custom_samples(input_file: str | Path, ensemble: Ensemble,
                        mat2vec_path: Optional[str] = None,
                        rbf_cutoff: float = 8.0,
                        rbf_gamma: Optional[float] = None) -> GraphStore:
    """Parse the custom-inference JSON into a (standardized) GraphStore:
    entries with a pymatgen `structure` dict are featurized here, entries
    with precomputed raw graph arrays are taken as they are.

    The radial/angular basis *sizes* are inferred from the checkpoint's edge
    and angle dimensions (edge_dim = rbf_n + 4, angle_dim = angle_n + 3), so
    custom featurization always matches the trained architecture — the
    reference hardcodes the default basis here (predict.py:403-407). Without
    a mat2vec lookup the embedding columns the checkpoint expects are zero."""
    payload = json.loads(Path(input_file).read_text())
    entries = payload.get("materials", [])
    if not isinstance(entries, list) or not entries:
        raise ValueError("Input JSON must contain a non-empty 'materials' list.")
    cfg = ensemble.cfgs[0]
    node_dim, edge_dim, angle_dim = cfg.node_dim, cfg.edge_dim, cfg.angle_dim
    g_scalar_dim = int(ensemble.dims.get("global_scalar_dim", 59))
    basis = BasisConfig(rbf_n=max(edge_dim - 4, 1), rbf_cutoff=rbf_cutoff,
                        rbf_gamma=rbf_gamma, angle_n=max(angle_dim - 3, 1))
    m2v_dim = max(0, node_dim - 6)
    lookup = load_mat2vec(mat2vec_path) if (m2v_dim and mat2vec_path) else {}
    if m2v_dim and lookup:
        got = len(next(iter(lookup.values())))
        if got != m2v_dim:
            raise ValueError(f"mat2vec dim {got} != checkpoint expectation {m2v_dim}")

    samples: List[GraphSample] = []
    for i, entry in enumerate(entries):
        mid = str(entry.get("material_id", f"custom_{i}"))
        y = _extract_target(entry, cfg.target_dim)
        if "structure" in entry:
            structure = Structure.from_dict(entry["structure"])
            sample = build_graph(
                structure, material_id=mid,
                formula=str(entry.get("formula", "")),
                y=y, basis=basis,
                nn_method=str(entry.get("nn_method", DEFAULT_NN_METHOD)),
                cutoff=float(entry.get("cutoff", DEFAULT_CUTOFF)),
                fallback_cutoff=float(entry.get("fallback_cutoff",
                                                DEFAULT_FALLBACK_CUTOFF)),
                mat2vec=lookup if m2v_dim else None,
                guess_oxidation=bool(entry.get("guess_oxidation", True)))
            if m2v_dim and not lookup:
                pad = np.zeros((sample.n_nodes, m2v_dim), dtype=np.float32)
                sample.node_feats = np.concatenate([sample.node_feats, pad], axis=1)
        elif "x" in entry and "edge_index" in entry:
            sample = _sample_from_raw(entry, mid, y, node_dim, edge_dim,
                                      angle_dim, g_scalar_dim)
        else:
            raise ValueError(f"Material {mid}: provide either 'structure' or "
                             "precomputed graph features ('x', 'edge_index', ...).")
        if sample.node_feats.shape[1] != node_dim:
            raise ValueError(f"Material {mid}: node feature dimension "
                             f"{sample.node_feats.shape[1]} != expected {node_dim}")
        sg_override = entry.get("spacegroup_number")
        if sg_override is not None:
            sg = int(sg_override)
            if not 1 <= sg <= 230:
                raise ValueError(f"Material {mid}: spacegroup_number {sg} "
                                 "outside [1, 230].")
            sample.sg_num = sg
        samples.append(sample)
    store = GraphStore.from_samples(samples, target_dim=cfg.target_dim)
    return ensemble.scaler.apply(store)


def _extract_target(entry: Dict, target_dim: int) -> Optional[np.ndarray]:
    if entry.get("y") is not None:
        vec = np.asarray(entry["y"], dtype=np.float32).reshape(-1)
    else:
        kv = entry.get("k_vrh", entry.get("bulk_modulus"))
        gv = entry.get("g_vrh", entry.get("shear_modulus"))
        if kv is None and gv is None:
            return None
        vec = np.asarray([v for v in (kv, gv) if v is not None], dtype=np.float32)
    if vec.size != target_dim:
        out = np.full(target_dim, np.nan, dtype=np.float32)
        out[:min(vec.size, target_dim)] = vec[:target_dim]
        return out
    return vec


def _sample_from_raw(entry: Dict, mid: str, y, node_dim: int, edge_dim: int,
                     angle_dim: int, g_scalar_dim: int) -> GraphSample:
    x = np.asarray(entry["x"], dtype=np.float32)
    if x.ndim != 2 or x.shape[1] != node_dim:
        raise ValueError(f"Material {mid}: node feature dimension "
                         f"{x.shape[-1] if x.ndim else 0} does not match expected {node_dim}.")
    ei = np.asarray(entry["edge_index"], dtype=np.int64)
    if ei.ndim != 2:
        raise ValueError(f"Material {mid}: edge_index must be 2-D.")
    if ei.shape[0] != 2:          # rows are (src, dst) pairs → transpose
        ei = ei.T
    n_edges = ei.shape[1]
    ea = entry.get("edge_attr")
    edge_attr = (np.zeros((n_edges, edge_dim), dtype=np.float32) if ea is None
                 else np.asarray(ea, dtype=np.float32).reshape(-1, edge_dim))
    if edge_attr.shape[0] != n_edges:
        raise ValueError(f"Material {mid}: edge_attr shape {edge_attr.shape} does not "
                         f"match (num_edges, edge_dim)=({n_edges}, {edge_dim}).")
    lgi = entry.get("lg_edge_index")
    lg = (np.asarray(lgi, dtype=np.int64) if lgi else np.zeros((2, 0), dtype=np.int64))
    if lg.size and lg.shape[0] != 2:
        lg = lg.T
    n_lg = lg.shape[1]
    la = entry.get("lg_edge_attr")
    lg_attr = (np.zeros((n_lg, angle_dim), dtype=np.float32) if la is None
               else np.asarray(la, dtype=np.float32).reshape(-1, angle_dim))
    if lg_attr.shape[0] != n_lg:
        raise ValueError(f"Material {mid}: lg_edge_attr shape {lg_attr.shape} does not "
                         f"match (num_lg_edges, angle_dim)=({n_lg}, {angle_dim}).")
    gx = np.asarray(entry.get("global_x", [0.0] * g_scalar_dim),
                    dtype=np.float32).reshape(-1)
    if gx.size != g_scalar_dim:
        raise ValueError(f"Material {mid}: global_x length mismatch "
                         f"(expected {g_scalar_dim}).")
    sg_num = 0
    soh = entry.get("sg_one_hot")
    if soh is not None:
        soh = np.asarray(soh, dtype=np.float32).reshape(-1)
        if soh.size != 230:
            raise ValueError(f"Material {mid}: sg_one_hot length mismatch (expected 230).")
        nz = np.nonzero(soh)[0]
        sg_num = int(nz[0]) + 1 if nz.size else 0
    return GraphSample(
        material_id=mid, formula=str(entry.get("formula", "")),
        reduced_formula="", prototype="",
        node_feats=x, edge_src=ei[0].astype(np.int32), edge_dst=ei[1].astype(np.int32),
        edge_attr=edge_attr, lg_src=lg[0].astype(np.int32), lg_dst=lg[1].astype(np.int32),
        lg_attr=lg_attr, global_scalars=gx, sg_num=sg_num, y=y)


def material_indices(store: GraphStore, material_ids: Sequence[str]) -> List[int]:
    id_to_idx = {mid: i for i, mid in enumerate(store.material_ids)}
    missing = [m for m in material_ids if m not in id_to_idx]
    if missing:
        raise KeyError(f"Material ids not in dataset: {missing}")
    return [id_to_idx[m] for m in material_ids]


def print_results(results: Sequence[Dict[str, Any]]) -> None:
    header = (f"{'Material ID':<20} {'mu_K':>10} {'mu_G':>10} "
              f"{'sigma_K':>10} {'sigma_G':>10} "
              f"{'CI90_K':>20} {'CI90_G':>20} {'true_K':>10} {'true_G':>10}")
    print(header)
    print("-" * len(header))
    for e in results:
        mu, sig, ci = e["mu"], e["sigma"], e["ci90"]
        tgt = e.get("target") or [float("nan"), float("nan")]

        def f(v):
            return f"{v:.3f}" if isinstance(v, (int, float)) and math.isfinite(v) else "N/A"

        def ci_str(c):
            return f"[{c['lower']:.2f}, {c['upper']:.2f}]"

        mu = (mu + [float("nan")])[:2]
        sig = (sig + [float("nan")])[:2]
        tgt = (list(tgt) + [float("nan")])[:2]
        print(f"{e['material_id']:<20} {f(mu[0]):>10} {f(mu[1]):>10} "
              f"{f(sig[0]):>10} {f(sig[1]):>10} "
              f"{ci_str(ci[0]):>20} {ci_str(ci[1]) if len(ci) > 1 else 'N/A':>20} "
              f"{f(tgt[0]):>10} {f(tgt[1]):>10}")
