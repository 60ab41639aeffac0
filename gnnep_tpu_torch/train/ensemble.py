"""Deep-ensemble training: setup → members → calibration → artifacts
(the counterpart of `gnnep_tpu.train.ensemble`): members trained one after
another on one device or over a mesh of rank processes (`--data-shards` /
`--edge-shards`), or member-parallel (`--member-parallel vmap|shard`),
with graphs beyond the batch budget routed through the boundary exchange
(`--giant-graphs boundary`).

Orchestration parity with the reference trainer's `main`
(`scripts/train.py:1948-2163`): grouped splits + K-fold member validation,
per-member seeds `seed + i*1007`, bootstrap resampling, per-member
hidden/dropout/LR overrides, mixture aggregation on the calibration split,
affine debias, scaled conformal quantiles, and the artifacts `model_{i}.npz`,
`scaler_state.npz`, `conformal.json` and `train_summary.json`, in the JAX
package's formats.

With `resume`, a member whose `model_{i}.npz` exists is not trained again
(the mid-training resume inside `train_member` covers partial members).
`member_isolation='process'` trains each member in its own
`python -m gnnep_tpu_torch.train.member_proc` process, which derives the
same member from `train_cfg.json`; the parent touches no device before the
members are done.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.batching import BatchBudget, epoch_batches
from ..data.splits import derive_splits
from ..data.store import GraphStore
from ..data.transforms import FeatureScaler, LogTransformer
from ..models.alignn import Alignn, AlignnConfig, DeviceBatch, alignn_embed
from ..utils.device import resolve_device
from .artifacts import (load_member, save_conformal, save_member,
                        save_scaler_state)
from .bins import compute_bin_statistics
from .calibrate import (apply_conformal_intervals, conformal_calibration,
                        ensemble_mixture, fit_affine_debias)
from .config import TrainConfig
from .member import member_mesh, train_member, train_member_on_mesh
from ..parallel.ensemble_vmap import train_members_vmapped
from ..parallel.giant import (GiantSet, MemberRows, build_giant_set,
                              classify_giants)
from ..parallel.mesh import WorldPool
from .metrics import error_stats

N_SG_ONE_HOT = 230


def check_supported(cfg: TrainConfig) -> None:
    """Raise ValueError where options conflict: a member trained over a
    mesh (`--data-shards` × `--edge-shards` > 1) cannot also run
    member-parallel, as in the JAX package. Every option runs: none is
    refused as unported."""
    n_slots = max(int(cfg.data_shards), 1) * max(int(cfg.edge_shards), 1)
    if n_slots > 1 and cfg.member_parallel in ("vmap", "shard"):
        raise ValueError(
            "--data-shards/--edge-shards train each member over a device "
            "mesh and cannot combine with --member-parallel "
            f"'{cfg.member_parallel}' (members would contend for the same "
            "devices). Use sequential members with a mesh, or member "
            "parallelism with single-device members.")


@dataclasses.dataclass
class TrainingSetup:
    """Everything derived from the dataset before member training starts."""

    store: GraphStore            # standardized
    scaler: FeatureScaler
    transformer: LogTransformer
    budget: BatchBudget
    train_idx: List[int]
    val_idx: List[int]
    calib_idx: List[int]
    test_idx: List[int]
    folds: List[List[int]]
    bin_edges: np.ndarray
    bin_weights: np.ndarray
    giant: Optional[GiantSet] = None   # graphs beyond the budget


def prepare(cfg: TrainConfig, store: Optional[GraphStore] = None
            ) -> TrainingSetup:
    """Load/standardize the dataset and derive splits (train.py:1300-1447)."""
    if store is None:
        store = GraphStore.load_dir(cfg.data_dir)
    if not cfg.use_mat2vec and store.node_dim > 6:
        store = dataclasses.replace(store,
                                    node_feats=store.node_feats[:, :6].copy())

    train_idx, val_idx, calib_idx, test_idx, folds = derive_splits(
        store.group_keys(), cfg.seed, cfg.val_frac, cfg.calib_frac,
        cfg.test_frac, cfg.ensemble_size)
    if not train_idx:
        raise ValueError("Training split is empty; adjust fractions or seed.")

    scaler = FeatureScaler.fit(store, train_idx)
    std_store = scaler.apply(store)
    train_targets = store.y[np.asarray(train_idx, dtype=np.int64)]
    transformer = LogTransformer.fit(train_targets)
    bin_edges, bin_weights, _, _ = compute_bin_statistics(
        train_targets, cfg.freq_bins, cfg.freq_gamma, eps=cfg.relative_eps)
    giant = None
    if cfg.giant_graphs == "boundary":
        # the fixpoint classification shared with evaluate and predict,
        # then the cover-all guarantee over the normal population
        _, g_idx, budget = classify_giants(
            std_store, range(std_store.n_graphs),
            lambda pop, ca: BatchBudget.plan(
                std_store, pop, cfg.batch_size, slack=cfg.batch_slack,
                quantile=cfg.batch_quantile, cover_all=ca))
        if g_idx:
            giant = build_giant_set(std_store, g_idx,
                                    n_shards=max(int(cfg.edge_shards), 1))
            if cfg.verbose:
                p = giant.plan
                print(f"[Giant] {len(g_idx)} graph(s) exceed the batch "
                      f"budget; routed via boundary partition over "
                      f"{giant.n_shards} edge shard(s) (plan: rn={p.rn} "
                      f"e_loc={p.e_loc} l_loc={p.l_loc} bn={p.bn} "
                      f"bl={p.bl})")
    else:
        budget = BatchBudget.plan(std_store, range(std_store.n_graphs),
                                  cfg.batch_size, slack=cfg.batch_slack,
                                  quantile=cfg.batch_quantile,
                                  cover_all=True)
    return TrainingSetup(std_store, scaler, transformer, budget, train_idx,
                         val_idx, calib_idx, test_idx, folds, bin_edges,
                         bin_weights, giant)


def model_config(cfg: TrainConfig, store: GraphStore, *,
                 hidden: Optional[int] = None,
                 dropout: Optional[float] = None,
                 budget: Optional[BatchBudget] = None) -> AlignnConfig:
    h = int(hidden if hidden is not None else cfg.hidden)
    if h % cfg.heads != 0:
        raise ValueError(f"Hidden dimension {h} must be divisible by heads "
                         f"({cfg.heads})")
    return AlignnConfig(
        node_dim=store.node_dim, edge_dim=store.edge_dim,
        angle_dim=store.angle_dim,
        global_dim=store.global_scalar_dim + N_SG_ONE_HOT,
        target_dim=store.target_dim, hidden=h, layers=cfg.layers,
        heads=cfg.heads,
        dropout=float(dropout if dropout is not None else cfg.dropout),
        conv_impl=cfg.conv_impl, scan_layers=cfg.scan_layers,
        attn_fused=cfg.attn_fused, attn_eproj=cfg.attn_eproj,
        # the packer's window bounds, carried in the checkpoint as the JAX
        # package carries them (the CUDA kernels read whole CSR ranges)
        edge_win64=budget.edge_win64 if budget else 0,
        lg_win64=budget.lg_win64 if budget else 0,
        edge_src_win64=budget.edge_src_win64 if budget else 0,
        lg_src_win64=budget.lg_src_win64 if budget else 0)


def collect_ensemble(members: Sequence[Alignn], batches, floor: float,
                     device: torch.device, giant: Optional[GiantSet] = None,
                     giant_ids: Sequence[int] = (),
                     pool: Optional[WorldPool] = None):
    """Member forwards → ([M,N,T] means, [M,N,T] vars, [N,T] targets), the
    packed batches fanned out over the visible cards, then the boundary
    forward's rows of `giant_ids` (`parallel.giant.MemberRows`; the same
    order for every member)."""
    means, variances, targets = [], [], None
    with MemberRows(floor, device=device,
                    gset=giant if len(giant_ids) else None,
                    pool=pool) as rows:
        for model in members:
            mean_z, sigma_z, targets, _ = rows(model.to(device), batches,
                                               giant_ids)
            means.append(mean_z)
            variances.append(sigma_z ** 2)
    return np.stack(means), np.stack(variances), targets


def compute_freq_weights(cfg: TrainConfig, setup: TrainingSetup):
    """Per-graph inverse-frequency loss weights (None when --freq-gamma 0)."""
    if cfg.freq_gamma <= 0.0:
        return None
    from .bins import freq_weights_for_store

    return freq_weights_for_store(setup.store.y, setup.bin_edges,
                                  setup.bin_weights)


def member_plan(cfg: TrainConfig, setup: TrainingSetup, i: int):
    """Everything member i's training needs, derived deterministically from
    (cfg, setup). Returns (seed_i, fold_idx, train_i, holdout, model_cfg,
    member_cfg)."""
    full_train = set(setup.train_idx)
    num_folds = len(setup.folds)
    seed_i = cfg.seed + i * 1007
    fold_idx = i % num_folds
    holdout = setup.folds[fold_idx]
    train_i = sorted(full_train - set(holdout)) if num_folds > 1 \
        else setup.train_idx
    ratio = min(max(cfg.train_subset_ratio, 0.0) or 1.0, 1.0)
    if 0.0 < ratio < 1.0 and train_i:
        rng_sub = np.random.default_rng(seed_i)
        keep = max(1, int(round(len(train_i) * ratio)))
        perm = rng_sub.permutation(len(train_i))[:keep]
        train_i = sorted(train_i[j] for j in np.sort(perm))
    mc = model_config(
        cfg, setup.store,
        hidden=cfg.member_override(cfg.member_hiddens, i, cfg.hidden),
        dropout=cfg.member_override(cfg.member_dropouts, i, cfg.dropout),
        budget=setup.budget)
    member_cfg = dataclasses.replace(
        cfg, lr=float(cfg.member_override(cfg.member_lrs, i, cfg.lr)))
    return seed_i, fold_idx, train_i, holdout, mc, member_cfg


# the line a member process prints last, with the optimizer steps it took
_STEPS_LINE = re.compile(r"^\[member_proc (\d+)\] optimizer_steps=(\d+)$")


def write_member_cfg(cfg: TrainConfig, save_dir: Path) -> Path:
    """`train_cfg.json` for the member processes, its path-valued fields
    made absolute (a child runs from the package's root)."""
    cfg_dict = dataclasses.asdict(cfg)
    for f in ("data_dir", "save_dir", "profile_dir"):
        if cfg_dict.get(f):
            cfg_dict[f] = str(Path(cfg_dict[f]).resolve())
    path = save_dir / "train_cfg.json"
    path.write_text(json.dumps(cfg_dict))
    return path


def run_member_process(cfg_path: Path, i: int, device: torch.device) -> int:
    """Train member i in `python -m gnnep_tpu_torch.train.member_proc`,
    with the child's output streamed through this process's; returns the
    optimizer steps the child reports. A child that fails raises."""
    pkg_root = Path(__file__).resolve().parents[2]
    proc = subprocess.Popen(
        [sys.executable, "-m", "gnnep_tpu_torch.train.member_proc",
         str(cfg_path), str(i), device.type],
        cwd=pkg_root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, bufsize=1)
    steps = None
    for line in proc.stdout:
        m = _STEPS_LINE.match(line.rstrip("\n"))
        if m and int(m.group(1)) == i:
            steps = int(m.group(2))
        else:
            print(line, end="", flush=True)
    rc = proc.wait()
    if rc != 0 or steps is None:
        raise RuntimeError(f"member {i} subprocess failed (rc={rc}"
                           + (", no optimizer_steps line)" if rc == 0
                              else ")"))
    return steps


def run_training(cfg: TrainConfig, store: Optional[GraphStore] = None,
                 device=None) -> Dict:
    """Full training pipeline; returns the summary dict (test stats, and the
    optimizer steps each member took in this run: 0 for a member skipped on
    resume). `device` None means CUDA, which must then be available. A
    member's mesh (`--data-shards` × `--edge-shards`) or `shard` mode's
    slots take one card each there. The rank processes of the run's meshes
    start once and serve every member and the calibration."""
    dev = resolve_device(device)
    check_supported(cfg)
    use_proc = cfg.member_isolation == "process"
    if use_proc and store is not None:
        raise ValueError(
            "member_isolation='process' reloads the dataset from "
            "cfg.data_dir in each member subprocess; an in-memory store "
            "argument cannot be forwarded. Pass store=None.")
    t_start = time.time()
    setup = prepare(cfg, store)
    s = setup.store
    save_dir = Path(cfg.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)

    if cfg.verbose:
        print(f"Dataset: {s.n_graphs} graphs | node_dim={s.node_dim} "
              f"edge_dim={s.edge_dim} angle_dim={s.angle_dim}")
        print(f"Splits: train={len(setup.train_idx)} val={len(setup.val_idx)} "
              f"calib={len(setup.calib_idx)} test={len(setup.test_idx)}")
        print(f"Batch budget: {setup.budget}")
        print(f"Device: {dev}")

    freq_weights = compute_freq_weights(cfg, setup)
    if freq_weights is not None and cfg.verbose:
        tw = freq_weights[np.asarray(setup.train_idx, dtype=np.int64)]
        print(f"[Weights] freq-gamma={cfg.freq_gamma}: bin weights over "
              f"{len(setup.train_idx)} train samples | "
              f"mean={tw.mean():.3f} min={tw.min():.3f} max={tw.max():.3f}")
    with WorldPool() as pool:
        if cfg.member_parallel in ("vmap", "shard"):
            members, steps = train_members_vmapped(
                setup, cfg, mode=cfg.member_parallel,
                freq_weights=freq_weights, device=dev, pool=pool)
            if cfg.member_parallel == "vmap":   # shard's ranks wrote theirs
                for i, model in enumerate(members):
                    save_member(save_dir / f"model_{i}.npz", model)
        else:
            members, steps = _train_sequential(
                cfg, setup, freq_weights, dev, save_dir, use_proc,
                member_mesh(cfg, dev), pool)
        summary = _calibrate_and_report(cfg, setup, members, steps, dev,
                                        save_dir, t_start, pool)
    (save_dir / "train_summary.json").write_text(
        json.dumps(summary, indent=2, default=float))
    return summary


def _train_sequential(cfg: TrainConfig, setup: TrainingSetup, freq_weights,
                      dev: torch.device, save_dir: Path, use_proc: bool,
                      mesh, pool: WorldPool):
    """The members one after another (each over `mesh` where it is set, or
    in its own process) → (members on the CPU, optimizer steps each)."""
    s = setup.store
    num_folds = len(setup.folds)
    members: List[Alignn] = []
    steps: List[int] = []
    cfg_path = write_member_cfg(cfg, save_dir) if use_proc else None
    for i in range(cfg.ensemble_size):
        member_path = save_dir / f"model_{i}.npz"
        if cfg.resume and member_path.exists():
            # a member's final artifact exists only after it finished:
            # skipping it is the member-level resume
            try:
                members.append(load_member(member_path, "cpu"))
                steps.append(0)
                if cfg.verbose:
                    print(f"Member {i + 1}/{cfg.ensemble_size}: loaded "
                          f"finished checkpoint {member_path.name}; "
                          "skipping training (resume)")
                continue
            except Exception as exc:
                print(f"Member {i}: existing {member_path.name} "
                      f"unreadable ({exc}); retraining")
        (seed_i, fold_idx, train_i, holdout, mc,
         member_cfg) = member_plan(cfg, setup, i)
        if cfg.verbose:
            print(f"Training ensemble member {i + 1}/{cfg.ensemble_size} "
                  f"(fold {fold_idx + 1}/{num_folds}) with seed {seed_i} | "
                  f"train={len(train_i)} fold_val={len(holdout)}",
                  flush=True)
        if use_proc:
            steps.append(run_member_process(cfg_path, i, dev))
            model = load_member(member_path, "cpu")
        else:
            args = (s, member_cfg, mc, setup.transformer, setup.budget,
                    seed_i, train_i, holdout, freq_weights)
            model, _, n_steps = (
                train_member(*args, device=dev, giant=setup.giant)
                if mesh is None else
                train_member_on_mesh(mesh, pool, *args, giant=setup.giant))
            save_member(member_path, model)
            steps.append(n_steps)
        members.append(model)
    return members, steps


def _calibrate_and_report(cfg: TrainConfig, setup: TrainingSetup, members,
                          steps, dev: torch.device, save_dir: Path,
                          t_start: float, pool: WorldPool) -> Dict:
    """Scaler state, conformal calibration, embeddings and the test report
    → the run's summary; `pool`'s worlds serve the giants' boundary
    forward."""
    s = setup.store
    dims = {"node_dim": s.node_dim, "edge_dim": s.edge_dim,
            "angle_dim": s.angle_dim, "global_scalar_dim": s.global_scalar_dim,
            "sg_dim": N_SG_ONE_HOT, "target_dim": s.target_dim,
            "heads": cfg.heads, "seed": cfg.seed, "val_frac": cfg.val_frac,
            "calib_frac": cfg.calib_frac, "test_frac": cfg.test_frac,
            "ensemble_size": cfg.ensemble_size}
    save_scaler_state(save_dir / "scaler_state.npz", setup.scaler,
                      setup.transformer, dims)

    # --- conformal calibration on the dedicated calib split ----------------
    if not setup.calib_idx:
        raise ValueError("Calibration split is empty; set calib_frac > 0 and "
                         "rerun.")
    calib_norm, calib_giant = (setup.giant.split(setup.calib_idx)
                               if setup.giant else (setup.calib_idx, []))
    calib_batches = (epoch_batches(s, calib_norm, setup.budget,
                                   shuffle=False) if calib_norm else [])
    m_means, m_vars, calib_y = collect_ensemble(
        members, calib_batches, cfg.min_logvar_floor, dev,
        giant=setup.giant, giant_ids=calib_giant, pool=pool)
    mean_z, var_z = ensemble_mixture(m_means, m_vars)
    std_z = np.sqrt(var_z)
    target_z = setup.transformer.transform(calib_y)
    a, b = fit_affine_debias(mean_z, target_z)
    mean_z_cal = mean_z * a + b
    conf = conformal_calibration(
        mean_z_cal, std_z if cfg.conformal_method == "scaled" else None,
        calib_y, setup.transformer, cfg.conformal_alpha, cfg.conformal_method)
    save_conformal(save_dir / "conformal.json", conf, a, b)

    if cfg.save_embeddings:
        _save_embeddings(save_dir, members, s, setup, dev)

    # --- final test report -------------------------------------------------
    summary: Dict = {"members": len(members),
                     "optimizer_steps": int(sum(steps)),
                     "member_optimizer_steps": steps,
                     "device": str(dev),
                     "train_time_s": time.time() - t_start}
    if setup.test_idx:
        test_norm, test_giant = (setup.giant.split(setup.test_idx)
                                 if setup.giant else (setup.test_idx, []))
        test_batches = (epoch_batches(s, test_norm, setup.budget,
                                      shuffle=False) if test_norm else [])
        tm, tv, test_y = collect_ensemble(
            members, test_batches, cfg.min_logvar_floor, dev,
            giant=setup.giant, giant_ids=test_giant, pool=pool)
        mean_zt, var_zt = ensemble_mixture(tm, tv)
        mean_zt = mean_zt * a + b
        std_zt = np.sqrt(var_zt)
        mean_orig, lower, upper = apply_conformal_intervals(
            mean_zt, std_zt if cfg.conformal_method == "scaled" else None,
            conf, setup.transformer)
        stats = error_stats(mean_orig, test_y)
        covered = ((test_y >= lower) & (test_y <= upper)).astype(float)
        summary["test_stats"] = stats
        summary["conformal_coverage"] = {
            "per_target": covered.mean(axis=0).tolist(),
            "overall": float(covered.mean()),
            "target": 1.0 - cfg.conformal_alpha,
        }
        if cfg.verbose:
            print("Test diagnostics (ensemble mean):")
            for label, v in stats.items():
                print(f"  {label}: rmse={v['rmse']:.4f}, mae={v['mae']:.4f}, "
                      f"std={v['std']:.4f}, mean_err={v['mean_error']:.4f}")
            print("Conformal PI coverage:")
            for t, c in enumerate(covered.mean(axis=0)):
                print(f"  target_{t}: {c:.4f}")
            print(f"  overall: {covered.mean():.4f} "
                  f"(target={1.0 - cfg.conformal_alpha:.4f})")
    elif cfg.verbose:
        print("No test split; skipping final evaluation.")
    return summary


def _save_embeddings(save_dir: Path, members: Sequence[Alignn],
                     store: GraphStore, setup: TrainingSetup,
                     device: torch.device) -> None:
    """Ensemble-mean penultimate embeddings per split (reference
    train.py:2125-2131): `embeddings_{split}.npz` with `z` [n_split, H]."""
    splits = {"train": setup.train_idx, "val": setup.val_idx,
              "calib": setup.calib_idx, "test": setup.test_idx}
    for name, idx in splits.items():
        if setup.giant is not None:   # giants: no packed embed pass
            idx = setup.giant.split(idx)[0]
        if not idx:
            continue
        accum = []
        for batch in epoch_batches(store, idx, setup.budget, shuffle=False):
            db = DeviceBatch.from_batch(batch, device)
            z_mean = torch.stack([alignn_embed(m.to(device), db)
                                  for m in members]).mean(dim=0)
            mask = np.asarray(batch.graph_mask) > 0
            accum.append(z_mean.cpu().numpy()[mask])
        np.savez(save_dir / f"embeddings_{name}.npz", z=np.concatenate(accum))
