"""Inference CLI, the flags of `gnnep_tpu.cli.predict`:

    python -m gnnep_tpu_torch.cli.predict --mode random --num-samples 5
    python -m gnnep_tpu_torch.cli.predict --mode materials --materials mp-149,mp-2534
    python -m gnnep_tpu_torch.cli.predict --mode custom --input-file materials.json

Runs on the GPU (`--device cuda`, the default) unless `--device cpu` is
given; without a GPU the default raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np

from ..data.store import GraphStore
from ..infer.predict import (Ensemble, load_custom_samples, material_indices,
                             print_results)
from ..train.loop import MIN_LOGVAR_FLOOR


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Ensemble inference (PyTorch/CUDA)")
    p.add_argument("--mode", choices=["random", "materials", "custom"],
                   default="random")
    p.add_argument("--ensemble-dir", default="artifacts/ensemble")
    p.add_argument("--data-dir", default="data/mp_gnn")
    p.add_argument("--num-samples", type=int, default=5)
    p.add_argument("--materials", default="",
                   help="Comma-separated material ids (mode=materials)")
    p.add_argument("--input-file", default=None,
                   help="Custom materials JSON (mode=custom)")
    p.add_argument("--mat2vec-path", default=None,
                   help="Element embedding JSON/NPZ for custom featurization "
                        "of structure entries (without it the checkpoint's "
                        "embedding columns are zero)")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--min-logvar-floor", type=float, default=MIN_LOGVAR_FLOOR)
    p.add_argument("--output-json", default=None)
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="bfloat16 runs the trunk in bf16; float32 matches "
                        "reference inference numerics")
    p.add_argument("--giant-shards", type=int, default=0,
                   help="not ported yet: values > 0 raise")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--heads", type=int, default=None,
                   help="Reference-CLI compatibility: heads come from the "
                        "embedded checkpoint config; validated if given")
    return p


def _reconcile_node_dim(store: GraphStore, node_dim: int) -> GraphStore:
    """Pad/slice dataset node features to the checkpoint's expectation."""
    if store.node_dim == node_dim:
        return store
    x = store.node_feats
    if store.node_dim > node_dim:
        x = x[:, :node_dim].copy()
    else:
        pad = np.zeros((x.shape[0], node_dim - store.node_dim), dtype=x.dtype)
        x = np.concatenate([x, pad], axis=1)
    return dataclasses.replace(store, node_feats=x)


def select_graphs(args: argparse.Namespace, ensemble: Ensemble):
    """(standardized store, indices) that the parsed request asks for."""
    node_dim = ensemble.cfgs[0].node_dim
    if args.mode in ("random", "materials"):
        if not Path(args.data_dir).exists():
            raise FileNotFoundError(f"Dataset directory not found: {args.data_dir}")
        raw = GraphStore.load_dir(args.data_dir)
        raw = _reconcile_node_dim(raw, node_dim)
        store = ensemble.scaler.apply(raw)
        if args.mode == "random":
            rng = np.random.default_rng(args.seed)
            n = min(args.num_samples, store.n_graphs)
            indices = rng.choice(store.n_graphs, size=n, replace=False).tolist()
        else:
            ids = [m.strip() for m in args.materials.split(",") if m.strip()]
            if not ids:
                raise SystemExit("Provide at least one material ID with --materials.")
            indices = material_indices(store, ids)
    else:
        if not args.input_file:
            raise SystemExit("--input-file is required when mode=custom.")
        store = load_custom_samples(args.input_file, ensemble,
                                    args.mat2vec_path)
        indices = list(range(store.n_graphs))
    return store, indices


def main(argv=None):
    args = build_parser().parse_args(argv)
    ensemble = Ensemble.load(args.ensemble_dir, device=args.device)
    if args.heads is not None and args.heads != ensemble.cfgs[0].heads:
        raise SystemExit(f"--heads {args.heads} does not match the "
                         f"checkpoint architecture (heads="
                         f"{ensemble.cfgs[0].heads})")
    store, indices = select_graphs(args, ensemble)
    results = ensemble.predict(store, indices, batch_size=args.batch_size,
                               min_logvar_floor=args.min_logvar_floor,
                               compute_dtype=args.compute_dtype,
                               giant_shards=args.giant_shards)
    print_results(results)
    if args.output_json:
        out = Path(args.output_json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"predictions": results}, indent=2))
        print(f"\nSaved predictions to {out}")
    return results


if __name__ == "__main__":
    main()
