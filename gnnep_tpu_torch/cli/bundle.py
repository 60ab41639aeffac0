"""Export / serve AOT serving bundles (`infer/bundle.py`), the flags of
`gnnep_tpu.cli.bundle`:

    python -m gnnep_tpu_torch.cli.bundle export --ensemble-dir artifacts/ensemble \
        --data-dir data/mp_gnn --out artifacts/serving --compute-dtype bfloat16
    python -m gnnep_tpu_torch.cli.bundle predict --bundle-dir artifacts/serving \
        --data-dir data/mp_gnn --num-samples 5

`export` writes the ensemble's eval forward as `torch.export` programs into
a self-contained directory (programs + checkpoints + scaler + packing
contract); `predict` serves from such a directory. Both run on the GPU
(`--device cuda`, the default) unless `--device cpu` is given, and a bundle
serves only on the platform it was exported for.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..data.store import GraphStore
from ..infer.bundle import ServingBundle, export_bundle
from ..infer.predict import print_results
from ..utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Export / serve exported (AOT) serving bundles")
    sub = p.add_subparsers(dest="command", required=True)

    e = sub.add_parser("export", help="export an ensemble as a bundle")
    e.add_argument("--ensemble-dir", default="artifacts/ensemble")
    e.add_argument("--data-dir", default="data/mp_gnn",
                   help="dataset supplying the arena statistics the "
                        "programs are specialized to (its packing contract)")
    e.add_argument("--out", default="artifacts/serving")
    e.add_argument("--batch-size", type=int, default=64)
    e.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                   default="float32")
    e.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    s = sub.add_parser("predict", help="serve from a bundle (random dataset "
                                       "samples, or --input-file customs)")
    s.add_argument("--bundle-dir", default="artifacts/serving")
    s.add_argument("--data-dir", default="data/mp_gnn")
    s.add_argument("--input-file", default=None,
                   help="custom-inference JSON (same schema as "
                        "cli.predict --mode custom): serve NEW structures "
                        "through the exported programs, no dataset needed")
    s.add_argument("--mat2vec-path", default=None)
    s.add_argument("--num-samples", type=int, default=5)
    s.add_argument("--seed", type=int, default=42)
    s.add_argument("--output-json", default=None)
    s.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    if args.command == "export":
        store = GraphStore.load_dir(args.data_dir)
        meta = export_bundle(args.ensemble_dir, store, args.out,
                             batch_size=args.batch_size,
                             compute_dtype=args.compute_dtype,
                             device=args.device)
        n_progs = max(meta["member_programs"]) + 1
        print(f"Exported {len(meta['member_programs'])} member(s) / "
              f"{n_progs} program(s) for platform '{meta['platform']}' "
              f"to {args.out}")
        return meta

    bundle = ServingBundle.load(args.bundle_dir, device=args.device)
    if args.input_file:
        from ..infer.predict import load_custom_samples

        store = load_custom_samples(args.input_file, bundle.ensemble,
                                    args.mat2vec_path)
        indices = list(range(store.n_graphs))
    else:
        raw = GraphStore.load_dir(args.data_dir)
        store = bundle.ensemble.scaler.apply(raw)
        rng = np.random.default_rng(args.seed)
        n = min(args.num_samples, store.n_graphs)
        indices = rng.choice(store.n_graphs, size=n, replace=False).tolist()
    results = bundle.predict(store, indices)
    print_results(results)
    if args.output_json:
        out = Path(args.output_json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"predictions": results}, indent=2))
        print(f"\nSaved predictions to {out}")
    return results


if __name__ == "__main__":
    main()
