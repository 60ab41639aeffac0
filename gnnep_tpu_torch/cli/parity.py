"""Parity-on-contact harness: one command from an MP dump to the
delta-vs-reference accuracy table (the counterpart of
`gnnep_tpu.cli.parity`, with the same flags, reference table and `--smoke`
shrink, plus `--device`).

The reference publishes its pretrained-ensemble test metrics in its
README. With a Materials Project dump at hand, the parity claim is one run
away:

    python -m gnnep_tpu_torch.cli.parity --mp-dump mp_dump.json --work-dir runs/parity

It (1) ingests the dump offline (`fetch --from-json` schema: a JSON list of
pymatgen `Structure.as_dict()` entries with k_vrh/g_vrh targets), (2) trains
the flagship 5-member ensemble with reference defaults (hidden 256, 4
layers, 4 heads, 60 epochs, bootstrap 1.3, conformal α=0.1), (3) evaluates
the test split, and (4) emits `parity_report.json` plus a printed table of
reference vs ours vs delta for every published metric.

`--smoke` shrinks everything (2 members, tiny model, 2 epochs) to dry-run
the whole path end to end. The evaluation writes its plots
(`EvalConfig.make_plots`, as in the JAX package), so the harness needs
matplotlib.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

# Reference pretrained-ensemble test metrics (README.md:236-242), keyed by
# (our metrics.json field, reference value per target).
REFERENCE_TABLE = {
    "rmse": {"bulk_modulus": 18.48, "shear_modulus": 17.72},
    "mae": {"bulk_modulus": 8.85, "shear_modulus": 9.67},
    "r2": {"bulk_modulus": 0.938, "shear_modulus": 0.831},
    "gaussian_nll": {"bulk_modulus": 0.394, "shear_modulus": 0.298},
    "ece_gaussian": {"bulk_modulus": 0.179, "shear_modulus": 0.069},
    "coverage_gaussian_90": {"bulk_modulus": 0.968, "shear_modulus": 0.926},
    "conformal_coverage": {"bulk_modulus": 0.898, "shear_modulus": 0.915},
}
# metrics where larger is better (delta sign convention: + = we are better)
_HIGHER_BETTER = {"r2"}
# calibration metrics: closeness to target matters, not direction
_TARGETS = {"coverage_gaussian_90": 0.90, "conformal_coverage": 0.90}


def build_delta_table(metrics: dict) -> list:
    """Rows of (metric, target, reference, ours, delta, better?) from an
    evaluate-runner metrics.json dict."""
    rows = []
    for metric, per_target in REFERENCE_TABLE.items():
        for target, ref_val in per_target.items():
            ours = metrics.get("per_target", {}).get(target, {}).get(metric)
            if ours is None:
                rows.append((metric, target, ref_val, None, None, None))
                continue
            ours = float(ours)
            if metric in _TARGETS:
                goal = _TARGETS[metric]
                delta = abs(ours - goal) - abs(ref_val - goal)
                better = delta <= 0
            elif metric in _HIGHER_BETTER:
                delta = ours - ref_val
                better = delta >= 0
            else:
                delta = ours - ref_val
                better = delta <= 0
            rows.append((metric, target, ref_val, ours, delta, better))
    return rows


def print_delta_table(rows) -> None:
    hdr = (f"{'metric':<22} {'target':<14} {'reference':>10} {'ours':>10} "
           f"{'delta':>9}  verdict")
    print(hdr)
    print("-" * len(hdr))
    for metric, target, ref_val, ours, delta, better in rows:
        if ours is None:
            print(f"{metric:<22} {target:<14} {ref_val:>10.3f} {'n/a':>10}")
            continue
        verdict = "OK (≥ reference)" if better else "behind reference"
        print(f"{metric:<22} {target:<14} {ref_val:>10.3f} {ours:>10.3f} "
              f"{delta:>+9.3f}  {verdict}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="MP-dump → flagship ensemble → delta-vs-reference table")
    p.add_argument("--mp-dump", required=True,
                   help="JSON dump in the fetch --from-json schema")
    p.add_argument("--work-dir", default="runs/parity")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--ensemble-size", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--nn-method", default="crystalnn",
                   help="falls back to cutoff graphs when pymatgen is absent")
    p.add_argument("--fetch-workers", type=int, default=4)
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--smoke", action="store_true",
                   help="tiny end-to-end dry run (2 members, hidden 32, "
                        "2 epochs) to validate the wiring")
    p.add_argument("--skip-fetch", action="store_true",
                   help="reuse an already-built <work-dir>/data store")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default) trains and evaluates on the GPU; cpu "
                        "runs the kernels' plain PyTorch versions")
    args = p.parse_args(argv)

    work = Path(args.work_dir)
    data_dir = work / "data"
    ens_dir = work / "ensemble"
    eval_dir = work / "eval"
    work.mkdir(parents=True, exist_ok=True)

    # 1) ingest the dump through the real fetch CLI (offline path)
    if not args.skip_fetch:
        from . import fetch as fetch_cli
        fetch_cli.main(["--out-dir", str(data_dir),
                        "--from-json", str(args.mp_dump),
                        "--nn-method", args.nn_method,
                        "--fetch-workers", str(args.fetch_workers),
                        "--skip-existing"])

    # 2) flagship training with reference defaults (train.py:1082-1174)
    from ..train.config import TrainConfig
    from ..train.ensemble import run_training

    if args.smoke:
        cfg = TrainConfig(
            data_dir=str(data_dir), save_dir=str(ens_dir),
            batch_size=min(args.batch_size, 8), epochs=2, ensemble_size=2,
            hidden=32, layers=1, heads=2, seed=args.seed,
            # wider fracs: tiny smoke datasets must still land ≥1 group in
            # the calib/test splits (whole-group allocation)
            val_frac=0.15, calib_frac=0.1, test_frac=0.15,
            compute_dtype="float32", verbose=True)
    else:
        cfg = TrainConfig(
            data_dir=str(data_dir), save_dir=str(ens_dir),
            batch_size=args.batch_size, epochs=args.epochs,
            ensemble_size=args.ensemble_size, seed=args.seed,
            compute_dtype=args.compute_dtype, conv_impl="fused",
            scan_steps=30, verbose=True)
    run_training(cfg, device=args.device)

    # 3) evaluate the test split with the full metric suite
    from ..evaluate.runner import EvalConfig, run_evaluation

    metrics = run_evaluation(EvalConfig(
        ensemble_dir=str(ens_dir), data_dir=str(data_dir),
        output_dir=str(eval_dir), seed=args.seed,
        val_frac=cfg.val_frac, calib_frac=cfg.calib_frac,
        test_frac=cfg.test_frac,
        ensemble_size=cfg.ensemble_size, eval_split="test",
        batch_size=cfg.batch_size), device=args.device)

    # 4) delta table vs the reference's published numbers
    rows = build_delta_table(metrics)
    print()
    print("Parity vs reference pretrained ensemble "
          "(reference README.md:236-242):")
    print_delta_table(rows)
    report = {
        "reference_source": "README.md:236-242 (pretrained ensemble, MP test split)",
        "dump": str(args.mp_dump),
        "smoke": bool(args.smoke),
        "rows": [{"metric": m, "target": t, "reference": r, "ours": o,
                  "delta": d, "at_or_above_reference": b}
                 for m, t, r, o, d, b in rows],
        "metrics": metrics,
    }
    (work / "parity_report.json").write_text(json.dumps(report, indent=2,
                                                        default=float))
    print(f"\nReport -> {work / 'parity_report.json'}")
    # a missing metric (better=None, e.g. no calib split -> no conformal
    # coverage) is NOT "at or above" — count only explicit wins
    ahead = [r for r in rows if r[5] is True]
    missing = [r for r in rows if r[5] is None]
    line = f"{len(ahead)}/{len(rows)} metrics at or above the reference."
    if missing:
        line += f" ({len(missing)} not computed this run)"
    print(line + (" (smoke run: numbers not meaningful)"
                  if args.smoke else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
