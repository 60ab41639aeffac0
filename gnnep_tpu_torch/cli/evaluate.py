"""Evaluation CLI, the flags of `gnnep_tpu.cli.evaluate` (reference
`evaluate.py:459-499`):

    python -m gnnep_tpu_torch.cli.evaluate --eval-split test
    python -m gnnep_tpu_torch.cli.evaluate --no-plots --device cpu

Runs on the GPU (`--device cuda`, the default) unless `--device cpu` is
given; without a GPU the default raises. Plots need matplotlib; `--no-plots`
runs without it.
"""
from __future__ import annotations

import argparse

from ..evaluate.runner import EvalConfig, run_evaluation
from ..train.loop import MIN_LOGVAR_FLOOR


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate deep ensemble metrics and plots")
    p.add_argument("--ensemble-dir", default="artifacts/ensemble")
    p.add_argument("--data-dir", default="data/mp_gnn")
    p.add_argument("--output-dir", default="artifacts/eval")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--val-frac", type=float, default=0.1)
    p.add_argument("--calib-frac", type=float, default=0.05)
    p.add_argument("--test-frac", type=float, default=0.1)
    p.add_argument("--ensemble-size", type=int, default=5)
    p.add_argument("--eval-split", choices=["train", "val", "calib", "test", "fold"],
                   default="test")
    p.add_argument("--fold-index", type=int, default=0)
    p.add_argument("--min-logvar-floor", type=float, default=MIN_LOGVAR_FLOOR)
    p.add_argument("--coverage-grid", default="0.5,0.6,0.7,0.8,0.9,0.95")
    p.add_argument("--no-plots", action="store_true")
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="bfloat16 runs the trunk in bf16; float32 matches "
                        "reference eval numerics (default)")
    p.add_argument("--giant-shards", type=int, default=0,
                   help="route graphs exceeding the batch budget through "
                        "the boundary-exchange edge partition over N ranks "
                        "(a card each; gloo processes on the CPU) instead "
                        "of ballooning every batch's arenas (0 = off)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    # reference-CLI compatibility: architecture comes from the embedded
    # checkpoint config here (the reference shape-sniffs and needs these);
    # when given they are validated against the checkpoints
    p.add_argument("--heads", type=int, default=None)
    p.add_argument("--layers", type=int, default=None)
    p.add_argument("--num-workers", type=int, default=0,
                   help="Accepted for reference-CLI compatibility; batch "
                        "assembly is in-process arena slicing")
    p.add_argument("--train-subset-ratio", type=float, default=1.0,
                   help="Accepted for reference-CLI compatibility; unused "
                        "here because the saved scaler_state round-trips "
                        "the exact target transform (the reference refits "
                        "it from a reconstructed train subset)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.heads is not None or args.layers is not None:
        from ..infer.predict import Ensemble

        mc = Ensemble.load(args.ensemble_dir, args.device).cfgs[0]
        if args.heads is not None and args.heads != mc.heads:
            raise SystemExit(f"--heads {args.heads} does not match the "
                             f"checkpoint architecture (heads={mc.heads})")
        if args.layers is not None and args.layers != mc.layers:
            raise SystemExit(f"--layers {args.layers} does not match the "
                             f"checkpoint architecture (layers={mc.layers})")
    cfg = EvalConfig(
        ensemble_dir=args.ensemble_dir, data_dir=args.data_dir,
        output_dir=args.output_dir, batch_size=args.batch_size, seed=args.seed,
        val_frac=args.val_frac, calib_frac=args.calib_frac,
        test_frac=args.test_frac, ensemble_size=args.ensemble_size,
        eval_split=args.eval_split, fold_index=args.fold_index,
        min_logvar_floor=args.min_logvar_floor, coverage_grid=args.coverage_grid,
        make_plots=not args.no_plots, compute_dtype=args.compute_dtype,
        giant_shards=args.giant_shards)
    return run_evaluation(cfg, device=args.device)


if __name__ == "__main__":
    main()
