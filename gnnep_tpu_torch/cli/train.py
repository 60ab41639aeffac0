"""Training CLI, the flags of `gnnep_tpu.cli.train`:

    python -m gnnep_tpu_torch.cli.train --data-dir data/mp_gnn --ensemble-size 5

Runs on the GPU (`--device cuda`, the default) unless `--device cpu` is
given; without a GPU the default raises. Every flag runs: on the card a
mesh slot (`--data-shards` × `--edge-shards`) or a shard-mode member takes
its own card (fewer visible cards raise a ValueError), on the CPU any
number of slots run as gloo processes. A mesh and member parallelism
conflict, as in the JAX package (`train.ensemble.check_supported`);
`--prng-impl` and `--flat-opt` are TPU stream and layout choices,
accepted and ignored (`--flat-opt` with giants raises, as in JAX).
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from ..train.config import TrainConfig
from ..train.ensemble import run_training
from ..train.loop import MIN_LOGVAR_FLOOR


def _parse_list(raw: Optional[str], cast, name: str, n: int) -> Optional[List]:
    if not raw:
        return None
    cleaned = str(raw).replace("[", "").replace("]", "")
    parts = [p.strip() for p in cleaned.split(",") if p.strip()]
    if len(parts) != n:
        raise SystemExit(f"{name} expects {n} entries, got {len(parts)}")
    return [cast(p) for p in parts]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Deep Ensemble + Heteroscedastic NLL + Conformal calibration "
                    "(PyTorch/CUDA)")
    p.add_argument("--data-dir", default="data/mp_gnn")
    p.add_argument("--save-dir", default="artifacts/ensemble")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--dropout", type=float, default=0.15)
    p.add_argument("--ensemble-size", type=int, default=5)
    p.add_argument("--member-dropouts", default=None)
    p.add_argument("--member-lrs", default=None)
    p.add_argument("--member-hiddens", default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--val-frac", type=float, default=0.1)
    p.add_argument("--calib-frac", type=float, default=0.05)
    p.add_argument("--test-frac", type=float, default=0.1)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--lr-min", type=float, default=1e-5)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--warmup-epochs", type=int, default=2)
    p.add_argument("--sigma-warmup-epochs", type=int, default=8)
    p.add_argument("--sigma-lr-max", type=float, default=3e-4)
    p.add_argument("--optimizer", choices=["adam", "adamw"], default="adamw")
    p.add_argument("--min-logvar-floor", type=float, default=MIN_LOGVAR_FLOOR)
    p.add_argument("--log-sigma-l2", type=float, default=0.1)
    p.add_argument("--feature-jitter-std", type=float, default=0.1)
    p.add_argument("--freq-bins", type=int, default=6)
    p.add_argument("--freq-gamma", type=float, default=0.0)
    p.add_argument("--relative-eps", type=float, default=1e-6)
    p.add_argument("--early-stop", type=int, default=20)
    p.add_argument("--delta-mae", type=float, default=1.0)
    p.add_argument("--delta-mae-reset", type=float, default=1.0)
    p.add_argument("--delta-ece", type=float, default=0.01)
    p.add_argument("--delta-coverage", type=float, default=0.02)
    p.add_argument("--no-bootstrap-train", action="store_true")
    p.add_argument("--bootstrap-ratio", type=float, default=1.3)
    p.add_argument("--train-subset-ratio", type=float, default=1.0)
    p.add_argument("--disable-mat2vec", action="store_true")
    p.add_argument("--conformal-alpha", type=float, default=0.1)
    p.add_argument("--conformal-method", choices=["scaled", "absolute"],
                   default="scaled")
    p.add_argument("--enable-density-weighting", action="store_true")
    p.add_argument("--disable-density-weighting", action="store_true",
                   help="Explicitly disable KNN density weighting (default state)")
    p.add_argument("--weight-warmup-epochs", type=int, default=8)
    p.add_argument("--knn-k", type=int, default=20)
    p.add_argument("--knn-eps", type=float, default=1e-6)
    p.add_argument("--knn-alpha", type=float, default=0.75)
    p.add_argument("--knn-beta", type=float, default=1.0)
    p.add_argument("--knn-weight-min", type=float, default=0.2)
    p.add_argument("--knn-weight-max", type=float, default=1.0)
    p.add_argument("--knn-refresh", type=int, default=5)
    p.add_argument("--knn-coverage-audit", action="store_true",
                   help="Audit weight map coverage before activation")
    p.add_argument("--knn-coverage-max-batches", type=int, default=0,
                   help="Max batches to audit (0=full train)")
    p.add_argument("--num-workers", type=int, default=0,
                   help="Accepted for reference-CLI compatibility; batches "
                        "are assembled in-process (see --pack-workers)")
    p.add_argument("--pack-workers", type=int, default=4,
                   help="Threads for epoch batch assembly (1 = serial)")
    p.add_argument("--save-embeddings", action="store_true")
    p.add_argument("--member-parallel",
                   choices=["sequential", "vmap", "shard"],
                   default="sequential",
                   help="vmap: the members in lock-step on one device, "
                        "their steps one captured graph; shard: one "
                        "member a slot (a card each, or gloo processes "
                        "on the CPU)")
    p.add_argument("--giant-graphs", choices=["error", "boundary"],
                   default="error",
                   help="'boundary' sizes batch arenas to typical statistics "
                        "and trains/predicts graphs exceeding them via the "
                        "boundary-exchange edge partition over --edge-shards "
                        "ranks (default: such graphs balloon the budget or "
                        "error)")
    p.add_argument("--data-shards", type=int, default=1,
                   help="Data-parallel slots per member: each optimizer "
                        "step takes data-shards × edge-shards packed "
                        "sub-batches, one rank process a slot, one "
                        "gradient all-reduce (1 = single device)")
    p.add_argument("--edge-shards", type=int, default=1,
                   help="Edge-partition slots (the mesh's inner axis). "
                        "With --giant-graphs boundary this is also the "
                        "boundary-exchange partition width for graphs "
                        "exceeding the batch budget")
    p.add_argument("--member-isolation", choices=["none", "process"],
                   default="none",
                   help="'process' trains each member in a subprocess "
                        "(python -m gnnep_tpu_torch.train.member_proc): "
                        "what a member holds on the card is freed when its "
                        "process ends")
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                   default="float32")
    p.add_argument("--conv-impl", choices=["table", "fused", "coo"],
                   default="table",
                   help="All three run the CUDA kernels on the card; on "
                        "the CPU, training runs their plain versions")
    # env vars act only as CLI defaults here — the chosen values live in
    # TrainConfig/AlignnConfig (no os.environ reads inside ops/)
    import os as _os
    p.add_argument("--no-attn-fused", dest="attn_fused", action="store_false",
                   default=_os.environ.get("GNNEP_ATTN_FUSED", "1") != "0",
                   help="With --conv-impl fused: the external-logits rung "
                        "(its own CUDA kernels); ignored otherwise, as in "
                        "the JAX package")
    p.add_argument("--no-attn-eproj", dest="attn_eproj", action="store_false",
                   default=_os.environ.get("GNNEP_ATTN_EPROJ", "1") != "0",
                   help="With --conv-impl fused: the kv+e rung (its own "
                        "CUDA kernels); ignored otherwise, as in the JAX "
                        "package")
    p.add_argument("--prng-impl", choices=["rbg", "threefry2x32"],
                   default="rbg",
                   help="Accepted and ignored: a TPU PRNG stream choice. "
                        "The port draws dropout and jitter from one "
                        "torch.Generator per member, seeded from its seed")
    p.add_argument("--scan-layers", action="store_true",
                   help="Accepted and carried in the checkpoint config; "
                        "the port runs the layers as one loop either way")
    p.add_argument("--flat-opt", action="store_true",
                   help="Accepted and ignored: a TPU parameter-layout "
                        "choice. The port's optimizer tail always runs per "
                        "leaf, with the same numerics")
    p.add_argument("--scan-steps", type=int, default=8,
                   help="Run K optimizer steps back to back and read "
                        "their metrics back once (0/1 = read after every "
                        "step)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="Save mid-training resume state every N epochs (0=off)")
    p.add_argument("--resume", action="store_true",
                   help="Resume member training from saved resume state")
    p.add_argument("--profile-dir", default="",
                   help="Write a torch.profiler trace (Chrome trace JSON) of "
                        "the first epoch here")
    p.add_argument("--batch-quantile", type=float, default=0.95)
    p.add_argument("--batch-slack", type=float, default=1.15)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default) runs the CUDA kernels; cpu runs "
                        "their plain PyTorch versions")
    return p


def config_from_args(args) -> TrainConfig:
    n = int(args.ensemble_size)
    return TrainConfig(
        data_dir=args.data_dir, save_dir=args.save_dir,
        batch_size=args.batch_size, epochs=args.epochs, hidden=args.hidden,
        layers=args.layers, heads=args.heads, dropout=args.dropout,
        ensemble_size=n,
        member_dropouts=_parse_list(args.member_dropouts, float, "--member-dropouts", n),
        member_lrs=_parse_list(args.member_lrs, float, "--member-lrs", n),
        member_hiddens=_parse_list(args.member_hiddens, int, "--member-hiddens", n),
        seed=args.seed, val_frac=args.val_frac, calib_frac=args.calib_frac,
        test_frac=args.test_frac, lr=args.lr, lr_min=args.lr_min,
        weight_decay=args.weight_decay, warmup_epochs=args.warmup_epochs,
        sigma_warmup_epochs=args.sigma_warmup_epochs, sigma_lr_max=args.sigma_lr_max,
        optimizer=args.optimizer, min_logvar_floor=args.min_logvar_floor,
        log_sigma_l2=args.log_sigma_l2, feature_jitter_std=args.feature_jitter_std,
        freq_bins=args.freq_bins, freq_gamma=args.freq_gamma,
        relative_eps=args.relative_eps, early_stop=args.early_stop,
        delta_mae=args.delta_mae, delta_mae_reset=args.delta_mae_reset,
        delta_ece=args.delta_ece, delta_coverage=args.delta_coverage,
        bootstrap=not args.no_bootstrap_train, bootstrap_ratio=args.bootstrap_ratio,
        train_subset_ratio=args.train_subset_ratio,
        use_mat2vec=not args.disable_mat2vec,
        conformal_alpha=args.conformal_alpha, conformal_method=args.conformal_method,
        enable_density_weighting=(args.enable_density_weighting
                                  and not args.disable_density_weighting),
        weight_warmup_epochs=args.weight_warmup_epochs, knn_k=args.knn_k,
        knn_eps=args.knn_eps, knn_alpha=args.knn_alpha, knn_beta=args.knn_beta,
        knn_weight_min=args.knn_weight_min, knn_weight_max=args.knn_weight_max,
        knn_refresh=args.knn_refresh,
        knn_coverage_audit=args.knn_coverage_audit,
        knn_coverage_max_batches=args.knn_coverage_max_batches,
        save_embeddings=args.save_embeddings,
        conv_impl=args.conv_impl, scan_layers=args.scan_layers,
        flat_opt=args.flat_opt,
        attn_fused=args.attn_fused, attn_eproj=args.attn_eproj,
        prng_impl=args.prng_impl, pack_workers=args.pack_workers,
        compute_dtype=args.compute_dtype, checkpoint_every=args.checkpoint_every,
        resume=args.resume, profile_dir=args.profile_dir,
        member_parallel=args.member_parallel,
        member_isolation=args.member_isolation,
        data_shards=args.data_shards, edge_shards=args.edge_shards,
        giant_graphs=args.giant_graphs,
        batch_quantile=args.batch_quantile,
        batch_slack=args.batch_slack, scan_steps=args.scan_steps,
        verbose=not args.quiet)


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    print("==== Training configuration ====")
    for key in sorted(vars(args)):
        print(f"{key}: {getattr(args, key)}")
    print("================================")
    return run_training(cfg, device=args.device)


if __name__ == "__main__":
    main()
