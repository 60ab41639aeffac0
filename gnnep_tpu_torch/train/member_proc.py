"""Subprocess entry for one ensemble member (`member_isolation='process'`),
the counterpart of `gnnep_tpu.train.member_proc`.

Each member then lives in its own process: whatever it holds on the card
(its captured graphs and their memory pools, the caching allocator's
blocks) is freed when the process ends. The member trained
here equals the in-process one: both derive (seed, fold, subset, config)
from `ensemble.member_plan` and the deterministic `prepare(cfg)` setup. The
first child builds the CUDA kernels into `gnnep_tpu_torch/build/`, and the
later ones load them from there.

Invoked by `ensemble.run_training`; also runnable by hand:
    python -m gnnep_tpu_torch.train.member_proc <cfg.json> <member_index> [cuda|cpu]

With `verbose` it prints the kernel launch counts of its process
(`[member_proc <i>] launches={...}`, `ops.cuda.graphs.launch_counts`), and
it prints `[member_proc <i>] optimizer_steps=<n>` last, which the parent
reads.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path


def main(cfg_path: str, index: str, device: str = "cuda") -> int:
    from .artifacts import save_member
    from .config import TrainConfig
    from .ensemble import compute_freq_weights, member_plan, prepare
    from .member import member_mesh, train_member, train_member_on_mesh

    cfg = TrainConfig(**json.loads(Path(cfg_path).read_text()))
    i = int(index)
    setup = prepare(cfg)
    freq_weights = compute_freq_weights(cfg, setup)
    seed_i, fold_idx, train_i, holdout, mc, member_cfg = member_plan(
        cfg, setup, i)
    if cfg.verbose:
        print(f"[member_proc {i}] seed={seed_i} fold={fold_idx + 1}/"
              f"{len(setup.folds)} train={len(train_i)} "
              f"fold_val={len(holdout)} device={device}", flush=True)
    args = (setup.store, member_cfg, mc, setup.transformer, setup.budget,
            seed_i, train_i, holdout, freq_weights)
    mesh = member_mesh(cfg, device)
    model, _, n_steps = (
        train_member(*args, device=device, giant=setup.giant)
        if mesh is None else
        train_member_on_mesh(mesh, None, *args, giant=setup.giant))
    save_member(Path(cfg.save_dir) / f"model_{i}.npz", model)
    if cfg.verbose:
        from ..ops.cuda.graphs import launch_counts

        print(f"[member_proc {i}] launches={json.dumps(launch_counts())}",
              flush=True)
    print(f"[member_proc {i}] optimizer_steps={n_steps}", flush=True)
    return n_steps


if __name__ == "__main__":
    if len(sys.argv) not in (3, 4):
        raise SystemExit("usage: python -m gnnep_tpu_torch.train.member_proc "
                         "<cfg.json> <member_index> [cuda|cpu]")
    main(*sys.argv[1:])
