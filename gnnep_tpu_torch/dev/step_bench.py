"""The default rung's train step and eval forward, eager and captured, f32
and bf16, on the card: wall ms (median of 5 passes) and device ms (one
traced pass) per step of a K-step chunk and per served batch, at
`chip_smoke.py`'s flagship fixture:

    python /path/to/gnnep_tpu_torch/dev/step_bench.py TAG

It measures the package, and takes the fixture and timers from the
`chip_smoke.py`, of the current directory (run it from the root of a
checkout), so that one call can A/B two trees: unpack the parent with
`git archive` into the gitignored `_tree/parent/` and run the file from
there and from the tree under test in turn (parent, tree, tree, parent).
Prints one line, `AB {json}`, tagged with TAG and the card's name and
power limit.
"""
from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import numpy as np


def main(tag: str) -> dict:
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs
    import torch
    from gnnep_tpu_torch.models.alignn import DeviceBatch, init_alignn
    from gnnep_tpu_torch.ops.cuda import build
    from gnnep_tpu_torch.train.artifacts import load_member
    from gnnep_tpu_torch.train.loop import (TrainHyper, TrainStep, cast_model,
                                            make_forward, make_train_step)
    from gnnep_tpu_torch.utils.synth import flagship_config
    dev, smi = cs.phase_device()
    build.build(["attn_eproj_fwd", "attn_eproj_bwd", "csr_segment_sum"])
    out = {"tag": tag, "card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        data, ens, _ = cs.write_fixture(root)
        batches = cs.served_batches(cs.serve_argv(root, data, ens,
                                                  "float32"), dev)
        setup, train_batches = cs.training_setup(data, root)
        store, t = setup.store, setup.transformer
        full = cs.full_batches(train_batches)
        seq = [full[i % len(full)] for i in range(cs.TIMING_K)]
        cfg = flagship_config(node_dim=store.node_dim,
                              edge_dim=store.edge_dim,
                              angle_dim=store.angle_dim,
                              global_dim=store.global_scalar_dim + 230)
        fseq = [batches[i % len(batches)] for i in range(cs.TIMING_BATCHES)]
        for dtype in ("float32", "bfloat16"):
            for kind in ("eager", "captured"):
                model = init_alignn(np.random.default_rng(cs.SEED + 7), cfg)
                hyper = TrainHyper(compute_dtype=dtype)
                step = (TrainStep(model.to(dev), hyper, t.means, t.stds)
                        if kind == "eager" else
                        make_train_step(model, hyper, t.means, t.stds, dev))
                gen = torch.Generator(device=dev).manual_seed(cs.SEED)

                def chunk():
                    return step.run(seq, gen, 1e-4, 1e-4).loss_sum.cpu()

                ms, _ = cs.chunk_ms(chunk)
                _, dev_ms = cs.profile_run(chunk, f"ab_step_{kind}", dtype,
                                           cs.TIMING_K)
                out[f"step_{dtype}_{kind}"] = [ms / cs.TIMING_K, dev_ms]
                step.close()
            run = cast_model(load_member(ens / "model_0.npz", dev), dtype)
            fwd = make_forward(compute_dtype=dtype)
            for b in fseq[:2]:
                fwd(run, b)[0].cpu()
            passes = {
                "eager": lambda: torch.stack([torch.stack(fwd.eager(
                    run, DeviceBatch.from_batch(b, dev)))
                    for b in fseq]).cpu(),
                "captured": lambda: torch.stack([torch.stack(fwd(run, b))
                                                 for b in fseq]).cpu()}
            for kind, one in passes.items():
                ms = cs.chunk_ms(one)[0] / len(fseq)
                _, dev_ms = cs.profile_run(one, f"ab_fwd_{kind}", dtype,
                                           len(fseq))
                out[f"forward_{dtype}_{kind}"] = [ms, dev_ms]
            fwd.close()
    print("AB " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree")
