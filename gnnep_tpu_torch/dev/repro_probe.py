"""How far apart runs of one member's training land on the card, and
where they part: the default rung's train step at `chip_smoke.py`'s
flagship fixture, the trainer's dropout 0.15 and jitter 0.1 (and, for
comparison, both off), f32 and bf16:

    python /path/to/gnnep_tpu_torch/dev/repro_probe.py TAG

From the same initial parameters, batches and generator seed, STEPS steps
of each of three kinds, RUNS times each:
- `eager`: the eager `TrainStep`;
- `graph`: a fresh `GraphTrainStep` (its first step the eager warm-up,
  then its capture's replays), as a member starts;
- `cont`: a `GraphTrainStep` captured beforehand on other batches, its
  state and generator then set back (every step a replay), as an
  uninterrupted run goes on where a resumed one starts.
Prints, per dtype and setting, the relative distance (over the final
update of the first eager run) of every pair of runs after each step, over
all parameters and over all but the attention key biases (`*.b_key`: a
query's logits all shift by q·b_key, which the softmax cancels, so their
exact gradient is zero and Adam steps them by the sign of rounding
noise), the number of runs bit-equal to the kind's first, and the leaves
where `graph` and `cont` part most after steps 1 and 2. One line each, `PROBE {json}`, tagged
with TAG and the card's name and power limit. It measures the package of
the current directory (run it from the root of a checkout).
"""
from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import numpy as np

STEPS = 8
RUNS = 4


def main(tag: str) -> None:
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs
    import torch
    from gnnep_tpu_torch.models.alignn import init_alignn
    from gnnep_tpu_torch.ops.cuda import build
    from gnnep_tpu_torch.train.loop import (GraphTrainStep, TrainHyper,
                                            TrainStep)
    from gnnep_tpu_torch.utils.synth import flagship_config
    dev, smi = cs.phase_device()
    build.build(["attn_eproj_fwd", "attn_eproj_bwd", "csr_segment_sum"])
    lr = 3e-4
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        data, _, _ = cs.write_fixture(root)
        setup, train_batches = cs.training_setup(data, root)
        store, t = setup.store, setup.transformer
        full = cs.full_batches(train_batches)
        seq = [full[i % len(full)] for i in range(STEPS)]
        other = [full[-1 - i % len(full)] for i in range(2)]
        for dtype, rng_on in (("float32", True), ("float32", False),
                              ("bfloat16", True)):
            cfg = flagship_config(node_dim=store.node_dim,
                                  edge_dim=store.edge_dim,
                                  angle_dim=store.angle_dim,
                                  global_dim=store.global_scalar_dim + 230,
                                  dropout=0.15 if rng_on else 0.0)
            hyper = TrainHyper(compute_dtype=dtype,
                               feature_jitter_std=0.1 if rng_on else 0.0)

            def flat(step):
                return torch.cat([p.detach().float().flatten()
                                  for p in step.params]).clone()

            def run(kind):
                model = init_alignn(np.random.default_rng(cs.SEED + 5), cfg)
                if kind == "eager":
                    step = TrainStep(model.to(dev), hyper, t.means, t.stds)
                else:
                    step = GraphTrainStep(model.to(dev), hyper, t.means,
                                          t.stds)
                gen = torch.Generator(device=dev).manual_seed(cs.SEED)
                if kind == "cont":
                    st = step.read_state()
                    init = {n: v.detach().clone()
                            for n, v in st["params"].items()}
                    for b in other:
                        step(b, gen, lr, lr)
                    zeros = {n: torch.zeros_like(v) for n, v in init.items()}
                    step.load_state(init, zeros, zeros, 0)
                    gen.manual_seed(cs.SEED)
                traj, grads = [flat(step)], []
                for b in seq:
                    step(b, gen, lr, lr)
                    torch.cuda.synchronize()
                    traj.append(flat(step))
                    grads.append([p.grad.detach().float().clone()
                                  for p in step.params])
                names = list(step.names)
                numels = [p.numel() for p in step.params]
                if isinstance(step, GraphTrainStep):
                    step.close()
                return traj, grads[:2], gen.get_state(), names, numels

            runs = {k: [run(k) for _ in range(RUNS)]
                    for k in ("eager", "graph", "cont")}
            ref = runs["eager"][0][0]
            names, numels = runs["eager"][0][3:5]
            keep = torch.cat([torch.full((k,), not n.endswith(".b_key"),
                                         dtype=torch.bool)
                              for n, k in zip(names, numels)]).to(dev)
            scale = float(torch.linalg.vector_norm(ref[-1] - ref[0]))
            scale_kept = float(torch.linalg.vector_norm(
                (ref[-1] - ref[0])[keep]))
            keys = [(k, i) for k in runs for i in range(RUNS)]
            pairs, pairs_kept = {}, {}
            for a in range(len(keys)):
                for b in range(a + 1, len(keys)):
                    ta = runs[keys[a][0]][keys[a][1]][0]
                    tb = runs[keys[b][0]][keys[b][1]][0]
                    tag_ab = (f"{keys[a][0]}{keys[a][1]}-{keys[b][0]}"
                              f"{keys[b][1]}")
                    pairs[tag_ab] = [
                        float(torch.linalg.vector_norm(x - y)) / scale
                        for x, y in zip(ta[1:], tb[1:])]
                    pairs_kept[tag_ab] = [
                        float(torch.linalg.vector_norm((x - y)[keep]))
                        / scale_kept for x, y in zip(ta[1:], tb[1:])]
            bit_equal = {k: sum(all(torch.equal(x, y) for x, y in
                                    zip(r[0], runs[k][0][0]))
                                for r in runs[k]) for k in runs}
            gens_equal = all(torch.equal(r[2], runs["eager"][0][2])
                             for k in runs for r in runs[k])
            leaves = {}
            for s in range(2):
                ga, gb, gc = (runs[k][0][1][s] for k in
                              ("graph", "cont", "eager"))
                rel = sorted(((float(torch.linalg.vector_norm(x - y)
                                     / torch.linalg.vector_norm(y)
                                     .clamp_min(1e-30)), n)
                              for n, x, y in zip(names, ga, gb)),
                             reverse=True)[:12]
                leaves[f"grad_step{s + 1}_graph_vs_cont"] = rel
                leaves[f"grad_step{s + 1}_eager_vs_cont_max"] = max(
                    float(torch.linalg.vector_norm(x - y)
                          / torch.linalg.vector_norm(y).clamp_min(1e-30))
                    for x, y in zip(gc, gb))
            print("PROBE " + json.dumps(dict(
                tag=tag, card=smi, dtype=dtype, dropout_jitter=rng_on,
                steps=STEPS, runs=RUNS, scale=scale, bit_equal=bit_equal,
                generators_equal=gens_equal, pairs=pairs,
                pairs_without_b_key=pairs_kept, leaves=leaves)),
                flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree")
