"""The readings a cell's limits are set from, on the card, in one process.

    python3 bench_port/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 [--seconds 3] [--out <file.jsonl>]

For every seed: the program runs the cell's window (`--seconds`; the first
seed warms up) and its compared numbers against the float32 reference are a
sound reading. For every control seed besides: the control, the reference
itself computed with TF32 products, against the float32 reference; and the
faults, planted in the reference put in the program's place: half of each
batch left out of the loss (the mean over the rest), and a step that returns
its state unchanged (no run: the clipped gradients read from Adam's moment
are 0 and the weights do not move). Each side put in the program's place is
judged as the program is: the float32 reference takes step 2's gradient at
that side's weights after step 1. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def half_batch(loss_fn):
    """The heteroscedastic loss over the first half of each batch's real
    graphs, the mean taken over them."""
    def loss(mean, logvar, a, *args):
        gm = a["graph_mask"]
        keep = (gm.cumsum(0) <= gm.sum() / 2).to(gm.dtype)
        return loss_fn(mean, logvar, dict(a, graph_mask=gm * keep), *args)
    return loss


def readings(drv, state, control: bool):
    """The sound reading of the program's run, and on a control seed the
    control's and the faults'."""
    from bench_port.reference import train as ref_train
    from bench_port.reference.model import Numerics

    def judged(side):
        f32 = drv.reference(state, Numerics(False), side["p1"])
        return drv.numbers(side, f32), f32

    prog = drv.program_readings(state)
    out = {}
    out["sound"], f32 = judged(prog)
    out["sound_detail"] = drv.detail(prog, f32)
    if not control:
        return out
    ctrl = drv.reference(state, Numerics(True))
    out["control_tf32"], f32c = judged(ctrl)
    out["control_detail"] = drv.detail(ctrl, f32c)
    loss0 = ref_train.hetero_loss
    ref_train.hetero_loss = half_batch(loss0)
    try:
        half = drv.reference(state, Numerics(False))
    finally:
        ref_train.hetero_loss = loss0
    out["fault_half_batch"], _ = judged(half)
    still = dict(f32, p1=f32["p0"], pn=f32["p0"],
                 g1={n: 0.0 * g for n, g in f32["g1"].items()},
                 g2={n: 0.0 * g for n, g in f32["g2"].items()})
    out["fault_state_unchanged"] = drv.numbers(still, f32)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import torch

    from bench_port import harness
    harness.fixed_caches()
    cell = harness.load_cell(args.workload)
    drv = harness.driver(cell)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    sink = open(args.out, "a") if args.out else None
    last_epoch_s = None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        state = drv.build(cell, seed, "cuda", harness.Obs(trace=False))
        if last_epoch_s is None:
            drv.warm(state)
            last_epoch_s = state.last_epoch_s
        else:
            state.last_epoch_s = last_epoch_s
        res = drv.window(state, args.seconds)
        peak = torch.cuda.max_memory_allocated()
        drv.release(state)
        row = dict(workload=args.workload, seed=seed,
                   attempted=res["attempted"], memory_peak_bytes=peak,
                   **readings(drv, state, seed in controls))
        row["seconds"] = time.perf_counter() - t0
        state.patches.restore()
        del state
        torch.cuda.empty_cache()
        line = json.dumps(row, default=float)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
