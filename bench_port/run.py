"""Run one cell of the port's benchmark once and print its result line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's configuration, traffic mix, driver, limits and metric readers are
found by name from `BENCHMARK.json` (see `harness.py`). Set-up (process
start, inputs from the seed, the program's set-up and warm-up) ends where the
window starts. With `--trace 0` the result holds the cell's end-to-end
metrics; with `--trace 1` the window runs under the device trace and the
result holds its per-layer metrics, busy and window seconds and a breakdown.
After the window the program's state is freed and the plain reference
checks what the timed path produced; the numbers compared are printed beside
their limits as the last lines on standard error and as the result's last
key. Without enough CUDA devices the run fails and times nothing.

    python3 bench_port/run.py --workload <cell> --seed <n> --dry <graphs>

builds the cell's inputs at a store of <graphs> graphs on the CPU, with the
program's budget and the reference's first batches, and stops before any
model runs.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--dry", type=int, default=0,
                   help="build the inputs at this store size and stop")
    return p.parse_args(argv)


def per_layer(cell, res, obs, summary, peaks):
    from types import SimpleNamespace

    from bench_port import harness
    ctx = SimpleNamespace(window_s=summary["window_s"],
                          busy_s=summary["busy_s"], by_op=summary["by_op"],
                          spans=obs.spans, counters=obs.counters,
                          work=obs.work, model_flops=res["model_flops"],
                          peak_flops=peaks[0])
    out = {}
    for m in cell.per_layer:
        value = harness.reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    from bench_port import harness
    harness.fixed_caches()
    if not (ROOT / "gnnep_tpu_torch").is_dir():
        print("bench_port: the program (gnnep_tpu_torch/) is not in this "
              "checkout", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    drv = harness.driver(cell)
    if args.dry:
        print(json.dumps({"dry": drv.dry(cell, args.seed, args.dry)}))
        return 0

    import torch

    from bench_port.reference.model import Numerics
    from bench_port.work import alignn as work
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ", so nothing is timed", file=sys.stderr)
        return 3

    obs = harness.Obs(trace=bool(args.trace))
    state = drv.build(cell, args.seed, "cuda", obs)
    drv.warm(state)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    trace = harness.Trace(bool(args.trace))
    with trace.run():
        res = drv.window(state, args.seconds)
    device = harness.device_info(chips)

    breakdown = None
    if args.trace:
        peaks = work.peaks(device["kind"], cell.model["compute_dtype"])
        t0 = time.perf_counter()
        summary = trace.summary(work.kernel_patterns())
        trace.events = []
        print(f"trace stop_s={trace.stop_s:.3f} read_s="
              f"{time.perf_counter() - t0:.3f} events="
              f"{summary['n_device_events']}", file=sys.stderr)
        metrics = per_layer(cell, res, obs, summary, peaks)
        device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        breakdown = {"device_ops": harness.top(summary["by_name"]),
                     "idle_gaps": harness.top(summary["idle"])}
        card = harness.power_limit()
        for name, m in metrics.items():
            print(f"reading {name}={m['value']!r} {m['unit']} on {card}",
                  file=sys.stderr)
    else:
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] in res["metrics"]:
                value, unit = res["metrics"][m["name"]]
                metrics[m["name"]] = {"value": value, "unit": unit}

    drv.release(state)
    t0 = time.perf_counter()
    numbers = drv.check(state, Numerics(tf32=False))
    check_s = time.perf_counter() - t0
    checks = {k: {"value": float(numbers[k]) if math.isfinite(numbers[k])
                  else None, "limit": cell.limits[k]} for k in cell.limits}
    correct = harness.judge(numbers, cell.limits)
    for k, v in res.get("detail", {}).items():
        print(f"window {k}={v}", file=sys.stderr)
    print(f"check seconds={check_s:.3f} window_s={res['wall_s']:.3f} "
          f"setup_s={setup_s:.3f}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}={c['value']!r} limit={c['limit']!r}",
              file=sys.stderr)
    foreign = harness.foreign_modules()
    if foreign:
        print(f"bench_port: the measured process holds {foreign}",
              file=sys.stderr)
        return 4
    result = {"correct": bool(correct), "attempted": res["attempted"],
              "failed": 0, "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
