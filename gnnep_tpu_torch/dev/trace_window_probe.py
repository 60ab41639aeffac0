"""Does a torch.profiler trace of CUDA-graph replays see every kernel, on
the card:

    python gnnep_tpu_torch/dev/trace_window_probe.py [--margin S] [--reps N]

It captures one graph of about 700 small kernels, 16 of them `cumsum`
markers, and traces 8 replays of it `--reps` times, with `--margin`
seconds of idle time inside the trace before and after the replays. Each
trace prints the markers seen against the 128 launched, the device events
seen, the first device event's start less the first graph launch's start
(negative: the device's converted clock runs ahead of the host's) and the
host synchronize's end less the last device event's end; the last line
counts the traces that missed a marker. `chip_smoke.py` holds every
profiled kernel count to the launch counts, and sets its margin
(TRACE_MARGIN_S) from what this shows.
"""
from __future__ import annotations

import argparse
import time

STEPS, MARKER_EVERY, REPLAYS = 700, 44, 8


def body(x):
    import torch
    y = x
    for i in range(STEPS):
        y = y + 1e-6
        if i % MARKER_EVERY == 0:
            y = torch.cumsum(y, 0) * 1e-3
    return y


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--margin", type=float, default=0.0)
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args()
    x = torch.randn(4096, 64, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body(x)
    want = REPLAYS * sum(1 for i in range(STEPS) if i % MARKER_EVERY == 0)
    missed = 0
    for rep in range(args.reps):
        for _ in range(REPLAYS):
            graph.replay()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(args.margin)
            for _ in range(REPLAYS):
                graph.replay()
            torch.cuda.synchronize()
            time.sleep(args.margin)
        events = prof.events()
        device = [e for e in events if str(e.device_type).endswith("CUDA")]
        seen = sum(1 for e in device
                   if "cumsum" in e.name or "scan" in e.name.lower())
        launch = min(e.time_range.start for e in events
                     if "GraphLaunch" in e.name)
        sync = max(e.time_range.end for e in events
                   if "Synchronize" in e.name)
        missed += seen != want
        print(f"rep={rep} margin={args.margin} markers={seen}/{want} "
              f"device_events={len(device)} first_device_minus_first_launch"
              f"_us={min(e.time_range.start for e in device) - launch:.1f} "
              f"sync_end_minus_last_device_us="
              f"{sync - max(e.time_range.end for e in device):.1f}",
              flush=True)
    print(f"summary margin={args.margin} traces_missing_markers="
          f"{missed}/{args.reps}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
