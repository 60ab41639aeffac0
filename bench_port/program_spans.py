"""The device trace's idle time put down to the program's own spans, and a
traced run of a cell that reports it.

    python3 bench_port/program_spans.py --workload <cell> --seed <n> \
        --seconds <s> [--out <file.json>]

runs the cell as `run.py --trace 1` does, then prints one line
`program_spans {...}` on standard error (also written to `--out`):

- `program_idle`: seconds of device idle inside the window, by the
  innermost `gnnep::` span (`gnnep_tpu_torch.utils.profiling.span`) open at
  that moment on the thread that recorded `bench::window`, `untraced` where
  none was; a gap that outlasts a span is split at the span's ends;
- `program_spans`: count and host seconds of each `gnnep::` span on that
  thread, clipped to the window;
- `captures`: the program's graph captures over the window, by kind (none
  where the program does not count them);
- `idle_pct`: the idle as shares of the window, in %: `pack`
  (`member.pack_wait`), `stage` (`stage.wait`, `stage.copy`), `loop` (every
  other span), `untraced`, and their sum `device_idle`, which is
  `device_idle.train`'s reading of the same trace;
- the window's `train_graphs_per_s` under the trace, and the trace's event
  counts.

`run.py` reads none of this: these shares are not metrics of the benchmark
(PERF.md, Open questions, says what wiring them in would edit).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path
from typing import Dict, List, Tuple

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

PREFIX = "gnnep::"
# the spans each share of the idle reads; `loop` is every other span
PACK = ("member.pack_wait",)
STAGE = ("stage.wait", "stage.copy")


def split(events) -> Dict:
    """`program_idle` and `program_spans` of a trace's raw events (Kineto's
    `KinetoEvent`s: `name()`, `device_type()`, `start_ns()`,
    `duration_ns()`, `start_thread_id()`). Device activity is what
    `harness.Trace.summary` counts: every non-CPU record but the `bench::`
    annotations' device copies, so the partition sums to its idle."""
    from torch.autograd import DeviceType
    cpu = DeviceType.CPU
    win, spans, dev = None, [], []
    for e in events:
        name = e.name()
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        if e.device_type() == cpu:
            if name == "bench::window":
                win = (t0, t1, e.start_thread_id())
            elif name.startswith(PREFIX):
                spans.append((t0, t1, name[len(PREFIX):],
                              e.start_thread_id()))
        elif not name.startswith("bench::"):
            dev.append((t0, t1))
    if win is None:
        raise RuntimeError("the trace holds no bench::window annotation")
    w0, w1, tid = win
    mine = [(max(s, w0), min(t, w1), n) for s, t, n, th in spans
            if th == tid and t > w0 and s < w1]
    gaps, end = [], w0
    for s, t in sorted((max(s, w0), min(t, w1)) for s, t in dev
                       if t > w0 and s < w1):
        if s > end:
            gaps.append((end, s))
        end = max(end, t)
    if end < w1:
        gaps.append((end, w1))
    return dict(program_idle=_idle_by_span(mine, gaps),
                program_spans=_span_totals(mine))


def _idle_by_span(spans: List[Tuple[int, int, str]],
                  gaps: List[Tuple[int, int]]) -> Dict[str, float]:
    """One sweep in time order over the spans' and gaps' ends: each stretch
    between two consecutive points that lies in a gap goes to the span
    entered last among those open (the spans of one thread nest), or to
    `untraced`. At one instant ends go before starts."""
    points = sorted([(s, 1, n) for s, _, n in spans]
                    + [(t, -1, n) for _, t, n in spans]
                    + [(g0, 2, "") for g0, _ in gaps]
                    + [(g1, -2, "") for _, g1 in gaps],
                    key=lambda p: (p[0], p[1] > 0))
    idle: Dict[str, float] = {}
    open_spans: List[str] = []
    in_gap, last = 0, None
    for at, kind, name in points:
        if in_gap and last is not None and at > last:
            host = open_spans[-1] if open_spans else "untraced"
            idle[host] = idle.get(host, 0.0) + (at - last) * 1e-9
        last = at
        if kind == 1:
            open_spans.append(name)
        elif kind == -1:
            # the last-entered open span of that name
            del open_spans[len(open_spans) - 1
                           - open_spans[::-1].index(name)]
        else:
            in_gap += 1 if kind == 2 else -1
    return idle


def _span_totals(spans: List[Tuple[int, int, str]]) -> Dict[str, Dict]:
    out: Dict[str, Dict] = {}
    for s, t, n in spans:
        d = out.setdefault(n, {"count": 0, "host_s": 0.0})
        d["count"] += 1
        d["host_s"] += (t - s) * 1e-9
    return out


def idle_pct(program_idle: Dict[str, float], window_s: float
             ) -> Dict[str, float]:
    """The idle by span as the four shares of the window, in %, and their
    sum."""
    pct = {k: 100.0 * v / window_s for k, v in program_idle.items()}
    pack = sum(pct.get(k, 0.0) for k in PACK)
    stage = sum(pct.get(k, 0.0) for k in STAGE)
    untraced = pct.get("untraced", 0.0)
    total = sum(pct.values())
    return dict(pack=pack, stage=stage, loop=total - pack - stage - untraced,
                untraced=untraced, device_idle=total)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    from bench_port import harness, run
    found: Dict = {}

    def captures():
        from gnnep_tpu_torch.ops.cuda import graphs
        counts = getattr(graphs, "captures", None)
        return dict(counts) if counts is not None else None

    class SpanTrace(harness.Trace):
        @contextlib.contextmanager
        def run(self):
            before = captures()
            with super().run():
                yield
            after = captures()
            if before is not None:
                found["captures"] = {k: after[k] - before[k] for k in after}

        def summary(self, patterns):
            out = super().summary(patterns)
            found.update(split(self.events))
            found["idle_pct"] = idle_pct(found["program_idle"],
                                         out["window_s"])
            found.update(window_s=out["window_s"], busy_s=out["busy_s"],
                         n_events=len(self.events),
                         n_device_events=out["n_device_events"])
            return out

    load_kind = harness.driver

    def kind_timed(cell):
        drv = load_kind(cell)
        window = drv.window

        def timed(state, seconds):
            res = window(state, seconds)
            found.update({k: v[0] for k, v in res["metrics"].items()})
            return res
        drv.window = timed
        return drv

    harness.Trace = SpanTrace
    harness.driver = kind_timed
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    line = json.dumps(dict(found, workload=args.workload, seed=args.seed))
    print(f"program_spans {line}", file=sys.stderr, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
