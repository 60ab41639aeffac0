"""What every cell shares: the cell's files found by name, the observer that
times the harness's spans around the program's calls and counts its work,
the device trace, the isolation check and the result line.

Nothing here knows a cell: a configuration is `configs/<name>.json`, a
traffic mix `traffic/<name>.json` whose `kind` names its driver
`drivers/<kind>.py`, a per-layer metric the reader `metrics/<metric>.py`,
the limits of a cell's comparison `limits/<cell>.json`, a kernel's names
`work/patterns/*.json`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names the measured process may never hold: the JAX
# package and its stack (compared whole: the port's name starts with the
# JAX package's)
FOREIGN = ("jax", "jaxlib", "flax", "gnnep_tpu")
# idle seconds on either side of a traced window: the profiler drops kernel
# records whose converted time falls outside its window
TRACE_MARGIN_S = 0.5


def fixed_caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own nvcc outputs already live in `gnnep_tpu_torch/build/`), and
    no library loading JAX by itself."""
    cache = ROOT / ".bench_port_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


@dataclasses.dataclass
class Cell:
    name: str
    entry: Dict
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    limits: Dict[str, float]

    @property
    def model(self) -> Dict:
        return self.config["model"]


def _for_cell(metrics: List[Dict], name: str) -> List[Dict]:
    return [m for m in metrics if name in m.get("workloads", [name])]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name, entry, json.loads((root / conf["file"]).read_text()),
        json.loads((HERE / "traffic" / f"{entry['traffic']}.json")
                   .read_text()),
        _for_cell(bench["end_to_end"], name),
        _for_cell(bench["per_layer"], name),
        json.loads((HERE / "limits" / f"{name}.json").read_text()))


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell):
    return importlib.import_module(f"bench_port.drivers.{cell.traffic['kind']}")


def reader(metric: str) -> Callable:
    return load_module(HERE / "metrics" / f"{metric}.py",
                       f"bench_port_metric_{metric.replace('.', '_')}").read


def foreign_modules() -> List[str]:
    return sorted(n for n in sys.modules if n.split(".")[0] in FOREIGN)


class Obs:
    """The harness's spans (host clock; with a trace, also profiler
    annotations named `bench::<span>`) and counters around the program's
    calls, and the live rows of every batch the window drives."""

    def __init__(self, trace: bool):
        self.trace = trace
        self.recording = False
        self.spans: Dict[str, List[float]] = {}
        self.counters: Dict[str, float] = {}
        self.work: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.recording:
            yield
            return
        ctx = contextlib.nullcontext()
        if self.trace:
            import torch
            ctx = torch.profiler.record_function(f"bench::{name}")
        t0 = time.perf_counter()
        with ctx:
            try:
                yield
            finally:
                self.spans.setdefault(name, []).append(
                    time.perf_counter() - t0)

    def count(self, name: str, n: float = 1.0) -> None:
        if self.recording:
            self.counters[name] = self.counters.get(name, 0.0) + n

    def add_work(self, parts: Dict[str, float]) -> None:
        for k, v in parts.items():
            self.work[k] = self.work.get(k, 0.0) + v


class Patches:
    """Attributes of the program replaced by the harness's wrappers, put
    back by `restore`."""

    def __init__(self):
        self.saved = []

    def set(self, owner, name: str, value) -> None:
        self.saved.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, value)

    def restore(self) -> None:
        for owner, name, value in reversed(self.saved):
            setattr(owner, name, value)
        self.saved.clear()


def live_counts(batch) -> Dict[str, int]:
    """Live rows of a packed host batch."""
    import numpy as np
    gm = np.asarray(batch.graph_mask)
    return dict(graphs=int(gm.sum()),
                atoms=int((np.asarray(batch.node_graph) < gm.shape[0]).sum()),
                bonds=int(np.asarray(batch.edge_mask).sum()),
                lg=int(np.asarray(batch.lg_mask).sum()))


class Trace:
    """The device trace of a window: torch's profiler (Kineto) with CPU and
    CUDA activity, idling TRACE_MARGIN_S before and after the work; the
    window proper is the harness's `bench::window` annotation inside it.

    The profiler is driven through its low-level calls, as
    `torch.autograd.profiler.profile` drives it, and its raw events are read
    directly: the profile object's own parse into function events takes
    minutes over a long training window and nothing here reads it.
    `stop_s` is the seconds the profiler took to stop."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.events = []
        self.stop_s = 0.0

    @contextlib.contextmanager
    def run(self):
        if not self.enabled:
            yield
            return
        import torch
        from torch.autograd import (_disable_profiler, _enable_profiler,
                                    _prepare_profiler)
        from torch.autograd.profiler import profile
        spec = profile(use_device="cuda", use_kineto=True)
        config, activities = spec.config(), spec.kineto_activities
        _prepare_profiler(config, activities)
        _enable_profiler(config, activities)
        try:
            torch.cuda.synchronize()
            time.sleep(TRACE_MARGIN_S)
            yield
            torch.cuda.synchronize()
            time.sleep(TRACE_MARGIN_S)
        finally:
            t0 = time.perf_counter()
            result = _disable_profiler()
            self.stop_s = time.perf_counter() - t0
        self.events = result.events()

    def summary(self, patterns: Dict[str, List[str]]) -> Dict:
        """Busy seconds (the union of device activity) inside the window,
        device seconds by kernel name and by op, and idle seconds by the
        innermost harness span the host was in."""
        from torch.autograd import DeviceType
        cpu = DeviceType.CPU
        win, spans, dev = None, [], []
        for e in self.events:
            name = e.name()
            if e.device_type() == cpu:
                if name.startswith("bench::"):
                    item = (e.start_ns(), e.start_ns() + e.duration_ns(),
                            name)
                    if name == "bench::window":
                        win = item
                    else:
                        spans.append(item)
            elif not name.startswith("bench::"):
                # (the device-side copy of an annotation is no activity)
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            name))
        if win is None:
            raise RuntimeError("the trace holds no bench::window annotation")
        w0, w1 = win[0], win[1]
        by_name: Dict[str, float] = {}
        inside = sorted((max(s, w0), min(t, w1), n) for s, t, n in dev
                        if t > w0 and s < w1)
        for s, t, n in inside:
            by_name[n] = by_name.get(n, 0.0) + (t - s) * 1e-9
        by_op = {op: sum(v for n, v in by_name.items()
                         if any(p in n for p in pats))
                 for op, pats in patterns.items()}
        busy, gaps, end = 0.0, [], w0
        for s, t, _ in inside:
            if s > end:
                gaps.append((end, s))
            if t > end:
                busy += (t - max(s, end)) * 1e-9
                end = t
        if end < w1:
            gaps.append((end, w1))
        # one sweep in time order: the harness's spans nest, so the open
        # span last entered is the innermost (ends before starts before
        # gaps at one instant: a span covers [start, end))
        order = {-1: 0, 1: 1, 0: 2}
        points = sorted([(s, 1, n) for s, _, n in spans]
                        + [(t, -1, n) for _, t, n in spans]
                        + [(g0, 0, g1) for g0, g1 in gaps],
                        key=lambda p: (p[0], order[p[1]]))
        idle: Dict[str, float] = {}
        open_spans: List[str] = []
        for at, kind, what in points:
            if kind == 1:
                open_spans.append(what)
            elif kind == -1:
                open_spans.reverse()
                open_spans.remove(what)
                open_spans.reverse()
            else:
                host = open_spans[-1] if open_spans else "bench::window"
                idle[host] = idle.get(host, 0.0) + (what - at) * 1e-9
        return dict(window_s=(w1 - w0) * 1e-9, busy_s=busy, by_name=by_name,
                    by_op=by_op, idle=idle, n_device_events=len(inside))


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Correct: every limited number read, and none above its limit (a
    number that is not finite fails)."""
    return set(numbers) == set(limits) and all(
        numbers[k] <= limits[k] for k in limits)


def device_info(chips: int) -> Dict:
    import torch
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def top(items: Dict[str, float], n: int = 10):
    return [[k[:160], v] for k, v in sorted(items.items(),
                                           key=lambda kv: -kv[1])[:n]]
