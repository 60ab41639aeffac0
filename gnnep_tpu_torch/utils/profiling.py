"""Observability: throughput counters, the program's spans and
torch.profiler tracing (the counterpart of `gnnep_tpu.utils.profiling`).

`ThroughputMeter` counts (atom + line-graph) edges and graphs per wall
second, as the JAX package's does; `span(name)` marks where the host is,
as a record named `gnnep::<name>` in whatever torch profiler is recording
on the calling thread, and costs one check otherwise; `maybe_trace(dir)`
writes a Chrome trace of the block it wraps (the trainer wraps a member's
first epoch, `--profile-dir`).
"""
from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

# idle seconds inside a trace that holds the card's activity, before and
# after its work: the profiler drops a kernel record whose timestamp,
# converted from the device's clock, falls outside the trace's window, and
# on an H100 that conversion moved by milliseconds to tens of milliseconds
# between traces, enough to drop the first or last kernels of the traced
# work (`gnnep_tpu_torch/dev/trace_window_probe.py`)
TRACE_MARGIN_S = 0.5

# the prefix of every span's record name
SPAN_PREFIX = "gnnep::"
_OFF = contextlib.nullcontext()


class ThroughputMeter:
    """Accumulates (atom + line-graph) edges and graphs per wall-second."""

    def __init__(self):
        self.edges = 0.0
        self.graphs = 0.0
        self._t0 = time.perf_counter()

    def count_batch(self, batch) -> None:
        self.edges += float(np.asarray(batch.edge_mask).sum()
                            + np.asarray(batch.lg_mask).sum())
        self.graphs += float(np.asarray(batch.graph_mask).sum())

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def summary(self) -> str:
        dt = max(self.elapsed, 1e-9)
        return (f"{self.edges / dt:,.0f} edges/s, "
                f"{self.graphs / dt:,.1f} graphs/s over {dt:.1f}s")


def span(name: str, **args):
    """A context that records the block as `gnnep::<name>` while a torch
    profiler records on this thread (the `--profile-dir` trace, the
    benchmark's device trace), on the profiler's clock, which is the card's
    kernels' clock too; `args` (e.g. `epoch=3`) go with the record and show
    in a trace that records shapes. Otherwise one shared no-op context and
    no profiler call.

    The record is an operator's, not a user annotation's: it puts no
    device-side copy of itself on the card's timeline, so a trace's device
    activity is the card's work alone. Never span code a CUDA graph
    captures: it runs once, at the capture."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + name, (),
                                                  args)


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str]):
    """torch.profiler trace of the host and, where CUDA is available, the
    card, written as `<trace_dir>/<pid>_<ms>.pt.trace.json` (a Chrome
    trace); a no-op when `trace_dir` is falsy. With the card traced, the
    window idles TRACE_MARGIN_S before the block and, after the block and
    a synchronization of the card, TRACE_MARGIN_S again."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        if cuda:
            time.sleep(TRACE_MARGIN_S)
        yield
        if cuda:
            torch.cuda.synchronize()
            time.sleep(TRACE_MARGIN_S)
    prof.export_chrome_trace(str(
        out / f"{os.getpid()}_{int(time.time() * 1e3)}.pt.trace.json"))
