"""CUDA graphs whose replays count the kernel launches they hold: the port's
counterpart of the JAX package's compiled programs (a jitted step, a scanned
chunk), captured once and replayed.

The wrappers of this package add one to their module's `launches` (or
`bwd_launches`) where they launch a kernel. Under stream capture a wrapper's
Python runs once and nothing reaches the card; each replay then launches
everything the capture recorded. So a `CountedGraph` puts the counts back as
they were before its capture, and adds the capture's increments on every
replay: the counts go on saying how often each kernel ran on the card.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, TypeVar, Union

import torch

from . import aggregate, attention, attention_eproj, attention_span, segment_sum

# every launch count of the kernels a train step or a forward can launch
_COUNTERS = ((attention_eproj, "launches"), (attention_eproj, "bwd_launches"),
             (attention_span, "launches"), (attention_span, "bwd_launches"),
             (attention, "launches"), (attention, "bwd_launches"),
             (aggregate, "launches"), (aggregate, "bwd_launches"),
             (segment_sum, "launches"))

# graph replays since the last reset, by kind: 'train' steps and 'eval'
# forwards; the chip smoke run sets them to 0 just before it drives a path
replays = {"train": 0, "eval": 0}

T = TypeVar("T")


def _read():
    return [getattr(mod, attr) for mod, attr in _COUNTERS]


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch count in this process, keyed
    '<module>.<attribute>' (e.g. 'attention_eproj.bwd_launches')."""
    return {f"{mod.__name__.rsplit('.', 1)[1]}.{attr}": getattr(mod, attr)
            for mod, attr in _COUNTERS}


class CountedGraph:
    """One CUDA graph of kind 'train' or 'eval' (None: a part of a step
    whose replays `replays` does not count, a mesh step's optimizer tail). `capture(fn, generator)`
    records `fn` (its outputs are the graph's static outputs, in its
    private memory pool), with `generator`'s draws (or each of a list of
    generators') registered so that each replay draws the next numbers of
    its stream; `replay()` launches it on
    the current stream. A failed capture raises."""

    def __init__(self, kind: Optional[str]):
        if kind is not None and kind not in replays:
            raise ValueError(f"kind must be one of {sorted(replays)}")
        self.kind = kind
        self.graph = torch.cuda.CUDAGraph()
        self.delta = [0] * len(_COUNTERS)

    def capture(self, fn: Callable[[], T],
                generator: Union[None, torch.Generator,
                                 Sequence[torch.Generator]] = None) -> T:
        """Capture on a side stream ordered after the current stream's
        work. Unlike `torch.cuda.graph`, no device synchronisation and no
        `empty_cache` first: at the flagship those cost more than the
        capture itself (PERF.md §6); the owner empties the cache when it
        frees its graphs."""
        gens = generator if isinstance(generator, (list, tuple)) else (
            [] if generator is None else [generator])
        for g in gens:
            self.graph.register_generator_state(g)
        before = _read()
        current = torch.cuda.current_stream()
        side = torch.cuda.Stream(current.device)
        side.wait_stream(current)
        try:
            with torch.cuda.stream(side):
                self.graph.capture_begin()
                try:
                    out = fn()
                finally:
                    self.graph.capture_end()
        finally:
            after = _read()
            for (mod, attr), n in zip(_COUNTERS, before):
                setattr(mod, attr, n)
        current.wait_stream(side)
        self.delta = [b - a for a, b in zip(before, after)]
        return out

    def replay(self) -> None:
        self.graph.replay()
        for (mod, attr), n in zip(_COUNTERS, self.delta):
            if n:
                setattr(mod, attr, getattr(mod, attr) + n)
        if self.kind is not None:
            replays[self.kind] += 1

    def reset(self) -> None:
        """Free the graph; its pool is free once its outputs are dropped,
        and goes back to the card at the next `torch.cuda.empty_cache`."""
        self.graph.reset()
