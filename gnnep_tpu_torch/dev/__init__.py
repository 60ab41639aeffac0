"""Timing probes of the port's kernels, run on the card:
`python -m gnnep_tpu_torch.dev.kernel_ladder` and
`python -m gnnep_tpu_torch.dev.gather_probe`."""
from typing import Callable


def event_ms(fn: Callable[[], object], iters: int, repeats: int = 1) -> float:
    """Device ms per call of `fn`: the best of `repeats` runs of `iters`
    back-to-back calls between two CUDA events, after one warm-up call (the
    JAX probes' method)."""
    import torch
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best
