"""Shared fixtures of the benchmark's own tests: the cells at a size the CPU
holds, and the card where a test needs one."""
import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True)
def _few_threads():
    """A tiny model gains nothing from many threads, and test workers
    share the machine."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def tiny_cell(name: str, hidden: int = 16, layers: int = 1, heads: int = 2):
    """The cell's files with the widths and store cut to a CPU test's size
    (the benchmark itself never runs this size)."""
    from bench_port import harness
    cell = harness.load_cell(name)
    model = dict(cell.model, hidden=hidden, layers=layers, heads=heads)
    t = dict(cell.traffic)
    small = max(cell.config["graphs"]["degree"]) > 20
    t.update(store_graphs=32 if small else 96, warmup_epochs_run=1,
             trainer=dict(t["trainer"], batch_size=4 if small else 8))
    return dataclasses.replace(cell, config=dict(cell.config, model=model),
                               traffic=t)


def run_tiny(cell, seed: int = 2147483700, seconds: float = 0.3):
    """One run of `cell` on the CPU as run.py drives it on the card: set-up,
    warm-up, window, release → (driver, state, compared numbers)."""
    from bench_port import harness
    from bench_port.reference.model import Numerics
    drv = harness.driver(cell)
    state = drv.build(cell, seed, "cpu", harness.Obs(trace=False))
    try:
        drv.warm(state)
        drv.window(state, seconds)
        drv.release(state)
        return drv, state, drv.check(state, Numerics(tf32=False))
    finally:
        state.patches.restore()


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the benchmark times "
                    "only the card (run `python3 bench_port/run.py` there)")
    return torch.device("cuda")
