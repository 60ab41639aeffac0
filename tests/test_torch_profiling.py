"""The port's observability (`gnnep_tpu_torch.utils.profiling`): the
throughput meter against the JAX package's on the same batches, the
torch.profiler trace of a block and of a member's first epoch
(`--profile-dir`), and nothing at all for a falsy directory."""
import dataclasses
import io
import json
import pathlib
import sys
from contextlib import redirect_stdout

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from synthetic import make_samples  # noqa: E402

from gnnep_tpu.data.batching import BatchBudget as JBudget  # noqa: E402
from gnnep_tpu.data.batching import epoch_batches as jbatches  # noqa: E402
from gnnep_tpu.data.store import GraphStore as JStore  # noqa: E402
from gnnep_tpu.utils import profiling as jprof  # noqa: E402
from gnnep_tpu_torch.data.batching import BatchBudget as PBudget  # noqa: E402
from gnnep_tpu_torch.data.batching import (  # noqa: E402
    epoch_batches as pbatches)
from gnnep_tpu_torch.data.store import GraphStore as PStore  # noqa: E402
from gnnep_tpu_torch.train import member as pmember  # noqa: E402
from gnnep_tpu_torch.train.config import TrainConfig  # noqa: E402
from gnnep_tpu_torch.train.ensemble import model_config, prepare  # noqa: E402
from gnnep_tpu_torch.utils import profiling as pprof  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's default of a thread a core would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("batch_size", [3, 8])
def test_meter_counts_equal_jax(batch_size):
    samples = make_samples(14, seed=4)
    js, ps = JStore.from_samples(samples), PStore.from_samples(samples)
    idx = list(range(14))
    jb = jbatches(js, idx, JBudget.plan(js, idx, batch_size), shuffle=False)
    pb = pbatches(ps, idx, PBudget.plan(ps, idx, batch_size), shuffle=False)
    jm, pm = jprof.ThroughputMeter(), pprof.ThroughputMeter()
    for a, b in zip(jb, pb):
        jm.count_batch(a)
        pm.count_batch(b)
    assert len(jb) == len(pb) > 0
    assert (pm.edges, pm.graphs) == (jm.edges, jm.graphs)
    assert pm.graphs == 14
    text = pm.summary()
    assert "edges/s" in text and "graphs/s" in text and pm.elapsed > 0


def _traces(d):
    return sorted(pathlib.Path(d).glob("*.pt.trace.json"))


def test_trace_written_on_cpu(tmp_path):
    x = torch.randn(64, 64)
    with pprof.maybe_trace(str(tmp_path / "t")):
        assert torch.autograd.profiler._is_profiler_enabled
        y = (x @ x).relu().sum()
    assert torch.isfinite(y)
    files = _traces(tmp_path / "t")
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())
             ["traceEvents"]}
    assert "aten::mm" in names


@pytest.mark.parametrize("falsy", ["", None])
def test_falsy_dir_does_nothing(tmp_path, monkeypatch, falsy):
    monkeypatch.chdir(tmp_path)
    with pprof.maybe_trace(falsy):
        assert not torch.autograd.profiler._is_profiler_enabled
        torch.ones(3).sum()
    assert list(tmp_path.iterdir()) == []


def test_member_traces_its_first_epoch_only(tmp_path):
    """`profile_dir` traces the first epoch's steps: one trace, holding the
    member's train ops; the best-epoch line carries the meter's
    summary."""
    store = PStore.from_samples(make_samples(20, seed=6))
    cfg = TrainConfig(save_dir=str(tmp_path), batch_size=8, epochs=2,
                      hidden=32, layers=2, heads=2, ensemble_size=2,
                      val_frac=0.2, calib_frac=0.1, test_frac=0.1,
                      pack_workers=1, profile_dir=str(tmp_path / "trace"),
                      verbose=True)
    setup = prepare(cfg, store)
    mc = model_config(cfg, setup.store, budget=setup.budget)
    buf = io.StringIO()
    with redirect_stdout(buf):
        _, _, steps = pmember.train_member(
            setup.store, cfg, mc, setup.transformer, setup.budget, 42,
            setup.train_idx, setup.val_idx, device="cpu")
    files = _traces(tmp_path / "trace")
    assert len(files) == 1 and steps > 0
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    # the backward ran inside the traced window
    assert any(n and "Backward" in n for n in names)
    assert "throughput:" in buf.getvalue()
    # and a run without it writes none
    plain = dataclasses.replace(cfg, profile_dir="",
                                save_dir=str(tmp_path / "b"))
    with redirect_stdout(io.StringIO()):
        pmember.train_member(setup.store, plain, mc, setup.transformer,
                             setup.budget, 42, setup.train_idx,
                             setup.val_idx, device="cpu")
    assert len(_traces(tmp_path / "trace")) == 1
