"""The port's observability (`gnnep_tpu_torch.utils.profiling`): the
throughput meter against the JAX package's on the same batches, the
torch.profiler trace of a block and of a member's first epoch
(`--profile-dir`), nothing at all for a falsy directory, and the program's
`gnnep::` spans: where a member's loop, the staging of a batch and the
captured graphs record them, and no profiler call while none records. The
`gpu` test holds a captured step's spans and capture count on the card."""
import contextlib
import dataclasses
import io
import json
import pathlib
import sys
from contextlib import redirect_stdout

import numpy as np

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
from gnnep_tpu_torch.data.transforms import LogTransformer  # noqa: E402
from gnnep_tpu_torch.models import alignn as pm  # noqa: E402
from gnnep_tpu_torch.ops.cuda import graphs  # noqa: E402
from gnnep_tpu_torch.train import loop as pl  # noqa: E402
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


def _member(tmp_path, **kw):
    """A small member's trainer config, prepared store and model config."""
    store = PStore.from_samples(make_samples(20, seed=6))
    cfg = TrainConfig(save_dir=str(tmp_path), batch_size=8, epochs=2,
                      hidden=32, layers=2, heads=2, ensemble_size=2,
                      val_frac=0.2, calib_frac=0.1, test_frac=0.1,
                      pack_workers=1, **kw)
    setup = prepare(cfg, store)
    return cfg, setup, model_config(cfg, setup.store, budget=setup.budget)


def _spans(events):
    """The trace's `gnnep::` records, name without the prefix."""
    return [dict(e, name=e["name"][len(pprof.SPAN_PREFIX):]) for e in events
            if e.get("ph") == "X"
            and e.get("name", "").startswith(pprof.SPAN_PREFIX)]


def test_member_traces_its_first_epoch_only(tmp_path):
    """`profile_dir` traces the first epoch, from the wait for its batches
    to its bookkeeping: one trace, holding the member's train ops and the
    epoch's spans once; the best-epoch line carries the meter's
    summary."""
    cfg, setup, mc = _member(tmp_path, profile_dir=str(tmp_path / "trace"),
                             verbose=True)
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
    for name in ("member.pack_wait", "member.val", "step.readback"):
        assert "gnnep::" + name in names, name
    # the first epoch's phases, once each; set-up and tear-down outside
    seen = [e["name"] for e in _spans(events)]
    for name in ("member.pack_wait", "member.steps", "member.val",
                 "member.select", "member.epoch_end"):
        assert seen.count(name) == 1, (name, seen)
    assert "member.setup" not in seen and "member.finish" not in seen
    assert "throughput:" in buf.getvalue()
    # and a run without it writes none
    plain = dataclasses.replace(cfg, profile_dir="",
                                save_dir=str(tmp_path / "b"))
    with redirect_stdout(io.StringIO()):
        pmember.train_member(setup.store, plain, mc, setup.transformer,
                             setup.budget, 42, setup.train_idx,
                             setup.val_idx, device="cpu")
    assert len(_traces(tmp_path / "trace")) == 1


# the spans a member's loop records on the CPU (the card's path adds
# stage.*, step.eager and graph.*), and the span each sits in
MEMBER_SPANS = {"member.setup": None, "member.pack_wait": None,
                "member.steps": None, "step.readback": "member.steps",
                "member.val": None, "val.readback": "member.val",
                "val.metrics": "member.val", "member.select": None,
                "member.epoch_end": None, "member.finish": None}


def _inside(child, parent):
    return (child["tid"] == parent["tid"] and parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"]
            <= parent["ts"] + parent["dur"] + 1e-3)


def test_member_spans_nest_on_the_calling_thread(tmp_path):
    """A CPU member under torch.profiler: every span its path reaches, all
    on the thread that called `train_member`, each inside the span it
    belongs to; the epoch's phases carry their epoch, in order."""
    import threading
    from torch.profiler import ProfilerActivity, profile
    cfg, setup, mc = _member(tmp_path)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        pmember.train_member(setup.store, cfg, mc, setup.transformer,
                             setup.budget, 42, setup.train_idx,
                             setup.val_idx, device="cpu")
    prof.export_chrome_trace(str(tmp_path / "member.json"))
    spans = _spans(json.loads((tmp_path / "member.json").read_text())
                   ["traceEvents"])
    assert {e["name"] for e in spans} == set(MEMBER_SPANS)
    assert {e["tid"] for e in spans} == {threading.get_native_id()}
    for e in spans:
        parent = MEMBER_SPANS[e["name"]]
        if parent is not None:
            assert any(_inside(e, p) for p in spans
                       if p["name"] == parent), e
    phases = [e for e in sorted(spans, key=lambda e: e["ts"])
              if e["name"] in ("member.pack_wait", "member.steps",
                               "member.val", "member.select",
                               "member.epoch_end")]
    assert [(e["name"], e["args"].get("epoch")) for e in phases] == [
        (n, epoch) for epoch in (1, 2)
        for n in ("member.pack_wait", "member.steps", "member.val",
                  "member.select", "member.epoch_end")]
    setup_end = max(e["ts"] + e["dur"] for e in spans
                    if e["name"] == "member.setup")
    assert setup_end <= min(e["ts"] for e in phases)


def _raise(*a, **k):
    raise AssertionError("a profiler call with no profiler recording")


def test_span_off_is_one_shared_object(monkeypatch):
    """With no profiler recording, `span` hands out one shared no-op
    context and calls nothing of the profiler's."""
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _raise)
    first = pprof.span("member.steps", epoch=1)
    assert pprof.span("graph.replay") is first
    with first:
        with pprof.span("step.readback"):
            pass


def _host_batch():
    store = PStore.from_samples(make_samples(6, seed=2))
    idx = list(range(6))
    return pbatches(store, idx, PBudget.plan(store, idx, 3),
                    shuffle=False)[0]


def _names(prof):
    return [e.name for e in prof.events()]


def test_copy_from_records_its_staging(tmp_path):
    """`DeviceBatch.copy_from` of a host batch on the CPU records
    `stage.copy` (the card's branch adds `stage.wait`)."""
    from torch.profiler import ProfilerActivity, profile
    batch = _host_batch()
    buf = pm.DeviceBatch.allocate(batch, torch.device("cpu"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        buf.copy_from(batch)
    assert _names(prof).count("gnnep::stage.copy") == 1
    assert torch.equal(buf.nodes, torch.as_tensor(np.asarray(batch.nodes)))


def test_graph_spans_and_capture_counts(monkeypatch):
    """`CountedGraph.capture` and `replay` record `graph.capture` and
    `graph.replay`; `captures` counts a capture of each counted kind and
    none of a kind-less graph. The CUDA graph is stood in for (a replay
    runs nothing here)."""
    from torch.profiler import ProfilerActivity, profile

    class FakeGraph:
        def __getattr__(self, name):
            return lambda *a: None

    class FakeStream:
        device = "cpu"

        def __init__(self, *a):
            pass

        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(graphs, "captures", {"train": 0, "eval": 0})
    monkeypatch.setattr(graphs, "replays", {"train": 0, "eval": 0})
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for kind in ("train", "eval", None):
            g = graphs.CountedGraph(kind)
            assert g.capture(lambda: kind) == kind
            g.replay()
            g.replay()
    names = _names(prof)
    assert names.count("gnnep::graph.capture") == 3
    assert names.count("gnnep::graph.replay") == 6
    assert graphs.captures == {"train": 1, "eval": 1}
    assert graphs.replays == {"train": 2, "eval": 2}


@pytest.mark.gpu
def test_captured_step_spans_and_captures_on_card(tmp_path):
    """A captured train step over 4 batches on the card: one capture of
    kind 'train'; its trace holds the eager warm-up step, the staging wait,
    the capture and the replays as the program's own records, and none of
    them as a device-side annotation (the card's timeline holds its work
    alone)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the captured step runs "
                    "only there")
    from torch.profiler import ProfilerActivity, profile
    from gnnep_tpu_torch.utils.synth import flagship_config
    store = PStore.from_samples(make_samples(12, seed=3))
    idx = list(range(12))
    batches = pbatches(store, idx, PBudget.plan(store, idx, 3,
                                                cover_all=True),
                       shuffle=False)[:4]
    assert len(batches) == 4
    cfg = flagship_config(node_dim=store.node_dim, edge_dim=store.edge_dim,
                          angle_dim=store.angle_dim,
                          global_dim=store.global_scalar_dim + 230,
                          hidden=16, layers=2, heads=2)
    t = LogTransformer.fit(store.y)
    step = pl.make_train_step(pm.init_alignn(np.random.default_rng(0), cfg),
                              pl.TrainHyper(), t.means, t.stds, "cuda")
    assert isinstance(step, pl.GraphTrainStep)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    before = dict(graphs.captures)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step.set_lr(1e-3, 1e-3)
        for b in batches:
            step(b, gen)
        torch.cuda.synchronize()
    step.close()
    assert graphs.captures["train"] - before["train"] == 1
    assert graphs.captures["eval"] == before["eval"]
    prof.export_chrome_trace(str(tmp_path / "step.json"))
    events = json.loads((tmp_path / "step.json").read_text())["traceEvents"]
    spans = _spans(events)
    seen = [e["name"] for e in spans]
    assert seen.count("step.eager") == 1 and seen.count("graph.capture") == 1
    assert seen.count("graph.replay") == 3
    assert seen.count("stage.wait") == 4 and seen.count("stage.copy") == 4
    assert {e.get("cat") for e in spans} == {"cpu_op"}
