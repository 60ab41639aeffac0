"""The port's captured programs (`train.loop.GraphTrainStep`, `Forward`) and
what makes them capturable, checked on the CPU: the step and the eval
forward read nothing back to the host on any rung, the optimizer tail with
its count and LRs as tensors equals optax, `DeviceBatch.copy_from` refills
fixed buffers, `run(K)` equals K single steps, and a graph's replays count
the launches its capture recorded. The `gpu` tests hold the captured step
and forward to the eager ones on the card."""
import contextlib
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import optax

torch = pytest.importorskip("torch")

from gnnep_tpu_torch.data.batching import (BatchBudget,  # noqa: E402
                                           epoch_batches, measure_span64)
from gnnep_tpu_torch.data.store import GraphStore  # noqa: E402
from gnnep_tpu_torch.data.transforms import LogTransformer  # noqa: E402
from gnnep_tpu_torch.models import alignn as pm  # noqa: E402
from gnnep_tpu_torch.ops.cuda import attention_eproj as ep  # noqa: E402
from gnnep_tpu_torch.ops.cuda import graphs  # noqa: E402
from gnnep_tpu_torch.ops.cuda import segment_sum as ss  # noqa: E402
from gnnep_tpu_torch.train import loop as pl  # noqa: E402
from gnnep_tpu_torch.train import member as pmem  # noqa: E402
from gnnep_tpu_torch.train.config import TrainConfig  # noqa: E402
from gnnep_tpu_torch.utils.synth import (flagship_config,  # noqa: E402
                                         synthetic_samples)

# the rungs' config fields; the span rung's bounds come from the batches
RUNGS = {"eproj": {}, "kv+e": {"attn_eproj": False},
         "logits": {"attn_fused": False}, "span": {"attn_span": True}}


@pytest.fixture(scope="module")
def packed():
    """12 small synthetic graphs packed 4 to a batch under one budget."""
    store = GraphStore.from_samples(synthetic_samples(
        np.random.default_rng(3), 12, mean_atoms=5, degree=5))
    idx = list(range(12))
    budget = BatchBudget.plan(store, idx, 4, cover_all=True)
    return store, budget, epoch_batches(store, idx, budget, shuffle=False)


def _cfg(store, batches, rung="eproj", **kw):
    extra = dict(RUNGS[rung])
    if rung == "span":
        spans = [measure_span64(np.asarray(b.node_graph),
                                np.asarray(b.edge_dst),
                                np.asarray(b.edge_mask), b.y.shape[0])
                 for b in batches]
        extra.update(edge_span64=max(s[0] for s in spans),
                     lg_span64=max(s[1] for s in spans))
    return flagship_config(node_dim=store.node_dim, edge_dim=store.edge_dim,
                           angle_dim=store.angle_dim,
                           global_dim=store.global_scalar_dim + 230,
                           hidden=16, layers=2, heads=2, **extra, **kw)


def _step(store, cfg, seed=0, **hyper):
    t = LogTransformer.fit(store.y)
    return pl.make_train_step(pm.init_alignn(np.random.default_rng(seed),
                                             cfg),
                              pl.TrainHyper(**hyper), t.means, t.stds, "cpu")


def _refuse(*a, **k):
    raise AssertionError("the step read a tensor back to the host")


# ------------------------------------------------- (a) nothing read back
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rung", list(RUNGS))
def test_step_and_forward_read_nothing_back(packed, monkeypatch, rung,
                                            dtype):
    """One train step (dropout and jitter on) and one eval forward on the
    CPU with every Python-level readback refused: the CPU's stand-in for
    "the step is capturable" (on the card a readback inside a capture
    raises)."""
    store, _, batches = packed
    cfg = _cfg(store, batches, rung, dropout=0.15)
    step = _step(store, cfg, compute_dtype=dtype)
    forward = pl.make_forward(compute_dtype=dtype)
    member = pl.cast_model(step.model, dtype)
    db = pm.DeviceBatch.from_batch(batches[0], "cpu")
    gen = torch.Generator().manual_seed(0)
    step.set_lr(1e-3, 5e-4)
    for name in ("item", "__bool__", "__float__", "__int__", "tolist", "cpu",
                 "numpy"):
        monkeypatch.setattr(torch.Tensor, name, _refuse)
    m = step(db, gen)
    mean, logvar = forward(member, db)
    monkeypatch.undo()
    assert np.isfinite([float(x) for x in m]).all()
    assert mean.shape == logvar.shape == (db.n_graphs, cfg.target_dim)
    assert torch.isfinite(mean).all() and torch.isfinite(logvar).all()


# -------------------------------------- (b) optimizer tail, tensor scalars
@pytest.mark.parametrize("optimizer", ["adamw", "adam"])
def test_optimizer_tail_with_tensor_count_and_lrs_matches_optax(optimizer):
    """Five steps of identical gradients with the count an int32 tensor and
    each LR group's rate a 0-d f32 tensor (as a captured step reads them),
    the sigma group on its own LR: the parameters equal optax
    `scale_by_adam` + the JAX package's per-leaf update at 1e-6."""
    rng = np.random.default_rng(4)
    shapes = [(3, 4), (4,), (2, 5), (5,)]
    smask = [False, True, False, True]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    hyper = pl.TrainHyper(optimizer=optimizer, grad_clip=2.0,
                          weight_decay=1e-2)
    adam = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
    jp = [jnp.asarray(p) for p in p0]
    state = adam.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    tstate = pl.init_adam(tp)
    lr_mean = torch.zeros((), dtype=torch.float32)
    lr_sigma = torch.zeros((), dtype=torch.float32)
    for k in range(5):
        grads = [rng.normal(size=s).astype(np.float32) * (3 - k)
                 for s in shapes]
        lr_m, lr_s = 1e-2 / (k + 1), 4e-3 * (k + 1)
        lr_mean.fill_(lr_m)
        lr_sigma.fill_(lr_s)
        g = [jnp.asarray(x) for x in grads]
        scale = jnp.minimum(1.0, hyper.grad_clip
                            / jnp.maximum(optax.global_norm(g), 1e-12))
        g = [x * scale for x in g]
        wd = hyper.weight_decay
        if optimizer == "adam":
            g = [x + wd * p for x, p in zip(g, jp)]
            wd = 0.0
        updates, state = adam.update(g, state, jp)
        jp = [p - jnp.where(s, lr_s, lr_m) * (u + wd * p)
              for u, p, s in zip(updates, jp, smask)]
        pl.apply_update(tp, [torch.from_numpy(x) for x in grads], tstate,
                        smask, lr_mean, lr_sigma, hyper)
        assert tstate.count.dtype == torch.int32
        assert int(tstate.count) == int(state.count) == k + 1
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
        for a, b in zip(tstate.mu, state.mu):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)


# ----------------------------------------------------- (c) static buffers
@pytest.mark.parametrize("span", [True, False])
def test_copy_from_refills_the_same_buffers(packed, span):
    """Every field after `copy_from` equals `from_batch` of the same batch,
    for each batch in turn, the span fields present or absent, and no
    buffer moves."""
    _, _, batches = packed
    if not span:
        batches = [b._replace(node_span_lo=None, bond_span_lo=None)
                   for b in batches]
    static = pm.DeviceBatch.allocate(batches[0], "cpu")
    names = [n for n, _ in pm.DeviceBatch._dtypes(batches[0])]
    assert (static.node_span_lo is not None) == span
    ptrs = {n: getattr(static, n).data_ptr() for n in names}
    for b in batches[::-1]:
        static.copy_from(b)
        want = pm.DeviceBatch.from_batch(b, "cpu")
        assert static.n_graphs == want.n_graphs
        for n in names:
            got = getattr(static, n)
            assert got.data_ptr() == ptrs[n], n
            assert got.dtype == getattr(want, n).dtype, n
            assert torch.equal(got, getattr(want, n)), n
    # a device batch refills them by device copies
    static.copy_from(pm.DeviceBatch.from_batch(batches[1], "cpu"))
    assert torch.equal(static.nodes, torch.from_numpy(batches[1].nodes))
    assert all(getattr(static, n).data_ptr() == ptrs[n] for n in names)


def test_copy_from_refuses_another_budget(packed):
    store, _, batches = packed
    static = pm.DeviceBatch.allocate(batches[0], "cpu")
    other = BatchBudget.plan(store, range(12), 6, cover_all=True)
    with pytest.raises(ValueError, match="budget"):
        static.copy_from(epoch_batches(store, range(6), other,
                                       shuffle=False)[0])
    with pytest.raises(ValueError, match="budget"):
        static.copy_from(batches[0]._replace(node_span_lo=None,
                                             bond_span_lo=None))


# ---------------------------------------------- (d) K steps in one chunk
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_run_equals_k_single_steps(packed, dtype):
    """`run` over K batches and K calls from the same start and generator
    seed (dropout and jitter on): equal metrics, parameters, gradients and
    Adam state."""
    store, _, batches = packed
    cfg = _cfg(store, batches, dropout=0.15)
    a, b = (_step(store, cfg, seed=1, compute_dtype=dtype) for _ in "ab")
    ga, gb = (torch.Generator().manual_seed(5) for _ in "ab")
    ms = a.run(batches, ga, 1e-3, 5e-4)
    singles = [b(x, gb, 1e-3, 5e-4) for x in batches]
    for name, got, one in zip(pl.StepMetrics._fields, ms, zip(*singles)):
        assert got.shape == (len(batches),)
        assert torch.equal(got, torch.stack(one)), name
    for pa, pb in zip(a.params, b.params):
        assert torch.equal(pa, pb) and torch.equal(pa.grad, pb.grad)
    for sa, sb in zip(a.state.mu + a.state.nu, b.state.mu + b.state.nu):
        assert torch.equal(sa, sb)
    assert int(a.state.count) == int(b.state.count) == len(batches)


def test_member_loop_summary_does_not_depend_on_the_chunk(packed):
    """The member loop with 3-step chunks (and a remainder each epoch)
    and step by step: the same best metrics, steps and parameters."""
    store, budget, _ = packed
    cfg0 = TrainConfig(epochs=2, batch_size=4, hidden=16, layers=2, heads=2,
                       verbose=False, scan_steps=1, lr=1e-3,
                       bootstrap=False)
    model_cfg = _cfg(store, [], dropout=0.15)
    t = LogTransformer.fit(store.y)
    out = {}
    for k in (1, 3):
        cfg = dataclasses.replace(cfg0, scan_steps=k)
        out[k] = pmem.train_member(store, cfg, model_cfg, t, budget, 11,
                                   list(range(10)) + [0, 1, 2, 3, 4, 5],
                                   [10, 11], device="cpu")
    (m1, best1, n1), (m3, best3, n3) = out[1], out[3]
    assert n1 == n3 >= 2 * 4
    np.testing.assert_equal(best1, best3)
    for (n, p1), p3 in zip(m1.named_parameters(), m3.parameters()):
        assert torch.equal(p1, p3), n


# ------------------------------------------------ launch counts of graphs
def test_replays_count_the_launches_the_capture_recorded(monkeypatch):
    """A capture leaves the counts as they were (nothing ran on the card);
    each replay adds what the capture's wrappers counted. The CUDA graph
    itself is stood in for: the capture runs the Python once, as stream
    capture does, and a replay runs nothing here."""
    class FakeGraph:
        def register_generator_state(self, gen):
            self.gen = gen

        def capture_begin(self):
            pass

        def capture_end(self):
            pass

        def replay(self):
            pass

    class FakeStream:
        device = "cpu"

        def __init__(self, *a):
            pass

        def wait_stream(self, other):
            pass

    @contextlib.contextmanager
    def on_stream(stream):
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "stream", on_stream)
    monkeypatch.setattr(ep, "launches", 5)
    monkeypatch.setattr(ep, "bwd_launches", 0)
    monkeypatch.setattr(ss, "launches", 1)
    monkeypatch.setattr(graphs, "replays", {"train": 0, "eval": 0})

    def body():
        ep.launches += 8
        ep.bwd_launches += 8
        ss.launches += 8
        return "out"

    g = graphs.CountedGraph("train")
    gen = object()
    assert g.capture(body, gen) == "out"
    assert g.graph.gen is gen
    assert (ep.launches, ep.bwd_launches, ss.launches) == (5, 0, 1)
    for _ in range(3):
        g.replay()
    assert (ep.launches, ep.bwd_launches, ss.launches) == (29, 24, 25)
    assert graphs.replays == {"train": 3, "eval": 0}
    with pytest.raises(ValueError):
        graphs.CountedGraph("serve")


# ---------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the captured programs "
                    "run only there (run `python3 chip_smoke.py` or this "
                    "file on one)")
    from gnnep_tpu_torch.utils.device import resolve_device
    return resolve_device("cuda")


def _close(a, b, rtol=5e-3, atol=1e-4):
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return torch.allclose(a, b, rtol=rtol, atol=atol), \
        (a - b).abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("rung", list(RUNGS))
def test_captured_step_equals_eager_on_card(packed, cuda, rung):
    """The card's captured step (one eager warm-up, then replays) and its
    eager step, from the same parameters, over the same batches with
    dropout and jitter on from one generator seed: every step's metrics,
    and the final parameters, at the JAX package's model tolerance (the
    kernels' float atomics keep them from being bitwise equal)."""
    store, _, batches = packed
    cfg = _cfg(store, batches, rung, dropout=0.15)
    t = LogTransformer.fit(store.y)
    seqs = batches * 2
    out = {}
    for kind in ("graph", "eager"):
        model = pm.init_alignn(np.random.default_rng(2), cfg).to(cuda)
        cls = pl.GraphTrainStep if kind == "graph" else pl.TrainStep
        step = cls(model, pl.TrainHyper(), t.means, t.stds)
        gen = torch.Generator(device=cuda).manual_seed(9)
        ms = step.run(seqs, gen, 1e-3, 5e-4)
        out[kind] = (torch.stack(list(ms), 1).cpu(),
                     [p.detach().cpu() for p in step.params], step)
    assert out["graph"][2].graph is not None
    ok, err = _close(out["graph"][0], out["eager"][0])
    assert ok, f"metrics differ by {err:.3e}"
    for a, b in zip(out["graph"][1], out["eager"][1]):
        ok, err = _close(a, b)
        assert ok, f"parameters differ by {err:.3e}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_captured_forward_equals_eager_on_card(packed, cuda, dtype):
    """The captured forward over the batches (the first eager, the second
    captured, every later one replayed) equals the eager forward on each,
    at the model tolerance in f32 and the bf16 kernels' 2e-2 in bf16 (the
    GEMMs cuBLAS picks under capture may round a bf16 output one unit
    apart); the launch counts grow by one forward's kernels per batch."""
    store, _, batches = packed
    cfg = _cfg(store, batches)
    model = pl.cast_model(pm.init_alignn(np.random.default_rng(2), cfg)
                          .to(cuda), dtype)
    forward = pl.make_forward(compute_dtype=dtype)
    before = ep.launches
    for b in batches * 2:
        got = forward(model, b)
        want = forward.eager(model, pm.DeviceBatch.from_batch(b, cuda))
        for g, w in zip(got, want):
            ok, err = _close(g, w, *((5e-3, 1e-4) if dtype == "float32"
                                     else (2e-2, 2e-2)))
            assert ok, f"outputs differ by {err:.3e}"
    assert ep.launches - before == 2 * len(batches) * 2 * 2 * cfg.layers
    forward.close()
