"""The port's train step against `gnnep_tpu.train.loop`: one step from the
same parameters and batch with dropout and jitter off (the JAX side on its
fused rung, Pallas kernels in interpret mode), the optimizer tail against
optax on identical gradients, and the schedule, sigma group and loss."""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from synthetic import make_store  # noqa: E402

from gnnep_tpu.data.batching import (BatchBudget, BatchPacker,  # noqa: E402
                                     measure_span64)
from gnnep_tpu.models import alignn as jm  # noqa: E402
from gnnep_tpu.ops.pallas import csr_attention as jmod  # noqa: E402
from gnnep_tpu.train import loop as jl  # noqa: E402
from gnnep_tpu_torch.models import alignn as pm  # noqa: E402
from gnnep_tpu_torch.ops import dense_attention as pda  # noqa: E402
from gnnep_tpu_torch.ops.cuda import aggregate as ag  # noqa: E402
from gnnep_tpu_torch.ops.cuda import attention as at  # noqa: E402
from gnnep_tpu_torch.ops.cuda import attention_eproj as ep  # noqa: E402
from gnnep_tpu_torch.ops.cuda import attention_span as sp  # noqa: E402
from gnnep_tpu_torch.ops.cuda import segment_sum as ss  # noqa: E402
from gnnep_tpu_torch.train import artifacts as pa  # noqa: E402
from gnnep_tpu_torch.train import loop as pl  # noqa: E402

# the JAX package's fused-vs-table model gradient tolerance
# (test_pallas_kernel.py:614-615)
RTOL, ATOL = 5e-3, 1e-4


@pytest.fixture(scope="module")
def fixture():
    store = make_store(10, seed=12)
    budget = BatchBudget.plan(store, range(10), batch_size=10)
    # 128-divisible arenas, so that the JAX fused path takes the eproj rung
    # and the csr_gather_ordered backward
    budget = dataclasses.replace(budget, n_nodes=128, n_edges=256,
                                 n_lg_edges=1024)
    batch = next(iter(BatchPacker(store, budget).pack(range(10))))
    # partial targets and non-uniform weights exercise the loss's masks
    y_mask = np.asarray(batch.y_mask).copy()
    y_mask[1, 0] = 0.0
    weight = np.asarray(batch.weight).copy()
    weight[:4] = [0.5, 2.0, 1.5, 0.25]
    batch = batch._replace(y_mask=y_mask, weight=weight.astype(np.float32))
    cfg = jm.AlignnConfig(
        node_dim=store.node_dim, edge_dim=store.edge_dim,
        angle_dim=store.angle_dim, global_dim=store.global_scalar_dim + 230,
        target_dim=2, hidden=16, layers=2, heads=2, dropout=0.0,
        conv_impl="fused", force_fused=True)
    params = jm.init_alignn(jax.random.PRNGKey(0), cfg)
    ys = np.asarray(batch.y)[np.asarray(batch.graph_mask) > 0]
    means = np.log(ys).mean(0).astype(np.float32)
    stds = np.log(ys).std(0).astype(np.float32) + 0.1
    return dict(batch=batch, cfg=cfg, params=params, means=means, stds=stds)


def _port_model(fx, jcfg=None):
    cfg = pm.AlignnConfig(**dataclasses.asdict(jcfg or fx["cfg"]))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(fx["params"])]
    return pa.params_from_leaves(leaves, cfg)


def _launches():
    return (ep.launches, ep.bwd_launches, ag.launches, ag.bwd_launches,
            at.launches, at.bwd_launches, ss.launches, sp.launches,
            sp.bwd_launches)


def _step_parity(fx, jcfg, optimizer, tiny_grad=0.0):
    """One step of the JAX package's `make_train_step` (config `jcfg`) and of
    the port's `TrainStep` from the same parameters and batch: loss, step
    metrics, grads and updated params. With `tiny_grad` > 0, an updated
    parameter whose JAX gradient is below it in magnitude is held only to
    Adam's first-step bound (each side moves it by at most the LR, 1e-3):
    there g / (|g| + eps) turns differences far inside the gradient
    tolerance into another step."""
    hyper_kw = dict(feature_jitter_std=0.0, optimizer=optimizer)
    jhyper = jl.TrainHyper(**hyper_kw)
    batch = fx["batch"]
    mu, sd = jnp.asarray(fx["means"]), jnp.asarray(fx["stds"])
    y_z = (jnp.log(jnp.maximum(jnp.asarray(batch.y), 1e-12)) - mu) / sd
    jbatch = jax.tree.map(jnp.asarray, batch)
    key = jax.random.PRNGKey(1)
    (j_loss, _), j_grads = jax.value_and_grad(
        lambda p: jl.hetero_nll(p, jcfg, jhyper, jbatch, y_z, key,
                                train=True), has_aux=True)(fx["params"])
    step, init_opt = jl.make_train_step(jcfg, jhyper, fx["means"],
                                        fx["stds"])
    params = jax.tree.map(jnp.array, fx["params"])
    new_params, _, j_m = step(params, init_opt(params),
                              jl.sigma_mask(params), jbatch, key, 1e-3, 5e-4)

    model = _port_model(fx, jcfg)
    train_step = pl.TrainStep(model, pl.TrainHyper(**hyper_kw), fx["means"],
                              fx["stds"])
    dbatch = pm.DeviceBatch.from_batch(batch, "cpu")
    launches = _launches()
    with torch.no_grad():
        y_z_t = pl.target_z(dbatch, train_step.mu, train_step.sd)
        p_loss, _ = pl.hetero_nll(model, train_step.hyper, dbatch, y_z_t,
                                  None, train=True)
    np.testing.assert_allclose(p_loss.item(), float(j_loss), rtol=RTOL)
    p_m = train_step(dbatch, torch.Generator().manual_seed(0), 1e-3, 5e-4)
    assert _launches() == launches
    for name, a, b in zip(pl.StepMetrics._fields, p_m, j_m):
        np.testing.assert_allclose(float(a), float(b), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    names = pm.leaf_names(model.cfg)
    got = dict(model.named_parameters())
    for name, g, p in zip(names, jax.tree_util.tree_leaves(j_grads),
                          jax.tree_util.tree_leaves(new_params)):
        np.testing.assert_allclose(got[name].grad.numpy(), np.asarray(g),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"grad {name}")
        if tiny_grad > 0:
            keep = np.abs(np.asarray(g)) >= tiny_grad
            diff = np.abs(got[name].detach().numpy() - np.asarray(p))
            assert (diff[~keep] <= 2e-3 + ATOL).all(), f"param {name}"
            np.testing.assert_allclose(got[name].detach().numpy()[keep],
                                       np.asarray(p)[keep], rtol=RTOL,
                                       atol=ATOL, err_msg=f"param {name}")
        else:
            np.testing.assert_allclose(got[name].detach().numpy(),
                                       np.asarray(p), rtol=RTOL, atol=ATOL,
                                       err_msg=f"param {name}")


@pytest.mark.parametrize("optimizer", ["adamw", "adam"])
def test_train_step_matches_jax(fixture, optimizer):
    _step_parity(fixture, fixture["cfg"], optimizer)


@pytest.mark.parametrize("rung", ["attn_fused", "attn_eproj"])
def test_train_step_matches_jax_on_rung(fixture, monkeypatch, rung):
    """The external-logits rung (`attn_fused=False`, Pallas `_kernel` /
    `_bwd_kernel` and the q gather's `csr_gather`) and the kv+e rung
    (`attn_eproj=False`, `_attn_kernel` / `_attn_bwd_kernel`), both with
    `conv_impl='fused', force_fused=True`, against the port's step on the
    same rung, which reaches that rung's own backward."""
    jcfg = dataclasses.replace(fixture["cfg"], **{rung: False})
    mod, name = ((ag, "aggregate_bwd_plain") if rung == "attn_fused"
                 else (at, "attention_bwd_plain"))
    calls = []
    real = getattr(mod, name)
    monkeypatch.setattr(mod, name,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _step_parity(fixture, jcfg, "adamw")
    assert len(calls) == 2 * jcfg.layers


def test_train_step_matches_jax_on_span_rung(fixture, monkeypatch):
    """The span rung (`conv_impl='fused', force_fused=True, attn_span=True`
    with the bounds `measure_span64` gives on the fixture's batch) against
    the port's step on it. The JAX side really runs `fused_attention_span`:
    its preconditions (csr_attention.py:2193) hold at this size, where the
    bounds are 128 rows each within 128- and 256-row arenas. The port runs
    the span plain versions in every conv and gathers no edge-space kv."""
    batch = fixture["batch"]
    nsp, bsp = measure_span64(np.asarray(batch.node_graph),
                              np.asarray(batch.edge_dst),
                              np.asarray(batch.edge_mask), batch.y.shape[0])
    assert 0 < nsp <= batch.nodes.shape[0] and 0 < bsp <= \
        batch.edge_src.shape[0]
    jcfg = dataclasses.replace(fixture["cfg"], attn_span=True,
                               edge_span64=nsp, lg_span64=bsp)
    calls = {}
    for mod, name in ((jmod, "fused_attention_span"),
                      (sp, "attention_span_plain"),
                      (sp, "attention_span_bwd_plain")):
        def counted(*a, _name=name, _real=getattr(mod, name), **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, counted)

    def refuse(*a, **k):
        raise AssertionError("the span rung gathered an edge-space kv")

    monkeypatch.setattr(pda, "csr_gather_ordered", refuse)
    _step_parity(fixture, jcfg, "adamw")
    layers = jcfg.layers
    # JAX traces the loss and the jitted step once each; the port's
    # forward runs in its loss check and in the step
    assert calls["fused_attention_span"] >= 2 * layers
    assert (calls["attention_span_plain"],
            calls["attention_span_bwd_plain"]) == (4 * layers, 2 * layers)


@pytest.mark.parametrize("optimizer", ["adamw", "adam"])
def test_optimizer_tail_matches_optax(optimizer):
    """Identical gradients through two steps, both LR groups: the port's
    tail against optax `scale_by_adam` + the JAX package's per-leaf update
    (train/loop.py:246-262), at 1e-6."""
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (4,), (2, 5)]
    smask = [False, True, False]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    steps = [[rng.normal(size=s).astype(np.float32) * 3 for s in shapes]
             for _ in range(2)]
    hyper = pl.TrainHyper(optimizer=optimizer, grad_clip=2.0,
                          weight_decay=1e-2)
    adam = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
    jp = [jnp.asarray(p) for p in p0]
    state = adam.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    tstate = pl.init_adam(tp)
    for grads in steps:
        g = [jnp.asarray(x) for x in grads]
        gnorm = optax.global_norm(g)
        scale = jnp.minimum(1.0, hyper.grad_clip / jnp.maximum(gnorm, 1e-12))
        g = [x * scale for x in g]
        wd = hyper.weight_decay
        if optimizer == "adam":
            g = [x + wd * p for x, p in zip(g, jp)]
            wd = 0.0
        updates, state = adam.update(g, state, jp)
        jp = [p - jnp.where(s, 5e-3, 1e-2) * (u + wd * p)
              for u, p, s in zip(updates, jp, smask)]
        got_norm = pl.apply_update(tp, [torch.from_numpy(x) for x in grads],
                                   tstate, smask, 1e-2, 5e-3, hyper)
        np.testing.assert_allclose(float(got_norm), float(gnorm), rtol=1e-6)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)


def test_cosine_lr_matches_jax():
    for args in ((10, 2, 3e-4, 1e-5), (5, 8, 1e-3, 0.0), (1, 0, 2e-4, 1e-5)):
        want, got = jl.cosine_lr(*args), pl.cosine_lr(*args)
        for e in range(args[0] + 2):
            assert got(e) == pytest.approx(want(e), rel=1e-12)


def test_sigma_mask_marks_the_logvar_head(fixture):
    model = _port_model(fixture)
    want = jax.tree_util.tree_leaves(jl.sigma_mask(fixture["params"]))
    got = pl.sigma_mask(model)
    assert [got[n] for n in pm.leaf_names(model.cfg)] == want
    assert sum(want) == 2


def test_loss_tail_matches_jax():
    """`hetero_nll`'s tail with a partial y_mask, weights and the floor:
    the JAX package's `nll_loss_sums` and `masked_sample_nll` on the same
    arrays."""
    rng = np.random.default_rng(5)
    g, t = 6, 2
    mean = rng.normal(size=(g, t)).astype(np.float32)
    logvar = rng.normal(size=(g, t)).astype(np.float32) * 2 - 1
    y = np.exp(rng.normal(4, 1, size=(g, t))).astype(np.float32)
    y_mask = (rng.random((g, t)) > 0.3).astype(np.float32)
    gm = np.array([1, 1, 1, 1, 0, 0], np.float32)
    w = rng.uniform(0.2, 2, g).astype(np.float32)
    mu, sd = np.float32([4.0, 4.1]), np.float32([0.9, 1.1])
    hyper = jl.TrainHyper()
    batch_j = type("B", (), dict(y=jnp.asarray(y), y_mask=jnp.asarray(y_mask),
                                 graph_mask=jnp.asarray(gm),
                                 weight=jnp.asarray(w)))
    loss_sum, sample_sum, n_real = jl.nll_loss_sums(
        jnp.asarray(mean), jnp.asarray(logvar), batch_j, jnp.asarray(mu),
        jnp.asarray(sd), hyper)
    want = float(loss_sum) / float(n_real)

    lv = np.maximum(logvar, hyper.min_logvar_floor)
    y_z = (np.log(y) - mu) / sd
    nll = torch.from_numpy((0.5 * (lv + (mean - y_z) ** 2 / np.exp(lv))
                            * w[:, None]).astype(np.float32))
    sample = pl.masked_sample_nll(nll, torch.from_numpy(y_mask),
                                  torch.from_numpy(gm))
    np.testing.assert_allclose(float(sample.sum()), float(sample_sum),
                               rtol=1e-6)
    np.testing.assert_allclose(
        sample.numpy(), np.asarray(jl.masked_sample_nll(
            jnp.asarray(nll.numpy()), jnp.asarray(y_mask), jnp.asarray(gm))),
        rtol=1e-6)
    # the whole loss through the port's hetero_nll on a stub model
    dbatch = type("D", (), dict(y=torch.from_numpy(y),
                                y_mask=torch.from_numpy(y_mask),
                                graph_mask=torch.from_numpy(gm),
                                weight=torch.from_numpy(w)))
    orig = pl._compute_forward
    try:
        pl._compute_forward = lambda *a, **k: (torch.from_numpy(mean),
                                               torch.from_numpy(logvar))
        got, _ = pl.hetero_nll(None, pl.TrainHyper(), dbatch,
                               torch.from_numpy(y_z.astype(np.float32)),
                               None, train=False)
    finally:
        pl._compute_forward = orig
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_bf16_step_keeps_f32_params_and_state(fixture):
    """Under bf16 the forward runs in bf16 from the f32 parameters cast
    inside the graph: gradients, parameters and Adam state stay f32."""
    model = _port_model(fixture)
    step = pl.TrainStep(model, pl.TrainHyper(compute_dtype="bfloat16"),
                        fixture["means"], fixture["stds"])
    m = step(pm.DeviceBatch.from_batch(fixture["batch"], "cpu"),
             torch.Generator().manual_seed(0), 1e-3, 1e-3)
    assert np.isfinite(float(m.loss_sum))
    for p, mu in zip(step.params, step.state.mu):
        assert p.dtype == p.grad.dtype == mu.dtype == torch.float32
        assert torch.isfinite(p).all()


def test_dropout_draws_from_the_generator(fixture):
    """Same seed, same step; another seed, another step."""
    def run(seed):
        model = _port_model(fixture)
        model.cfg = dataclasses.replace(model.cfg, dropout=0.3)
        step = pl.TrainStep(model, pl.TrainHyper(), fixture["means"],
                            fixture["stds"])
        return float(step(pm.DeviceBatch.from_batch(fixture["batch"], "cpu"),
                          torch.Generator().manual_seed(seed), 1e-3,
                          1e-3).loss_sum)

    assert run(0) == run(0)
    assert run(0) != run(1)
