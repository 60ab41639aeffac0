"""The port's boundary-exchange partition (`gnnep_tpu_torch.parallel.
boundary_shard`) against the JAX package's: the host plans array-equal at
S = 1, 2 and 4 over several seeds, the CSR tables equal to JAX's, and the
boundary forward, gradients and step over gloo rank processes equal to
JAX's `make_boundary_forward` / `make_boundary_train_step` on the fake CPU
devices and to the unpartitioned forward and step."""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).parent))

from gnnep_tpu.models import alignn as jm  # noqa: E402
from gnnep_tpu.parallel import boundary_shard as jb  # noqa: E402
from gnnep_tpu.parallel.mesh import make_mesh as j_make_mesh  # noqa: E402
from gnnep_tpu.parallel import train_step as jts  # noqa: E402
from gnnep_tpu.train import loop as jl  # noqa: E402
from gnnep_tpu.utils.synth import synthetic_batch  # noqa: E402
from gnnep_tpu_torch.models import alignn as pm  # noqa: E402
from gnnep_tpu_torch.parallel import boundary_shard as pb  # noqa: E402
from gnnep_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from gnnep_tpu_torch.parallel import train_step as pts  # noqa: E402
from gnnep_tpu_torch.train import artifacts as pa  # noqa: E402
from gnnep_tpu_torch.train import loop as pl  # noqa: E402

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

# the JAX package's fused-vs-table model tolerance (test_pallas_kernel.py)
RTOL, ATOL = 5e-3, 1e-4
FLOOR = -2.9
MU, SD = np.array([4.32, 3.56], np.float32), np.array([0.91, 0.94],
                                                      np.float32)
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds():
    """The gloo worlds of the module, one per mesh, started once."""
    with pmesh.WorldPool() as pool:
        yield lambda d, e: pool.get(pmesh.make_mesh(d, e,
                                                    devices=["cpu"] * (d * e)))


def _batch(seed, n_graphs=2, mean_atoms=60):
    """Graphs larger than a rank's row window, so the exchange runs (the
    JAX package's `_giant_batch`)."""
    return synthetic_batch(np.random.default_rng(seed), n_graphs=n_graphs,
                           mean_atoms=mean_atoms, degree=8, node_dim=16,
                           edge_dim=12, angle_dim=7, global_dim=59,
                           table_cap=24, lg_table_cap=40)


def _cfg():
    return jm.AlignnConfig(node_dim=16, edge_dim=12, angle_dim=7,
                           global_dim=289, target_dim=2, hidden=32, layers=2,
                           heads=2, dropout=0.0, conv_impl="coo")


@pytest.fixture(scope="module")
def model_fx():
    cfg = _cfg()
    params = jm.init_alignn(jax.random.PRNGKey(4), cfg)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]
    model = pa.params_from_leaves(leaves, pm.AlignnConfig(
        **dataclasses.asdict(cfg)))
    state = {k: v.detach().numpy().copy()
             for k, v in model.state_dict().items()}
    return dict(cfg=cfg, params=params, model=model, state=state)


def _assert_equal_tuples(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in a._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)


# ---------------------------------------------------------------------------
# host planning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_plan_boundary_matches_jax(seed, n_shards):
    b = _batch(seed, n_graphs=3, mean_atoms=40)
    if np.asarray(b.nodes).shape[0] % n_shards:
        pytest.skip("arena not divisible")
    jbb, jplan = jb.plan_boundary(b, n_shards)
    pbb, pplan = pb.plan_boundary(b, n_shards)
    _assert_equal_tuples(pbb, jbb)
    assert dataclasses.asdict(pplan) == dataclasses.asdict(jplan)
    assert (pplan.a_arena, pplan.l_arena) == (jplan.a_arena, jplan.l_arena)
    for proj in (True, False):
        assert pplan.comm_bytes_per_conv(32, projected=proj) == \
            jplan.comm_bytes_per_conv(32, projected=proj)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_plan_boundary_batches_matches_jax(n_shards):
    batches = [_batch(7), _batch(8)]
    jbbs, jplan = jb.plan_boundary_batches(batches, n_shards)
    pbbs, pplan = pb.plan_boundary_batches(batches, n_shards)
    assert dataclasses.asdict(pplan) == dataclasses.asdict(jplan)
    for p, j in zip(pbbs, jbbs):
        _assert_equal_tuples(p, j)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_tables_match_jax_csr_fields(n_shards):
    bbs, plan = pb.plan_boundary_batches([_batch(9), _batch(10)], n_shards)
    jtabs, _ = jb.build_boundary_tables(bbs, plan)
    ptabs = pb.build_boundary_tables(bbs, plan)
    assert len(ptabs) == len(jtabs) == 2
    for p, j in zip(ptabs, jtabs):
        for f in pb.BoundaryTables._fields:
            np.testing.assert_array_equal(getattr(p, f), getattr(j, f),
                                          err_msg=f)


def test_exchange_bytes_follow_the_plan():
    """A rank sends S·B raw-state rows a conv: the plan's unprojected
    comm bytes, half the projected (kv) exchange's."""
    _, plan = pb.plan_boundary(_batch(3), 4)
    assert plan.bn > 0 and plan.bl > 0
    b = plan.comm_bytes_per_conv(32, projected=False)
    assert b == {"atom_conv": 4 * plan.bn * 32 * 4,
                 "lg_conv": 4 * plan.bl * 32 * 4}
    kv = plan.comm_bytes_per_conv(32)
    assert all(kv[k] == 2 * b[k] for k in b)


# ---------------------------------------------------------------------------
# forward, gradients and steps over rank processes
# ---------------------------------------------------------------------------

def _run(worlds, model_fx, b, n_shards, n_steps=1, hyper=None, n_data=1,
         extra=()):
    """The port's boundary forward and `n_steps` steps of `b` (and the
    batches of `extra`, one a data slot) → every rank's result."""
    batches = [b, *extra]
    bbs, plan = pb.plan_boundary_batches(batches, n_shards)
    tabs = pb.build_boundary_tables(bbs, plan)
    hyper = hyper or pl.TrainHyper(feature_jitter_std=0.0)
    return worlds(n_data, n_shards).run(
        pts.boundary_steps_rank, model_fx["state"], model_fx["model"].cfg,
        hyper, MU, SD, plan, [bbs] * max(n_steps, 1),
        [tabs] * max(n_steps, 1), [(LR, LR)] * n_steps, FLOOR,
        every_rank=True), bbs, plan


def _jax_loss(params, cfg, b, hyper):
    mean, logvar = jm.alignn_apply(params, cfg, b)
    logvar = jnp.maximum(logvar, hyper.min_logvar_floor)
    y_z = (jnp.log(jnp.maximum(b.y, 1e-12)) - MU) / SD
    nll = 0.5 * (logvar + (mean - y_z) ** 2 / jnp.exp(logvar))
    nll = nll * b.weight[:, None]
    loss = (nll.mean(axis=1) * b.graph_mask).sum()
    loss += hyper.log_sigma_l2 * ((0.5 * logvar) ** 2
                                  * b.graph_mask[:, None]).sum() / 2.0
    return loss / b.graph_mask.sum()


@pytest.mark.parametrize("n_shards", [2, 4])
def test_forward_matches_jax_boundary_forward(worlds, model_fx, n_shards):
    b = _batch(3)
    outs, bbs, plan = _run(worlds, model_fx, b, n_shards, n_steps=0)
    assert plan.bn > 0 and plan.bl > 0     # the exchange really runs
    mesh = j_make_mesh(1, n_shards, devices=jax.devices()[:n_shards])
    fwd = jts.make_boundary_forward(mesh, model_fx["cfg"], FLOOR, plan)
    want = fwd(model_fx["params"], jts.stack_boundary_for_mesh(bbs, 1))
    for out in outs:                        # replicated over the edge axis
        for got, w in zip(out["forward"], want):
            np.testing.assert_allclose(got, np.asarray(w)[0], rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_forward_matches_unpartitioned(worlds, model_fx, n_shards):
    b = _batch(3)
    outs, _, _ = _run(worlds, model_fx, b, n_shards, n_steps=0)
    with torch.no_grad():
        mean, logvar = pm.alignn_apply(model_fx["model"],
                                       pm.DeviceBatch.from_batch(b, "cpu"))
    np.testing.assert_allclose(outs[0]["forward"][0], mean.numpy(),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(outs[0]["forward"][1],
                               np.maximum(logvar.numpy(), FLOOR),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_gradients_match_jax(worlds, model_fx, n_shards):
    """The step's reduced gradients (edge-averaged, over the global graph
    count) against `jax.grad` of the unpartitioned mean loss."""
    b = _batch(5)
    hyper = pl.TrainHyper(feature_jitter_std=0.0)
    outs, _, plan = _run(worlds, model_fx, b, n_shards, hyper=hyper)
    assert plan.bn > 0
    jhyper = jl.TrainHyper(feature_jitter_std=0.0)
    _, want = jax.value_and_grad(_jax_loss)(model_fx["params"],
                                            model_fx["cfg"], b, jhyper)
    names = pm.leaf_names(model_fx["model"].cfg)
    for name, w in zip(names, jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(outs[0]["grads"][name], np.asarray(w),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_step_matches_unpartitioned_step(worlds, model_fx, n_shards):
    """Two boundary steps against two single-device steps of the whole
    batch (the same optimizer tail), and bitwise equal on every rank."""
    b = _batch(6)
    hyper = pl.TrainHyper(feature_jitter_std=0.0)
    outs, _, _ = _run(worlds, model_fx, b, n_shards, n_steps=2, hyper=hyper)
    model = pa.params_from_leaves(
        [model_fx["state"][n] for n in pm.leaf_names(model_fx["model"].cfg)],
        model_fx["model"].cfg)
    step = pl.TrainStep(model, hyper, MU, SD)
    ms = [step(b, None, LR, LR) for _ in range(2)]
    for name, p in model.state_dict().items():
        got = outs[0]["params"][name]
        # Adam moves a parameter by about the LR along its gradient's sign:
        # where the gradient is tiny the sign is noise (two steps: 4 LR)
        tiny = np.abs(outs[0]["grads"][name]) < 10 * ATOL
        np.testing.assert_allclose(got[~tiny], p.numpy()[~tiny], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        assert np.all(np.abs(got - p.numpy()) <= 4 * LR + 1e-6)
        for other in outs[1:]:
            np.testing.assert_array_equal(other["params"][name],
                                          outs[0]["params"][name])
    for k, m in enumerate(ms):
        # the mesh's logvar diagnostics are raw, the single step's floored
        np.testing.assert_allclose(outs[0]["metrics"][k][:5],
                                   [float(x) for x in m][:5], rtol=RTOL,
                                   atol=ATOL)


def test_step_matches_jax_boundary_step(worlds, model_fx):
    jhyper = jl.TrainHyper(feature_jitter_std=0.0)
    b = _batch(5)
    outs, bbs, plan = _run(worlds, model_fx, b, 2)
    mesh = j_make_mesh(1, 2, devices=jax.devices()[:2])
    step, init_opt = jts.make_boundary_train_step(
        mesh, model_fx["cfg"], jhyper, MU, SD, plan, full_metrics=True)
    params = jax.tree.map(jnp.array, model_fx["params"])
    new, _, m = step(params, init_opt(params),
                     jts.stack_boundary_for_mesh(bbs, 1),
                     jax.random.PRNGKey(0), LR, LR, jl.sigma_mask(params))
    for name, a, w in zip(pl.StepMetrics._fields, outs[0]["metrics"][0], m):
        np.testing.assert_allclose(a, float(w), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    grads = outs[0]["grads"]
    names = pm.leaf_names(model_fx["model"].cfg)
    for name, w, p0 in zip(names, jax.tree_util.tree_leaves(new),
                           jax.tree_util.tree_leaves(model_fx["params"])):
        got = outs[0]["params"][name]
        # Adam's first step moves a parameter by about the LR along its
        # gradient's sign; where the gradient is tiny the sign is noise
        tiny = np.abs(grads[name]) < 10 * ATOL
        np.testing.assert_allclose(got[~tiny], np.asarray(w)[~tiny],
                                   rtol=RTOL, atol=ATOL, err_msg=name)
        assert np.all(np.abs(got - np.asarray(p0)) <= 2 * LR + 1e-6)


def test_data_axis_sums_two_giants(worlds, model_fx):
    """A 2 × 2 mesh: two giants, one a data slot, each over two edge
    ranks → the step equals one single-device step on both graphs'
    union (the gradients summed over data, averaged over edge)."""
    b0, b1 = _batch(11), _batch(12)
    hyper = pl.TrainHyper(feature_jitter_std=0.0)
    outs, _, _ = _run(worlds, model_fx, b0, 2, hyper=hyper, n_data=2,
                      extra=(b1,))
    names = pm.leaf_names(model_fx["model"].cfg)
    jhyper = jl.TrainHyper(feature_jitter_std=0.0)

    def loss_sum(p, b):
        return _jax_loss(p, model_fx["cfg"], b, jhyper) * b.graph_mask.sum()

    g0 = jax.grad(loss_sum)(model_fx["params"], b0)
    g1 = jax.grad(loss_sum)(model_fx["params"], b1)
    n = float(np.sum(b0.graph_mask) + np.sum(b1.graph_mask))
    for name, a, c in zip(names, jax.tree_util.tree_leaves(g0),
                          jax.tree_util.tree_leaves(g1)):
        want = (np.asarray(a) + np.asarray(c)) / n
        for out in outs:
            np.testing.assert_allclose(out["grads"][name], want, rtol=RTOL,
                                       atol=ATOL, err_msg=name)
    np.testing.assert_allclose(outs[0]["metrics"][0][1], n)


def test_rank_without_edges_enters_every_collective(worlds, model_fx):
    """One small graph in a wide arena: the upper ranks own padding rows
    only, and still enter each exchange and the pooling all-reduce."""
    b = _batch(13, n_graphs=1, mean_atoms=20)
    bb, plan = pb.plan_boundary(b, 4)
    live = [float(np.asarray(bb.a_mask[s]).sum()) for s in range(4)]
    assert min(live) == 0.0
    outs, _, _ = _run(worlds, model_fx, b, 4)
    with torch.no_grad():
        mean, _ = pm.alignn_apply(model_fx["model"],
                                  pm.DeviceBatch.from_batch(b, "cpu"))
    np.testing.assert_allclose(outs[0]["forward"][0], mean.numpy(),
                               rtol=2e-4, atol=2e-5)
    assert all(np.isfinite(o["metrics"]).all() for o in outs)


def test_jitter_and_dropout_keep_the_tail_replicated(worlds, model_fx):
    """With jitter and dropout on, each rank draws its rows' noise from
    its own stream and the replicated tail's from the edge axis' shared
    one: the loss, the metrics and the parameters stay equal on every
    rank."""
    cfg = dataclasses.replace(model_fx["model"].cfg, dropout=0.3)
    b = _batch(3)
    bbs, plan = pb.plan_boundary_batches([b], 2)
    tabs = pb.build_boundary_tables(bbs, plan)
    outs = worlds(1, 2).run(
        pts.boundary_steps_rank, model_fx["state"], cfg,
        pl.TrainHyper(feature_jitter_std=0.1), MU, SD, plan, [bbs] * 2,
        [tabs] * 2, [(LR, LR)] * 2, FLOOR, 5, every_rank=True)
    np.testing.assert_array_equal(outs[0]["metrics"], outs[1]["metrics"])
    for name in outs[0]["params"]:
        np.testing.assert_array_equal(outs[0]["params"][name],
                                      outs[1]["params"][name])
    assert np.isfinite(outs[0]["metrics"]).all()
