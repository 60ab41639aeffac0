"""The port's mesh (`gnnep_tpu_torch.parallel.mesh`) and graph-aligned step
(`parallel.train_step`) against the JAX package: the collectives over gloo
rank processes, the aligned step and its `StepMetrics` against JAX's
`make_aligned_train_step` on the fake CPU devices (D·E = 2 and 4), against
the port's own single-device step over the union batch, bitwise across
ranks, inert pad slots, the fan-out forward, and `cli.train --data-shards`
(its members served by the JAX package)."""
import dataclasses
import json
import operator
import pathlib
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from synthetic import make_samples, make_store  # noqa: E402

from gnnep_tpu.data.batching import BatchBudget, epoch_batches  # noqa: E402
from gnnep_tpu.models import alignn as jm  # noqa: E402
from gnnep_tpu.parallel import train_step as jts  # noqa: E402
from gnnep_tpu.parallel.mesh import make_mesh as j_make_mesh  # noqa: E402
from gnnep_tpu.train import loop as jl  # noqa: E402
from gnnep_tpu_torch.data.store import GraphStore as PStore  # noqa: E402
from gnnep_tpu_torch.data.store import save_sample, write_index  # noqa: E402
from gnnep_tpu_torch.models import alignn as pm  # noqa: E402
from gnnep_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from gnnep_tpu_torch.parallel import train_step as pts  # noqa: E402
from gnnep_tpu_torch.train import artifacts as pa  # noqa: E402
from gnnep_tpu_torch.train import loop as pl  # noqa: E402
from gnnep_tpu_torch.train.config import TrainConfig  # noqa: E402
from gnnep_tpu_torch.train.member import member_mesh  # noqa: E402

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

# the JAX package's fused-vs-table model tolerance (test_pallas_kernel.py)
RTOL, ATOL = 5e-3, 1e-4
LR = 1e-3
MESHES = [(1, 2), (2, 1), (2, 2)]
IDS = [f"{d}x{e}" for d, e in MESHES]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds():
    with pmesh.WorldPool() as pool:
        yield lambda d, e: pool.get(pmesh.make_mesh(d, e,
                                                    devices=["cpu"] * (d * e)))


@pytest.fixture(scope="module")
def fx():
    """Sub-batches of 4 graphs and the union batch of the same 16, a
    member from JAX's init, its port twin and the target statistics."""
    store = make_store(16, seed=21)
    idx = list(range(16))
    sub = epoch_batches(store, idx, BatchBudget.plan(store, idx, 4,
                                                     cover_all=True),
                        shuffle=False)
    union = epoch_batches(store, idx, BatchBudget.plan(store, idx, 16,
                                                       cover_all=True),
                          shuffle=False)
    assert len(sub) == 4 and len(union) == 1
    # partial targets and non-uniform weights exercise the loss's masks
    b0 = sub[0]
    y_mask = np.asarray(b0.y_mask).copy()
    y_mask[1, 0] = 0.0
    weight = np.asarray(b0.weight).copy()
    weight[:2] = [0.5, 2.0]
    sub[0] = b0._replace(y_mask=y_mask, weight=weight.astype(np.float32))
    cfg = jm.AlignnConfig(
        node_dim=store.node_dim, edge_dim=store.edge_dim,
        angle_dim=store.angle_dim, global_dim=store.global_scalar_dim + 230,
        target_dim=2, hidden=32, layers=1, heads=2, dropout=0.0,
        conv_impl="coo")
    params = jm.init_alignn(jax.random.PRNGKey(3), cfg)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]
    pcfg = pm.AlignnConfig(**dataclasses.asdict(cfg))
    model = pa.params_from_leaves(leaves, pcfg)
    state = {k: v.detach().numpy().copy()
             for k, v in model.state_dict().items()}
    ys = np.log(np.asarray(store.y))
    return dict(sub=sub, union=union[0], cfg=cfg, pcfg=pcfg, params=params,
                state=state, means=ys.mean(0).astype(np.float32),
                stds=(ys.std(0) + 0.1).astype(np.float32))


def _aligned(worlds, fx, d, e, n_steps=1, slots=None, hyper=None):
    n = d * e
    slots = slots or [pts.stack_for_mesh(fx["sub"][k * n:(k + 1) * n], n)
                      for k in range(n_steps)]
    return worlds(d, e).run(
        pts.aligned_steps_rank, fx["state"], fx["pcfg"],
        hyper or pl.TrainHyper(feature_jitter_std=0.0), fx["means"],
        fx["stds"], slots, [(LR, LR)] * len(slots), every_rank=True)


def _model(fx):
    return pa.params_from_leaves(
        [fx["state"][n] for n in pm.leaf_names(fx["pcfg"])], fx["pcfg"])


# ---------------------------------------------------------------------------
# the mesh and its collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,e", [(1, 1), *MESHES, (1, 4)],
                         ids=["1x1", *IDS, "1x4"])
def test_collectives(worlds, d, e):
    for out in worlds(d, e).run(pmesh.probe_collectives, every_rank=True):
        assert all(out.values()), [k for k, v in out.items() if not v]


@pytest.mark.parametrize("kw,match", [
    (dict(n_data=3, n_edge=2, devices=["cpu"] * 4), "device count"),
    (dict(n_data=2, devices=["cuda:0", "cuda:0"]), "used by two slots"),
    (dict(n_data=2, devices=["cpu", "cpu"], backend="nccl"), "CUDA"),
    (dict(n_data=2, devices=["cpu", "cuda:0"]), "one device type"),
])
def test_make_mesh_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        pmesh.make_mesh(**kw)


def test_make_mesh_layout():
    m = pmesh.make_mesh(2, 2, devices=["cpu"] * 4)
    assert (m.backend, m.size) == ("gloo", 4)
    assert [m.coords(r) for r in range(4)] == [(0, 0), (0, 1), (1, 0),
                                               (1, 1)]
    two = pmesh.make_mesh(devices=["cuda:0", "cuda:0"], backend="gloo")
    assert (two.n_data, two.n_edge, two.backend) == (2, 1, "gloo")


def test_member_mesh_needs_a_card_a_slot(monkeypatch):
    """On the card a slot takes its own card: fewer raise the JAX
    package's ValueError; the CPU runs any number over gloo."""
    cfg = TrainConfig(data_shards=2, edge_shards=2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="4 device slots, but only 2"):
        member_mesh(cfg, "cuda")
    mesh = member_mesh(cfg, "cpu")
    assert (mesh.n_data, mesh.n_edge, mesh.backend) == (2, 2, "gloo")
    assert member_mesh(TrainConfig(), "cuda") is None


def test_a_failing_rank_raises_with_its_traceback():
    with pmesh.World(pmesh.make_mesh(2, 1, devices=["cpu"] * 2)) as w:
        with pytest.raises(RuntimeError,
                           match="(?s)failed in truediv.*TypeError"):
            w.run(operator.truediv, 0)
        assert not w.procs


def _multihost_rank(rank):
    """In an initialized group: `init_distributed` is a no-op, and the
    multi-host mesh keeps the edge axis inside a host."""
    pmesh.init_distributed()
    out = [pmesh.make_multihost_mesh(n_edge=2, local_size=2)]
    for bad in (3, 4):
        try:
            pmesh.make_multihost_mesh(n_edge=bad, local_size=2)
        except ValueError as exc:
            out.append(str(exc))
    return out


def test_multihost_mesh_in_an_initialized_group(worlds):
    mesh, *errors = worlds(1, 2).run(_multihost_rank)
    assert (mesh.n_data, mesh.n_edge, mesh.backend) == (1, 2, "gloo")
    assert len(errors) == 2 and all("must divide" in e for e in errors)
    with pytest.raises(RuntimeError, match="init_distributed first"):
        pmesh.make_multihost_mesh()


def test_one_slot_runs_in_process():
    world = pmesh.World(pmesh.make_mesh(1, 1, devices=["cpu"]))
    assert world.procs == []
    out = world.run(pmesh.probe_collectives)
    assert all(out.values())


# ---------------------------------------------------------------------------
# the aligned step
# ---------------------------------------------------------------------------

def test_stack_for_mesh_pads_as_jax(fx):
    b = fx["sub"][:1]
    got = pts.stack_for_mesh(b, 3)
    want = jts.stack_for_mesh(b, 3)
    for f in want._fields:
        np.testing.assert_array_equal(
            np.stack([np.asarray(getattr(g, f)) for g in got]),
            np.asarray(getattr(want, f)), err_msg=f)
    with pytest.raises(ValueError, match="3 batches for 2 slots"):
        pts.stack_for_mesh(fx["sub"][:3], 2)


@pytest.mark.parametrize("d,e", MESHES, ids=IDS)
def test_aligned_step_matches_jax(worlds, fx, d, e):
    """One step: `StepMetrics` and reduced gradients against JAX's aligned
    step and `jax.grad`, updated parameters against JAX's."""
    n = d * e
    outs = _aligned(worlds, fx, d, e)
    jhyper = jl.TrainHyper(feature_jitter_std=0.0)
    mesh = j_make_mesh(d, e, devices=jax.devices()[:n])
    step, init_opt = jts.make_aligned_train_step(
        mesh, fx["cfg"], jhyper, fx["means"], fx["stds"], full_metrics=True)
    params = jax.tree.map(jnp.array, fx["params"])
    new, _, m = step(params, init_opt(params),
                     jts.stack_for_mesh(fx["sub"][:n], n),
                     jax.random.PRNGKey(0), LR, LR, jl.sigma_mask(params))
    for name, a, w in zip(pl.StepMetrics._fields, outs[0]["metrics"][0], m):
        np.testing.assert_allclose(a, float(w), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    mu, sd = jnp.asarray(fx["means"]), jnp.asarray(fx["stds"])

    def loss_sum(p, b):
        mean, logvar = jm.alignn_apply(p, fx["cfg"], b)
        return jl.nll_loss_sums(mean, logvar, b, mu, sd, jhyper)[0]

    grads = [jax.grad(loss_sum)(fx["params"], b) for b in fx["sub"][:n]]
    n_graphs = sum(float(np.sum(b.graph_mask)) for b in fx["sub"][:n])
    names = pm.leaf_names(fx["pcfg"])
    for k, name in enumerate(names):
        want = sum(np.asarray(jax.tree_util.tree_leaves(g)[k])
                   for g in grads) / n_graphs
        got = outs[0]["grads"][name]
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
        new_p = np.asarray(jax.tree_util.tree_leaves(new)[k])
        # Adam's first step moves a parameter by about the LR along its
        # gradient's sign; where the gradient is tiny the sign is noise
        tiny = np.abs(want) < 10 * ATOL
        np.testing.assert_allclose(outs[0]["params"][name][~tiny],
                                   new_p[~tiny], rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("d,e", MESHES, ids=IDS)
def test_aligned_step_equals_union_batch_step(worlds, fx, d, e):
    """D·E sub-batches through the aligned step = one single-device step
    over the union batch of the same graphs (two steps, the second on the
    next D·E sub-batches and again the union)."""
    n = d * e
    if n == 4:
        slots = [pts.stack_for_mesh(fx["sub"], 4)] * 2
    else:
        slots = [pts.stack_for_mesh(fx["sub"][:2], 2)] * 2
    outs = _aligned(worlds, fx, d, e, slots=slots)
    store = make_store(16, seed=21)
    idx = list(range(8 if n == 2 else 16))
    union = epoch_batches(store, idx, BatchBudget.plan(
        store, idx, len(idx), cover_all=True), shuffle=False)[0]
    # the same masks and weights as the fixture's first sub-batch
    y_mask = np.asarray(union.y_mask).copy()
    y_mask[1, 0] = 0.0
    weight = np.asarray(union.weight).copy()
    weight[:2] = [0.5, 2.0]
    union = union._replace(y_mask=y_mask, weight=weight.astype(np.float32))
    model = _model(fx)
    step = pl.TrainStep(model, pl.TrainHyper(feature_jitter_std=0.0),
                        fx["means"], fx["stds"])
    ms = [step(union, None, LR, LR) for _ in range(2)]
    for name, p in model.state_dict().items():
        got = outs[0]["params"][name]
        # Adam moves a parameter by about the LR along its gradient's sign:
        # where the gradient is tiny the sign is noise (two steps: 4 LR)
        tiny = np.abs(outs[0]["grads"][name]) < 10 * ATOL
        np.testing.assert_allclose(got[~tiny], p.numpy()[~tiny], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        assert np.all(np.abs(got - p.numpy()) <= 4 * LR + 1e-6)
    for k, m in enumerate(ms):
        np.testing.assert_allclose(outs[0]["metrics"][k][:5],
                                   [float(x) for x in m][:5], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("d,e", MESHES, ids=IDS)
def test_parameters_bitwise_equal_across_ranks(worlds, fx, d, e):
    hyper = pl.TrainHyper(feature_jitter_std=0.1)
    cfg = dataclasses.replace(fx["pcfg"], dropout=0.2)
    n = d * e
    slots = [pts.stack_for_mesh(fx["sub"][k * n:(k + 1) * n] or
                                fx["sub"][:n], n) for k in range(3)]
    outs = worlds(d, e).run(pts.aligned_steps_rank, fx["state"], cfg, hyper,
                            fx["means"], fx["stds"], slots, [(LR, LR)] * 3,
                            11, every_rank=True)
    for out in outs[1:]:
        np.testing.assert_array_equal(out["metrics"], outs[0]["metrics"])
        for name in out["params"]:
            np.testing.assert_array_equal(out["params"][name],
                                          outs[0]["params"][name])
    assert np.isfinite(outs[0]["metrics"]).all()


def test_inert_slots_contribute_nothing(worlds, fx):
    """One real sub-batch and an inert pad slot = the single-device step
    on that sub-batch alone."""
    slots = [pts.stack_for_mesh(fx["sub"][:1], 2)] * 2
    assert float(np.sum(slots[0][1].graph_mask)) == 0.0
    outs = _aligned(worlds, fx, 1, 2, slots=slots)
    model = _model(fx)
    step = pl.TrainStep(model, pl.TrainHyper(feature_jitter_std=0.0),
                        fx["means"], fx["stds"])
    ms = [step(fx["sub"][0], None, LR, LR) for _ in range(2)]
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(outs[0]["params"][name], p.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(outs[0]["metrics"][1][:5],
                               [float(x) for x in ms[1]][:5], rtol=1e-5)


def test_scan_chunks_equal_single_steps(worlds, fx):
    """`run(K)` on the aligned step (one metric readback for K steps)
    equals K calls."""
    slots = [pts.stack_for_mesh(fx["sub"][k * 2:k * 2 + 2], 2)
             for k in range(2)]
    a = _aligned(worlds, fx, 1, 2, slots=slots)
    host = {k: fx[k] for k in ("state", "pcfg", "means", "stds")}
    b = worlds(1, 2).run(_aligned_run_rank, host, slots, every_rank=True)
    np.testing.assert_array_equal(a[0]["metrics"], b[0]["metrics"])
    for name in a[0]["params"]:
        np.testing.assert_array_equal(a[0]["params"][name],
                                      b[0]["params"][name])


def _aligned_run_rank(rank, fx, slots):
    model = pa.params_from_leaves(
        [fx["state"][n] for n in pm.leaf_names(fx["pcfg"])], fx["pcfg"])
    step = pts.make_aligned_train_step(
        rank, model, pl.TrainHyper(feature_jitter_std=0.0), fx["means"],
        fx["stds"])
    ms = step.run([s[rank.rank] for s in slots], None, LR, LR)
    return {"metrics": torch.stack(list(ms), dim=1).numpy(),
            "params": {k: v.detach().numpy()
                       for k, v in model.state_dict().items()}}


def test_fan_out_forward_equals_single_device(fx):
    """`AlignedForward` (the JAX package's `collect_predictions_auto`) over
    devices ['cpu', 'cpu'] = the single-device loop, and each device's
    member copy is made once."""
    model = _model(fx)
    fan = pts.AlignedForward(pl.make_forward(), devices=["cpu", "cpu"])
    got = fan(model, fx["sub"])
    again = fan(model, fx["sub"])
    assert len(fan._copies) == 1
    want = pl.collect_predictions(pl.make_forward(), model, fx["sub"])
    for g, a, w in zip(got, again, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(a, w)
    one = pts.AlignedForward(pl.make_forward())
    assert one.devices_for(model) == [torch.device("cpu")]
    fan.close()


# ---------------------------------------------------------------------------
# cli.train over a mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_cli")
    data = root / "data"
    samples = make_samples(28, seed=9)
    for s in samples:
        save_sample(data, s)
    write_index(data, PStore.from_samples(samples))
    return root


def _train_argv(root, out, *extra):
    return ["--data-dir", str(root / "data"), "--save-dir", str(out),
            "--device", "cpu", "--hidden", "16", "--layers", "1",
            "--heads", "2", "--ensemble-size", "2", "--epochs", "2",
            "--batch-size", "4", "--seed", "3", "--val-frac", "0.15",
            "--calib-frac", "0.15", "--test-frac", "0.15", *extra]


def test_cli_train_over_data_shards(data_dir, tmp_path, capfd):
    """`cli.train --data-shards 2 --edge-shards 2` trains each member over
    four gloo ranks (each optimizer step takes four sub-batches), rank 0
    alone reporting; the members serve in the JAX package as in the
    port."""
    from gnnep_tpu.infer import predict as jp
    from gnnep_tpu.data.store import GraphStore as JStore
    from gnnep_tpu_torch.cli import train as tcli
    from gnnep_tpu_torch.infer import predict as ip

    out = tmp_path / "ens"
    capfd.readouterr()
    summary = tcli.main(_train_argv(data_dir, out, "--data-shards", "2",
                                    "--edge-shards", "2", "--scan-steps",
                                    "2"))
    # each member's epochs are reported once, by its rank 0
    assert capfd.readouterr().out.count("] Epoch 001 |") == 2
    ref = tcli.main(_train_argv(data_dir, tmp_path / "one", "--quiet",
                                "--scan-steps", "2"))
    # a mesh step takes 4 packed sub-batches: fewer optimizer steps
    assert 0 < summary["optimizer_steps"] < ref["optimizer_steps"]
    assert json.loads((out / "train_summary.json").read_text())[
        "members"] == 2
    p_ens = ip.Ensemble.load(out, "cpu")
    j_ens = jp.Ensemble.load(out)
    idx = list(range(0, 28, 3))
    got = p_ens.predict(p_ens.scaler.apply(PStore.load_dir(data_dir /
                                                           "data")), idx,
                        batch_size=8)
    want = j_ens.predict(j_ens.scaler.apply(JStore.load_dir(data_dir /
                                                            "data")), idx,
                         batch_size=8)
    np.testing.assert_allclose([r["mu"] for r in got],
                               [r["mu"] for r in want], rtol=1e-3, atol=1e-4)


def _mesh_member_rank(rank, setup, cfg, copy_to):
    """`train_member` on this rank, rank 0 keeping a copy of the epoch-1
    resume archive (the member deletes its own when it finishes)."""
    import shutil

    from gnnep_tpu_torch.train import member as pmem
    from gnnep_tpu_torch.train.ensemble import member_plan

    seed_i, _, train_i, holdout, mc, member_cfg = member_plan(cfg, setup, 0)
    save = pmem.save_pytree

    def save_and_copy(path, leaves, meta):
        save(path, leaves, meta)
        if rank.rank == 0 and meta["epoch"] == 1 and copy_to:
            shutil.copy(path, copy_to)

    pmem.save_pytree = save_and_copy
    try:
        model, _, n = pmem.train_member(
            setup.store, member_cfg, mc, setup.transformer, setup.budget,
            seed_i, train_i, holdout, rank=rank)
    finally:
        pmem.save_pytree = save
    return {k: v.numpy() for k, v in model.state_dict().items()}, n


def test_mesh_member_resumes_as_uninterrupted(data_dir, tmp_path, worlds):
    """A mesh member's archive holds every rank's generator state; resumed
    from epoch 1 it ends bitwise where the uninterrupted member ends."""
    from gnnep_tpu_torch.train.artifacts import load_pytree_meta
    from gnnep_tpu_torch.train.ensemble import prepare

    cfg = TrainConfig(data_dir=str(data_dir / "data"),
                      save_dir=str(tmp_path), batch_size=4, epochs=2,
                      hidden=16, layers=1, heads=2, ensemble_size=1, seed=3,
                      val_frac=0.15, calib_frac=0.15, test_frac=0.15,
                      data_shards=2, checkpoint_every=1, scan_steps=0,
                      pack_workers=1, verbose=False)
    setup = prepare(cfg)
    keep = tmp_path / "epoch1.npz"
    full, n_full = worlds(2, 1).run(_mesh_member_rank, setup, cfg, keep)
    assert load_pytree_meta(keep)["layout"].endswith(":cpu:generators2")
    rpath = tmp_path / f"resume_member_{cfg.seed}.npz"
    keep.rename(rpath)
    resumed, n_resumed = worlds(2, 1).run(
        _mesh_member_rank, setup, dataclasses.replace(cfg, resume=True),
        None)
    assert 0 < n_resumed < n_full
    for name, v in full.items():
        np.testing.assert_array_equal(resumed[name], v, err_msg=name)
