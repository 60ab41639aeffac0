"""Member-parallel ensembles (`gnnep_tpu_torch.parallel.ensemble_vmap`):
the stacked step of M members against M single-member steps (the port's
and the JAX package's, from the same parameters), `--member-parallel vmap`
and `shard` through `cli.train` (shard's members equal to sequential
training's, their checkpoints served by the JAX package), lock-step early
stopping, and the JAX package's refusals."""
import dataclasses
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
from gnnep_tpu.train import loop as jl  # noqa: E402
from gnnep_tpu_torch.data.store import GraphStore as PStore  # noqa: E402
from gnnep_tpu_torch.data.store import save_sample, write_index  # noqa: E402
from gnnep_tpu_torch.models import alignn as pm  # noqa: E402
from gnnep_tpu_torch.parallel import ensemble_vmap as pev  # noqa: E402
from gnnep_tpu_torch.train import artifacts as pa  # noqa: E402
from gnnep_tpu_torch.train import loop as pl  # noqa: E402
from gnnep_tpu_torch.train.config import TrainConfig  # noqa: E402
from gnnep_tpu_torch.train.ensemble import (check_supported,  # noqa: E402
                                            prepare)

RTOL, ATOL = 5e-3, 1e-4
LRS = [(1e-3, 5e-4), (2e-3, 1e-3), (5e-4, 5e-4)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fx():
    store = make_store(12, seed=31)
    idx = list(range(12))
    batches = epoch_batches(store, idx, BatchBudget.plan(store, idx, 4,
                                                         cover_all=True),
                            shuffle=False)
    cfg = jm.AlignnConfig(
        node_dim=store.node_dim, edge_dim=store.edge_dim,
        angle_dim=store.angle_dim, global_dim=store.global_scalar_dim + 230,
        target_dim=2, hidden=32, layers=1, heads=2, dropout=0.0,
        conv_impl="coo")
    params = [jm.init_alignn(jax.random.PRNGKey(k), cfg) for k in range(3)]
    ys = np.log(np.asarray(store.y))
    return dict(batches=batches, cfg=cfg, params=params,
                pcfg=pm.AlignnConfig(**dataclasses.asdict(cfg)),
                means=ys.mean(0).astype(np.float32),
                stds=(ys.std(0) + 0.1).astype(np.float32))


def _member(fx, k, **kw):
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        fx["params"][k])]
    return pa.params_from_leaves(leaves, dataclasses.replace(fx["pcfg"],
                                                             **kw))


@pytest.mark.parametrize("m", [2, 3])
def test_stacked_step_equals_single_steps(fx, m):
    """With dropout and jitter on, each member of the stacked step draws
    from its own generator and takes its own LRs: bitwise the member's
    single step."""
    hyper = pl.TrainHyper(feature_jitter_std=0.1)
    drops = [0.1, 0.2, 0.3][:m]
    stacked = pev.StackedTrainStep(
        [_member(fx, k, dropout=drops[k]) for k in range(m)], hyper,
        fx["means"], fx["stds"], "cpu")
    stacked.set_lrs(np.asarray(LRS[:m]))
    gens = [torch.Generator().manual_seed(10 + k) for k in range(m)]
    rows = [stacked([fx["batches"][(t + k) % 3] for k in range(m)], gens)
            for t in range(2)]
    for k in range(m):
        model = _member(fx, k, dropout=drops[k])
        single = pl.TrainStep(model, hyper, fx["means"], fx["stds"])
        gen = torch.Generator().manual_seed(10 + k)
        for t in range(2):
            ms = single(fx["batches"][(t + k) % 3], gen, *LRS[k])
            np.testing.assert_array_equal(rows[t][k].numpy(),
                                          torch.stack(list(ms)).numpy())
        for name, p in model.state_dict().items():
            np.testing.assert_array_equal(
                stacked.members[k].model.state_dict()[name].numpy(),
                p.numpy(), err_msg=name)
    stacked.close()


@pytest.mark.parametrize("m", [2, 3])
def test_stacked_step_matches_jax_single_steps(fx, m):
    """One stacked step against M of the JAX package's single-member steps
    from the same parameters: metrics, gradients, updated parameters."""
    hyper = pl.TrainHyper(feature_jitter_std=0.0)
    jhyper = jl.TrainHyper(feature_jitter_std=0.0)
    stacked = pev.StackedTrainStep([_member(fx, k) for k in range(m)],
                                   hyper, fx["means"], fx["stds"], "cpu")
    stacked.set_lrs(np.asarray(LRS[:m]))
    batches = [fx["batches"][k % 3] for k in range(m)]
    rows = stacked(batches, [None] * m)
    step, init_opt = jl.make_train_step(fx["cfg"], jhyper, fx["means"],
                                        fx["stds"])
    mu, sd = jnp.asarray(fx["means"]), jnp.asarray(fx["stds"])
    names = pm.leaf_names(fx["pcfg"])
    for k in range(m):
        jb = jax.tree.map(jnp.asarray, batches[k])
        y_z = (jnp.log(jnp.maximum(jb.y, 1e-12)) - mu) / sd
        grads = jax.grad(lambda p: jl.hetero_nll(
            p, fx["cfg"], jhyper, jb, y_z, None, train=True)[0])(
                fx["params"][k])
        params = jax.tree.map(jnp.array, fx["params"][k])
        new, _, jm_ = step(params, init_opt(params), jl.sigma_mask(params),
                           jb, jax.random.PRNGKey(0), *LRS[k])
        for name, a, w in zip(pl.StepMetrics._fields, rows[k], jm_):
            np.testing.assert_allclose(float(a), float(w), rtol=RTOL,
                                       atol=ATOL, err_msg=name)
        model = stacked.members[k].model
        got = dict(model.named_parameters())
        for name, g, w in zip(names, jax.tree_util.tree_leaves(grads),
                              jax.tree_util.tree_leaves(new)):
            g = np.asarray(g)
            np.testing.assert_allclose(got[name].grad.numpy(), g, rtol=RTOL,
                                       atol=ATOL, err_msg=name)
            tiny = np.abs(g) < 10 * ATOL
            np.testing.assert_allclose(got[name].detach().numpy()[~tiny],
                                       np.asarray(w)[~tiny], rtol=RTOL,
                                       atol=ATOL, err_msg=name)
    stacked.close()


# ---------------------------------------------------------------------------
# the trainer's modes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("member_parallel")
    data = root / "data"
    samples = make_samples(24, seed=17)
    for s in samples:
        save_sample(data, s)
    write_index(data, PStore.from_samples(samples))
    return data


def _cfg(data, out, **kw):
    base = dict(data_dir=str(data), save_dir=str(out), batch_size=4,
                epochs=2, hidden=16, layers=1, heads=2, ensemble_size=2,
                seed=5, val_frac=0.2, calib_frac=0.15, test_frac=0.15,
                scan_steps=2, pack_workers=1, verbose=False)
    base.update(kw)
    return TrainConfig(**base)


def _argv(data, out, *extra):
    return ["--data-dir", str(data), "--save-dir", str(out), "--device",
            "cpu", "--hidden", "16", "--layers", "1", "--heads", "2",
            "--ensemble-size", "2", "--epochs", "2", "--batch-size", "4",
            "--seed", "5", "--val-frac", "0.2", "--calib-frac", "0.15",
            "--test-frac", "0.15", "--quiet", *extra]


def test_cli_vmap_trains_and_serves_in_jax(data_dir, tmp_path):
    from gnnep_tpu.data.store import GraphStore as JStore
    from gnnep_tpu.infer import predict as jp
    from gnnep_tpu_torch.cli import train as tcli
    from gnnep_tpu_torch.infer import predict as ip

    out = tmp_path / "vmap"
    summary = tcli.main(_argv(data_dir, out, "--member-parallel", "vmap"))
    steps = summary["member_optimizer_steps"]
    assert len(steps) == 2 and steps[0] == steps[1] > 0   # lock-step
    assert np.isfinite(summary["test_stats"]["overall"]["mae"])
    idx = list(range(0, 24, 2))
    got = ip.Ensemble.load(out, "cpu")
    want = jp.Ensemble.load(out)
    g = got.predict(got.scaler.apply(PStore.load_dir(data_dir)), idx,
                    batch_size=8)
    w = want.predict(want.scaler.apply(JStore.load_dir(data_dir)), idx,
                     batch_size=8)
    np.testing.assert_allclose([r["mu"] for r in g], [r["mu"] for r in w],
                               rtol=1e-3, atol=1e-4)


def test_cli_shard_equals_sequential(data_dir, tmp_path):
    """`--member-parallel shard` trains member i alone on gloo slot i, as
    the sequential trainer trains it: the same checkpoints, to the bit."""
    from gnnep_tpu_torch.cli import train as tcli

    a = tcli.main(_argv(data_dir, tmp_path / "shard", "--member-parallel",
                        "shard", "--pack-workers", "1"))
    b = tcli.main(_argv(data_dir, tmp_path / "seq", "--pack-workers", "1"))
    assert a["member_optimizer_steps"] == b["member_optimizer_steps"]
    for i in range(2):
        x = pa.load_member(tmp_path / "shard" / f"model_{i}.npz", "cpu")
        y = pa.load_member(tmp_path / "seq" / f"model_{i}.npz", "cpu")
        for name, p in x.state_dict().items():
            np.testing.assert_array_equal(p.numpy(),
                                          y.state_dict()[name].numpy())


def test_vmap_lock_step_early_stopping(data_dir, tmp_path):
    """Patience 1 with no significant improvement after the grace epochs:
    every member stops at epoch 6 and the run ends there, each member's
    selected parameters frozen at its best epoch."""
    cfg = _cfg(data_dir, tmp_path, epochs=8, early_stop=1,
               delta_mae_reset=1e9, member_parallel="vmap")
    setup = prepare(cfg)
    models, steps = pev.train_members_vmapped(setup, cfg, "vmap",
                                              device="cpu")
    per_epoch = steps[0] / 6
    assert steps == [steps[0]] * 2 and per_epoch == int(per_epoch) > 0
    assert all(isinstance(m, pm.Alignn) for m in models)


@pytest.mark.parametrize("kw,match", [
    (dict(member_hiddens=[16, 32]), "homogeneous hidden"),
    (dict(enable_density_weighting=True), "KNN density weighting"),
])
@pytest.mark.parametrize("mode", ["vmap", "shard"])
def test_modes_refuse_as_jax(data_dir, tmp_path, kw, match, mode):
    cfg = _cfg(data_dir, tmp_path, member_parallel=mode, **kw)
    setup = prepare(dataclasses.replace(cfg, member_hiddens=None))
    with pytest.raises(ValueError, match=match):
        pev.train_members_vmapped(setup, cfg, mode, device="cpu")


def test_modes_refuse_giants(data_dir, tmp_path):
    cfg = _cfg(data_dir, tmp_path)
    setup = dataclasses.replace(prepare(cfg), giant=object())
    with pytest.raises(ValueError, match="giant graphs"):
        pev.train_members_vmapped(setup, cfg, "vmap", device="cpu")


def test_shard_needs_a_card_a_member(data_dir, tmp_path, monkeypatch):
    """The JAX package's refusal (test_parallel.py:436): more members than
    visible cards."""
    cfg = _cfg(data_dir, tmp_path, ensemble_size=3)
    setup = prepare(cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="one member per device"):
        pev.train_members_vmapped(setup, cfg, "shard", device="cuda")


@pytest.mark.parametrize("mode", ["vmap", "shard"])
def test_mesh_and_member_parallel_conflict(mode):
    """As in the JAX package (ensemble.py:243-250)."""
    with pytest.raises(ValueError, match="cannot combine"):
        check_supported(TrainConfig(data_shards=2, member_parallel=mode))
    check_supported(TrainConfig(member_parallel=mode))
