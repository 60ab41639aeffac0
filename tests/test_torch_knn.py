"""The port's KNN density weighting and embeddings (`train.knn_weights`,
`models.alignn.alignn_embed`, `--enable-density-weighting`,
`--save-embeddings`) against `gnnep_tpu` on the same parameters and
batches."""
import dataclasses
import json
import pathlib
import sys
import types

import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from synthetic import make_samples, make_store  # noqa: E402

from gnnep_tpu.data.batching import epoch_batches as j_epoch_batches  # noqa: E402
from gnnep_tpu.models import alignn as jm  # noqa: E402
from gnnep_tpu.train import ensemble as je  # noqa: E402
from gnnep_tpu.train import knn_weights as jk  # noqa: E402
from gnnep_tpu.train.config import TrainConfig as JCfg  # noqa: E402
from gnnep_tpu_torch.data.store import GraphStore as PStore  # noqa: E402
from gnnep_tpu_torch.data.store import save_sample as p_save_sample  # noqa: E402
from gnnep_tpu_torch.data.store import write_index  # noqa: E402
from gnnep_tpu_torch.models import alignn as pm  # noqa: E402
from gnnep_tpu_torch.train import artifacts as pa  # noqa: E402
from gnnep_tpu_torch.train import ensemble as pe  # noqa: E402
from gnnep_tpu_torch.train import knn_weights as pk  # noqa: E402
from gnnep_tpu_torch.train import member as pmem  # noqa: E402
from gnnep_tpu_torch.train.config import TrainConfig as PCfg  # noqa: E402

KNN = dict(k=5, eps=1e-6, alpha=0.75, beta=1.0, clip_min=0.2, clip_max=1.0)


@pytest.fixture(scope="module")
def fixture():
    """20 graphs, the JAX package's setup and a random-weight member (hidden
    16, 1 layer, 2 heads), and the same member in the port."""
    store = make_store(20, seed=10)
    cfg = JCfg(batch_size=10, hidden=16, layers=1, heads=2, ensemble_size=2,
               verbose=False)
    setup = je.prepare(cfg, store)
    mc = je.model_config(cfg, setup.store)
    params = jm.init_alignn(jax.random.PRNGKey(0), mc)
    batches = j_epoch_batches(setup.store, setup.train_idx, setup.budget,
                              shuffle=False)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]
    model = pa.params_from_leaves(
        leaves, pm.AlignnConfig(**dataclasses.asdict(mc)))
    return dict(setup=setup, mc=mc, params=params, batches=batches,
                model=model)


def test_alignn_embed_matches_jax(fixture):
    for b in fixture["batches"]:
        want = np.asarray(jm.alignn_embed(fixture["params"], fixture["mc"], b))
        got = pm.alignn_embed(fixture["model"],
                              pm.DeviceBatch.from_batch(b, "cpu"))
        assert not got.requires_grad and got.is_inference()
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-3, atol=1e-4)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_compute_knn_weights_matches_jax(fixture, monkeypatch, backend):
    """The same member, batches and backend in both packages: the same
    train ids, weights within 1e-5."""
    monkeypatch.setenv("GNNEP_KNN_BACKEND", backend)
    want = jk.compute_knn_weights(fixture["mc"], fixture["params"],
                                  fixture["batches"], fixture["setup"].store,
                                  **KNN)
    got = pk.compute_knn_weights(fixture["model"], fixture["batches"],
                                 fixture["setup"].store, **KNN)
    assert got.keys() == want.keys() == set(fixture["setup"].train_idx)
    keys = sorted(want)
    np.testing.assert_allclose([got[k] for k in keys], [want[k] for k in keys],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_weights_from_the_same_embeddings_match_jax(fixture, monkeypatch,
                                                    backend):
    """Both packages fed one set of embeddings (their embedding forwards
    replaced): the density weights agree to 1e-6."""
    rng = np.random.default_rng(3)
    n_real = [int(np.asarray(b.graph_mask).sum()) for b in fixture["batches"]]
    zs = [rng.normal(size=(int(np.asarray(b.graph_mask).shape[0]), 16))
          .astype(np.float32) for b in fixture["batches"]]
    by_id = {id(b): z for b, z in zip(fixture["batches"], zs)}
    monkeypatch.setenv("GNNEP_KNN_BACKEND", backend)
    monkeypatch.setattr(jk, "embed_fn",
                        lambda mc: lambda params, b: by_id[id(b)])
    order = iter(zs)
    monkeypatch.setattr(pk, "alignn_embed",
                        lambda model, db: torch.from_numpy(next(order)))
    want = jk.compute_knn_weights(fixture["mc"], fixture["params"],
                                  fixture["batches"], None, **KNN)
    got = pk.compute_knn_weights(fixture["model"], fixture["batches"], None,
                                 **KNN)
    assert sum(n_real) == len(got) == len(want)
    keys = sorted(want)
    np.testing.assert_allclose([got[k] for k in keys], [want[k] for k in keys],
                               rtol=0, atol=1e-6)


def test_weight_properties(fixture):
    weights = pk.compute_knn_weights(fixture["model"], fixture["batches"],
                                     fixture["setup"].store, **KNN)
    vals = np.array(list(weights.values()))
    assert abs(vals.mean() - 1.0) < 1e-6
    assert (vals > 0).all()
    assert vals.max() / vals.min() <= 1.0 / 0.2 + 1e-6


def test_device_backend_matches_host_and_jax():
    """Chunked GEMM + top-k (several chunks) equals the exact host kNN and
    the JAX package's device backend."""
    Z = np.random.default_rng(0).normal(size=(500, 24)).astype(np.float32)
    dd, ii = pk.knn_neighbors(Z, 10, backend="device", device="cpu")
    dh, ih = pk.knn_neighbors(Z, 10, backend="host")
    jd, ji = jk.knn_neighbors(Z, 10, backend="device")
    np.testing.assert_allclose(dd, dh, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dd, jd, rtol=1e-4, atol=1e-4)
    assert (ii == ih).mean() > 0.999
    assert (ii == ji).mean() > 0.999


def test_device_backend_orders_ties_by_index():
    """Points on a line: each inner point's two neighbours are tied at
    distance 1 and come lower index first, as `lax.top_k` orders them."""
    Z = np.arange(12, dtype=np.float32)[:, None] * np.ones((1, 3), np.float32)
    dd, ii = pk.knn_neighbors(Z, 2, backend="device", device="cpu")
    jd, ji = jk.knn_neighbors(Z, 2, backend="device")
    inner = np.arange(1, 11)
    np.testing.assert_array_equal(ii[inner], np.stack([inner - 1, inner + 1], 1))
    np.testing.assert_array_equal(ii[inner], np.asarray(ji)[inner])
    np.testing.assert_allclose(dd, jd, rtol=1e-6)


def test_env_override(monkeypatch):
    Z = np.random.default_rng(1).normal(size=(64, 8)).astype(np.float32)
    seen = []
    real = pk._device_knn
    monkeypatch.setattr(pk, "_device_knn",
                        lambda *a: seen.append(a[-1]) or real(*a))
    monkeypatch.setenv("GNNEP_KNN_BACKEND", "device")
    dd, _ = pk.knn_neighbors(Z, 5, device="cpu")
    assert seen == [torch.device("cpu")]
    dh, _ = pk.knn_neighbors(Z, 5, backend="host")
    np.testing.assert_allclose(dd, dh, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,want", [(4095, "host"), (4096, "device")])
def test_backend_chosen_by_size(monkeypatch, n, want):
    """The JAX package's rule: device from 4096 rows on, host below."""
    monkeypatch.delenv("GNNEP_KNN_BACKEND", raising=False)
    taken = []
    monkeypatch.setattr(pk, "_device_knn",
                        lambda Zs, k, chunk, dev: taken.append("device")
                        or (np.zeros((n, k)), np.zeros((n, k), int)))
    sk = types.ModuleType("sklearn.neighbors")

    class NearestNeighbors:
        def __init__(self, n_neighbors, metric):
            self.k = n_neighbors

        def fit(self, Z):
            taken.append("host")
            return self

        def kneighbors(self, Z, n_neighbors):
            return np.zeros((n, self.k)), np.zeros((n, self.k), int)

    sk.NearestNeighbors = NearestNeighbors
    monkeypatch.setitem(sys.modules, "sklearn.neighbors", sk)
    pk.knn_neighbors(np.zeros((n, 2), np.float32), 3, device="cpu")
    assert taken == [want]


def test_host_backend_without_sklearn_is_numpy(monkeypatch):
    """Without sklearn (as on the card's machine) the host backend is the
    numpy path, equal to sklearn's neighbours."""
    Z = np.random.default_rng(2).normal(size=(200, 6)).astype(np.float32)
    want = jk.knn_neighbors(Z, 7, backend="host")
    monkeypatch.setitem(sys.modules, "sklearn.neighbors", None)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    dn, i_n = pk.knn_neighbors(Z, 7, backend="host")
    np.testing.assert_allclose(dn, want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(i_n, want[1])


# ---------------------------------------------------- the member loop
def _port_setup(n, seed, **kw):
    cfg = PCfg(batch_size=8, hidden=16, layers=1, heads=2, ensemble_size=2,
               verbose=False, feature_jitter_std=0.0,
               enable_density_weighting=True, weight_warmup_epochs=1,
               knn_refresh=1, knn_k=3, **kw)
    samples = make_samples(n, seed=seed)
    setup = pe.prepare(cfg, PStore.from_samples(samples))
    return cfg, setup, pe.model_config(cfg, setup.store)


def _train(cfg, setup, mc, **kw):
    return pmem.train_member(setup.store, cfg, mc, setup.transformer,
                             setup.budget, 7, setup.train_idx, setup.val_idx,
                             device="cpu", **kw)


def test_snapshot_invariant_to_bootstrap_duplication(monkeypatch):
    """The embedding snapshot covers UNIQUE train ids: bootstrap duplicates
    at distance 0 would inflate their density (reference train.py:930-1010)."""
    cfg, setup, mc = _port_setup(16, 3, epochs=3, bootstrap=True,
                                 bootstrap_ratio=2.0)
    seen = []
    real = pmem.compute_knn_weights

    def spy(model, snapshot_batches, st, **kw):
        batches = list(snapshot_batches)
        seen.append(np.concatenate([
            np.asarray(b.sample_index)[np.asarray(b.graph_mask) > 0]
            for b in batches]))
        return real(model, batches, st, **kw)

    monkeypatch.setattr(pmem, "compute_knn_weights", spy)
    _train(cfg, setup, mc)
    assert len(seen) == 3                 # after every epoch (refresh 1)
    for ids in seen:
        assert len(ids) == len(np.unique(ids))
        assert set(ids.tolist()) <= set(setup.train_idx)


@pytest.mark.parametrize("with_freq", [False, True])
def test_weights_reach_the_step(monkeypatch, with_freq):
    """From the epoch after a snapshot, every batch the step takes carries
    the KNN weight of each real graph (times its inverse-frequency weight
    when those are on) in its `weight` field; before it, 1 (or the
    frequency weight)."""
    cfg, setup, mc = _port_setup(16, 3, epochs=3, bootstrap=False)
    freq = (np.random.default_rng(4).uniform(0.5, 2.0, setup.store.n_graphs)
            .astype(np.float32) if with_freq else None)
    snaps = []
    real = pmem.compute_knn_weights
    monkeypatch.setattr(pmem, "compute_knn_weights",
                        lambda *a, **k: snaps.append(real(*a, **k))
                        or snaps[-1])
    taken = []
    real_step = pmem.make_train_step

    def recording_step(*a, **k):
        step = real_step(*a, **k)
        inner = step._one

        def one(batch, generator):
            taken.append((np.asarray(batch.sample_index).copy(),
                          np.asarray(batch.weight).copy()))
            return inner(batch, generator)
        step._one = one
        return step

    monkeypatch.setattr(pmem, "make_train_step", recording_step)
    _, metrics, steps = _train(cfg, setup, mc, freq_weights=freq)
    assert np.isfinite(metrics["mae"]) and len(snaps) == 3
    per_epoch = steps // 3
    base = freq if with_freq else np.ones(setup.store.n_graphs, np.float32)
    for i, (idx, w) in enumerate(taken):
        epoch = i // per_epoch + 1
        knn = snaps[epoch - 2] if epoch >= 2 else {}
        real_rows = idx >= 0
        want = np.array([base[g] * knn.get(int(g), 1.0)
                         for g in idx[real_rows]], np.float32)
        np.testing.assert_allclose(w[real_rows], want, rtol=1e-6)
        assert (w[~real_rows] == 0).all()


def test_coverage_audit_passes_and_failure_skips_activation(monkeypatch,
                                                            capsys):
    cfg, setup, mc = _port_setup(16, 3, epochs=3, bootstrap=False,
                                 knn_coverage_audit=True)
    _, metrics, _ = _train(cfg, setup, mc)
    out = capsys.readouterr().out
    assert "Coverage audit" in out and "missing=0" in out
    assert np.isfinite(metrics["mae"])

    real = pmem.compute_knn_weights

    def broken(*a, **kw):
        w = real(*a, **kw)
        w.pop(sorted(w)[0])
        return w

    monkeypatch.setattr(pmem, "compute_knn_weights", broken)
    weights_seen = []
    real_graft = pmem._graft_weights
    monkeypatch.setattr(pmem, "_graft_weights",
                        lambda b, w: weights_seen.append(w) or real_graft(b, w))
    _, metrics, _ = _train(cfg, setup, mc)
    assert "Coverage failure" in capsys.readouterr().out
    assert np.isfinite(metrics["mae"])
    assert weights_seen == [None, None, None]   # never activated


def test_density_weighted_training_writes_embeddings(tmp_path):
    """`cli.train --enable-density-weighting --save-embeddings` on the CPU:
    it trains, and writes `embeddings_{split}.npz` with z [n_split,
    hidden]."""
    from gnnep_tpu_torch.cli import train as cli
    data = tmp_path / "data"
    samples = make_samples(28, seed=6)
    for s in samples:
        p_save_sample(data, s)
    write_index(data, PStore.from_samples(samples))
    out = tmp_path / "ens"
    summary = cli.main(["--device", "cpu", "--data-dir", str(data),
                        "--save-dir", str(out), "--hidden", "16",
                        "--layers", "1", "--heads", "2",
                        "--ensemble-size", "2", "--epochs", "2",
                        "--batch-size", "8", "--val-frac", "0.15",
                        "--calib-frac", "0.15", "--test-frac", "0.15",
                        "--enable-density-weighting",
                        "--weight-warmup-epochs", "0", "--knn-refresh", "1",
                        "--knn-k", "3", "--save-embeddings", "--quiet"])
    assert summary["members"] == 2
    setup = pe.prepare(PCfg(val_frac=0.15, calib_frac=0.15, test_frac=0.15,
                            ensemble_size=2, batch_size=8),
                       PStore.load_dir(data, use_cache=False))
    for split in ("train", "val", "calib", "test"):
        z = np.load(out / f"embeddings_{split}.npz")["z"]
        assert z.shape == (len(getattr(setup, f"{split}_idx")), 16)
        assert np.isfinite(z).all()
    assert json.loads((out / "train_summary.json").read_text())["members"] == 2


def test_saved_embeddings_match_jax(fixture, tmp_path):
    """`_save_embeddings` of both packages on the same two members and
    splits: each split's ensemble-mean z within rtol 5e-3 / atol 1e-4."""
    setup = fixture["setup"]
    params2 = jm.init_alignn(jax.random.PRNGKey(1), fixture["mc"])
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(params2)]
    model2 = pa.params_from_leaves(leaves, fixture["model"].cfg)
    split_setup = types.SimpleNamespace(
        train_idx=setup.train_idx, val_idx=setup.val_idx,
        calib_idx=setup.calib_idx, test_idx=setup.test_idx,
        budget=setup.budget, giant=None)
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    je._save_embeddings(tmp_path / "j", [fixture["params"], params2],
                        [fixture["mc"]] * 2, setup.store, split_setup)
    pe._save_embeddings(tmp_path / "p", [fixture["model"], model2],
                        setup.store, split_setup, torch.device("cpu"))
    for split in ("train", "val", "calib", "test"):
        f = f"embeddings_{split}.npz"
        if not getattr(setup, f"{split}_idx"):
            assert not (tmp_path / "p" / f).exists()
            continue
        np.testing.assert_allclose(np.load(tmp_path / "p" / f)["z"],
                                   np.load(tmp_path / "j" / f)["z"],
                                   rtol=5e-3, atol=1e-4)


# ---------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (run `python3 "
                    "chip_smoke.py` or this file on one)")
    from gnnep_tpu_torch.utils.device import resolve_device
    return resolve_device("cuda")


@pytest.mark.gpu
def test_device_backend_on_card_matches_host(cuda):
    Z = np.random.default_rng(0).normal(size=(5000, 64)).astype(np.float32)
    dd, ii = pk.knn_neighbors(Z, 20, backend="device", device=cuda)
    dh, ih = pk.knn_neighbors(Z, 20, backend="host")
    np.testing.assert_allclose(dd, dh, rtol=1e-4, atol=1e-4)
    assert (ii == ih).mean() > 0.999
