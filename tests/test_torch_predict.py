"""The port's ensemble inference against `gnnep_tpu.infer.predict` on one
ensemble written by the JAX package, the port's CLI modes on the CPU, and a
member written by the port loading in the JAX package."""
import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from synthetic import make_samples  # noqa: E402

from gnnep_tpu.data.store import GraphStore as JStore  # noqa: E402
from gnnep_tpu.data.store import save_sample, write_index  # noqa: E402
from gnnep_tpu.data.transforms import FeatureScaler, LogTransformer  # noqa: E402
from gnnep_tpu.infer import predict as jp  # noqa: E402
from gnnep_tpu.models.alignn import AlignnConfig, init_alignn  # noqa: E402
from gnnep_tpu.train import artifacts as ja  # noqa: E402
from gnnep_tpu_torch.cli import predict as pcli  # noqa: E402
from gnnep_tpu_torch.data.store import GraphStore as PStore  # noqa: E402
from gnnep_tpu_torch.infer import predict as pp  # noqa: E402
from gnnep_tpu_torch.models.alignn import init_alignn as p_init  # noqa: E402
from gnnep_tpu_torch.train import artifacts as pa  # noqa: E402

N_GRAPHS = 8


@pytest.fixture(scope="module")
def ensemble_dir(tmp_path_factory):
    """Data dir + a 2-member ensemble, all written by the JAX package."""
    root = tmp_path_factory.mktemp("predict")
    samples = make_samples(N_GRAPHS, seed=4)
    for s in samples:
        save_sample(root / "data", s)
    store = JStore.from_samples(samples)
    write_index(root / "data", store)
    cfg = AlignnConfig(node_dim=store.node_dim, edge_dim=store.edge_dim,
                       angle_dim=store.angle_dim,
                       global_dim=store.global_scalar_dim + 230,
                       target_dim=2, hidden=16, layers=1, heads=2,
                       dropout=0.0)
    ens = root / "ensemble"
    ens.mkdir()
    for i in range(2):
        ja.save_member(ens / f"model_{i}.npz",
                       init_alignn(jax.random.PRNGKey(10 + i), cfg), cfg)
    ja.save_scaler_state(ens / "scaler_state.npz",
                         FeatureScaler.fit(store, range(N_GRAPHS)),
                         LogTransformer.fit(store.y),
                         dims={"global_scalar_dim": store.global_scalar_dim})
    return root


@pytest.mark.parametrize("rung", ["attn_fused", "attn_eproj"])
def test_jax_member_on_a_rung_serves_on_it(ensemble_dir, tmp_path,
                                           monkeypatch, rung):
    """A member the JAX package trained on a rung (`conv_impl='fused'` and
    `attn_fused=False` or `attn_eproj=False` in its config_json) loads in
    the port with that rung, and the port's ensemble serves it through that
    rung's own plain version (its kernels on the card), with the JAX
    ensemble's predictions."""
    from gnnep_tpu_torch.ops.cuda import aggregate, attention
    from gnnep_tpu_torch.ops.cuda import attention_eproj as ep

    store = JStore.load_dir(ensemble_dir / "data", use_cache=False)
    cfg = AlignnConfig(node_dim=store.node_dim, edge_dim=store.edge_dim,
                       angle_dim=store.angle_dim,
                       global_dim=store.global_scalar_dim + 230,
                       target_dim=2, hidden=16, layers=1, heads=2,
                       dropout=0.0, conv_impl="fused", **{rung: False})
    ens = tmp_path / "ensemble"
    ens.mkdir()
    ja.save_member(ens / "model_0.npz",
                   init_alignn(jax.random.PRNGKey(7), cfg), cfg)
    (ens / "scaler_state.npz").write_bytes(
        (ensemble_dir / "ensemble" / "scaler_state.npz").read_bytes())
    p_ens = pp.Ensemble.load(ens, device="cpu")
    assert getattr(p_ens.cfgs[0], rung) is False
    assert p_ens.cfgs[0].conv_impl == "fused"
    own = "aggregate_plain" if rung == "attn_fused" else "attention_plain"
    reached = {}
    for mod, fn in ((ep, "attention_eproj_plain"),
                    (attention, "attention_plain"),
                    (aggregate, "aggregate_plain")):
        def counted(*a, _fn=fn, _real=getattr(mod, fn), **k):
            reached[_fn] = reached.get(_fn, 0) + 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, fn, counted)
    j_ens = jp.Ensemble.load(ens)
    idx = list(range(N_GRAPHS))
    want = j_ens.predict(j_ens.scaler.apply(store), idx, batch_size=4)
    got = p_ens.predict(p_ens.scaler.apply(PStore.load_dir(
        ensemble_dir / "data", use_cache=False)), idx, batch_size=4)
    assert reached == {own: 2 * cfg.layers * 2}      # 2 batches of 4
    _assert_results_close(got, want, rtol=1e-3)


def _by_id(results):
    return {r["material_id"]: r for r in results}


def _assert_results_close(got, want, rtol):
    got, want = _by_id(got), _by_id(want)
    assert got.keys() == want.keys()
    for mid, w in want.items():
        g = got[mid]
        for key in ("mu", "sigma"):
            np.testing.assert_allclose(g[key], w[key], rtol=rtol,
                                       err_msg=f"{mid} {key}")
        np.testing.assert_allclose(
            [[c["lower"], c["upper"]] for c in g["ci90"]],
            [[c["lower"], c["upper"]] for c in w["ci90"]], rtol=rtol,
            atol=rtol)
        assert g.get("target") == pytest.approx(w.get("target"))


# relative: μ and σ are exp of f32 forwards that agree to ~1e-4 (see
# test_torch_model.py), so 1e-3 leaves an order of magnitude
@pytest.mark.parametrize("indices", [list(range(N_GRAPHS)), [5, 1, 6]])
def test_ensemble_predict_matches_jax(ensemble_dir, indices):
    ens = ensemble_dir / "ensemble"
    j_ens = jp.Ensemble.load(ens)
    p_ens = pp.Ensemble.load(ens, device="cpu")
    j_store = j_ens.scaler.apply(JStore.load_dir(ensemble_dir / "data",
                                                 use_cache=False))
    p_store = p_ens.scaler.apply(PStore.load_dir(ensemble_dir / "data",
                                                 use_cache=False))
    want = j_ens.predict(j_store, indices, batch_size=3)
    got = p_ens.predict(p_store, indices, batch_size=3)
    assert [r["material_id"] for r in got] \
        == [p_store.material_ids[i] for i in indices]
    _assert_results_close(got, want, rtol=1e-3)


def _raw_entries(store, n):
    out = []
    for g in range(n):
        s = store.sample(g)
        soh = np.zeros(230)
        soh[s.sg_num - 1] = 1.0
        out.append({
            "material_id": f"raw_{g}", "x": s.node_feats.tolist(),
            "edge_index": [s.edge_src.tolist(), s.edge_dst.tolist()],
            "edge_attr": s.edge_attr.tolist(),
            "lg_edge_index": [s.lg_src.tolist(), s.lg_dst.tolist()],
            "lg_edge_attr": s.lg_attr.tolist(),
            "global_x": s.global_scalars.tolist(),
            "sg_one_hot": soh.tolist(), "y": s.y.tolist()})
    return out


def test_cli_modes_on_cpu(ensemble_dir, tmp_path):
    ens = ensemble_dir / "ensemble"
    data = ensemble_dir / "data"
    store = JStore.load_dir(data, use_cache=False)
    custom = tmp_path / "custom_input.json"
    custom.write_text(json.dumps({"materials": _raw_entries(store, 3)}))
    base = ["--ensemble-dir", str(ens), "--data-dir", str(data),
            "--device", "cpu", "--batch-size", "4"]
    runs = {
        "random": ["--mode", "random", "--num-samples", "5"],
        "materials": ["--mode", "materials", "--materials",
                      ",".join(store.material_ids[:2])],
        "custom": ["--mode", "custom", "--input-file", str(custom)],
    }
    for mode, extra in runs.items():
        out = tmp_path / f"{mode}.json"
        pcli.main(base + extra + ["--output-json", str(out)])
        preds = json.loads(out.read_text())["predictions"]
        assert len(preds) == {"random": 5, "materials": 2, "custom": 3}[mode]
        for p in preds:
            assert np.isfinite(p["mu"]).all() and (np.asarray(p["sigma"]) > 0).all()
    # custom raw graphs through both packages
    j_ens = jp.Ensemble.load(ens)
    want = j_ens.predict(jp.load_custom_samples(custom, j_ens), range(3),
                         batch_size=4)
    got = json.loads((tmp_path / "custom.json").read_text())["predictions"]
    _assert_results_close(got, want, rtol=1e-3)
    # structure entries are featurized on the fly (tests/
    # test_torch_custom_structures.py); a malformed one raises, as in JAX
    custom.write_text(json.dumps({"materials": [{"structure": {}}]}))
    with pytest.raises(KeyError, match="lattice"):
        pcli.main(base + runs["custom"])
    # --giant-shards routes graphs beyond the request's typical budget
    # through the boundary exchange (tests/test_torch_giant.py); this
    # store has none, so the predictions are the cover-all budget's
    out = tmp_path / "giant.json"
    pcli.main(base + runs["materials"] + ["--giant-shards", "2",
                                          "--output-json", str(out)])
    _assert_results_close(
        json.loads(out.read_text())["predictions"],
        json.loads((tmp_path / "materials.json").read_text())["predictions"],
        rtol=1e-6)


def test_member_written_by_port_loads_in_jax(ensemble_dir, tmp_path):
    cfg = pa.load_member(ensemble_dir / "ensemble" / "model_0.npz",
                          "cpu").cfg
    cfg = dataclasses.replace(cfg, layers=2)
    model = p_init(np.random.default_rng(0), cfg)
    pa.save_member(tmp_path / "model_0.npz", model)
    params, jcfg = ja.load_member(tmp_path / "model_0.npz")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    leaves = jax.tree_util.tree_leaves(params)
    for got, want in zip(leaves, pa.leaves_from_params(model)):
        assert np.array_equal(np.asarray(got), want)
    assert len(leaves) == len(pa.leaves_from_params(model))
