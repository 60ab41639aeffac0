"""Custom-structure serving in the port (`infer.predict.load_custom_samples`
and `cli.predict --mode custom` with pymatgen structure entries) against
`gnnep_tpu` on the repo's `examples/custom_materials.json`: equal stores and
served results within rtol 1e-3."""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

from gnnep_tpu import native as jn  # noqa: E402
from gnnep_tpu.data.featurize import build_graph, load_mat2vec  # noqa: E402
from gnnep_tpu.data.store import GraphStore as JStore  # noqa: E402
from gnnep_tpu.data.structure import Structure  # noqa: E402
from gnnep_tpu.data.transforms import FeatureScaler, LogTransformer  # noqa: E402
from gnnep_tpu.infer import predict as jp  # noqa: E402
from gnnep_tpu.models.alignn import AlignnConfig, init_alignn  # noqa: E402
from gnnep_tpu.train import artifacts as ja  # noqa: E402
from gnnep_tpu_torch.cli import predict as pcli  # noqa: E402
from gnnep_tpu_torch.infer import predict as pp  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLE = ROOT / "examples" / "custom_materials.json"
J_M2V = ROOT / "gnnep_tpu" / "assets" / "mat2vec_200d.npz"
P_M2V = ROOT / "gnnep_tpu_torch" / "assets" / "mat2vec_200d.npz"


@pytest.fixture(autouse=True)
def jax_native(monkeypatch):
    """The JAX package's native library loaded in this process (a worker
    that lost the race of concurrent first builds while collecting retries
    the load; see ROADMAP.md, Hazards)."""
    if not jn.available():
        monkeypatch.setattr(jn, "_lib_failed", False)
    assert jn.available()


@pytest.fixture(scope="module")
def ensemble_dir(tmp_path_factory):
    """A 2-member random-weight ensemble at the featurizer's widths (node
    206, edge 36, angle 11, global 59; hidden 16, 1 layer, 2 heads), its
    scaler fitted on the example structures, all written by the JAX
    package. The examples featurize with the fetcher's defaults: crystalnn,
    so the 7.5 Å cutoff without pymatgen (MgO: 1,424 bonds, 252,048
    line-graph edges)."""
    root = tmp_path_factory.mktemp("custom")
    entries = json.loads(EXAMPLE.read_text())["materials"]
    lookup = load_mat2vec(str(J_M2V))
    samples = [build_graph(Structure.from_dict(e["structure"]),
                           material_id=e["material_id"], mat2vec=lookup,
                           y=[100.0, 50.0]) for e in entries]
    store = JStore.from_samples(samples)
    cfg = AlignnConfig(node_dim=store.node_dim, edge_dim=store.edge_dim,
                       angle_dim=store.angle_dim,
                       global_dim=store.global_scalar_dim + 230,
                       target_dim=2, hidden=16, layers=1, heads=2,
                       dropout=0.0)
    assert (cfg.node_dim, cfg.edge_dim, cfg.angle_dim) == (206, 36, 11)
    ens = root / "ensemble"
    ens.mkdir()
    for i in range(2):
        ja.save_member(ens / f"model_{i}.npz",
                       init_alignn(jax.random.PRNGKey(30 + i), cfg), cfg)
    ja.save_scaler_state(ens / "scaler_state.npz",
                         FeatureScaler.fit(store, range(store.n_graphs)),
                         LogTransformer.fit(store.y),
                         dims={"global_scalar_dim": store.global_scalar_dim})
    return ens


@pytest.fixture(scope="module")
def ensembles(ensemble_dir):
    return jp.Ensemble.load(ensemble_dir), pp.Ensemble.load(ensemble_dir,
                                                            device="cpu")


def _assert_stores_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("mat2vec", [True, False])
def test_custom_store_equals_jax(ensembles, mat2vec):
    """The standardized stores are equal, with the bundled mat2vec table and
    without one (then the 200 embedding columns are zero)."""
    j_ens, p_ens = ensembles
    want = jp.load_custom_samples(EXAMPLE, j_ens,
                                  str(J_M2V) if mat2vec else None)
    got = pp.load_custom_samples(EXAMPLE, p_ens,
                                 str(P_M2V) if mat2vec else None)
    _assert_stores_equal(got, want)
    assert got.material_ids == ["example-MgO", "example-Si", "example-GaAs"]
    assert got.sg_num.tolist() == [225, 227, 216]     # the entries' override
    assert int(got.lg_off[1] - got.lg_off[0]) == 252048


@pytest.mark.parametrize("mat2vec", [True, False])
def test_custom_structures_serve_as_jax(ensembles, mat2vec):
    j_ens, p_ens = ensembles
    want = j_ens.predict(jp.load_custom_samples(
        EXAMPLE, j_ens, str(J_M2V) if mat2vec else None), range(3),
        batch_size=2)
    got = p_ens.predict(pp.load_custom_samples(
        EXAMPLE, p_ens, str(P_M2V) if mat2vec else None), range(3),
        batch_size=2)
    assert [r["material_id"] for r in got] == [r["material_id"] for r in want]
    for g, w in zip(got, want):
        for key in ("mu", "sigma"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-3,
                                       err_msg=f"{w['material_id']} {key}")
        assert g.get("target") == pytest.approx(w.get("target"))


def test_cli_custom_mode_serves_structures(ensemble_dir, tmp_path):
    out = tmp_path / "pred.json"
    results = pcli.main(["--mode", "custom", "--input-file", str(EXAMPLE),
                         "--ensemble-dir", str(ensemble_dir), "--device",
                         "cpu", "--mat2vec-path", str(P_M2V),
                         "--output-json", str(out)])
    preds = json.loads(out.read_text())["predictions"]
    assert [p["material_id"] for p in preds] == \
        ["example-MgO", "example-Si", "example-GaAs"] == \
        [r["material_id"] for r in results]
    for p in preds:
        assert np.isfinite(p["mu"]).all() and (np.asarray(p["sigma"]) > 0).all()
    # MgO and Si carry VRH targets in the file, GaAs none
    assert [("target" in p) for p in preds] == [True, True, False]


def test_structure_entry_options(ensembles, tmp_path):
    """Per-entry nn_method / cutoff reach the featurizer, and a mat2vec
    table of another width is refused, as in the JAX package."""
    j_ens, p_ens = ensembles
    entry = json.loads(EXAMPLE.read_text())["materials"][0]
    f = tmp_path / "one.json"
    f.write_text(json.dumps({"materials": [
        dict(entry, nn_method="cutoff", cutoff=2.2)]}))
    got = pp.load_custom_samples(f, p_ens, str(P_M2V))
    _assert_stores_equal(got, jp.load_custom_samples(f, j_ens, str(J_M2V)))
    assert (got.edge_src.size, got.lg_src.size) == (48, 240)
    bad = tmp_path / "m2v.json"
    bad.write_text(json.dumps({"Mg": [1.0, 2.0], "O": [3.0, 4.0]}))
    with pytest.raises(ValueError, match="mat2vec dim 2"):
        pp.load_custom_samples(f, p_ens, str(bad))


# ---------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels have no CPU "
                    "mode (run `python3 chip_smoke.py` or this file on one)")
    from gnnep_tpu_torch.utils.device import resolve_device
    return resolve_device("cuda")


@pytest.mark.gpu
def test_card_serves_structures_as_cpu(cuda, ensemble_dir):
    """Kernel 5 on the example crystals' long segments (~177 rows): the
    card's f32 means equal the CPU's."""
    got = pp.Ensemble.load(ensemble_dir, device=cuda)
    want = pp.Ensemble.load(ensemble_dir, device="cpu")
    res = [e.predict(pp.load_custom_samples(EXAMPLE, e, str(P_M2V)),
                     range(3), batch_size=2) for e in (got, want)]
    for g, w in zip(*res):
        np.testing.assert_allclose(g["mu"], w["mu"], rtol=1e-3, atol=1e-4)
