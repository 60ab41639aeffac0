"""The port's featurization (`gnnep_tpu_torch.elements`, `data.structure`,
`data.neighbors`, `data.featurize`, the native neighbour list and line
graph) array-equal to `gnnep_tpu`'s on the same seeded structures."""
import dataclasses
import json
import math
import pathlib

import numpy as np
import pytest

from gnnep_tpu import elements as je
from gnnep_tpu import native as jn
from gnnep_tpu.data import featurize as jf
from gnnep_tpu.data import neighbors as jnb
from gnnep_tpu.data import structure as js
from gnnep_tpu_torch import elements as pel
from gnnep_tpu_torch import native as pn
from gnnep_tpu_torch.data import featurize as pf
from gnnep_tpu_torch.data import neighbors as pnb
from gnnep_tpu_torch.data import structure as ps

ROOT = pathlib.Path(__file__).resolve().parent.parent
SPECIES = ["Si", "O", "Mg", "Fe", "Na", "Cl", "Ga", "As", "Al", "Ti"]
# the fields of a GraphSample, arrays and strings
FIELDS = [f.name for f in dataclasses.fields(pf.GraphSample)]


@pytest.fixture(autouse=True)
def jax_native(monkeypatch):
    """The JAX package's native library loaded in this process. Workers
    that lost the race of concurrent first builds while collecting
    (ROADMAP.md, Hazards) marked it failed; the library is built by now, so
    the load is retried."""
    if not jn.available():
        monkeypatch.setattr(jn, "_lib_failed", False)
    assert jn.available()


def _structure_dict(seed: int):
    """A seeded triclinic cell of 1-4 atoms as pymatgen's as_dict()."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 5))
    lat = ps.Lattice.from_parameters(*rng.uniform(3.2, 4.2, 3),
                                     *rng.uniform(75.0, 105.0, 3))
    s = ps.Structure(lat, list(rng.choice(SPECIES, n)), rng.random((n, 3)))
    return s.as_dict()


def _assert_samples_equal(got, want):
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


def _python_line_graph(monkeypatch):
    """Both packages on their Python line graph (and Python neighbour
    list), as on a host without a C++ toolchain."""
    for mod in (jn, pn):
        monkeypatch.setattr(mod, "build_line_graph_native",
                            lambda *a, **k: None)
        monkeypatch.setattr(mod, "cutoff_neighbors_native",
                            lambda *a, **k: None)


# per method: (cutoff, fallback_cutoff), small enough for the Python path
METHODS = {"cutoff": dict(cutoff=3.6), "knn12": dict(),
           "crystalnn": dict(fallback_cutoff=4.0)}


@pytest.mark.parametrize("line_graph", ["native", "python"])
@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_graph_equals_jax(monkeypatch, seed, method, line_graph):
    if line_graph == "python":
        _python_line_graph(monkeypatch)
    else:
        assert pn.available()
    d = _structure_dict(seed)
    basis_kw = dict(rbf_n=8, rbf_cutoff=6.0, angle_n=5)
    kw = dict(nn_method=method, material_id=f"s{seed}", y=[90.0, 40.0],
              **METHODS[method])
    m2v = {"Si": np.arange(4.0), "O": -np.arange(4.0)}
    got = pf.build_graph(ps.Structure.from_dict(d),
                         basis=pf.BasisConfig(**basis_kw), mat2vec=m2v, **kw)
    want = jf.build_graph(js.Structure.from_dict(d),
                          basis=jf.BasisConfig(**basis_kw), mat2vec=m2v, **kw)
    assert got.n_edges > 0
    assert got.neighbor_method == ("cutoff" if method == "crystalnn"
                                   else method)
    _assert_samples_equal(got, want)


@pytest.mark.parametrize("line_graph", ["native", "python"])
def test_mgo_anchor(monkeypatch, line_graph):
    """Rocksalt MgO at a = 4.21, cutoff 2.2: 48 bonds, 240 angles, 59 global
    scalars, in both packages."""
    if line_graph == "python":
        _python_line_graph(monkeypatch)
    fr = [[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0],
          [.5, 0, 0], [0, .5, 0], [0, 0, .5], [.5, .5, .5]]
    sp = ["Mg"] * 4 + ["O"] * 4
    got = pf.build_graph(ps.Structure(ps.Lattice(np.eye(3) * 4.21), sp, fr),
                         nn_method="cutoff", cutoff=2.2)
    want = jf.build_graph(js.Structure(js.Lattice(np.eye(3) * 4.21), sp, fr),
                          nn_method="cutoff", cutoff=2.2)
    assert (got.n_edges, got.n_lg_edges, got.global_scalars.shape) == \
        (48, 240, (59,))
    assert got.reduced_formula == "MgO" and got.prototype == "AB"
    _assert_samples_equal(got, want)


def test_custom_materials_featurize_equal():
    """The repo's example structures with the fetcher's defaults (crystalnn,
    so the 7.5 Å cutoff without pymatgen) and the bundled mat2vec table."""
    entries = json.loads((ROOT / "examples" / "custom_materials.json")
                         .read_text())["materials"]
    lookup = pf.load_mat2vec(str(ROOT / "gnnep_tpu_torch" / "assets"
                                 / "mat2vec_200d.npz"))
    j_lookup = jf.load_mat2vec(str(ROOT / "gnnep_tpu" / "assets"
                                   / "mat2vec_200d.npz"))
    for e in entries:
        got = pf.build_graph(ps.Structure.from_dict(e["structure"]),
                             material_id=e["material_id"], mat2vec=lookup)
        want = jf.build_graph(js.Structure.from_dict(e["structure"]),
                              material_id=e["material_id"], mat2vec=j_lookup)
        assert got.node_feats.shape[1] == 206
        _assert_samples_equal(got, want)
    assert (got.n_nodes, got.neighbor_method) == (8, "cutoff")


def test_mat2vec_assets_equal():
    a = pf.load_mat2vec(str(ROOT / "gnnep_tpu_torch" / "assets"
                            / "mat2vec_200d.npz"))
    b = jf.load_mat2vec(str(ROOT / "gnnep_tpu" / "assets"
                            / "mat2vec_200d.npz"))
    assert a.keys() == b.keys() and len(a) == 118
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_mat2vec_json_and_missing(tmp_path):
    path = tmp_path / "m2v.json"
    path.write_text(json.dumps({"Si": [1.0, 2.0], "o": [3.0, 4.0]}))
    assert {k: v.tolist() for k, v in pf.load_mat2vec(str(path)).items()} \
        == {k: v.tolist() for k, v in jf.load_mat2vec(str(path)).items()}
    assert pf.load_mat2vec(None) == {}
    with pytest.raises(FileNotFoundError):
        pf.load_mat2vec(str(tmp_path / "absent.npz"))


def test_native_bindings_equal_jax_reference(monkeypatch):
    """The two ctypes bindings the port adds return what the JAX package's
    Python neighbour list and line graph give on the same inputs."""
    assert pn.available()
    s = ps.Structure.from_dict(_structure_dict(7))
    reps = pnb._image_ranges(s.lattice.matrix, 4.0)
    src, dst, img, dist, dirs = pn.cutoff_neighbors_native(
        s.frac_coords, s.lattice.matrix, 4.0, reps)
    monkeypatch.setattr(jn, "cutoff_neighbors_native", lambda *a, **k: None)
    edges = jnb.cutoff_neighbors(js.Structure.from_dict(_structure_dict(7)),
                                 4.0)
    assert [(int(a), int(b), tuple(int(x) for x in m))
            for a, b, m in zip(src, dst, img)] == edges
    vec = (s.frac_coords[dst] + img - s.frac_coords[src]) @ s.lattice.matrix
    np.testing.assert_allclose(dist, np.linalg.norm(vec, axis=1), rtol=1e-12)
    centers = np.linspace(0.0, math.pi, 6)
    got = pn.build_line_graph_native(src, dst, img, dirs, len(s), centers,
                                     1.3)
    want = jf._line_graph_python(edges, src, dst, img, dirs, centers, 1.3)
    # indices exact; the features' exp and trigonometry round in the last
    # bit of f32 differently in C and numpy
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-12)
    assert got[0].size > 0


# ---------------------------------------------------- structure, elements
FORMULA_CASES = [["Cl", "Na"], ["Na", "Cl", "Na", "Cl"],
                 ["Fe", "Fe", "O", "O", "O"], ["O"] * 4 + ["Al"] * 2 + ["Mg"],
                 ["Fe"] * 2 + ["S"] * 3 + ["O"] * 12,
                 ["Ca", "C", "O", "O", "O"], ["Na", "O", "Na", "O"],
                 ["O", "O"], ["H", "O", "H"], ["Fe2+", "O2-"], ["Po"]]


@pytest.mark.parametrize("species", FORMULA_CASES,
                         ids=["".join(c) for c in FORMULA_CASES])
def test_formulas_equal_jax(species):
    fr = np.zeros((len(species), 3))
    got = ps.Structure(ps.Lattice(np.eye(3) * 4.0), species, fr)
    want = js.Structure(js.Lattice(np.eye(3) * 4.0), species, fr)
    for fn in ("reduced_formula", "anonymized_formula", "prototype_label"):
        assert getattr(got, fn)() == getattr(want, fn)(), fn
    assert got.composition == want.composition
    assert got.density == want.density and got.volume == want.volume


@pytest.mark.parametrize("form", ["matrix", "parameters", "disordered"])
def test_structure_from_dict_equals_jax(form):
    d = _structure_dict(3)
    if form == "parameters":
        d["lattice"] = {k: v for k, v in d["lattice"].items()
                        if k != "matrix"}
    elif form == "disordered":
        d["sites"][0]["species"] = [{"element": "Fe", "occu": 0.3},
                                    {"element": "Ni", "occu": 0.7}]
    got, want = ps.Structure.from_dict(d), js.Structure.from_dict(d)
    np.testing.assert_array_equal(got.lattice.matrix, want.lattice.matrix)
    np.testing.assert_array_equal(got.frac_coords, want.frac_coords)
    assert got.species == want.species
    assert got.as_dict() == want.as_dict()
    for p in ("a", "b", "c", "alpha", "beta", "gamma", "volume"):
        assert getattr(got.lattice, p) == getattr(want.lattice, p), p


def test_element_tables_equal_jax():
    assert pel.SYMBOLS == je.SYMBOLS and pel.Z_OF == je.Z_OF
    for sym in pel.SYMBOLS + ["Fe2+", "O2-", "fe", "CL"]:
        assert pel.element_props(sym) == je.element_props(sym), sym
    for mod in (pel, je):
        with pytest.raises(KeyError, match="Unknown element"):
            mod.element_props("Xx")


@pytest.mark.parametrize("method", ["crystalNN", "cutof", "knn-3", "voronoi"])
def test_find_edges_rejects_unknown_method(method):
    s = ps.Structure.from_dict(_structure_dict(0))
    with pytest.raises(ValueError, match="Unknown neighbor method"):
        pnb.find_edges(s, method, 3.0)


def test_knn_zero_rejected_and_spacegroup_unknown():
    s = ps.Structure.from_dict(_structure_dict(0))
    with pytest.raises(ValueError, match=">= 1"):
        pnb.find_edges(s, "knn0", 3.0)
    # without pymatgen the space group is unknown, as in the JAX package
    assert pf.spacegroup_number(s) == jf.spacegroup_number(
        js.Structure.from_dict(_structure_dict(0)))
