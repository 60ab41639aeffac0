"""The port's offline fetch CLI (`gnnep_tpu_torch.cli.fetch --from-json`)
writes a store that loads array-equal to the one `gnnep_tpu.cli.fetch`
writes from the same JSON: serial, parallel, and resumed."""
import dataclasses
import json
import sys

import numpy as np
import pytest

from gnnep_tpu import native as jn
from gnnep_tpu.cli import fetch as jfetch
from gnnep_tpu.data.store import GraphStore as JStore
from gnnep_tpu.data.structure import Lattice, Structure
from gnnep_tpu_torch.cli import fetch as pfetch
from gnnep_tpu_torch.data.store import GraphStore as PStore

# small cutoffs and bases: the cells are 2-atom Si (and one SiO) cubes
SMALL = ["--nn-method", "cutoff", "--cutoff", "2.9", "--rbf-n", "4",
         "--angle-n", "4", "--disable-mat2vec"]


@pytest.fixture(autouse=True)
def jax_native(monkeypatch):
    """The JAX package's native library loaded in this process (a worker
    that lost the race of concurrent first builds while collecting retries
    the load; see ROADMAP.md, Hazards)."""
    if not jn.available():
        monkeypatch.setattr(jn, "_lib_failed", False)
    assert jn.available()


def _entries(n=6):
    rng = np.random.default_rng(3)
    out = []
    for i in range(n):
        a = 3.0 + 0.1 * i
        species = ["Si", "O"] if i == 4 else ["Si", "Si"]
        s = Structure(Lattice(np.eye(3) * a), species,
                      [[0, 0, 0], [0.5, 0.5, 0.5]])
        e = {"material_id": f"mp-{i:04d}", "formula": "Si2",
             "structure": s.as_dict()}
        if i != 5:                  # the last one carries no target
            e.update(k_vrh=float(80 + 10 * rng.random()),
                     g_vrh=float(40 + 5 * rng.random()))
        out.append(e)
    return out


def _fetch(main, src, out, extra):
    main(["--out-dir", str(out), "--from-json", str(src)] + extra)


def _assert_stores_equal(port_dir, jax_dir):
    got = PStore.load_dir(port_dir, require_target=False, use_cache=False)
    want = JStore.load_dir(jax_dir, require_target=False, use_cache=False)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert json.loads((port_dir / "index.json").read_text()) == \
        json.loads((jax_dir / "index.json").read_text())
    assert sorted(p.name for p in port_dir.iterdir()) == \
        sorted(p.name for p in jax_dir.iterdir())
    return got


RUNS = {"serial": SMALL, "parallel": SMALL + ["--fetch-workers", "2"],
        "mat2vec": SMALL[:-1],
        "crystalnn": ["--rbf-n", "4", "--angle-n", "4", "--disable-mat2vec"]}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_from_json_store_equals_jax(tmp_path, capsys, run):
    """`serial`, `parallel` (spawned workers), `mat2vec` (each package's
    bundled 200-d table) and `crystalnn` (the default method: without
    pymatgen the 7.5 Å cutoff) write the same store."""
    src = tmp_path / "structures.json"
    n = 2 if run == "crystalnn" else 6
    src.write_text(json.dumps({"materials": _entries(n)}))
    _fetch(pfetch.main, src, tmp_path / "port", RUNS[run])
    _fetch(jfetch.main, src, tmp_path / "jax", RUNS[run])
    got = _assert_stores_equal(tmp_path / "port", tmp_path / "jax")
    assert got.n_graphs == n
    assert got.node_dim == (206 if run == "mat2vec" else 6)
    out = capsys.readouterr().out
    assert f"Saved {n} graphs" in out
    if run == "crystalnn":
        assert "fell back to cutoff neighbors (r=7.5" in out


def test_skip_existing_and_rebuild(tmp_path, capsys):
    """A second run with --skip-existing skips every file; an unreadable
    file and one of another mat2vec width are rebuilt, in both packages."""
    src = tmp_path / "structures.json"
    src.write_text(json.dumps(_entries()))
    outs = {}
    for name, main in (("port", pfetch.main), ("jax", jfetch.main)):
        out = tmp_path / name
        _fetch(main, src, out, SMALL)
        capsys.readouterr()
        _fetch(main, src, out, SMALL + ["--skip-existing"])
        assert "skipped: 6" in capsys.readouterr().out
        (out / "mp-0001.npz").write_bytes(b"not a zip")
        _fetch(main, src, out, SMALL[:-1] + ["--skip-existing"])
        outs[name] = capsys.readouterr().out
        assert "mp-0001.npz is unreadable" in outs[name]
        assert "skipped: 0" in outs[name]    # 6-wide files: mat2vec mismatch
    _assert_stores_equal(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("argv,match", [
    (["--limit", "1"], "API key"),
    (["--limit", "0"], "positive"),
    (["--no-all"], "requires --limit"),
])
def test_argument_errors_exit(tmp_path, monkeypatch, argv, match):
    monkeypatch.delenv("MAPI_KEY", raising=False)
    monkeypatch.delenv("MP_API_KEY", raising=False)
    for main in (pfetch.main, jfetch.main):
        with pytest.raises(SystemExit, match=match):
            main(["--out-dir", str(tmp_path / "o")] + argv)


def test_without_mp_api_exits(tmp_path, monkeypatch):
    """The online source is the same lazy `mp_api` import: without the
    package it exits with the message that names --from-json."""
    monkeypatch.setitem(sys.modules, "mp_api", None)
    monkeypatch.setitem(sys.modules, "mp_api.client", None)
    for main in (pfetch.main, jfetch.main):
        with pytest.raises(SystemExit, match="--from-json"):
            main(["--out-dir", str(tmp_path / "o"), "--limit", "1",
                  "--api-key", "k"])


def test_flags_equal_the_jax_cli():
    def flags(parser):
        return {a.dest: a.default for a in parser._actions
                if a.dest != "help"}
    got, want = flags(pfetch.build_parser()), flags(jfetch.build_parser())
    # each points at its own copy of the bundled table
    assert got.pop("mat2vec_path").endswith(
        "gnnep_tpu_torch/assets/mat2vec_200d.npz")
    assert want.pop("mat2vec_path").endswith(
        "gnnep_tpu/assets/mat2vec_200d.npz")
    assert got == want
