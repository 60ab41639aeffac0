"""Reference-artifact conversion in the port (`gnnep_tpu_torch.train.convert`,
`cli.convert`) against the JAX package's (`gnnep_tpu.train.convert`) on the
same synthetic state dicts and `.pt` files: array-equal outputs; the port
reads `.pt` files with `weights_only=True`."""
import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from synthetic import make_samples  # noqa: E402
from test_convert import _torch_member_state  # noqa: E402

from gnnep_tpu.train import convert as jconv  # noqa: E402
from gnnep_tpu_torch.cli import convert as pcli  # noqa: E402
from gnnep_tpu_torch.data.store import GraphStore as PStore  # noqa: E402
from gnnep_tpu_torch.infer.predict import Ensemble  # noqa: E402
from gnnep_tpu_torch.train import convert as pconv  # noqa: E402
from gnnep_tpu_torch.train.artifacts import (load_conformal,  # noqa: E402
                                             load_scaler_state, save_member)


def _state(seed, hidden, layers, tdim, store=None):
    store = store or PStore.from_samples(make_samples(4, seed=2))
    return _torch_member_state(np.random.default_rng(seed), store.node_dim,
                               store.edge_dim, store.angle_dim,
                               store.global_scalar_dim + 230, hidden, layers,
                               tdim)


def _npz(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


@pytest.mark.parametrize("hidden,layers,tdim", [(8, 2, 2), (16, 1, 1),
                                                (12, 3, 2)])
def test_member_conversion_equals_jax(tmp_path, hidden, layers, tdim):
    """The same reference state dict converted by both packages gives the
    same `model_{i}.npz`, leaf for leaf and config for config."""
    from gnnep_tpu.train.artifacts import save_member as jsave

    sd = _state(hidden + layers, hidden, layers, tdim)
    jparams, jcfg = jconv.convert_member_state(sd, heads=2, dropout=0.1)
    model, cfg = pconv.convert_member_state(sd, heads=2, dropout=0.1)
    jsave(tmp_path / "j.npz", jparams, jcfg)
    save_member(tmp_path / "p.npz", model)
    j, p = _npz(tmp_path / "j.npz"), _npz(tmp_path / "p.npz")
    assert sorted(j) == sorted(p)
    for k in j:
        if k == "config_json":
            assert json.loads(str(p[k])) == json.loads(str(j[k]))
        else:
            np.testing.assert_array_equal(p[k], j[k])
    assert (cfg.hidden, cfg.layers, cfg.target_dim, cfg.heads) == (
        hidden, layers, tdim, 2)


def _scaler_pt(path, rng, log=True):
    raw = {"scalar_mean": torch.tensor(rng.normal(size=6)),
           "scalar_std": torch.tensor(rng.uniform(0.5, 2, 6)),
           "embed_mean": torch.tensor(rng.normal(size=4)),
           "embed_std": torch.tensor(rng.uniform(0.5, 2, 4)),
           "global_mean": torch.tensor(rng.normal(size=59)),
           "global_std": torch.tensor(rng.uniform(0.5, 2, 59)),
           "target_transform": "log" if log else "none"}
    if log:
        raw["log_transform"] = {"means": torch.tensor([4.3, 3.5]),
                                "stds": torch.tensor([0.9, 0.94])}
    torch.save(raw, path)


def _conformal_pt(path):
    torch.save({"q": torch.tensor([0.9173, 1.5967]), "method": "scaled",
                "alpha": 0.1,
                "affine_a": torch.tensor([1.02, 0.99], dtype=torch.bfloat16),
                "affine_b": torch.tensor([0.01, -0.02])}, path)


@pytest.mark.parametrize("log", [True, False])
def test_scaler_state_equals_jax(tmp_path, log):
    _scaler_pt(tmp_path / "s.pt", np.random.default_rng(3), log)
    jconv.convert_scaler_state(tmp_path / "s.pt", tmp_path / "j.npz")
    pconv.convert_scaler_state(tmp_path / "s.pt", tmp_path / "p.npz")
    j, p = _npz(tmp_path / "j.npz"), _npz(tmp_path / "p.npz")
    assert sorted(j) == sorted(p)
    for k in j:
        np.testing.assert_array_equal(p[k], j[k])
    _, transformer, _ = load_scaler_state(tmp_path / "p.npz")
    assert (transformer is not None) == log


def test_conformal_equals_jax(tmp_path):
    _conformal_pt(tmp_path / "c.pt")
    want = jconv.convert_conformal(tmp_path / "c.pt", tmp_path / "j.json")
    got = pconv.convert_conformal(tmp_path / "c.pt", tmp_path / "p.json")
    assert (tmp_path / "p.json").read_text() == \
        (tmp_path / "j.json").read_text()
    for k in ("q", "affine_a", "affine_b"):
        np.testing.assert_array_equal(got[k], want[k])
    assert load_conformal(tmp_path / "p.json")["method"] == "scaled"


def test_cli_converts_a_directory_like_jax(tmp_path):
    ref = tmp_path / "ref"
    ref.mkdir()
    store = PStore.from_samples(make_samples(6, seed=5))
    _scaler_pt(ref / "scaler_state.pt", np.random.default_rng(1))
    _conformal_pt(ref / "conformal.pt")
    for i in range(2):
        torch.save(_state(i, 8, 2, 2, store), ref / f"model_{i}.pt")
    assert jconv.convert_ensemble(ref, tmp_path / "j", heads=2,
                                  verbose=False) == 2
    assert pcli.main(["--reference-dir", str(ref), "--out-dir",
                      str(tmp_path / "p"), "--heads", "2", "--quiet"]) == 2
    names = sorted(f.name for f in (tmp_path / "j").iterdir())
    assert names == sorted(f.name for f in (tmp_path / "p").iterdir())
    for name in names:
        if name.endswith(".npz"):
            j, p = _npz(tmp_path / "j" / name), _npz(tmp_path / "p" / name)
            assert sorted(j) == sorted(p)
            for k in j:
                if k == "config_json":
                    assert json.loads(str(p[k])) == json.loads(str(j[k]))
                else:
                    np.testing.assert_array_equal(p[k], j[k])
        else:
            assert (tmp_path / "p" / name).read_text() == \
                (tmp_path / "j" / name).read_text()
    # the converted directory serves through the port on the CPU
    ens = Ensemble.load(tmp_path / "p", device="cpu")
    std = ens.scaler.apply(store)
    res = ens.predict(std, range(6), batch_size=3)
    assert len(res) == 6 and np.isfinite([r["mu"] for r in res]).all()


class _Payload:
    """Not a tensor, number, string or container: refused by a
    weights-only load."""


def test_pt_files_are_read_weights_only(tmp_path):
    torch.save({"q": torch.ones(2), "method": "scaled", "alpha": 0.1,
                "affine_a": torch.ones(2), "affine_b": torch.zeros(2),
                "extra": _Payload()}, tmp_path / "c.pt")
    with pytest.raises(Exception, match="[Ww]eights only|weights_only"):
        pconv.convert_conformal(tmp_path / "c.pt", tmp_path / "c.json")
    assert not (tmp_path / "c.json").exists()
