"""The port's training host code against the JAX package's on the same
arrays (splits, bins, metrics, calibration, store keys), a tiny
`cli.train --device cpu` run end to end whose artifacts load and serve in
both packages, and the options this slice does not port."""
import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from synthetic import make_samples  # noqa: E402

from gnnep_tpu.data import splits as jsplits  # noqa: E402
from gnnep_tpu.data.store import GraphStore as JStore  # noqa: E402
from gnnep_tpu.data.transforms import LogTransformer as JLog  # noqa: E402
from gnnep_tpu.train import bins as jbins  # noqa: E402
from gnnep_tpu.train import calibrate as jcal  # noqa: E402
from gnnep_tpu.train import metrics as jmet  # noqa: E402
from gnnep_tpu_torch.data import splits as psplits  # noqa: E402
from gnnep_tpu_torch.data.store import GraphStore as PStore  # noqa: E402
from gnnep_tpu_torch.data.transforms import LogTransformer as PLog  # noqa: E402
from gnnep_tpu_torch.train import bins as pbins  # noqa: E402
from gnnep_tpu_torch.train import calibrate as pcal  # noqa: E402
from gnnep_tpu_torch.train import metrics as pmet  # noqa: E402


def _targets(rng, n=40, t=2):
    return np.exp(rng.normal(4.0, 0.8, size=(n, t))).astype(np.float32)


def test_store_keys_and_subset_match_jax():
    samples = make_samples(12, seed=3)
    js, ps = JStore.from_samples(samples), PStore.from_samples(samples)
    assert ps.group_keys() == js.group_keys()
    pick = [7, 2, 9]
    jsub, psub = js.subset(pick), ps.subset(pick)
    assert psub.material_ids == jsub.material_ids
    for key in ("node_feats", "edge_src", "edge_dst", "lg_src", "lg_dst",
                "node_off", "edge_off", "lg_off", "y", "sg_num"):
        np.testing.assert_array_equal(getattr(psub, key), getattr(jsub, key))


@pytest.mark.parametrize("seed,ens", [(42, 5), (7, 2), (3, 1)])
def test_splits_match_jax(seed, ens):
    rng = np.random.default_rng(seed)
    keys = [f"g{int(k)}" for k in rng.integers(0, 30, 120)]
    want = jsplits.derive_splits(keys, seed, 0.1, 0.05, 0.1, ens)
    got = psplits.derive_splits(keys, seed, 0.1, 0.05, 0.1, ens)
    assert got == want


@pytest.mark.parametrize("gamma,bins", [(0.0, 6), (0.5, 4), (1.0, 1)])
def test_bins_match_jax(gamma, bins):
    y = _targets(np.random.default_rng(1))
    want = jbins.compute_bin_statistics(y, bins, gamma)
    got = pbins.compute_bin_statistics(y, bins, gamma)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    y2 = y.copy()
    y2[3] = np.nan
    np.testing.assert_array_equal(
        pbins.freq_weights_for_store(y2, got[0], got[1]),
        jbins.freq_weights_for_store(y2, want[0], want[1]))


def test_metrics_match_jax():
    rng = np.random.default_rng(2)
    y = _targets(rng)
    y[5, 1] = np.nan                       # a partially targeted sample
    tf_j = JLog.fit(np.nan_to_num(y, nan=50.0))
    tf_p = PLog.from_state_dict(tf_j.state_dict())
    mean_z = rng.normal(size=y.shape)
    sigma_z = rng.uniform(0.3, 2.0, size=y.shape)
    want = jmet.eval_metrics(mean_z, sigma_z, y, tf_j)
    got = pmet.eval_metrics(mean_z, sigma_z, y, tf_p)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    preds = _targets(rng)
    assert pmet.error_stats(preds, np.nan_to_num(y, nan=1.0)) == \
        jmet.error_stats(preds, np.nan_to_num(y, nan=1.0))


@pytest.mark.parametrize("method", ["scaled", "absolute"])
def test_calibration_matches_jax(method):
    rng = np.random.default_rng(4)
    y = _targets(rng, n=30)
    tf_j = JLog.fit(y)
    tf_p = PLog.from_state_dict(tf_j.state_dict())
    m_means = rng.normal(size=(3, 30, 2))
    m_vars = rng.uniform(0.1, 1.0, size=(3, 30, 2))
    for a, b in zip(pcal.ensemble_mixture(m_means, m_vars),
                    jcal.ensemble_mixture(m_means, m_vars)):
        np.testing.assert_array_equal(a, b)
    mean_z, var_z = jcal.ensemble_mixture(m_means, m_vars)
    tz = tf_j.transform(y)
    for a, b in zip(pcal.fit_affine_debias(mean_z, tz),
                    jcal.fit_affine_debias(mean_z, tz)):
        np.testing.assert_array_equal(a, b)
    std = np.sqrt(var_z)
    want = jcal.conformal_calibration(mean_z, std, y, tf_j, 0.1, method)
    got = pcal.conformal_calibration(mean_z, std, y, tf_p, 0.1, method)
    assert got["method"] == want["method"] and got["alpha"] == want["alpha"]
    np.testing.assert_array_equal(got["q"], want["q"])
    for a, b in zip(pcal.apply_conformal_intervals(mean_z, std, got, tf_p),
                    jcal.apply_conformal_intervals(mean_z, std, want, tf_j)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------- the CLI end to end
@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """`cli.train --device cpu` at hidden 16, 1 layer, 2 members, 2
    epochs, on 40 featurized synthetic crystals."""
    from gnnep_tpu_torch.cli import train
    from gnnep_tpu_torch.data.store import save_sample

    root = tmp_path_factory.mktemp("train")
    data, ens = root / "data", root / "ens"
    for s in make_samples(40, seed=5):
        save_sample(data, s)
    summary = train.main([
        "--data-dir", str(data), "--save-dir", str(ens), "--device", "cpu",
        "--hidden", "16", "--layers", "1", "--heads", "2",
        "--ensemble-size", "2", "--epochs", "2", "--batch-size", "8",
        "--scan-steps", "2", "--quiet"])
    return dict(data=data, ens=ens, summary=summary)


def test_cli_train_writes_the_artifacts(trained):
    ens, summary = trained["ens"], trained["summary"]
    for name in ("model_0.npz", "model_1.npz", "scaler_state.npz",
                 "conformal.json", "train_summary.json"):
        assert (ens / name).exists(), name
    on_disk = json.loads((ens / "train_summary.json").read_text())
    assert on_disk["members"] == 2
    assert on_disk["optimizer_steps"] == sum(
        on_disk["member_optimizer_steps"]) > 0
    assert summary["optimizer_steps"] == on_disk["optimizer_steps"]
    assert np.isfinite(on_disk["test_stats"]["overall"]["mae"])


def test_port_trained_ensemble_serves_in_both_packages(trained):
    """The JAX package loads the port's members, scaler state and conformal
    JSON, and its means equal the port's (f32 forward tolerance,
    test_torch_model.py)."""
    from gnnep_tpu.infer.predict import Ensemble as JEnsemble
    from gnnep_tpu.train.artifacts import load_conformal as j_load_conformal
    from gnnep_tpu_torch.infer.predict import Ensemble as PEnsemble
    from gnnep_tpu_torch.train.artifacts import load_conformal

    ens, data = trained["ens"], trained["data"]
    j_ens = JEnsemble.load(ens)
    p_ens = PEnsemble.load(ens, device="cpu")
    assert len(j_ens.members) == len(p_ens.members) == 2
    js = j_ens.scaler.apply(JStore.load_dir(data))
    ps = p_ens.scaler.apply(PStore.load_dir(data))
    idx = list(range(0, 40, 3))
    want = j_ens.predict(js, idx, batch_size=8)
    got = p_ens.predict(ps, idx, batch_size=8)
    assert [r["material_id"] for r in got] == [r["material_id"] for r in want]
    np.testing.assert_allclose([r["mu"] for r in got],
                               [r["mu"] for r in want], rtol=1e-3, atol=1e-4)
    a, b = load_conformal(ens / "conformal.json"), \
        j_load_conformal(ens / "conformal.json")
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


# no option is left unported (a mesh and member parallelism conflict, as
# in the JAX package: tests/test_torch_member_parallel.py)
UNPORTED = {}
# options that raised until they were ported (KNN weighting, embeddings,
# member processes, resume and checkpoints, the profiler trace, the
# multi-device paths)
PORTED = {"enable_density_weighting": True, "save_embeddings": True,
          "member_isolation": "process", "resume": True,
          "checkpoint_every": 2, "profile_dir": "trace",
          "member_parallel": "vmap", "data_shards": 2, "edge_shards": 2,
          "giant_graphs": "boundary"}


@pytest.mark.parametrize("field", sorted({**UNPORTED, **PORTED}))
def test_unported_option_raises(tmp_path, field):
    """An option not ported yet raises NotImplementedError naming
    ROADMAP.md; one ported since passes `check_supported`."""
    from gnnep_tpu_torch.train.config import TrainConfig
    from gnnep_tpu_torch.train.ensemble import check_supported, run_training

    cfg = dataclasses.replace(TrainConfig(data_dir=str(tmp_path),
                                          save_dir=str(tmp_path)),
                              **{field: {**UNPORTED, **PORTED}[field]})
    if field in PORTED:
        check_supported(cfg)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_training(cfg, device="cpu")


@pytest.mark.parametrize("flag", ["--no-attn-fused", "--no-attn-eproj"])
def test_rung_flags_are_accepted(monkeypatch, flag):
    """Each rung flag passes `check_supported` (on any device: both rungs
    have their kernels) and lands in the member's config; under the default
    `--conv-impl table` it leaves every conv on the eproj rung, as the JAX
    package ignores it there (dense_attention.py:151-163)."""
    from gnnep_tpu.data.batching import BatchBudget, BatchPacker
    from gnnep_tpu_torch.cli.train import build_parser, config_from_args
    from gnnep_tpu_torch.models import alignn as pm
    from gnnep_tpu_torch.ops.cuda import aggregate, attention
    from gnnep_tpu_torch.ops.cuda import attention_eproj as ep
    from gnnep_tpu_torch.train.ensemble import check_supported, model_config

    cfg = config_from_args(build_parser().parse_args(
        [flag, "--hidden", "16", "--layers", "1", "--heads", "2"]))
    check_supported(cfg)
    samples = make_samples(4, seed=3)
    store = PStore.from_samples(samples)
    mc = model_config(cfg, store)
    assert mc.conv_impl == "table"
    assert (mc.attn_fused, mc.attn_eproj) == (flag != "--no-attn-fused",
                                              flag != "--no-attn-eproj")
    reached = {}
    for mod, fn in ((ep, "attention_eproj_plain"),
                    (attention, "attention_plain"),
                    (aggregate, "aggregate_plain")):
        def counted(*a, _fn=fn, _real=getattr(mod, fn), **k):
            reached[_fn] = reached.get(_fn, 0) + 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, fn, counted)
    jstore = JStore.from_samples(samples)
    budget = BatchBudget.plan(jstore, range(4), batch_size=4)
    batch = next(iter(BatchPacker(jstore, budget).pack(range(4))))
    model = pm.init_alignn(np.random.default_rng(0), mc)
    with torch.inference_mode():
        mean, _ = pm.alignn_apply(model, pm.DeviceBatch.from_batch(batch,
                                                                   "cpu"))
    assert torch.isfinite(mean).all()
    assert reached == {"attention_eproj_plain": 2 * mc.layers}
