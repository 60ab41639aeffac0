"""The port's evaluation (`gnnep_tpu_torch.evaluate`, `cli.evaluate`) against
`gnnep_tpu.evaluate` on the same inputs: the metric numerics of
`tests/test_evaluate.py` run against both packages, and the runner's
`metrics.json` on one JAX-written random-weight ensemble, with and without a
JAX-written `conformal.json`."""
import dataclasses
import json
import math
import pathlib
import shutil
import sys

import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from synthetic import make_samples  # noqa: E402

from gnnep_tpu.data.store import GraphStore as JStore  # noqa: E402
from gnnep_tpu.data.store import save_sample, write_index  # noqa: E402
from gnnep_tpu.data.transforms import FeatureScaler  # noqa: E402
from gnnep_tpu.data.transforms import LogTransformer as JLog  # noqa: E402
from gnnep_tpu.evaluate import metrics as JM  # noqa: E402
from gnnep_tpu.models.alignn import AlignnConfig, init_alignn  # noqa: E402
from gnnep_tpu.train import artifacts as ja  # noqa: E402
from gnnep_tpu.train.metrics import error_stats as j_error_stats  # noqa: E402
from gnnep_tpu_torch.cli import evaluate as pcli  # noqa: E402
from gnnep_tpu_torch.data.store import GraphStore as PStore  # noqa: E402
from gnnep_tpu_torch.data.transforms import LogTransformer as PLog  # noqa: E402
from gnnep_tpu_torch.evaluate import metrics as PM  # noqa: E402
from gnnep_tpu_torch.evaluate import runner as pr  # noqa: E402
from gnnep_tpu_torch.train.metrics import error_stats as p_error_stats  # noqa: E402

N_GRAPHS = 28
FRACS = dict(seed=42, val_frac=0.15, calib_frac=0.15, test_frac=0.15,
             ensemble_size=2, batch_size=8)
RTOL, ATOL = 1e-3, 1e-4

PACKAGES = {"jax": (JM, JLog, j_error_stats),
            "torch": (PM, PLog, p_error_stats)}


# ---------------------------------------------------- metric numerics
# the cases of tests/test_evaluate.py::TestMetricNumerics, each run against
# both packages' `metrics`
def _r2_perfect_and_mean_predictor(M, Log, error_stats, rng):
    y = rng.normal(10, 3, (100, 2))
    np.testing.assert_allclose(M.r2_score(y, y), 1.0)
    mean_pred = np.tile(y.mean(axis=0), (100, 1))
    np.testing.assert_allclose(M.r2_score(mean_pred, y), 0.0, atol=1e-9)


def _skewness_signs(M, Log, error_stats, rng):
    right = rng.exponential(1.0, (5000, 1))
    assert M.residual_skewness(right)[0] > 0.5
    sym = rng.normal(0, 1, (5000, 1))
    assert abs(M.residual_skewness(sym)[0]) < 0.2


def _gaussian_nll_matches_formula(M, Log, error_stats, rng):
    mean, std, y = np.zeros((4, 1)), np.ones((4, 1)), np.zeros((4, 1))
    np.testing.assert_allclose(M.gaussian_nll(mean, std, y),
                               0.5 * math.log(2 * math.pi), rtol=1e-9)


def _reliability_curve_well_calibrated(M, Log, error_stats, rng):
    n = 20000
    y = rng.normal(0, 1, (n, 1))
    nom, emp = M.reliability_curve(np.zeros((n, 1)), np.ones((n, 1)), y,
                                   [0.5, 0.9])
    np.testing.assert_allclose(emp[0], [0.5, 0.9], atol=0.02)
    assert M.scalar_ece(nom, emp[0].tolist()) < 0.02


def _diversity_identical_members(M, Log, error_stats, rng):
    y = np.exp(rng.normal(4, 0.5, (50, 2)))
    t = Log.fit(y)
    mz = t.transform(y) + rng.normal(0, 0.2, (50, 2))
    means = np.stack([mz, mz, mz])
    stds = np.full((3, 50, 2), 0.3)
    d = M.diversity_metrics(means, stds, (stds ** 2).mean(0), y, t,
                            error_stats(t.inverse(mz), y))
    assert d["epistemic_fraction_mean"] < 1e-9
    assert abs(d["ensemble_gain_percent"]) < 1e-6
    np.testing.assert_allclose(d["member_correlation_matrix"], 1.0,
                               atol=1e-9)
    assert d["q_statistic_mean"] > 0.999


def _kendall_w_consistent_ordering(M, Log, error_stats, rng):
    y = np.exp(rng.normal(4, 0.5, (50, 2)))
    t = Log.fit(y)
    mz = t.transform(y) + rng.normal(0, 0.2, (50, 2))
    means = np.stack([mz, mz + 0.3, mz + 0.6])
    stds = np.full((3, 50, 2), 0.3)
    var_z = (stds ** 2).mean(0) + (means ** 2).mean(0) - means.mean(0) ** 2
    d = M.diversity_metrics(means, stds, var_z, y, t,
                            error_stats(t.inverse(means.mean(0)), y))
    assert d["kendall_w"] > 0.999


def _diversity_anticorrelated_members(M, Log, error_stats, rng):
    y = np.exp(rng.normal(4, 0.5, (200, 2)))
    t = Log.fit(y)
    y_z = t.transform(y)
    noise = rng.normal(0, 0.3, (200, 2))
    means = np.stack([y_z + noise, y_z - noise])
    stds = np.full((2, 200, 2), 0.3)
    mix = means.mean(0)
    var_z = (stds ** 2).mean(0) + (means ** 2).mean(0) - mix ** 2
    d = M.diversity_metrics(means, stds, var_z, y, t,
                            error_stats(t.inverse(mix), y))
    assert d["q_statistic_mean"] < -0.9
    assert d["ensemble_gain_percent"] > 20.0


def _sharpness_monotone_widths(M, Log, error_stats, rng):
    y = np.exp(rng.normal(4, 1, (300, 2)))
    t = Log.fit(y)
    mz = t.transform(y) + rng.normal(0, 0.3, (300, 2))
    scores = np.abs(t.transform(y) - mz)
    widths, covers = M.sharpness_vs_coverage(scores[:150], mz[150:], y[150:],
                                             t, [0.5, 0.8, 0.95])
    assert (np.diff(widths, axis=1) > 0).all()
    assert covers[0, -1] >= covers[0, 0]


NUMERIC_CASES = [_r2_perfect_and_mean_predictor, _skewness_signs,
                 _gaussian_nll_matches_formula,
                 _reliability_curve_well_calibrated,
                 _diversity_identical_members,
                 _kendall_w_consistent_ordering,
                 _diversity_anticorrelated_members,
                 _sharpness_monotone_widths]


@pytest.mark.parametrize("package", sorted(PACKAGES))
@pytest.mark.parametrize("case", NUMERIC_CASES,
                         ids=[c.__name__.strip("_") for c in NUMERIC_CASES])
def test_metric_numerics(case, package):
    case(*PACKAGES[package], np.random.default_rng(0))


def test_metric_functions_agree_on_random_inputs():
    """Every metric of both packages on the same random predictions."""
    rng = np.random.default_rng(5)
    y = np.exp(rng.normal(4, 0.6, (60, 2)))
    means = np.log(y)[None] + rng.normal(0, 0.3, (3, 60, 2)) - 4.0
    stds = np.exp(rng.normal(-1, 0.3, (3, 60, 2)))
    out = {}
    for name, (M, Log, error_stats) in PACKAGES.items():
        t = Log.fit(y)
        mix = means.mean(0)
        var = (stds ** 2).mean(0) + (means ** 2).mean(0) - mix ** 2
        d = M.diversity_metrics(means, stds, var, y, t,
                                error_stats(t.inverse(mix), y))
        nom, emp = M.reliability_curve(mix, np.sqrt(var), t.transform(y),
                                       [0.5, 0.9])
        sw, sc = M.sharpness_vs_coverage(np.abs(t.transform(y) - mix)[:30],
                                         mix[30:], y[30:], t, [0.5, 0.9],
                                         std_z=np.sqrt(var)[30:], scaled=True)
        out[name] = dict(d, emp=emp, sw=sw, sc=sc,
                         spear=M.spearman_per_target(np.abs(mix), var),
                         nll=M.gaussian_nll(mix, np.sqrt(var), t.transform(y)))
    assert out["jax"].keys() == out["torch"].keys()
    for key, want in out["jax"].items():
        np.testing.assert_array_equal(np.asarray(out["torch"][key]),
                                      np.asarray(want), err_msg=key)


# ---------------------------------------------------- the runner
@pytest.fixture(scope="module")
def ensemble_dir(tmp_path_factory):
    """Data dir + a 2-member random-weight ensemble and its conformal.json,
    all written by the JAX package (the fixture of
    tests/test_torch_predict.py: hidden 16, 1 layer, 2 heads)."""
    root = tmp_path_factory.mktemp("evaluate")
    samples = make_samples(N_GRAPHS, seed=6)
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
                       init_alignn(jax.random.PRNGKey(20 + i), cfg), cfg)
    ja.save_scaler_state(ens / "scaler_state.npz",
                         FeatureScaler.fit(store, range(N_GRAPHS)),
                         JLog.fit(store.y),
                         dims={"global_scalar_dim": store.global_scalar_dim})
    ja.save_conformal(ens / "conformal.json",
                      {"q": np.array([1.3, 0.8]), "method": "scaled",
                       "alpha": 0.1},
                      np.array([1.02, 0.97]), np.array([0.01, -0.02]))
    bare = root / "no_conformal"
    bare.mkdir()
    for f in ens.iterdir():
        if f.name != "conformal.json":
            shutil.copy(f, bare / f.name)
    return root


CASES = {"test": ("ensemble", dict(eval_split="test")),
         "fold": ("ensemble", dict(eval_split="fold", fold_index=1)),
         "no_conformal": ("no_conformal", dict(eval_split="test"))}


def _jax_runner():
    """`gnnep_tpu.evaluate.runner`, which imports matplotlib at its top:
    imported by the tests that need it, so that this file collects on a
    host without matplotlib (the card's machine)."""
    pytest.importorskip("matplotlib")
    from gnnep_tpu.evaluate import runner
    return runner


def _run_both(root, tmp_path, case):
    jr = _jax_runner()
    ens, kw = CASES[case]
    common = dict(ensemble_dir=str(root / ens), data_dir=str(root / "data"),
                  make_plots=False, **FRACS, **kw)
    want = jr.run_evaluation(jr.EvalConfig(output_dir=str(tmp_path / "jax"),
                                           **common))
    got = pr.run_evaluation(pr.EvalConfig(output_dir=str(tmp_path / "torch"),
                                          **common), device="cpu")
    return got, want


def _assert_same(got, want, path="metrics"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif want is None or isinstance(want, str):
        assert got == want, path
    elif "conformal_coverage" in path:
        assert got == want, path           # a coverage fraction: equal
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   equal_nan=True, err_msg=path)


def _interval_edge_margin(root, case):
    """Smallest relative distance of a target in the evaluated split from
    its conformal interval's edge (inf without conformal.json)."""
    jr = _jax_runner()
    ens, kw = CASES[case]
    cfg = jr.EvalConfig(ensemble_dir=str(root / ens),
                        data_dir=str(root / "data"), **FRACS, **kw)
    conf_path = root / ens / "conformal.json"
    if not conf_path.exists():
        return math.inf
    from gnnep_tpu.data.batching import BatchBudget
    from gnnep_tpu.data.splits import derive_splits
    from gnnep_tpu.infer.predict import Ensemble
    from gnnep_tpu.train.calibrate import apply_conformal_intervals
    e = Ensemble.load(cfg.ensemble_dir)
    store = e.scaler.apply(JStore.load_dir(cfg.data_dir, use_cache=False))
    splits = derive_splits(store.group_keys(), cfg.seed, cfg.val_frac,
                           cfg.calib_frac, cfg.test_frac, cfg.ensemble_size)
    idx = splits[4][cfg.fold_index] if cfg.eval_split == "fold" \
        else splits[3]
    budget = BatchBudget.plan(store, range(store.n_graphs), cfg.batch_size,
                              cover_all=True)
    means, stds, y = jr._collect_members(e, store, idx, budget,
                                         cfg.min_logvar_floor)
    # the runner's debiased mixture
    conf = ja.load_conformal(conf_path)
    means = means * conf["affine_a"] + conf["affine_b"]
    stds = stds * np.abs(conf["affine_a"])
    mean_z = means.mean(0)
    std_z = np.sqrt(np.clip((stds ** 2).mean(0) + (means ** 2).mean(0)
                            - mean_z ** 2, 1e-12, None))
    _, lo, hi = apply_conformal_intervals(mean_z, std_z, conf,
                                          e.transformer)
    return float(np.min(np.minimum(np.abs(y - lo) / np.abs(lo),
                                   np.abs(y - hi) / np.abs(hi))))


@pytest.mark.parametrize("case", sorted(CASES))
def test_metrics_json_matches_jax(ensemble_dir, tmp_path, case):
    """The port's metrics.json equals the JAX runner's on the same
    artifacts: the same keys and split tag, floats within rtol 1e-3 / atol
    1e-4, NaN where JAX has NaN, the same conformal coverage fractions."""
    got, want = _run_both(ensemble_dir, tmp_path, case)
    tag = want["split"]
    assert tag == {"test": "test", "fold": "fold1",
                   "no_conformal": "test"}[case]
    on_disk = json.loads((tmp_path / "torch" / tag / "metrics.json")
                         .read_text())
    _assert_same(on_disk, json.loads((tmp_path / "jax" / tag
                                      / "metrics.json").read_text()))
    _assert_same(got, json.loads(json.dumps(want, default=float)))
    if case == "no_conformal":
        assert got["overall"]["conformal_coverage"] is None
    else:
        assert 0.0 < got["overall"]["conformal_coverage"] <= 1.0


@pytest.mark.parametrize("case", ["test", "fold"])
def test_no_target_sits_on_an_interval_edge(ensemble_dir, case):
    """The equal coverage fractions above are not luck of rounding: no
    evaluated target lies within 1e-4 (relative) of its interval's edge."""
    assert _interval_edge_margin(ensemble_dir, case) > 1e-4


def test_bf16_tracks_f32(ensemble_dir, tmp_path):
    """The bf16 trunk through the same runner (the JAX package's bf16
    check): the MAE within max(0.5, 2 %) of the f32 run's."""
    common = dict(ensemble_dir=str(ensemble_dir / "ensemble"),
                  data_dir=str(ensemble_dir / "data"), make_plots=False,
                  output_dir=str(tmp_path), **FRACS)
    f32 = pr.run_evaluation(pr.EvalConfig(**common), device="cpu")
    b16 = pr.run_evaluation(pr.EvalConfig(compute_dtype="bfloat16",
                                          **common), device="cpu")
    assert abs(b16["overall"]["mae"] - f32["overall"]["mae"]) \
        < max(0.5, 0.02 * f32["overall"]["mae"])


def test_plots_are_written(ensemble_dir, tmp_path):
    pytest.importorskip("matplotlib")
    pcli.main(["--ensemble-dir", str(ensemble_dir / "ensemble"),
               "--data-dir", str(ensemble_dir / "data"),
               "--output-dir", str(tmp_path), "--device", "cpu",
               "--batch-size", "8", "--seed", "42", "--val-frac", "0.15",
               "--calib-frac", "0.15", "--test-frac", "0.15",
               "--ensemble-size", "2"])
    for png in ("parity.png", "residuals_vs_pred.png",
                "reliability_gaussian.png", "sharpness_vs_coverage.png",
                "error_variance.png", "corr_heatmap.png"):
        assert (tmp_path / "test" / png).exists(), png


def _hide_matplotlib(monkeypatch):
    import gnnep_tpu_torch.evaluate as pkg
    for name in list(sys.modules):
        if name == "matplotlib" or name.startswith("matplotlib."):
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises
    monkeypatch.delitem(sys.modules, "gnnep_tpu_torch.evaluate.plots",
                        raising=False)
    monkeypatch.delattr(pkg, "plots", raising=False)


def _cli_argv(root, out, *extra):
    return ["--ensemble-dir", str(root / "ensemble"),
            "--data-dir", str(root / "data"), "--output-dir", str(out),
            "--device", "cpu", "--batch-size", "8", "--seed", "42",
            "--val-frac", "0.15", "--calib-frac", "0.15",
            "--test-frac", "0.15", "--ensemble-size", "2", *extra]


def test_no_plots_runs_without_matplotlib(ensemble_dir, tmp_path,
                                          monkeypatch):
    _hide_matplotlib(monkeypatch)
    result = pcli.main(_cli_argv(ensemble_dir, tmp_path, "--no-plots"))
    assert math.isfinite(result["overall"]["rmse"])
    assert "matplotlib" not in {m.split(".")[0] for m, v in
                                sys.modules.items() if v is not None}
    assert not list((tmp_path / "test").glob("*.png"))


def test_plots_without_matplotlib_raise(ensemble_dir, tmp_path,
                                        monkeypatch):
    _hide_matplotlib(monkeypatch)
    with pytest.raises(ImportError, match="--no-plots"):
        pcli.main(_cli_argv(ensemble_dir, tmp_path))


def test_giant_shards_raise(ensemble_dir, tmp_path, monkeypatch):
    """`--giant-shards N` runs (this store has no giant, so the metrics are
    the cover-all budget's; tests/test_torch_giant.py routes real giants),
    and raises the JAX package's ValueError where fewer cards are visible
    than shards."""
    routed = pcli.main(_cli_argv(ensemble_dir, tmp_path / "r", "--no-plots",
                                 "--giant-shards", "2"))
    cover = pcli.main(_cli_argv(ensemble_dir, tmp_path / "c", "--no-plots"))
    for key in ("mae", "rmse"):
        np.testing.assert_allclose(routed["overall"][key],
                                   cover["overall"][key], rtol=1e-5)
    monkeypatch.setattr(pr, "visible_cards", lambda device: 1)
    with pytest.raises(ValueError, match="exceeds the 1 visible devices"):
        pcli.main(_cli_argv(ensemble_dir, tmp_path, "--giant-shards", "2"))


@pytest.mark.parametrize("flag", ["--heads", "--layers"])
def test_architecture_mismatch_exits(ensemble_dir, tmp_path, flag):
    with pytest.raises(SystemExit, match=flag):
        pcli.main(_cli_argv(ensemble_dir, tmp_path, flag, "3"))


def test_architecture_match_and_ignored_flags_run(ensemble_dir, tmp_path):
    """Matching --heads / --layers pass, and --num-workers /
    --train-subset-ratio are accepted and ignored, as in the JAX CLI."""
    result = pcli.main(_cli_argv(ensemble_dir, tmp_path, "--no-plots",
                                 "--heads", "2", "--layers", "1",
                                 "--num-workers", "4",
                                 "--train-subset-ratio", "0.5"))
    assert result["split"] == "test"


def test_flags_equal_the_jax_cli():
    from gnnep_tpu.cli import evaluate as jcli

    def flags(parser):
        return {a.dest: a.default for a in parser._actions
                if a.dest != "help"}
    want, got = flags(jcli.build_parser()), flags(pcli.build_parser())
    assert got.pop("device") == "cuda" and want.pop("device") is None
    assert got == want


def test_entry_point_raises_without_gpu(ensemble_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _cli_argv(ensemble_dir, tmp_path, "--no-plots")
    argv.remove("--device")
    argv.remove("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcli.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pr.run_evaluation(pr.EvalConfig(
            ensemble_dir=str(ensemble_dir / "ensemble"),
            data_dir=str(ensemble_dir / "data"), make_plots=False))


def test_drops_partially_targeted_rows(ensemble_dir, tmp_path, capsys):
    """A store whose evaluated graphs lack a target: those rows leave the
    metric suite with a message, as in the JAX runner."""
    store = PStore.load_dir(ensemble_dir / "data", use_cache=False)
    y = store.y.copy()
    y[:, 1] = np.nan
    y[::2, 1] = 90.0
    cfg = pr.EvalConfig(ensemble_dir=str(ensemble_dir / "ensemble"),
                        output_dir=str(tmp_path), make_plots=False, **FRACS)
    out = pr.run_evaluation(cfg, dataclasses.replace(store, y=y),
                            device="cpu")
    assert "dropping" in capsys.readouterr().out
    assert math.isfinite(out["overall"]["mae"])


# ---------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels have no CPU "
                    "mode (run `python3 chip_smoke.py` or this file on one)")
    from gnnep_tpu_torch.utils.device import resolve_device
    return resolve_device("cuda")


@pytest.mark.gpu
def test_card_metrics_equal_cpu(cuda, ensemble_dir, tmp_path):
    """The card's f32 metrics.json equals the CPU's at the serving
    tolerance."""
    common = dict(ensemble_dir=str(ensemble_dir / "ensemble"),
                  data_dir=str(ensemble_dir / "data"), make_plots=False,
                  **FRACS)
    got = pr.run_evaluation(pr.EvalConfig(output_dir=str(tmp_path / "g"),
                                          **common), device=cuda)
    want = pr.run_evaluation(pr.EvalConfig(output_dir=str(tmp_path / "c"),
                                           **common), device="cpu")
    _assert_same(got, want)
