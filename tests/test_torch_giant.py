"""Giant graphs (`gnnep_tpu_torch.parallel.giant`): graphs beyond the batch
budget train, predict and evaluate through the boundary exchange. The
classification, the giant set and its data-axis groups array-equal to the
JAX package's at S = 1, 2 and 4; the boundary predictions equal to the
unpartitioned forward; `cli.train --giant-graphs boundary`, and
`cli.predict` / `cli.evaluate --giant-shards 2` against the JAX package's
serving of the same checkpoints (after tests/test_giant_graphs.py); and
the JAX package's refusals."""
import dataclasses
import json
import math
import pathlib
import sys

import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).parent))

from gnnep_tpu.data.batching import BatchBudget as JBudget  # noqa: E402
from gnnep_tpu.data.featurize import BasisConfig, build_graph  # noqa: E402
from gnnep_tpu.data.store import GraphStore as JStore  # noqa: E402
from gnnep_tpu.data.structure import Lattice, Structure  # noqa: E402
from gnnep_tpu.parallel import giant as jg  # noqa: E402
from gnnep_tpu.train import ensemble as je  # noqa: E402
from gnnep_tpu.train.config import TrainConfig as JConfig  # noqa: E402
from gnnep_tpu_torch.data.batching import BatchBudget  # noqa: E402
from gnnep_tpu_torch.data.batching import epoch_batches  # noqa: E402
from gnnep_tpu_torch.data.store import GraphStore as PStore  # noqa: E402
from gnnep_tpu_torch.data.store import save_sample, write_index  # noqa: E402
from gnnep_tpu_torch.models import alignn as pm  # noqa: E402
from gnnep_tpu_torch.parallel import giant as pg  # noqa: E402
from gnnep_tpu_torch.parallel.mesh import WorldPool  # noqa: E402
from gnnep_tpu_torch.train import loop as pl  # noqa: E402
from gnnep_tpu_torch.train import ensemble as pe  # noqa: E402
from gnnep_tpu_torch.train.config import TrainConfig  # noqa: E402
from gnnep_tpu_torch.train.member import train_member  # noqa: E402

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

BASIS = BasisConfig(rbf_n=4, rbf_cutoff=4.0, angle_n=4)
SPLITS = dict(val_frac=0.15, calib_frac=0.15, test_frac=0.15)
# the CLI parity tolerance (tests/test_torch_predict.py)
CLI_RTOL, CLI_ATOL = 1e-3, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(i, rng):
    a = 3.0 + 0.12 * (i % 5)
    s = Structure(Lattice(np.eye(3) * a), ["Si", "Si"],
                  [[0, 0, 0], [0.5, 0.5, 0.5]])
    return build_graph(s, material_id=f"small-{i:02d}",
                       y=[80.0 + 5 * i + rng.normal(0, 2),
                          40.0 + 3 * i + rng.normal(0, 1)],
                       basis=BASIS, nn_method="cutoff", cutoff=a * 0.9,
                       prototype=f"proto_{i}", sg_num=(i % 20) + 1)


def _giant(n, mid, proto, y):
    """n×n×n supercell of a 2-atom cubic cell → 2n³ atoms: at n = 5 its
    250 atoms straddle every rank window of S = 2 and 4."""
    a = 3.1
    species, coords = [], []
    for i in range(n):
        for j in range(n):
            for k in range(n):
                for base in ([0, 0, 0], [0.5, 0.5, 0.5]):
                    species.append("Si")
                    coords.append([(i + base[0]) / n, (j + base[1]) / n,
                                   (k + base[2]) / n])
    s = Structure(Lattice(np.eye(3) * a * n), species, coords)
    return build_graph(s, material_id=mid, y=y, basis=BASIS,
                       nn_method="cutoff", cutoff=a * 0.9, prototype=proto,
                       sg_num=1)


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """20 two-atom cells and two giants (250 and 54 atoms), as both
    packages' stores and on disk."""
    rng = np.random.default_rng(0)
    samples = [_small(i, rng) for i in range(20)]
    samples.append(_giant(5, "giant-big", "proto_giant_a", [95.0, 47.0]))
    samples.append(_giant(3, "giant-med", "proto_giant_b", [88.0, 44.0]))
    root = tmp_path_factory.mktemp("giant")
    data = root / "data"
    for s in samples:
        save_sample(data, s)
    pstore = PStore.from_samples(samples)
    write_index(data, pstore)
    return dict(root=root, data=data, pstore=PStore.load_dir(data),
                jstore=JStore.load_dir(data))


def _plan(store, budget_cls):
    return lambda pop, ca: budget_cls.plan(store, pop, 4, cover_all=ca)


def test_classification_matches_jax(mixed):
    n = mixed["pstore"].n_graphs
    got = pg.classify_giants(mixed["pstore"], range(n),
                             _plan(mixed["pstore"], BatchBudget))
    want = jg.classify_giants(mixed["jstore"], range(n),
                              _plan(mixed["jstore"], JBudget))
    assert got[0] == want[0] and got[1] == want[1] and len(got[1]) == 2
    assert [mixed["pstore"].material_ids[g] for g in got[1]] == \
        ["giant-big", "giant-med"]
    assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2])
    # the final budget is cover-all over the normal population
    assert pg.find_giants(mixed["pstore"], got[0], got[2]) == []
    assert pg.find_giants(mixed["pstore"], got[1], got[2]) == got[1]


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_giant_set_and_groups_match_jax(mixed, n_shards):
    n = mixed["pstore"].n_graphs
    _, giants, _ = pg.classify_giants(mixed["pstore"], range(n),
                                      _plan(mixed["pstore"], BatchBudget))
    got = pg.build_giant_set(mixed["pstore"], giants, n_shards)
    want = jg.build_giant_set(mixed["jstore"], giants, n_shards)
    assert got.indices == want.indices
    assert dataclasses.asdict(got.plan) == dataclasses.asdict(want.plan)
    if n_shards > 1:
        assert got.plan.bn > 0 and got.plan.bl > 0   # a real cut
    assert got.split([0, giants[1], 3, giants[0]]) == \
        want.split([0, giants[1], 3, giants[0]])
    weights = np.linspace(0.5, 1.5, n).astype(np.float32)
    ids = [giants[0], giants[1], giants[0]]     # a bootstrap duplicate
    for n_data in (1, 2):
        for w in (None, weights):
            g_groups = got.groups(ids, n_data, w)
            w_groups = want.groups(ids, n_data, w)
            assert len(g_groups) == len(w_groups)
            for gg, wg in zip(g_groups, w_groups):
                for a, b in zip(gg, wg):
                    for f in a._fields:
                        np.testing.assert_array_equal(
                            np.asarray(getattr(a, f)),
                            np.asarray(getattr(b, f)), err_msg=f)
        tabs = got.group_tables(ids, n_data)
        assert [len(t) for t in tabs] == [n_data] * len(tabs)


@pytest.fixture(scope="module")
def member(mixed):
    store = mixed["pstore"]
    cfg = pm.AlignnConfig(node_dim=store.node_dim, edge_dim=store.edge_dim,
                          angle_dim=store.angle_dim,
                          global_dim=store.global_scalar_dim + 230,
                          hidden=32, layers=2, heads=2, dropout=0.0)
    return pm.init_alignn(np.random.default_rng(1), cfg)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_boundary_predictions_match_unpartitioned(mixed, member, n_shards):
    store = mixed["pstore"]
    n = store.n_graphs
    _, giants, _ = pg.classify_giants(store, range(n),
                                      _plan(store, BatchBudget))
    gset = pg.build_giant_set(store, giants, n_shards)
    with WorldPool() as pool:
        collect = pg.make_giant_collector(gset, pl.MIN_LOGVAR_FLOOR,
                                          device="cpu", pool=pool)
        mean, sigma, y, idx = collect(member, giants[::-1])
    assert list(idx) == giants[::-1]
    cover = BatchBudget.plan(store, giants, 1, cover_all=True)
    want = pl.collect_predictions(pl.make_forward(), member,
                                  epoch_batches(store, giants[::-1], cover,
                                                shuffle=False))
    for got, w in zip((mean, sigma, y), want[:3]):
        np.testing.assert_allclose(got, w, rtol=2e-4, atol=2e-5)


def test_collector_needs_a_card_a_shard(mixed, monkeypatch):
    store = mixed["pstore"]
    gset = pg.build_giant_set(store, [0, 1], 2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 edge-shard devices"):
        pg.make_giant_collector(gset, -2.9, device="cuda")


# ---------------------------------------------------------------------------
# training, serving and evaluation with giants
# ---------------------------------------------------------------------------

def _train_argv(mixed, out, *extra):
    return ["--data-dir", str(mixed["data"]), "--save-dir", str(out),
            "--device", "cpu", "--hidden", "16", "--layers", "1",
            "--heads", "2", "--epochs", "2", "--batch-size", "4",
            "--ensemble-size", "2", "--no-bootstrap-train", "--quiet",
            "--val-frac", "0.15", "--calib-frac", "0.15",
            "--test-frac", "0.15", "--giant-graphs", "boundary", *extra]


@pytest.fixture(scope="module")
def trained(mixed):
    from gnnep_tpu_torch.cli import train as tcli

    out = mixed["root"] / "ens"
    summary = tcli.main(_train_argv(mixed, out, "--edge-shards", "2"))
    return out, summary


def test_prepare_routes_giants_as_jax(mixed):
    kw = dict(batch_size=4, ensemble_size=2, giant_graphs="boundary",
              edge_shards=2, verbose=False, **SPLITS)
    got = pe.prepare(TrainConfig(**kw), mixed["pstore"])
    want = je.prepare(JConfig(**kw), mixed["jstore"])
    assert got.giant.indices == want.giant.indices
    assert len(got.giant.indices) == 2
    assert dataclasses.asdict(got.giant.plan) == \
        dataclasses.asdict(want.giant.plan)
    assert dataclasses.asdict(got.budget) == dataclasses.asdict(want.budget)
    assert (got.train_idx, got.calib_idx, got.test_idx) == \
        (want.train_idx, want.calib_idx, want.test_idx)


def test_cli_train_routes_giants(mixed, trained):
    """The giants take boundary steps over two gloo edge ranks beside the
    packed steps, and reach calibration and the test report."""
    out, summary = trained
    setup = pe.prepare(TrainConfig(batch_size=4, ensemble_size=2,
                                   giant_graphs="boundary", edge_shards=2,
                                   verbose=False, **SPLITS), mixed["pstore"])
    in_train = [g for g in setup.giant.indices if g in setup.train_idx]
    assert in_train
    assert math.isfinite(summary["test_stats"]["overall"]["mae"])
    assert all(s > 0 for s in summary["member_optimizer_steps"])
    assert (out / "model_1.npz").exists()


def test_cli_predict_giant_shards_matches_jax(mixed, trained, tmp_path):
    from gnnep_tpu.infer import predict as jp
    from gnnep_tpu_torch.cli import predict as pcli

    out, _ = trained
    dest = tmp_path / "pred.json"
    # enough typical graphs that the request's budget leaves the giants out
    mids = ["giant-big", *[f"small-{i:02d}" for i in range(0, 20, 2)],
            "giant-med"]
    pcli.main(["--ensemble-dir", str(out), "--data-dir", str(mixed["data"]),
               "--device", "cpu", "--mode", "materials", "--materials",
               ",".join(mids), "--batch-size", "4", "--giant-shards", "2",
               "--output-json", str(dest)])
    got = json.loads(dest.read_text())["predictions"]
    j_ens = jp.Ensemble.load(out)
    idx = [mixed["jstore"].material_ids.index(m) for m in mids]
    want = j_ens.predict(j_ens.scaler.apply(mixed["jstore"]), idx,
                         batch_size=4, giant_shards=2)
    # the packed rows first, then the giants' boundary rows
    assert [r["material_id"] for r in got] == \
        [r["material_id"] for r in want] == \
        [*mids[1:-1], "giant-big", "giant-med"]
    for key in ("mu", "sigma"):
        np.testing.assert_allclose([r[key] for r in got],
                                   [r[key] for r in want], rtol=CLI_RTOL,
                                   atol=CLI_ATOL, err_msg=key)


def test_cli_evaluate_giant_shards(mixed, trained, tmp_path):
    """Routed through the boundary forward, the giant-holding train split
    evaluates to the cover-all budget's metrics, and to the JAX package's
    routed evaluation of the same ensemble."""
    from gnnep_tpu.evaluate import runner as jr
    from gnnep_tpu_torch.cli import evaluate as ecli

    out, _ = trained

    def argv(dest, shards):
        return ["--ensemble-dir", str(out), "--data-dir", str(mixed["data"]),
                "--output-dir", str(dest), "--device", "cpu", "--no-plots",
                "--batch-size", "4", "--ensemble-size", "2",
                "--eval-split", "train", "--giant-shards", str(shards),
                "--val-frac", "0.15", "--calib-frac", "0.15",
                "--test-frac", "0.15"]

    routed = ecli.main(argv(tmp_path / "routed", 2))
    cover = ecli.main(argv(tmp_path / "cover", 0))
    want = jr.run_evaluation(jr.EvalConfig(
        ensemble_dir=str(out), output_dir=str(tmp_path / "jax"),
        batch_size=4, ensemble_size=2, eval_split="train", make_plots=False,
        giant_shards=2, **SPLITS), mixed["jstore"])
    for key in ("mae", "rmse"):
        np.testing.assert_allclose(routed["overall"][key],
                                   cover["overall"][key], rtol=1e-3)
        np.testing.assert_allclose(routed["overall"][key],
                                   want["overall"][key], rtol=CLI_RTOL)


def test_evaluate_needs_a_card_a_shard(mixed, trained, monkeypatch):
    from gnnep_tpu_torch.evaluate import runner as pr
    from gnnep_tpu_torch.infer import predict as ip

    out, _ = trained
    ens = ip.Ensemble.load(out, "cpu")
    monkeypatch.setattr(ip.Ensemble, "load",
                        classmethod(lambda cls, d, device=None: ens))
    monkeypatch.setattr(ens, "device", torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="exceeds the 1 visible devices"):
        pr.run_evaluation(pr.EvalConfig(ensemble_dir=str(out),
                                        giant_shards=2, make_plots=False),
                          mixed["pstore"])


def test_one_edge_shard_trains_in_process(mixed, tmp_path):
    """`--edge-shards 1`: the giants' boundary steps run in this process,
    over one rank, beside the single-device steps."""
    from gnnep_tpu_torch.cli import train as tcli

    summary = tcli.main(_train_argv(mixed, tmp_path, "--edge-shards", "1",
                                    "--ensemble-size", "1"))
    assert math.isfinite(summary["test_stats"]["overall"]["mae"])


def test_giants_refuse_flat_opt_and_a_mismatched_mesh(mixed):
    setup = pe.prepare(TrainConfig(batch_size=4, ensemble_size=2,
                                   giant_graphs="boundary", edge_shards=2,
                                   verbose=False, **SPLITS), mixed["pstore"])
    cfg = TrainConfig(hidden=16, layers=1, heads=2, flat_opt=True,
                      verbose=False)
    mc = pe.model_config(cfg, setup.store, budget=setup.budget)
    args = (setup.store, cfg, mc, setup.transformer, setup.budget, 1,
            setup.train_idx, setup.folds[0])
    with pytest.raises(ValueError, match="flat-opt"):
        train_member(*args, device="cpu", giant=setup.giant)
    with pytest.raises(ValueError, match="planned for 2 edge shards"):
        train_member(*args[:1], dataclasses.replace(cfg, flat_opt=False),
                     *args[2:], device="cpu", giant=setup.giant)
