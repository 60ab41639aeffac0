"""The port's parity-on-contact harness (`gnnep_tpu_torch.cli.parity`)
against the JAX package's (`gnnep_tpu.cli.parity`): the reference table,
the delta table and its sign conventions; and its `--smoke` run end to end
on the CPU (ingest → train → evaluate → report)."""
import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_parity_cli import _tiny_dump  # noqa: E402

from gnnep_tpu.cli import parity as jpar  # noqa: E402
from gnnep_tpu_torch.cli import parity as ppar  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's default of a thread a core would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_reference_table_equals_jax():
    assert ppar.REFERENCE_TABLE == jpar.REFERENCE_TABLE
    assert ppar._HIGHER_BETTER == jpar._HIGHER_BETTER
    assert ppar._TARGETS == jpar._TARGETS


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_delta_table_equals_jax(seed):
    """On metrics near the reference's, some targets or metrics missing,
    both packages give the same rows."""
    rng = np.random.default_rng(seed)
    per_target = {}
    for target in ("bulk_modulus", "shear_modulus"):
        per_target[target] = {
            m: float(ref * rng.uniform(0.8, 1.2))
            for m, refs in jpar.REFERENCE_TABLE.items()
            for t, ref in refs.items() if t == target and rng.random() > 0.2}
    metrics = {"per_target": per_target}
    assert ppar.build_delta_table(metrics) == jpar.build_delta_table(metrics)


def test_delta_sign_conventions():
    metrics = {"per_target": {"bulk_modulus": {"mae": 5.0, "r2": 0.9,
                                               "conformal_coverage": 0.91},
                              "shear_modulus": {}}}
    rows = {(m, t): (r, o, d, b)
            for m, t, r, o, d, b in ppar.build_delta_table(metrics)}
    # lower-better (mae): ours 5 < ref 8.85 → better
    assert rows[("mae", "bulk_modulus")][3] is True
    # higher-better (r2): ours 0.9 < ref 0.938 → behind
    assert rows[("r2", "bulk_modulus")][3] is False
    # calibration: the reference's 0.898 is closer to 0.9 than our 0.91
    assert rows[("conformal_coverage", "bulk_modulus")][3] is False
    # a missing metric is neither better nor behind
    assert rows[("mae", "shear_modulus")][1:] == (None, None, None)


def test_print_delta_table_equals_jax(capsys):
    metrics = {"per_target": {"bulk_modulus": {"mae": 5.0, "rmse": 20.0}}}
    rows = ppar.build_delta_table(metrics)
    ppar.print_delta_table(rows)
    got = capsys.readouterr().out
    jpar.print_delta_table(rows)
    assert got == capsys.readouterr().out


def test_smoke_end_to_end_on_cpu(tmp_path):
    pytest.importorskip("matplotlib")
    dump = tmp_path / "dump.json"
    _tiny_dump(dump)
    rc = ppar.main(["--mp-dump", str(dump), "--work-dir",
                    str(tmp_path / "work"), "--smoke", "--nn-method",
                    "cutoff", "--batch-size", "8", "--fetch-workers", "1",
                    "--device", "cpu"])
    assert rc == 0
    work = tmp_path / "work"
    report = json.loads((work / "parity_report.json").read_text())
    assert report["smoke"] is True
    assert len(report["rows"]) == 2 * len(ppar.REFERENCE_TABLE)
    missing = [r for r in report["rows"] if r["ours"] is None]
    assert not missing, f"metrics missing from eval output: {missing}"
    assert (work / "ensemble" / "model_1.npz").exists()
    summary = json.loads((work / "ensemble" / "train_summary.json")
                         .read_text())
    assert summary["device"] == "cpu" and summary["members"] == 2
    assert (work / "eval" / "test" / "metrics.json").exists()
