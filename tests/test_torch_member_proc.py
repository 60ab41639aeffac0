"""Members trained in their own processes (`member_isolation='process'`,
`python -m gnnep_tpu_torch.train.member_proc`): equal on the CPU, to the
bit, to the members trained in-process, with the optimizer steps each
child reports in `train_summary.json`."""
import dataclasses
import io
import json
import os
import pathlib
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from synthetic import make_samples  # noqa: E402

from gnnep_tpu_torch.data.store import GraphStore as PStore  # noqa: E402
from gnnep_tpu_torch.data.store import save_sample, write_index  # noqa: E402
from gnnep_tpu_torch.train import member_proc  # noqa: E402
from gnnep_tpu_torch.train.config import TrainConfig  # noqa: E402
from gnnep_tpu_torch.train.ensemble import (run_training,  # noqa: E402
                                            write_member_cfg)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, here and in the member processes (which read
    OMP_NUM_THREADS): the suite runs several workers on the machine's
    cores, and the two sides must sum with equal thread counts to agree
    to the bit."""
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same 2-member ensemble trained in-process and in processes."""
    root = tmp_path_factory.mktemp("member_proc")
    data = root / "data"
    samples = make_samples(24, seed=5)
    for s in samples:
        save_sample(data, s)
    write_index(data, PStore.from_samples(samples))
    cfg = TrainConfig(data_dir=str(data), save_dir=str(root / "inproc"),
                      batch_size=8, epochs=2, hidden=32, layers=2, heads=2,
                      ensemble_size=2, seed=7, val_frac=0.2, calib_frac=0.1,
                      test_frac=0.1, scan_steps=2, pack_workers=1,
                      verbose=True)
    out = {}
    for kind, iso in (("inproc", "none"), ("proc", "process")):
        c = dataclasses.replace(cfg, save_dir=str(root / kind),
                                member_isolation=iso)
        buf = io.StringIO()
        with redirect_stdout(buf):
            summary = run_training(c, device="cpu")
        out[kind] = dict(dir=root / kind, summary=summary,
                         log=buf.getvalue(), cfg=c)
    return out


@pytest.mark.parametrize("i", [0, 1])
def test_process_member_equals_in_process(runs, i):
    a = runs["inproc"]["dir"] / f"model_{i}.npz"
    b = runs["proc"]["dir"] / f"model_{i}.npz"
    with np.load(a) as da, np.load(b) as db:
        assert sorted(da.files) == sorted(db.files)
        for k in da.files:
            np.testing.assert_array_equal(da[k], db[k])


def test_steps_reported_and_artifacts_equal(runs):
    want, got = runs["inproc"]["summary"], runs["proc"]["summary"]
    assert got["member_optimizer_steps"] == want["member_optimizer_steps"]
    assert all(n > 0 for n in got["member_optimizer_steps"])
    assert got["test_stats"] == want["test_stats"]
    on_disk = json.loads((runs["proc"]["dir"] / "train_summary.json")
                         .read_text())
    assert on_disk["member_optimizer_steps"] == \
        want["member_optimizer_steps"]
    for name in ("conformal.json",):
        assert (runs["proc"]["dir"] / name).read_text() == \
            (runs["inproc"]["dir"] / name).read_text()


def test_child_output_streams_through_parent(runs):
    """The children's epoch lines reach the parent's output; their
    optimizer-steps lines are read, not printed."""
    log = runs["proc"]["log"]
    assert "[member_proc 0]" in log and "[member_proc 1]" in log
    assert "Epoch 002" in log
    assert "optimizer_steps=" not in log


def test_member_cfg_paths_absolute(runs, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rel = {"data_dir": "rel/data", "save_dir": "rel/out",
           "profile_dir": "rel/trace"}
    cfg = dataclasses.replace(runs["proc"]["cfg"], **rel)
    (tmp_path / "rel").mkdir()
    path = write_member_cfg(cfg, tmp_path / "rel")
    got = json.loads(path.read_text())
    for f, value in rel.items():
        assert got[f] == str((tmp_path / value).resolve())
    assert TrainConfig(**got).member_isolation == "process"


def test_store_with_process_isolation_raises(runs):
    cfg = runs["proc"]["cfg"]
    store = PStore.from_samples(make_samples(4, seed=1))
    with pytest.raises(ValueError, match="store"):
        run_training(cfg, store, device="cpu")


def test_member_proc_main_in_process(runs, tmp_path, capsys):
    """`member_proc.main` trains the member the parent would, and prints
    the steps line last."""
    cfg = dataclasses.replace(runs["proc"]["cfg"], save_dir=str(tmp_path),
                              verbose=False)
    path = write_member_cfg(cfg, tmp_path)
    steps = member_proc.main(str(path), "1", "cpu")
    assert steps == runs["inproc"]["summary"]["member_optimizer_steps"][1]
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        f"[member_proc 1] optimizer_steps={steps}"
    with np.load(tmp_path / "model_1.npz") as a, \
            np.load(runs["inproc"]["dir"] / "model_1.npz") as b:
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
