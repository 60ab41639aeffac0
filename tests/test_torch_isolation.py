"""The port (`gnnep_tpu_torch`) and `chip_smoke.py` stand alone: no jax, nothing
of `gnnep_tpu`, and entry points that never drift to the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "gnnep_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "gnnep_tpu")


def _port_sources():
    """The package's Python files, leaving out its gitignored build outputs."""
    return sorted(p for p in PORT.rglob("*.py")
                  if "build" not in p.relative_to(PORT).parts[:1])


def _port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in _port_sources())


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_importing_the_port_loads_no_jax():
    mods = _port_modules()
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert {"gnnep_tpu_torch.cli.predict", "gnnep_tpu_torch.cli.train",
            "gnnep_tpu_torch.train.member",
            "gnnep_tpu_torch.ops.cuda.segment_sum",
            "gnnep_tpu_torch.ops.cuda.attention",
            "gnnep_tpu_torch.ops.cuda.aggregate",
            "gnnep_tpu_torch.cli.evaluate", "gnnep_tpu_torch.cli.fetch",
            "gnnep_tpu_torch.evaluate.runner",
            "gnnep_tpu_torch.evaluate.metrics",
            "gnnep_tpu_torch.evaluate.plots", "gnnep_tpu_torch.elements",
            "gnnep_tpu_torch.data.structure",
            "gnnep_tpu_torch.data.neighbors",
            "gnnep_tpu_torch.data.featurize",
            "gnnep_tpu_torch.train.knn_weights"} <= set(mods)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in _port_sources()]
    + ["chip_smoke.py"]))
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_entry_points_raise_without_gpu(monkeypatch, tmp_path):
    import numpy as np

    from gnnep_tpu_torch.cli import predict as cli
    from gnnep_tpu_torch.cli import train as cli_train
    from gnnep_tpu_torch.infer.predict import Ensemble
    from gnnep_tpu_torch.models.alignn import init_alignn
    from gnnep_tpu_torch.train.artifacts import load_member
    from gnnep_tpu_torch.train.loop import TrainHyper, make_train_step
    from gnnep_tpu_torch.utils.device import resolve_device
    from gnnep_tpu_torch.utils.synth import flagship_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Ensemble.load(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_member(tmp_path / "model_0.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--ensemble-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(["--data-dir", str(tmp_path), "--save-dir",
                        str(tmp_path / "out")])
    model = init_alignn(np.random.default_rng(0),
                        flagship_config(hidden=8, heads=2, layers=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(model, TrainHyper(), np.zeros(2), np.ones(2))
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_refuses_to_run_without_gpu(tmp_path):
    """Alone in a directory, or on a machine without a GPU, the smoke run
    exits non-zero and prints no result line."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd in (tmp_path, ROOT):
        script = alone if cwd == tmp_path else ROOT / "chip_smoke.py"
        res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=300,
                             env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
