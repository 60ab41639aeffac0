"""What the benchmark's files promise: no module of it imports JAX or the
JAX package, the plain reference imports nothing of the port, and
BENCHMARK.json keeps to its contract (names, units, metrics and their cells,
files found by name). A run without a card fails and times nothing."""
import ast
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench_port import harness

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "bench_port"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _imports(path: Path):
    """Every module a file imports, at any depth (relative imports resolved
    against the file's package)."""
    package = list(path.relative_to(ROOT).parent.parts)
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[:len(package) - node.level + 1]
                yield ".".join(base + ([node.module] if node.module else []))
            else:
                yield node.module or ""


SOURCES_PY = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES_PY, ids=lambda p: str(p.relative_to(
    ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    for mod in _imports(path):
        assert mod.split(".")[0] not in harness.FOREIGN, (path, mod)


def test_reference_imports_nothing_of_the_port():
    for path in sorted((HERE / "reference").glob("*.py")):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("gnnep_tpu_torch", "gnnep_tpu"), (path, mod)
            if top == "bench_port":
                assert mod.startswith("bench_port.reference"), (path, mod)


def test_foreign_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "gnnep_tpu_torch_like", object())
    assert "gnnep_tpu_torch_like" not in harness.foreign_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert "jaxlib.fake" in harness.foreign_modules()


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert BENCH["paths"] == ["bench_port"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    cells = 24
    full = (2 + 14 * cells) * (BENCH["run_seconds"] + 60) \
        + cells * 2 * 90 + 1200
    assert full <= 43200


def _all_names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            yield entry["name"]


def test_names_units_and_lines():
    names = list(_all_names())
    assert all(NAME.match(n) for n in names), names
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in BENCH[group]]
        assert len(got) == len(set(got)), group
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        mine = [m for m in BENCH["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert len(mine) >= 2 and "setup_s" in {m["name"] for m in mine}
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in BENCH["per_layer"])


def test_every_metric_moves_one_its_cells_report():
    e2e = BENCH["end_to_end"]
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in e2e}
        target = next(e for e in e2e if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in target.get("workloads", [cell]), (m["name"], cell)
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    # one layer, one spelling
    assert all(len(v) == 1 for v in layers.values()), layers


def test_files_are_found_by_name():
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("bench_port/")
        assert conf["reduced"] == c["reduced"] and conf["name"] == c["name"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert (HERE / "drivers" / f"{cell.traffic['kind']}.py").exists()
        assert cell.limits
        assert all(math.isfinite(v) and v >= 0 for v in cell.limits.values())
    for m in BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_a_run_without_a_card_fails_and_prints_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                          BENCH["workloads"][0]["name"], "--seed",
                          "4294967311", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_a_checkout_without_the_program_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                          BENCH["workloads"][0]["name"], "--seed", "3",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_dry_path_builds_the_inputs(cell):
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                          cell, "--seed", "4294967311", "--dry", "32"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    dry = json.loads(out.stdout.strip().splitlines()[-1])["dry"]
    assert dry["store_graphs"] == 32


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct_on_the_card(cuda, cell):
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                          cell, "--seed", "4294967329", "--seconds", "2",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
