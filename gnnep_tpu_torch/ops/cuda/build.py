"""Builds the port's CUDA sources into shared libraries with a C interface.

Each `csrc/<name>.cu` compiles with nvcc into
`build/kernels/lib<name>-<hash>.so` inside this package (the hash covers the
source, the `csrc/` headers it includes and the flags, so an edited source
or header rebuilds) at its first use, and loads with ctypes. Nothing builds
when a module is imported: the CPU tests import every module, and the CPU
has no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD = _PKG / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# per source: nvcc's report (registers, shared memory, spills per kernel) and
# the seconds the build took, for the chip smoke run to print
build_logs: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels build only on a machine with the "
                           "CUDA toolkit")
    return str(path)


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: Dict[Path, bytes]) -> Dict[Path, bytes]:
    """`path` and every header it includes with quotes, recursively, from
    `csrc/`, each once."""
    if path not in seen:
        seen[path] = path.read_bytes()
        for name in _INCLUDE.findall(seen[path]):
            _sources(CSRC / name.decode(), seen)
    return seen


def _target(name: str) -> Path:
    """The library's path, tagged with a hash of the source, the headers it
    includes and the flags, so that an edited header rebuilds too."""
    parts = _sources(CSRC / f"{name}.cu", {})
    tag = hashlib.sha256(b"".join(parts.values())
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}-{tag}.so"


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every source not yet built, one nvcc per source, all started
    together. Raises with nvcc's output if any build fails."""
    out = {name: _target(name) for name in names}
    todo = {name: so for name, so in out.items() if not so.exists()}
    if not todo:
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, so in todo.items():
        tmp = so.with_suffix(f".so.{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        try:
            log, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for other, _ in procs.values():
                other.kill()
                other.wait()
            raise
        build_logs[name] = log
        build_seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
        else:
            tmp.rename(todo[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _libs[name] = lib
    return lib


def check_card_tensors(tensors: Dict[str, torch.Tensor]) -> torch.device:
    """Raise unless every tensor is contiguous and on one CUDA device, that
    of the first; returns the device."""
    first, t0 = next(iter(tensors.items()))
    device = t0.device
    for name, t in tensors.items():
        if t.device != device or device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; every input must be "
                             f"on the one CUDA device of {first} ({device})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return device


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would take a gradient through any of `tensors`:
    where not, a differentiable op calls its forward op alone (which is
    what `torch.export` traces in an eval forward)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
