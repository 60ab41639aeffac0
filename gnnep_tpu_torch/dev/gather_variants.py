"""Variants of kernels 7 and 11 (the CSR segment-sum and the row gather),
each one knob away from the design in `csrc/`, timed on the card at
`chip_smoke.py`'s flagship cases:

    python gnnep_tpu_torch/dev/gather_variants.py [--out FILE]

Run from the root of a checkout. Each variant is a copy of the source with
one constant or one line replaced, built with the package's nvcc flags
(all builds in parallel) and called through ctypes with the launch plan
of the package's wrapper. Kernel 7: rows in flight (`kRows` 4, 16), the
block (`kThreads` 256), the row load (plain, evict-first `__ldcs`, against
L2-only `__ldcg`), at the six flagship cases; every output bitwise the
CPU's sequential sum. Kernel 11: words a lane (`kWordsPerLane` 1, 2) and
stores with and without streaming, at the probe's 640 × 512 and the span
gather, f32 and bf16; every output bitwise tab[idx]. Device ms per launch
is chip_smoke's `device_ms` (the median of 30 chains of 10).
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

_SEGSUM_LOAD = "x[r] = __ldcg(col + static_cast<size_t>(row) * words);"
SEGSUM = {  # name: (old text, new text); "design" is the source as it is
    "design": None,
    "rows4": ("constexpr int kRows = 8;", "constexpr int kRows = 4;"),
    "rows16": ("constexpr int kRows = 8;", "constexpr int kRows = 16;"),
    "threads256": ("constexpr int kThreads = 128;",
                   "constexpr int kThreads = 256;"),
    "load_plain": (_SEGSUM_LOAD,
                   "x[r] = col[static_cast<size_t>(row) * words];"),
    "load_ldcs": (_SEGSUM_LOAD,
                  "x[r] = __ldcs(col + static_cast<size_t>(row) * words);"),
}
GATHER = {
    "design": None,
    "words1": ("constexpr int kWordsPerLane = 4;",
               "constexpr int kWordsPerLane = 1;"),
    "words2": ("constexpr int kWordsPerLane = 4;",
               "constexpr int kWordsPerLane = 2;"),
}


def build_variants(build, source: str, variants: dict, tmp: Path) -> dict:
    """Each variant of `csrc/<source>.cu` built in `tmp` → {name: CDLL}.
    Raises if a replaced line is missing or a build fails."""
    text = (build.CSRC / f"{source}.cu").read_text()
    procs = {}
    for name, edit in variants.items():
        if edit is not None and edit[0] not in text:
            raise ValueError(f"{source}.cu has no line {edit[0]!r}")
        cu = tmp / f"{source}_{name}.cu"
        cu.write_text(text if edit is None else text.replace(*edit))
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"{source} {name}: nvcc failed:\n{log}")
        libs[name] = ctypes.CDLL(str(tmp / f"{source}_{name}.so"))
    return libs


def segsum_rows(cs, libs, batch, dev) -> list:
    import numpy as np
    import torch
    from gnnep_tpu_torch.ops.cuda import segment_sum as ss
    p, i = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.csr_segment_sum.argtypes = [p] * 4 + [i] * 5 + [p]
    rng = np.random.default_rng(cs.SEED + 20)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = "float32" if dtype == torch.float32 else "bfloat16"
        cases = {which: cs.segsum_case(rng, batch, which, width=512,
                                       dtype=dtype, device=dev)
                 for which in ("lg", "atom")}
        cases["lg_identity"] = cs.qgather_case(rng, batch, width=256,
                                               dtype=dtype, device=dev)
        for which, c in cases.items():
            v, o, st = c["values"], c["order"], c["starts"]
            n, width = st.shape[0], v.shape[1]
            want = ss.csr_segment_sum_plain(
                v.cpu(), None if o is None else o.cpu(), st.cpu()).to(dtype)
            out = torch.empty((n, width), dtype=dtype, device=dev)
            plan = ss.segsum_plan(n, width, dtype, dtype, v.data_ptr(),
                                  out.data_ptr())
            bf16 = int(dtype == torch.bfloat16)
            for name, lib in libs.items():
                def run(lib=lib):
                    rc = lib.csr_segment_sum(
                        v.data_ptr(), None if o is None else o.data_ptr(),
                        st.data_ptr(), out.data_ptr(), n, width, bf16, bf16,
                        plan.vec, torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"{name}: CUDA error {rc}")
                run()
                if not torch.equal(out.cpu(), want):
                    raise AssertionError(f"csr_segment_sum {name} {which} "
                                         f"{tag}: not the sequential sum")
                ms = cs.device_ms(run)
                r = {"kernel": "csr_segment_sum", "variant": name,
                     "conv": which, "dtype": tag, "ms": ms,
                     "share_of_bound": cs.segsum_bound_ms(c)[0] / ms}
                print(f"[variant] {json.dumps(r)}", flush=True)
                rows.append(r)
    return rows


def gather_rows(cs, libs, batch, dev) -> list:
    import torch
    from gnnep_tpu_torch.dev import gather_probe as gp
    p, i = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.row_gather.argtypes = [p, p, p] + [i] * 5 + [p]
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = "float32" if dtype == torch.float32 else "bfloat16"
        for which, c in (("probe640", gp.probe_case(640, gp.WIDTH, dtype,
                                                    dev)),
                         ("span", gp.span_case(batch, dtype=dtype,
                                               device=dev))):
            tab, idx = c["tab"], c["idx"]
            out = torch.empty((idx.shape[0], tab.shape[1]), dtype=dtype,
                              device=dev)
            row_bytes = tab.shape[1] * tab.element_size()
            for name, lib in libs.items():
                for stream in (0, 1):
                    def run(lib=lib, stream=stream):
                        rc = lib.row_gather(
                            tab.data_ptr(), idx.data_ptr(), out.data_ptr(),
                            idx.shape[0], row_bytes, 16, stream,
                            int(idx.dtype == torch.int64),
                            torch.cuda.current_stream().cuda_stream)
                        if rc != 0:
                            raise RuntimeError(f"{name}: CUDA error {rc}")
                    run()
                    if not torch.equal(out, tab[idx.long()]):
                        raise AssertionError(f"row_gather {name} {which} "
                                             f"{tag}: not bitwise")
                    ms = cs.device_ms(run)
                    r = {"kernel": "row_gather", "variant": name,
                         "streaming_stores": bool(stream), "case": which,
                         "dtype": tag, "ms": ms,
                         "share_of_bound": cs.gather_bound_ms(c)[0] / ms}
                    print(f"[variant] {json.dumps(r)}", flush=True)
                    rows.append(r)
    return rows


def main(argv=None) -> int:
    import argparse
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("gather_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from gnnep_tpu_torch.ops.cuda import build
    dev, smi = cs.phase_device()
    with tempfile.TemporaryDirectory(prefix="gather_variants_") as tmp:
        seg_libs = build_variants(build, "csr_segment_sum", SEGSUM,
                                  Path(tmp))
        gather_libs = build_variants(build, "row_gather", GATHER, Path(tmp))
        data, _, _ = cs.write_fixture(Path(tmp))
        _, batches = cs.training_setup(data, Path(tmp))
        rec = {"card": smi,
               "csr_segment_sum": segsum_rows(cs, seg_libs, batches[0], dev),
               "row_gather": gather_rows(cs, gather_libs, batches[0], dev)}
    print(smi, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
