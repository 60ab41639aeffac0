"""Kernels 7 and 11 (the CSR segment-sum and the row gather) at
`chip_smoke.py`'s flagship cases, on the card, beside their bounds, their
library calls and the empty-launch floor:

    python /path/to/gnnep_tpu_torch/dev/gather_bench.py [--out FILE]

It measures the package of the current directory (run it from the root of
a checkout), as `fwd_bench.py` does, so that one call can time two trees:
unpack the parent with `git archive` into the gitignored `_tree/parent/`
and run this file from there as well. The fixture, the cases, the bounds
and the timer (`device_ms`: the median of 30 chains of 10 launches) come
from the `chip_smoke.py` of the tree that holds this file, so both trees
are timed on the same inputs against the same bounds.

Kernel 7 is timed at the line-graph and the atom conv's kv-gather backward
(permuted order, width 512) and the line-graph q gather's (identity order,
width 256), f32 and bf16: `ms` is the kernel as the backward launches it
(since its output is in the cotangent's type; before, in f32), and
`backward_ms` the backward's whole work, which in a tree whose kernel
writes f32 adds the cast to bf16. Beside it: its bound, `index_add_`,
`torch.segment_reduce` for the identity order, and the empty-launch floor
(an empty kernel on the kernel's grid and block; only in a tree that has
one). Kernel 11 is timed at the probe's 640 × 512 and at the span gather
(the line-graph conv's kvn [N, 2H] by src), f32 and bf16, beside its bound,
`torch.index_select` and the floor.
"""
from __future__ import annotations

import importlib.util
import inspect
import json
import os
import sys
import tempfile
from pathlib import Path

_SMOKE = Path(__file__).resolve().parents[2] / "chip_smoke.py"


def _smoke():
    """The `chip_smoke.py` of the tree that holds this file."""
    spec = importlib.util.spec_from_file_location("chip_smoke", _SMOKE)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def segsum_rows(cs, batch, dev) -> list:
    """Kernel 7's device ms per launch at the six flagship cases."""
    import numpy as np
    import torch
    from gnnep_tpu_torch.ops.cuda import segment_sum as ss
    typed = "out_dtype" in inspect.signature(
        ss.csr_segment_sum_cuda).parameters
    floor = getattr(ss, "empty_launch_cuda", None)

    def run(c):
        if typed:
            return ss.csr_segment_sum_cuda(c["values"], c["order"],
                                           c["starts"], c["values"].dtype)
        return ss.csr_segment_sum_cuda(c["values"], c["order"], c["starts"])

    def backward(c):
        return run(c).to(c["values"].dtype)

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
            want = ss.csr_segment_sum_plain(c["values"], c["order"],
                                            c["starts"])
            if not torch.allclose(run(c).float(), want, rtol=1e-2, atol=1e-2):
                raise AssertionError(f"csr_segment_sum {which} {tag}: wrong")
            v = c["values"]
            bound, _ = cs.segsum_bound_ms(c)
            r = {"kernel": "csr_segment_sum", "conv": which, "dtype": tag,
                 "ms": cs.device_ms(lambda: run(c)),
                 "backward_ms": cs.device_ms(lambda: backward(c)),
                 "bound_ms": bound,
                 "index_add_ms": cs.device_ms(lambda: torch.zeros(
                     (c["starts"].shape[0], v.shape[1]), dtype=v.dtype,
                     device=dev).index_add_(0, c["src"], v)),
                 "empty_launch_ms": None}
            r["share_of_bound"] = bound / r["ms"]
            if c["order"] is None:
                starts = c["starts"].long()
                offsets = torch.cat([starts, starts[-1:]])
                r["segment_reduce_ms"] = cs.device_ms(
                    lambda: torch.segment_reduce(v, "sum", offsets=offsets,
                                                 axis=0))
            if floor is not None:
                r["empty_launch_ms"] = cs.device_ms(lambda: floor(
                    c["values"], c["order"], c["starts"], c["values"].dtype))
            print(f"[bench] {json.dumps(r)}", flush=True)
            rows.append(r)
    return rows


def gather_rows(cs, batch, dev) -> list:
    """Kernel 11's device ms per launch at the probe's 640 × 512 and the
    span gather, f32 and bf16."""
    import torch
    from gnnep_tpu_torch.dev import gather_probe as gp
    floor = getattr(gp, "empty_launch_cuda", None)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = "float32" if dtype == torch.float32 else "bfloat16"
        for which, c in (("probe640", gp.probe_case(640, gp.WIDTH, dtype,
                                                    dev)),
                         ("span", gp.span_case(batch, dtype=dtype,
                                               device=dev))):
            if not gp.check_bitwise(c):
                raise AssertionError(f"row_gather {which} {tag}: not bitwise")
            bound, _ = cs.gather_bound_ms(c)
            r = {"kernel": "row_gather", "case": which, "dtype": tag,
                 "ms": cs.device_ms(lambda: gp.row_gather_cuda(c["tab"],
                                                               c["idx"])),
                 "bound_ms": bound,
                 "index_select_ms": cs.device_ms(lambda: torch.index_select(
                     c["tab"], 0, c["idx"])),
                 "empty_launch_ms": None}
            r["share_of_bound"] = bound / r["ms"]
            if floor is not None:
                r["empty_launch_ms"] = cs.device_ms(
                    lambda: floor(c["tab"], c["idx"]))
            print(f"[bench] {json.dumps(r)}", flush=True)
            rows.append(r)
    return rows


def main(argv=None) -> int:
    import argparse
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("gather_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    cs = _smoke()
    from gnnep_tpu_torch.ops.cuda import build
    dev, smi = cs.phase_device()
    build.build(["csr_segment_sum", "row_gather"])
    with tempfile.TemporaryDirectory(prefix="gather_bench_") as tmp:
        data, _, _ = cs.write_fixture(Path(tmp))
        _, batches = cs.training_setup(data, Path(tmp))
    rec = {"card": smi, "tree": os.getcwd(),
           "csr_segment_sum": segsum_rows(cs, batches[0], dev),
           "row_gather": gather_rows(cs, batches[0], dev)}
    print(smi, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
