"""Kernels 5 and 8 (the eproj and span attention forwards) at the flagship
conv shapes, on the card, beside kernels 1-4 and the ladder's stages:

    python /path/to/gnnep_tpu_torch/dev/fwd_bench.py [--out FILE]

It measures the package of the current directory (run it from the root of
a checkout), as `bwd_bench.py` does, so that one call can time two trees.
For the line-graph and the atom conv of the trainer's first packed batch
(`chip_smoke.py`'s fixture and cases), f32 and bf16, it prints each
kernel's device ms per launch: kernels 5 and 8, and kernels 1-4 on the
same case (kernels 1-4 with their bound, and, in a tree that has it, their
plan and the empty-launch floor on the plan's grid); at the line-graph
conv in f32 the error of kernels 5 and 8 against a float64 reference
beside the plain f32 version's own; the ladder's device ms per stage
(kernel 10); nvcc's register report and the tensor-core and FMA
instruction counts of each built forward kernel.

With `--widths` it times instead kernels 1-6, 8 and 9 at the line-graph
conv's CSR structure at each of chip_smoke's WIDTHS (hidden 512 / 4 heads,
256 / 1, 384 / 2, Fe = hidden), f32 and bf16, kernels 1-4 with their bound
and, in a tree that has it, their plan. With `--rungs` it times kernels 1-4
alone (no kernel 5 or 8, no ladder): the A/B of the kv+e and
external-logits rungs' kernels.
"""
from __future__ import annotations

import json
import os
import re
import sys
import tempfile
from pathlib import Path


def eproj_fwd_f64(q, kv, ea, w_edge, scale_t, mask2, dst, *, heads: int,
                  src=None):
    """Kernel 5's output in float64 with no rounding point (with `src`,
    kernel 8's: kv is then the node table, read at row src[j]) → out [N, H];
    rows with no live edge are zero."""
    import torch
    d = torch.float64
    n, hidden = q.shape
    ch = hidden // heads
    q, kv, ea, w = (x.to(d) for x in (q, kv, ea, w_edge))
    if src is not None:
        kv = kv[src]
    e_total = ea.shape[0]
    e = ea @ w
    k, v = kv[:, :hidden] + e, kv[:, hidden:] + e
    live = (mask2 > 0)[:, None]
    logit = (q[dst] * k).reshape(e_total, heads, ch).sum(-1) / ch ** 0.5
    logit = torch.where(live, logit, torch.full_like(logit, -torch.inf))
    mx = torch.full((n, heads), -torch.inf, dtype=d, device=q.device)
    mx = mx.scatter_reduce(0, dst[:, None].expand(-1, heads), logit, "amax")
    ex = torch.where(live, torch.exp(logit - mx[dst]), 0.0)
    den = torch.zeros((n, heads), dtype=d, device=q.device).index_add_(
        0, dst, ex)
    alpha = ex / den.clamp_min(1e-300)[dst] * scale_t.t().to(d)
    return torch.zeros((n, hidden), dtype=d, device=q.device).index_add_(
        0, dst, alpha.repeat_interleave(ch, 1) * v)


def f64_error(out, ref) -> float:
    """The largest absolute difference on the real rows (the dummy row
    n-1's output is unspecified), over the reference's largest magnitude."""
    a, b = out[:-1].double(), ref[:-1]
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-300)


BOUNDS = {"attn_fwd": "attn_bound_ms", "attn_bwd": "attn_bwd_bound_ms",
          "softmax_aggregate_fwd": "agg_bound_ms",
          "softmax_aggregate_bwd": "agg_bwd_bound_ms"}


def plan_extras(cs, c, kernel, floor=True) -> dict:
    """Kernel 1's, 2's, 3's or 4's bound at case `c`, and where the package
    has them (kernels with a plan) its plan and (with `floor`) an empty
    kernel on the plan's grid and block, timed the same way (the launch
    floor)."""
    import dataclasses
    from gnnep_tpu_torch.ops.cuda import aggregate as ag
    from gnnep_tpu_torch.ops.cuda import attention as at
    out = {"bound_ms": getattr(cs, BOUNDS[kernel])(c)[0]}
    backward = kernel.endswith("_bwd")
    if kernel.startswith("attn"):
        if not hasattr(at, "attention_empty_cuda"):
            return out
        q, k, v = c["q"], c["k"], c["v"]
        plan = at.attention_plan(q.shape[0], k.shape[0], q.shape[1],
                                 c["heads"], q.element_size(), q.data_ptr(),
                                 k.data_ptr(), v.data_ptr(),
                                 backward=backward)

        def empty():
            at.attention_empty_cuda(q, k, v, heads=c["heads"],
                                    backward=backward)
    else:
        if not hasattr(ag, "aggregate_empty_cuda"):
            return out
        v = c["v"]
        plan = ag.aggregate_plan(c["n"], v.shape[0], v.shape[1], c["heads"],
                                 v.element_size(), v.data_ptr(),
                                 backward=backward)

        def empty():
            ag.aggregate_empty_cuda(v, c["n"], heads=c["heads"],
                                    backward=backward)
    out["plan"] = dataclasses.asdict(plan)
    if floor:
        out["empty_launch_ms"] = cs.device_ms(empty)
    return out


def width_times(cs, batch, dev) -> list:
    """Device ms per launch of kernels 1-6, 8 and 9 at the line-graph conv
    of `batch` for each of `cs.WIDTHS`, f32 and bf16."""
    import numpy as np
    import torch
    from gnnep_tpu_torch.ops.cuda import aggregate as ag
    from gnnep_tpu_torch.ops.cuda import attention as at
    from gnnep_tpu_torch.ops.cuda import attention_eproj as ep
    from gnnep_tpu_torch.ops.cuda import attention_span as sp
    rng = np.random.default_rng(cs.SEED + 70)
    out = []
    for hidden, heads in cs.WIDTHS:
        for dtype in (torch.float32, torch.bfloat16):
            tag = "float32" if dtype == torch.float32 else "bfloat16"
            c = cs.span_batch_case(rng, batch, "lg", hidden=hidden,
                                   dtype=dtype, device=dev)
            c["heads"] = heads
            c["scale_t"] = torch.ones((heads, c["ea"].shape[0]),
                                      dtype=torch.float32, device=dev)
            a5 = (c["q"], c["kv"], c["ea"], c["w_edge"], c["scale_t"],
                  c["mask2"], c["row_ptr"], c["dst"])
            a6 = cs.bwd_inputs(c)
            a8 = cs.span_fwd_args(c) + (c["row_ptr"], c["src"], c["dst"])
            a9 = a8 + cs.span_bwd_inputs(c)
            ca, cg = cs.attn_inputs(c), cs.agg_inputs(rng, c)
            b3 = cs.rung_bwd_inputs("attn_bwd", ca)
            b1 = cs.rung_bwd_inputs("softmax_aggregate_bwd", cg)
            runs = {
                "softmax_aggregate_fwd": lambda: ag.aggregate_cuda(
                    *cs.agg_fwd_args(cg), heads=heads),
                "softmax_aggregate_bwd": lambda: ag.aggregate_bwd_cuda(
                    *b1, heads=heads),
                "attn_fwd": lambda: at.attention_cuda(
                    *cs.attn_fwd_args(ca), ca["row_ptr"], heads=heads),
                "attn_bwd": lambda: at.attention_bwd_cuda(*b3, heads=heads),
                "attn_eproj_fwd": lambda: ep.attention_eproj_cuda(
                    *a5, heads=heads),
                "attn_eproj_bwd": lambda: ep.attention_eproj_bwd_cuda(
                    *a6, heads=heads),
                "attn_span_fwd": lambda: sp.attention_span_cuda(
                    *a8, heads=heads),
                "attn_span_bwd": lambda: sp.attention_span_bwd_cuda(
                    *a9, heads=heads)}
            for kernel, run in runs.items():
                r = {"kernel": kernel, "hidden": hidden, "heads": heads,
                     "dtype": tag, "ms": cs.device_ms(run)}
                if kernel in BOUNDS:
                    r.update(plan_extras(cs, ca if kernel.startswith("attn")
                                         else cg, kernel, floor=False))
                print(f"[width] {json.dumps(r)}", flush=True)
                out.append(r)
    return out


def main(argv=None) -> int:
    import argparse
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None)
    parser.add_argument("--widths", action="store_true")
    parser.add_argument("--rungs", action="store_true",
                        help="kernels 1-4 alone")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("fwd_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import chip_smoke as cs
    from gnnep_tpu_torch.dev import kernel_ladder as kl
    from gnnep_tpu_torch.dev.bwd_bench import sass_counts
    from gnnep_tpu_torch.ops.cuda import aggregate as ag
    from gnnep_tpu_torch.ops.cuda import attention as at
    from gnnep_tpu_torch.ops.cuda import attention_eproj as ep
    from gnnep_tpu_torch.ops.cuda import attention_span as sp
    from gnnep_tpu_torch.ops.cuda import build
    dev, smi = cs.phase_device()
    if args.widths:
        with tempfile.TemporaryDirectory(prefix="fwd_bench_") as tmp:
            data, _, _ = cs.write_fixture(Path(tmp))
            _, batches = cs.training_setup(data, Path(tmp))
        rec = {"card": smi, "widths": width_times(cs, batches[0], dev)}
        print(smi, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(rec, indent=1))
        return 0
    names = ["attn_fwd", "attn_bwd", "softmax_aggregate_fwd",
             "softmax_aggregate_bwd"]
    build.build(names if args.rungs
                else ["attn_eproj_fwd", "attn_span_fwd"] + names)
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if re.search(r"registers|spill|Compiling entry", line):
                print(f"[nvcc] {name}: {line.strip()}", flush=True)
    sass = {k: sass_counts(k) for k in ("attn_eproj_fwd", "attn_span_fwd")
            if not args.rungs}
    for k, funcs in sass.items():
        for func, c in funcs.items():
            print(f"[sass] {k} {func} " + " ".join(
                f"{op}={v}" for op, v in c.items()), flush=True)
    rec = {"card": smi, "sass": sass, "cases": [], "ladder": {}}
    with tempfile.TemporaryDirectory(prefix="fwd_bench_") as tmp:
        data, _, _ = cs.write_fixture(Path(tmp))
        _, batches = cs.training_setup(data, Path(tmp))
    batch = batches[0]
    rng = np.random.default_rng(cs.SEED + 50)
    for which in ("lg", "atom"):
        for dtype in (torch.float32, torch.bfloat16):
            tag = "float32" if dtype == torch.float32 else "bfloat16"
            c5 = cs.batch_case(rng, batch, which, hidden=256, dtype=dtype,
                               device=dev)
            runs = {}
            if not args.rungs:
                c8 = cs.span_batch_case(rng, batch, which, hidden=256,
                                        dtype=dtype, device=dev)
                a5 = (c5["q"], c5["kv"], c5["ea"], c5["w_edge"],
                      c5["scale_t"], c5["mask2"], c5["row_ptr"], c5["dst"])
                a8 = cs.span_fwd_args(c8) + (c8["row_ptr"], c8["src"],
                                             c8["dst"])
                runs = {
                    "attn_eproj_fwd": lambda: ep.attention_eproj_cuda(
                        *a5, heads=4),
                    "attn_span_fwd": lambda: sp.attention_span_cuda(
                        *a8, heads=4)}
            ca, cg = cs.attn_inputs(c5), cs.agg_inputs(rng, c5)
            b3 = cs.rung_bwd_inputs("attn_bwd", ca)
            b1 = cs.rung_bwd_inputs("softmax_aggregate_bwd", cg)
            runs["attn_fwd"] = lambda: at.attention_cuda(
                *cs.attn_fwd_args(ca), ca["row_ptr"], heads=4)
            runs["attn_bwd"] = lambda: at.attention_bwd_cuda(*b3, heads=4)
            runs["softmax_aggregate_fwd"] = lambda: ag.aggregate_cuda(
                *cs.agg_fwd_args(cg), heads=4)
            runs["softmax_aggregate_bwd"] = lambda: ag.aggregate_bwd_cuda(
                *b1, heads=4)
            for kernel, run in runs.items():
                r = {"kernel": kernel, "conv": which, "dtype": tag,
                     "ms": cs.device_ms(run)}
                if kernel in BOUNDS:
                    r.update(plan_extras(cs, ca if kernel.startswith("attn")
                                         else cg, kernel))
                print(f"[bench] {json.dumps(r)}", flush=True)
                rec["cases"].append(r)
            if which == "lg" and tag == "float32" and not args.rungs:
                ref5 = eproj_fwd_f64(*a5[:6], c5["dst"], heads=4)
                ref8 = eproj_fwd_f64(*cs.span_fwd_args(c8), c8["dst"],
                                     heads=4, src=c8["src_plain"])
                r = {"check": "f32_vs_float64", "conv": which,
                     "attn_eproj_fwd": f64_error(
                         ep.attention_eproj_cuda(*a5, heads=4)[0], ref5),
                     "attn_eproj_plain": f64_error(ep.attention_eproj_plain(
                         *a5[:6], c5["dst"], heads=4)[0], ref5),
                     "attn_span_fwd": f64_error(
                         sp.attention_span_cuda(*a8, heads=4)[0], ref8),
                     "attn_span_plain": f64_error(sp.attention_span_plain(
                         *cs.span_fwd_args(c8), c8["src_plain"], c8["dst"],
                         heads=4)[0], ref8)}
                print(f"[bench] {json.dumps(r)}", flush=True)
                rec["f32_vs_float64"] = r
        if which == "lg" and not args.rungs:
            for dtype in (torch.bfloat16, torch.float32):
                tag = "float32" if dtype == torch.float32 else "bfloat16"
                c = kl.lg_case(batch, dtype=dtype, device=dev)
                rec["ladder"][tag] = kl.time_stages(c, timer=cs.device_ms)
                print(f"[bench] {json.dumps({'ladder': tag, **rec['ladder'][tag]})}",
                      flush=True)
    print(smi, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
