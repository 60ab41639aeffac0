"""Kernels 6 and 9 (the eproj and span attention backward) at the flagship
conv shapes, on the card:

    python /path/to/gnnep_tpu_torch/dev/bwd_bench.py [--out FILE]

It measures the package of the current directory (run it from the root of
a checkout), so that one call can time two trees: the script's own
directory does not decide which package is imported. For the line-graph
and the atom conv of the trainer's first packed batch (`chip_smoke.py`'s
fixture and cases), f32 and bf16, it prints each kernel's device ms per
launch and each of its CUDA kernels' share (from torch.profiler), the f32
error at the line-graph conv against a float64 reference beside the plain
f32 version's own, the three products' time as `torch.matmul` calls (a
diagnostic floor, never called by the port), nvcc's register report and
the tensor-core and FMA instruction counts of each built kernel.
`chip_smoke.py` uses the helpers below for the same lines.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Callable, Dict, Sequence

OUTPUTS = {"attn_eproj_bwd": ("dq", "dkv", "dea", "dw"),
           "attn_span_bwd": ("dq", "dkvn", "dea", "dw")}


def eproj_bwd_f64(q, kv, ea, w_edge, scale_t, mask2, row_ptr, dst, g, mx,
                  den, *, heads: int, src=None, n_src: int = 0):
    """Kernel 6's gradients in float64 with no rounding point → (dq, dkv,
    dea, dW_e); with `src` (kv then the node table kvn), kernel 9's (dq,
    dkvn, dea, dW_e). The forward's stats are taken as given."""
    import torch
    d = torch.float64
    n, hidden = q.shape
    ch = hidden // heads
    q, kv, ea, w, g = (x.to(d) for x in (q, kv, ea, w_edge, g))
    if src is not None:
        kv = kv[src]
    e_total = ea.shape[0]
    live = ((mask2 > 0) & (dst != n - 1))[:, None]
    e = ea @ w
    k, v = kv[:, :hidden] + e, kv[:, hidden:] + e
    inv = 1.0 / ch ** 0.5
    qe, ge = q[dst], g[dst]
    logit = (qe * k).reshape(e_total, heads, ch).sum(-1) * inv
    ex = torch.exp(torch.where(live, logit, 0.0) - mx.to(d)[dst])
    s = torch.where(live, ex / den.to(d)[dst], 0.0)
    sc = scale_t.t().to(d)
    u = (ge * v).reshape(e_total, heads, ch).sum(-1)
    inner = torch.zeros((n, heads), dtype=d, device=q.device).index_add_(
        0, dst, s * sc * u)
    dl = (s * (sc * u - inner[dst])).repeat_interleave(ch, 1)
    dq = torch.zeros_like(q).index_add_(0, dst, dl * k) * inv
    dq[n - 1] = 0
    dk = dl * qe * inv
    dv = (s * sc).repeat_interleave(ch, 1) * ge
    de = dk + dv
    dkv = torch.cat([dk, dv], 1)
    if src is not None:
        dkv = torch.zeros((n_src, 2 * hidden), dtype=d,
                          device=q.device).index_add_(0, src, dkv)
    return dq, dkv, de @ w.t(), ea.t() @ de


def f64_errors(got, ref, names: Sequence[str]) -> Dict[str, float]:
    """Each output's largest absolute difference from the float64 result,
    over that result's largest magnitude (dq without the dummy row)."""
    out = {}
    for name, a, b in zip(names, got, ref):
        if name == "dq":
            a, b = a[:-1], b[:-1]
        scale = b.abs().max().item()
        out[name] = (a.double() - b).abs().max().item() / max(scale, 1e-300)
    return out


def kernel_split_ms(fn: Callable[[], object], calls: int = 10
                    ) -> Dict[str, float]:
    """Device ms per call of `fn` by CUDA kernel name, from torch.profiler
    over `calls` back-to-back calls after a warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: Dict[str, float] = {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        m = re.search(r"(attn_eproj_bwd_\w+?_kernel|cast_kernel)", e.key)
        name = m.group(1) if m else e.key[:40]
        out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return out


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "cuobjdump")


def sass_counts(name: str) -> Dict[str, Dict[str, int]]:
    """HGMMA, HMMA and FFMA instructions in each kernel function of the
    built `csrc/<name>.cu`, from `cuobjdump --dump-sass`."""
    from gnnep_tpu_torch.ops.cuda import build
    so = build.build([name])[name]
    sass = subprocess.run([_cuobjdump(), "--dump-sass", str(so)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    out: Dict[str, Dict[str, int]] = {}
    func = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = _demangle(m.group(1))
            out[func] = {"HGMMA": 0, "HMMA": 0, "FFMA": 0}
        elif func:
            for op in out[func]:
                if re.search(rf"\b{op}\b", line):
                    out[func][op] += 1
    return out


def _demangle(mangled: str) -> str:
    """The kernel's name and its template arguments, shortened."""
    m = re.search(r"\d+([a-z_]+_kernel)(?:I(\w*?)EEv|E)", mangled)
    if not m:
        return mangled[:60]
    args = (m.group(2) or "").replace("13__nv_bfloat16", "bf16") \
        .replace("Lb0E", ",false").replace("Lb1E", ",true") \
        .replace("Li", ",").replace("E", "").strip(",")
    return f"{m.group(1)}<{args}>" if args else m.group(1)


def gemm_floor_ms(case, timer) -> float:
    """The backward's three E·Fe·H products (e = ea·W_e, dea = de·W_eᵀ,
    dW_e = eaᵀ·de) as three `torch.matmul` calls in the input type with f32
    products, on the case's live edge rows, timed by `timer`: a diagnostic
    floor for the kernels' products, never called by the port."""
    import torch
    n = case["q"].shape[0]
    live = (case["mask2"] > 0) & (case["dst"] != n - 1)
    ea = case["ea"][live].contiguous()
    w = case["w_edge"]
    de = torch.randn((ea.shape[0], w.shape[1]), device=ea.device,
                     dtype=ea.dtype)

    def three():
        torch.matmul(ea, w)
        torch.matmul(de, w.t())
        torch.matmul(ea.t(), de)

    return timer(three)


def main(argv=None) -> int:
    import argparse
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bwd_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import chip_smoke as cs
    from gnnep_tpu_torch.ops.cuda import attention_eproj as ep
    from gnnep_tpu_torch.ops.cuda import attention_span as sp
    from gnnep_tpu_torch.ops.cuda import build
    dev, smi = cs.phase_device()
    build.build(["attn_eproj_bwd", "attn_span_bwd"])
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if re.search(r"registers|spill|Compiling entry", line):
                print(f"[nvcc] {name}: {line.strip()}", flush=True)
    sass = {k: sass_counts(k) for k in OUTPUTS}
    for k, funcs in sass.items():
        for func, c in funcs.items():
            print(f"[sass] {k} {func} " + " ".join(
                f"{op}={v}" for op, v in c.items()), flush=True)
    rec = {"card": smi, "sass": sass, "cases": []}
    with tempfile.TemporaryDirectory(prefix="bwd_bench_") as tmp:
        data, _, _ = cs.write_fixture(Path(tmp))
        _, batches = cs.training_setup(data, Path(tmp))
    batch = batches[0]
    rng = np.random.default_rng(cs.SEED + 10)
    for which in ("lg", "atom"):
        for dtype in (torch.float32, torch.bfloat16):
            tag = "float32" if dtype == torch.float32 else "bfloat16"
            c6 = cs.batch_case(rng, batch, which, hidden=256, dtype=dtype,
                               device=dev)
            a6 = cs.bwd_inputs(c6)
            c9 = cs.span_batch_case(rng, batch, which, hidden=256,
                                    dtype=dtype, device=dev)
            g, mx, den = cs.span_bwd_inputs(c9)
            a9 = (c9["q"], c9["kvn"], c9["ea"], c9["w_edge"], c9["scale_t"],
                  c9["mask2"], c9["row_ptr"], c9["src"], c9["dst"], g, mx,
                  den)
            runs = {
                "attn_eproj_bwd": (
                    lambda: ep.attention_eproj_bwd_cuda(*a6, heads=4),
                    lambda: ep.attention_eproj_bwd_plain(*a6, heads=4), c6),
                "attn_span_bwd": (
                    lambda: sp.attention_span_bwd_cuda(*a9, heads=4),
                    lambda: sp.attention_span_bwd_plain(*a9, heads=4), c9)}
            for kernel, (run, plain, case) in runs.items():
                r = {"kernel": kernel, "conv": which, "dtype": tag,
                     "ms": cs.device_ms(run),
                     "split_ms": kernel_split_ms(run),
                     "gemm_floor_ms": gemm_floor_ms(case, cs.device_ms)}
                if which == "lg" and tag == "float32":
                    extra = ({"src": c9["src"], "n_src": c9["kvn"].shape[0]}
                             if kernel == "attn_span_bwd" else {})
                    ref = eproj_bwd_f64(*(a6 if not extra else
                                          a9[:7] + a9[8:]), heads=4, **extra)
                    r["err_vs_f64"] = f64_errors(run(), ref,
                                                 OUTPUTS[kernel])
                    r["plain_err_vs_f64"] = f64_errors(plain(), ref,
                                                       OUTPUTS[kernel])
                print(f"[bench] {json.dumps(r)}", flush=True)
                rec["cases"].append(r)
    print(smi, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
