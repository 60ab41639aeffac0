"""Source variants of kernels 1 and 2 (the external-logits softmax-aggregate
forward and backward), each one design choice away from the sources in
`csrc/`, timed on the card beside the sources' own kernels at
`chip_smoke.py`'s flagship cases:

    python gnnep_tpu_torch/dev/agg_source_variants.py [--out FILE]

Run from the root of a checkout. Each variant is the source with a few
textual edits, built by nvcc (`build.NVCC_FLAGS`) into a temporary
directory beside a copy of `attn_kv.cuh`, all builds started together, and
called through ctypes on the wrappers' own plans:

- `heads_major` (both kernels): the logits, the scale and kernel 2's dl in
  the TPU kernels' [heads, E] layout, as the previous design took them,
  rather than [E, heads];
- `windows_g` (kernel 1): the softmax's pair lanes over windows of G edges
  (kernel 3's groups) rather than 2G;
- `no_early` (kernel 1): the first two groups' v words loaded after alpha,
  not with the logits.

(The plan's knobs, streaming among them, are `attn_variants.py`'s.)

Each variant's outputs are held against the own kernel's at chip_smoke's
tolerances (1e-4 f32, 1e-2 bf16 of the largest magnitude); device ms per
launch is chip_smoke's `device_ms` (the median of 30 chains of 10).
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# a [heads, E] loader in chunk_to_shared's place (the previous layout)
_HEADS_MAJOR = """
template <int G, int NA>
__device__ __forceinline__ void heads_major(
    const float* const (&src)[NA], int e_total, int h0, int nh, int j0,
    int cnt, int lane, int r, int split,
    float (*const (&dst)[NA])[kChunk + 1]) {
  if (lane >= cnt || ((lane / G) & (split - 1)) != r) return;
  float xv[NA][kMaxHeads];
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h)
      if (h < nh)
        xv[i][h] = src[i] ? src[i][static_cast<size_t>(h0 + h) * e_total +
                                   j0 + lane]
                          : 1.f;
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h)
      if (h < nh) dst[i][h][lane] = xv[i][h];
}
"""
_NS = "using namespace attn_kv;\n"

# (kernel, name) -> textual edits of the source
VARIANTS = {
    ("fwd", "heads_major"): [
        (_NS, _NS + _HEADS_MAJOR),
        ("chunk_to_shared<G, 2>(src, a.heads,",
         "heads_major<G, 2>(src, a.e_total,")],
    ("fwd", "windows_g"): [
        ("constexpr int PG = 2 * G;", "constexpr int PG = G;")],
    ("fwd", "no_early"): [
        ("const bool early = nchunk == 1 && L.passes == 1;",
         "const bool early = false;")],
    ("bwd", "heads_major"): [
        (_NS, _NS + _HEADS_MAJOR),
        ("chunk_to_shared<G, 2>(ls, a.heads,",
         "heads_major<G, 2>(ls, a.e_total,"),
        ("chunk_to_shared<G, 3>(lus, a.heads,",
         "heads_major<G, 3>(lus, a.e_total,"),
        ("float* dl = a.dl + h0 + (pair_on ? ph : 0);",
         "float* dl = a.dl + static_cast<size_t>(h0 + (pair_on ? ph : 0)) *"
         " a.e_total;"),
        ("dl[static_cast<size_t>(j0 + uu) * a.heads] = u;", "dl[j0 + uu] = u;"),
        ("dl[static_cast<size_t>(j0 + uu) * a.heads] = pdl;",
         "dl[j0 + uu] = pdl;"),
        ("zero_bytes<1>(dl, lo * dl_bytes, e_total * dl_bytes, me, stride);",
         "for (int h = 0; h < a.heads; ++h)\n"
         "    zero_bytes<1>(dl, (h * e_total + lo) * 4, (h + 1) * e_total * 4,"
         " me, stride);")],
}


def variant_source(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"edit does not apply once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_all(tmp: Path):
    """Build every variant beside a copy of the header → {key: library}."""
    from gnnep_tpu_torch.ops.cuda import build
    shutil.copy(build.CSRC / "attn_kv.cuh", tmp / "attn_kv.cuh")
    jobs = {}
    for (kernel, name), edits in VARIANTS.items():
        src = (build.CSRC / f"softmax_aggregate_{kernel}.cu").read_text()
        path = tmp / f"{kernel}_{name}.cu"
        path.write_text(variant_source(src, edits))
        jobs[(kernel, name)] = path

    def nvcc(item):
        key, path = item
        so = path.with_suffix(".so")
        r = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                            str(path)], capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"{key}: nvcc failed\n{r.stderr[-3000:]}")
        return key, so

    with ThreadPoolExecutor(len(jobs)) as ex:
        return dict(ex.map(nvcc, jobs.items()))


def run(lib, kernel, c, plan, heads_major, extra=()):
    """One launch of a variant library on case `c` → its outputs."""
    import torch
    from gnnep_tpu_torch.ops.cuda.kv_layout import plan_args
    logits, scale, v, row_ptr = c["logits"], c["scale"], c["v"], c["row_ptr"]
    if heads_major:
        logits, scale = c["logits_t"], c["scale_t"]
    n, heads = c["n"], c["heads"]
    e_total, hidden = v.shape
    bf16 = int(v.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    if kernel == "fwd":
        out = torch.empty((n, hidden), device=v.device)
        mx = torch.empty((n, heads), device=v.device)
        den = torch.empty_like(mx)
        rc = lib.softmax_aggregate_fwd(
            logits.data_ptr(), scale.data_ptr(), v.data_ptr(),
            row_ptr.data_ptr(), out.data_ptr(), mx.data_ptr(),
            den.data_ptr(), n, e_total, hidden, heads, bf16,
            *plan_args(plan), int(plan.stream), stream)
        outs = (out, mx, den)
    else:
        g, mx, den = extra
        dl = torch.empty((heads, e_total) if heads_major
                         else (e_total, heads), device=v.device)
        dv = torch.empty_like(v)
        rc = lib.softmax_aggregate_bwd(
            logits.data_ptr(), scale.data_ptr(), v.data_ptr(),
            row_ptr.data_ptr(), g.data_ptr(), mx.data_ptr(), den.data_ptr(),
            dl.data_ptr(), dv.data_ptr(), n, e_total, hidden, heads, bf16,
            *plan_args(plan), plan.tail_blocks, int(plan.stream), stream)
        outs = (dl.t() if heads_major else dl, dv)
    if rc:
        raise RuntimeError(f"{kernel} variant launch failed with {rc}")
    return outs


def main(argv=None) -> int:
    import argparse
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("agg_source_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import chip_smoke as cs
    from gnnep_tpu_torch.ops.cuda import aggregate as ag
    dev, smi = cs.phase_device()
    tmp = Path(tempfile.mkdtemp(prefix="agg_variants_"))
    libs = build_all(tmp)
    p, i = ctypes.c_void_p, ctypes.c_int
    loaded = {}
    for (kernel, name), so in libs.items():
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, f"softmax_aggregate_{kernel}")
        fn.argtypes = ([p] * 7 + [i] * 12 + [p] if kernel == "fwd"
                       else [p] * 9 + [i] * 13 + [p])
        fn.restype = i
        loaded[(kernel, name)] = lib
    data, _, _ = cs.write_fixture(tmp / "fixture")
    _, batches = cs.training_setup(data, tmp / "fixture")
    rng = np.random.default_rng(cs.SEED + 50)
    rows = []
    for which in ("lg", "atom"):
        for dtype in (torch.float32, torch.bfloat16):
            tag = "float32" if dtype == torch.float32 else "bfloat16"
            c = cs.agg_inputs(rng, cs.batch_case(rng, batches[0], which,
                                                 hidden=256, dtype=dtype,
                                                 device=dev))
            c["logits_t"] = c["logits"].t().contiguous()
            c["scale_t"] = c["scale"].t().contiguous()
            v = c["v"]
            plans = {b: ag.aggregate_plan(c["n"], v.shape[0], v.shape[1],
                                          c["heads"], v.element_size(),
                                          v.data_ptr(), backward=b)
                     for b in (False, True)}
            gen = torch.Generator(device=dev).manual_seed(0)
            g = torch.randn((c["n"], v.shape[1]), generator=gen, device=dev)
            fwd = ag.aggregate_cuda(*cs.agg_fwd_args(c), heads=c["heads"])
            own = {"fwd": (fwd, lambda: ag.aggregate_cuda(
                       *cs.agg_fwd_args(c), heads=c["heads"])),
                   "bwd": (ag.aggregate_bwd_cuda(
                       *cs.agg_fwd_args(c), g, fwd[1], fwd[2],
                       heads=c["heads"]),
                       lambda: ag.aggregate_bwd_cuda(
                           *cs.agg_fwd_args(c), g, fwd[1], fwd[2],
                           heads=c["heads"]))}
            tol = 1e-4 if tag == "float32" else 1e-2
            for kernel in ("fwd", "bwd"):
                want, call = own[kernel]
                r = {"kernel": kernel, "variant": "own", "conv": which,
                     "dtype": tag, "ms": cs.device_ms(call)}
                print(f"[source] {json.dumps(r)}", flush=True)
                rows.append(r)
                for (k, name), lib in loaded.items():
                    if k != kernel:
                        continue
                    hm = name == "heads_major"
                    extra = (g, fwd[1], fwd[2])

                    def go(lib=lib, hm=hm):
                        return run(lib, kernel, c, plans[kernel == "bwd"],
                                   hm, extra)

                    got = go()
                    torch.cuda.synchronize()
                    err = max(((a.float()[:-1] - b.float()[:-1]).abs().max()
                               / b.float()[:-1].abs().max().clamp_min(1e-30))
                              .item() for a, b in zip(got, want))
                    if not err <= tol:
                        raise AssertionError(f"{kernel} {name} {which} {tag}:"
                                             f" differs by {err:.3e}")
                    r = {"kernel": kernel, "variant": name, "conv": which,
                         "dtype": tag, "ms": cs.device_ms(go),
                         "rel_err_vs_own": err}
                    print(f"[source] {json.dumps(r)}", flush=True)
                    rows.append(r)
    shutil.rmtree(tmp)
    print(smi, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": smi, "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
