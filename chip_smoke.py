#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`gnnep_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line (a failure anywhere exits non-zero):
  1. device: nvidia-smi's name and power limit, torch and CUDA versions;
     TF32 off for matrix products and convolutions.
  2. build: nvcc builds every kernel of the serving and training paths from
     `csrc/` (one nvcc per source, all started together).
  3. kernel: each kernel against its plain PyTorch version on the card, on
     small seeded edge cases and at the flagship conv shapes, f32 and bf16:
     the eproj forward (kernel 5) and backward (kernel 6), the CSR
     segment-sum (kernel 7, permuted and identity order), the kv+e
     attention forward (kernel 3) and backward (kernel 4), and the
     external-logits softmax-aggregate forward (kernel 1) and backward
     (kernel 2). Dead rows of every backward must be exact zeros.
  4. serve: 256 synthetic MP-like graphs and a 5-member flagship ensemble
     (hidden 256, 4 layers, 4 heads, random weights from a seed) written to
     disk, then `gnnep_tpu_torch.cli.predict` in float32 and bfloat16; the
     launch counts show every conv went through the kernel, and member 0's
     means on the card match the CPU plain forward. The same for a
     2-member ensemble on each other rung (`conv_impl='fused'` with
     `attn_eproj=False`: kernel 3; with `attn_fused=False`: kernel 1), whose
     convs never reach kernel 5.
  5. train: `gnnep_tpu_torch.cli.train --conv-impl fused` on the same 256
     graphs at flagship width, 2 members in float32 and 1 in bfloat16; every
     step's loss is finite, kernels 6 and 7 ran 2·layers times per optimizer
     step (the trainer reports its steps), and the written f32 ensemble
     serves through `cli.predict`. Then one member for one epoch in float32
     with `--no-attn-eproj` (kernels 4 and 7, 2·layers each per step) and
     with `--no-attn-fused` (kernel 2 2·layers, kernel 7 4·layers: the kv
     and the q gathers), the forward kernel 2·layers per train and eval
     forward, kernels 5 and 6 never.
  6. check: one train step on the card against the CPU plain step from the
     same parameters and batch, dropout and jitter off, on each rung.
  7. times: CUDA events, warm-up first. A kernel's (and its plain
     version's) device time per launch is the median of 30 chains of 10
     back-to-back launches; its wall time per call, host work included, and
     the forward's and the train step's wall times (on each rung) are
     medians of 30 single calls. Profiler passes split the forward's and
     the train step's device time by kernel.

The next-to-last line is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

N_GRAPHS, BATCH, MEMBERS, SEED = 256, 64, 5, 0
NEG = -1e30
# the two other ladder rungs: the config fields each sets, its CLI flag, its
# forward and backward kernels, and kernel 7's launches per conv and step
RUNGS = {
    "kv+e": dict(cfg={"attn_eproj": False}, flag="--no-attn-eproj",
                 fwd="attn_fwd", bwd="attn_bwd", gathers=1),
    "logits": dict(cfg={"attn_fused": False}, flag="--no-attn-fused",
                   fwd="softmax_aggregate_fwd", bwd="softmax_aggregate_bwd",
                   gathers=2),
}
RUNG_MEMBERS = 2
REPS, WARMUP = 30, 5
# kernel timing: launches per timed chain, and the card-side spin (about
# 25 ms at the H100's clock) that covers the host's enqueuing of a chain
CHAIN, SPIN_CYCLES = 10, 50_000_000
# NVIDIA H100 SXM data sheet (dense): memory rate, f32 on the CUDA cores,
# bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def median_ms(fn, reps: int = REPS, warmup: int = WARMUP) -> float:
    """Median over `reps` calls of `fn`, each between two CUDA events: the
    wall time of one call on an idle card, host work included (what a
    serving request waits for)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, reps: int = REPS, warmup: int = WARMUP,
              chain: int = CHAIN) -> float:
    """Device time of one call of `fn`: the median over `reps` chains of
    `chain` back-to-back calls, each chain queued behind a spin on the card
    so that the host has enqueued it before the card reaches it (the
    wrapper's host work then overlaps the previous call). A chain the card
    reached before the host had enqueued it is dropped and taken again
    behind a spin twice as long; raises if even 16 times the first spin
    does not cover the host."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times, spin = [], SPIN_CYCLES
    while len(times) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(chain):
            fn()
        end.record()
        caught_up = start.query()
        end.synchronize()
        if caught_up:
            if spin >= 16 * SPIN_CYCLES:
                raise RuntimeError("the card reached the timed chain before "
                                   "the host had enqueued it, behind a spin "
                                   f"of {spin} cycles")
            spin *= 2
            continue
        times.append(start.elapsed_time(end) / chain)
    return float(np.median(times))


# --------------------------------------------------------------- phase 1
def phase_device():
    import torch
    from gnnep_tpu_torch.utils.device import resolve_device
    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("device", kind=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda,
        tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
        tf32_cudnn=torch.backends.cudnn.allow_tf32)
    return dev, smi


# --------------------------------------------------------------- phase 2
KERNELS = ("attn_eproj_fwd", "attn_eproj_bwd", "csr_segment_sum",
           "attn_fwd", "attn_bwd", "softmax_aggregate_fwd",
           "softmax_aggregate_bwd")
# the TPU kernel each one replaces
REPLACES = {"attn_eproj_fwd": "gnnep_tpu/ops/pallas/csr_attention.py:983",
            "attn_eproj_bwd": "gnnep_tpu/ops/pallas/csr_attention.py:1065",
            "csr_segment_sum": "gnnep_tpu/ops/pallas/csr_attention.py:1533",
            "attn_fwd": "gnnep_tpu/ops/pallas/csr_attention.py:535",
            "attn_bwd": "gnnep_tpu/ops/pallas/csr_attention.py:613",
            "softmax_aggregate_fwd": "gnnep_tpu/ops/pallas/csr_attention.py:38",
            "softmax_aggregate_bwd":
                "gnnep_tpu/ops/pallas/csr_attention.py:189"}
# each kernel's launch count: (module of gnnep_tpu_torch.ops.cuda, attribute)
COUNTERS = {"attn_eproj_fwd": ("attention_eproj", "launches"),
            "attn_eproj_bwd": ("attention_eproj", "bwd_launches"),
            "csr_segment_sum": ("segment_sum", "launches"),
            "attn_fwd": ("attention", "launches"),
            "attn_bwd": ("attention", "bwd_launches"),
            "softmax_aggregate_fwd": ("aggregate", "launches"),
            "softmax_aggregate_bwd": ("aggregate", "bwd_launches")}


def _counter_module(name: str):
    return importlib.import_module(
        f"gnnep_tpu_torch.ops.cuda.{COUNTERS[name][0]}")


def reset_counts() -> None:
    for name, (_, attr) in COUNTERS.items():
        setattr(_counter_module(name), attr, 0)


def read_counts() -> dict:
    return {name: getattr(_counter_module(name), attr)
            for name, (_, attr) in COUNTERS.items()}


def phase_build():
    from gnnep_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    build.build(list(KERNELS))
    say("build", kernels=",".join(KERNELS),
        seconds=f"{time.perf_counter() - t0:.1f}")
    for name, log in build.build_logs.items():
        entry = ""
        for line in log.splitlines():
            # the mangled kernel name carries its length, then its template
            # arguments: ...26attn_eproj_bwd_attn_kernelI13__nv_bfloat16Li4EE
            m = re.search(r"\d+([a-z_]+_kernel)I(\w*?)EEv", line)
            if m:
                args = (m.group(2).replace("13__nv_bfloat16", "bf16")
                        .replace("Li", ",").replace("E", ""))
                entry = f" {m.group(1)}<{args}>"
            elif "registers" in line or "spill" in line:
                print(f"  {name}{entry}: {line.strip()}", flush=True)


# --------------------------------------------------------------- phase 3
def eproj_case(rng, *, n, heads, hidden, fe, degs, dtype, device,
               interior_pad=0.0, dead_rows=(), scale=False):
    """A dst-sorted CSR arena with `degs[t]` edges into target t, tail
    padding owned by the dummy row n-1, masked interior padding rows at rate
    `interior_pad`, rows in `dead_rows` all masked, and optionally a dropout
    scale. Returns the kernel's inputs plus dst."""
    import torch
    degs = np.asarray(degs, np.int64).copy()
    degs[-1] = 0
    dst = np.repeat(np.arange(n, dtype=np.int64), degs)
    e_real = dst.size
    e_total = e_real + 16
    dst = np.concatenate([dst, np.full(e_total - e_real, n - 1)])
    mask = (np.arange(e_total) < e_real).astype(np.float32)
    mask[:e_real] *= rng.random(e_real) >= interior_pad
    for t in dead_rows:
        mask[dst == t] = 0.0
    row_ptr = np.searchsorted(dst, np.arange(n + 1)).astype(np.int32)

    def t_(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)

    sc = ((rng.random((heads, e_total)) > 0.25) / 0.75 if scale
          else np.ones((heads, e_total))).astype(np.float32)
    return dict(
        q=t_(rng.normal(size=(n, hidden))),
        kv=t_(rng.normal(size=(e_total, 2 * hidden))),
        ea=t_(rng.normal(size=(e_total, fe))),
        w_edge=t_(rng.normal(size=(fe, hidden)) * (0.3 / np.sqrt(fe / 16))),
        scale_t=t_(sc, torch.float32), mask2=t_(mask, torch.float32),
        row_ptr=t_(row_ptr, torch.int32),
        dst=t_(dst, torch.int64), heads=heads)


def batch_case(rng, batch, which, *, hidden, dtype, device):
    """Kernel inputs at the shapes and CSR structure of one conv of a packed
    batch ('lg': line-graph conv over bonds; 'atom': atom conv)."""
    import torch
    if which == "lg":
        n, dst, mask, rp = (batch.edge_src.shape[0], batch.lg_dst,
                            batch.lg_mask, batch.lg_row_ptr)
    else:
        n, dst, mask, rp = (batch.nodes.shape[0], batch.edge_dst,
                            batch.edge_mask, batch.edge_row_ptr)
    e_total = dst.shape[0]

    def t_(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)

    return dict(
        q=t_(rng.normal(size=(n, hidden))),
        kv=t_(rng.normal(size=(e_total, 2 * hidden))),
        ea=t_(rng.normal(size=(e_total, hidden))),
        w_edge=t_(rng.normal(size=(hidden, hidden)) / np.sqrt(hidden)),
        scale_t=t_(np.ones((4, e_total), np.float32), torch.float32),
        mask2=t_(mask, torch.float32), row_ptr=t_(rp, torch.int32),
        dst=t_(dst, torch.int64), heads=4)


def run_both(case):
    """(kernel result, plain result), each (out, max, denom)."""
    import torch
    from gnnep_tpu_torch.ops.cuda import attention_eproj as ep
    args = (case["q"], case["kv"], case["ea"], case["w_edge"],
            case["scale_t"], case["mask2"])
    kern = ep.attention_eproj_cuda(*args, case["row_ptr"], case["dst"],
                                   heads=case["heads"])
    torch.cuda.synchronize()
    plain = ep.attention_eproj_plain(*args, case["dst"], heads=case["heads"])
    return kern, plain


def check_case(name, case, rtol, atol):
    """Kernel vs plain on the real rows (all but the dummy row n-1); returns
    the largest absolute difference of `out`."""
    import torch
    kern, plain = run_both(case)
    errs = []
    for what, a, b in zip(("out", "max", "denom"), kern, plain):
        a, b = a[:-1].float(), b[:-1].float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name}: kernel {what} has non-finite values")
        if not torch.allclose(a, b, rtol=rtol, atol=atol):
            bad = (a - b).abs().max().item()
            raise AssertionError(f"{name}: kernel {what} differs from the "
                                 f"plain version by {bad:.3e} "
                                 f"(rtol {rtol}, atol {atol})")
        errs.append((a - b).abs().max().item())
    say("kernel", case=name, rtol=rtol, atol=atol,
        max_abs_err_out=f"{errs[0]:.3e}", max_abs_err_max=f"{errs[1]:.3e}",
        max_abs_err_denom=f"{errs[2]:.3e}")
    return errs[0]


def phase_kernel(dev, batch):
    import torch
    rng = np.random.default_rng(SEED)
    small = []
    for dtype, tol in ((torch.float32, (1e-4, 1e-5)),
                       (torch.bfloat16, (0.05, 0.05))):
        tag = "f32" if dtype == torch.float32 else "bf16"
        # head width 8 (lanes idle), short rows, interior padding, an
        # all-masked row, empty rows, dropout scale
        degs = rng.integers(0, 7, 40)
        small.append((f"small_{tag}_ch8", eproj_case(
            rng, n=40, heads=2, hidden=16, fe=16, degs=degs, dtype=dtype,
            device=dev, interior_pad=0.2, dead_rows=(3,), scale=True), tol))
        # rows longer than a warp and than one 64-edge projection chunk,
        # head width 64 as the flagship's
        degs = rng.integers(10, 60, 24)
        small.append((f"long_rows_{tag}_ch64", eproj_case(
            rng, n=24, heads=4, hidden=256, fe=256, degs=degs, dtype=dtype,
            device=dev, interior_pad=0.1, dead_rows=(5,), scale=True), tol))
        # head width 96, padded to 128 channels inside the kernel
        degs = rng.integers(1, 20, 16)
        small.append((f"ch96_{tag}", eproj_case(
            rng, n=16, heads=2, hidden=192, fe=32, degs=degs, dtype=dtype,
            device=dev, interior_pad=0.1, scale=True), tol))
    for name, case, (rtol, atol) in small:
        check_case(name, case, rtol, atol)
    flagship = {}
    for which in ("lg", "atom"):
        for dtype, tol in ((torch.float32, (1e-4, 1e-5)),
                           (torch.bfloat16, (0.05, 0.05))):
            tag = "float32" if dtype == torch.float32 else "bfloat16"
            case = batch_case(rng, batch, which, hidden=256, dtype=dtype,
                              device=dev)
            err = check_case(f"{which}_conv_{tag}", case, *tol)
            flagship[(which, tag)] = (case, err)
    return flagship


def bwd_inputs(case, g_seed=0):
    """Kernel 6's inputs for an eproj case: the forward's inputs, a seeded
    f32 cotangent g and the forward kernel's max and denom."""
    import torch
    from gnnep_tpu_torch.ops.cuda import attention_eproj as ep
    fwd = (case["q"], case["kv"], case["ea"], case["w_edge"],
           case["scale_t"], case["mask2"])
    _, mx, den = ep.attention_eproj_cuda(*fwd, case["row_ptr"], case["dst"],
                                         heads=case["heads"])
    gen = torch.Generator(device=case["q"].device).manual_seed(g_seed)
    g = torch.randn(case["q"].shape, generator=gen, device=case["q"].device)
    return fwd + (case["row_ptr"], case["dst"], g, mx, den)


def check_bwd_case(name, case, tol):
    """Kernel 6 against its plain version on the card: dq on the real rows,
    dkv and dea on the live edges and dW_e in full, each within `tol` of
    the plain tensor's largest magnitude; dead edges' rows and the dummy
    row's dq must be exact zeros. Returns the largest absolute difference
    and the largest share of its limit."""
    import torch
    from gnnep_tpu_torch.ops.cuda import attention_eproj as ep
    args = bwd_inputs(case)
    kern = ep.attention_eproj_bwd_cuda(*args, heads=case["heads"])
    torch.cuda.synchronize()
    plain = ep.attention_eproj_bwd_plain(*args, heads=case["heads"])
    n = case["q"].shape[0]
    live = (case["mask2"] > 0) & (case["dst"] != n - 1)
    errs, share = {}, 0.0
    for what, a, b in zip(("dq", "dkv", "dea", "dw"), kern, plain):
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name}: kernel {what} has non-finite "
                                 "values")
        if what == "dq":
            if a[-1].any():
                raise AssertionError(f"{name}: dq of the dummy row is not "
                                     "zero")
            a, b = a[:-1], b[:-1]
        elif what in ("dkv", "dea"):
            if a[~live].any():
                raise AssertionError(f"{name}: {what} of dead edges is not "
                                     "zero")
            a, b = a[live], b[live]
        scale = b.abs().max().item() if b.numel() else 0.0
        err = (a - b).abs().max().item() if a.numel() else 0.0
        if err > tol * scale:
            raise AssertionError(f"{name}: kernel {what} differs from the "
                                 f"plain version by {err:.3e} (tol {tol} x "
                                 f"{scale:.3e})")
        errs[what] = err
        if scale > 0:
            share = max(share, err / (tol * scale))
    say("kernel", kernel="attn_eproj_bwd", case=name, tol_rel_to_max=tol,
        **{f"max_abs_err_{k}": f"{v:.3e}" for k, v in errs.items()},
        share_of_limit=f"{share:.3f}")
    return max(errs.values())


def phase_kernel_bwd(dev, batch):
    """Kernel 6 on small seeded edge cases and at the flagship conv shapes
    of a packed training batch."""
    import torch
    rng = np.random.default_rng(SEED + 10)
    flagship = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        tag = "f32" if dtype == torch.float32 else "bf16"
        degs = rng.integers(0, 7, 40)
        check_bwd_case(f"small_{tag}_ch8", eproj_case(
            rng, n=40, heads=2, hidden=16, fe=16, degs=degs, dtype=dtype,
            device=dev, interior_pad=0.2, dead_rows=(3,), scale=True), tol)
        degs = rng.integers(10, 60, 24)
        check_bwd_case(f"long_rows_{tag}_ch64", eproj_case(
            rng, n=24, heads=4, hidden=256, fe=256, degs=degs, dtype=dtype,
            device=dev, interior_pad=0.1, dead_rows=(5,), scale=True), tol)
        degs = rng.integers(1, 20, 16)
        check_bwd_case(f"ch96_{tag}", eproj_case(
            rng, n=16, heads=2, hidden=192, fe=32, degs=degs, dtype=dtype,
            device=dev, interior_pad=0.1, scale=True), tol)
        for which in ("lg", "atom"):
            tagl = "float32" if dtype == torch.float32 else "bfloat16"
            case = batch_case(rng, batch, which, hidden=256, dtype=dtype,
                              device=dev)
            err = check_bwd_case(f"{which}_conv_{tagl}", case, tol)
            flagship[(which, tagl)] = (case, err)
    return flagship


def segsum_case(rng, batch, which, *, width, dtype, device):
    """Kernel 7's inputs at one conv's kv-gather backward of a packed batch:
    the cotangent of kv [E, 2H] (zero on masked edges, as the eproj
    backward leaves it), the source-sorted order and starts."""
    import torch
    if which == "lg":
        src, order, starts, mask = (batch.lg_src, batch.lg_src_order,
                                    batch.lg_src_starts, batch.lg_mask)
    else:
        src, order, starts, mask = (batch.edge_src, batch.edge_src_order,
                                    batch.edge_src_starts, batch.edge_mask)

    def t_(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)

    live = (np.asarray(mask) > 0)[:, None]
    values = rng.normal(size=(src.shape[0], width)) * live
    return dict(values=t_(values, dtype),
                order=t_(order, torch.int32), starts=t_(starts, torch.int32),
                src=t_(src, torch.int64))


def check_segsum_case(name, case, rtol, atol):
    import torch
    from gnnep_tpu_torch.ops.cuda import segment_sum as ss
    args = (case["values"], case["order"], case["starts"])
    kern = ss.csr_segment_sum_cuda(*args)
    torch.cuda.synchronize()
    plain = ss.csr_segment_sum_plain(*args)
    err = (kern - plain).abs().max().item() if kern.numel() else 0.0
    if not torch.isfinite(kern).all() or not torch.allclose(
            kern, plain, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: segment-sum kernel differs from the "
                             f"plain version by {err:.3e} (rtol {rtol}, "
                             f"atol {atol})")
    if not torch.equal(ss.csr_segment_sum_cuda(*args), kern):
        raise AssertionError(f"{name}: segment-sum kernel is not "
                             "deterministic")
    say("kernel", kernel="csr_segment_sum", case=name, rtol=rtol, atol=atol,
        max_abs_err=f"{err:.3e}")
    return err


def phase_kernel_segsum(dev, batch):
    """Kernel 7 on small seeded cases (empty segments, odd widths) and at
    the flagship kv-gather backward shapes."""
    import torch
    rng = np.random.default_rng(SEED + 20)
    flagship = {}
    for dtype, tol in ((torch.float32, (1e-5, 1e-5)),
                       (torch.bfloat16, (1e-4, 1e-4))):
        tag = "float32" if dtype == torch.float32 else "bfloat16"
        for width in (6, 16, 512):
            idx = rng.integers(0, 299, 3000)
            idx[-100:] = 299
            order = np.argsort(idx, kind="stable")
            starts = np.searchsorted(idx[order], np.arange(300))
            case = dict(
                values=torch.from_numpy(rng.normal(size=(3000, width))).to(
                    dev, dtype),
                order=torch.from_numpy(order).to(dev, torch.int32),
                starts=torch.from_numpy(starts).to(dev, torch.int32))
            check_segsum_case(f"small_w{width}_{tag}", case, *tol)
        for which in ("lg", "atom"):
            case = segsum_case(rng, batch, which, width=512, dtype=dtype,
                               device=dev)
            err = check_segsum_case(f"{which}_conv_{tag}", case, *tol)
            flagship[(which, tag)] = (case, err)
        # the identity order: the q gather's backward on the external-logits
        # rung, the line-graph conv's cotangent of q_dst [E, H] summed over
        # its own CSR rows
        case = qgather_case(rng, batch, width=256, dtype=dtype, device=dev)
        err = check_segsum_case(f"lg_identity_order_{tag}", case, *tol)
        flagship[("lg_identity", tag)] = (case, err)
    return flagship


def qgather_case(rng, batch, *, width, dtype, device):
    """Kernel 7's inputs at the line-graph conv's q-gather backward: the
    cotangent of q_dst (zero on masked edges), no order (the identity) and
    the CSR row starts; `src` is dst, for the library call."""
    import torch
    live = (np.asarray(batch.lg_mask) > 0)[:, None]
    values = rng.normal(size=(batch.lg_dst.shape[0], width)) * live
    return dict(values=torch.from_numpy(values).to(device, dtype), order=None,
                starts=torch.from_numpy(np.ascontiguousarray(
                    batch.lg_row_ptr[:-1])).to(device, torch.int32),
                src=torch.from_numpy(np.asarray(batch.lg_dst)).to(
                    device, torch.int64))


# ------------------------------------------- phase 3, kernels 3, 4, 1 and 2
def attn_inputs(case):
    """Kernel 3's inputs from an eproj case: k and v are kv's two halves."""
    hidden = case["q"].shape[1]
    return dict(q=case["q"], k=case["kv"][:, :hidden].contiguous(),
                v=case["kv"][:, hidden:].contiguous(),
                scale_t=case["scale_t"], mask2=case["mask2"],
                row_ptr=case["row_ptr"], dst=case["dst"],
                heads=case["heads"])


def agg_inputs(rng, case):
    """Kernel 1's inputs from an eproj case: f32 [heads, E] logits from the
    rng (spread as q·k/√c of unit rows, about 2), written as −1e30 where
    mask2 is 0 as the conv writes them; v is kv's second half."""
    import torch
    heads, e_total = case["scale_t"].shape
    logits = torch.from_numpy(rng.normal(size=(heads, e_total)).astype(
        np.float32) * 2.0).to(case["q"].device)
    logits = torch.where(case["mask2"][None, :] > 0, logits,
                         torch.full_like(logits, NEG)).contiguous()
    return dict(logits_t=logits, scale_t=case["scale_t"],
                v=case["kv"][:, case["q"].shape[1]:].contiguous(),
                row_ptr=case["row_ptr"], dst=case["dst"], mask2=case["mask2"],
                heads=heads, n=case["q"].shape[0])


def attn_fwd_args(c):
    return (c["q"], c["k"], c["v"], c["scale_t"], c["mask2"])


def agg_fwd_args(c):
    return (c["logits_t"], c["scale_t"], c["v"], c["row_ptr"])


def run_fwd(kernel, c):
    """(kernel result, plain result) of kernel 3 or 1, each (out, max,
    denom)."""
    import torch
    from gnnep_tpu_torch.ops.cuda import aggregate as ag
    from gnnep_tpu_torch.ops.cuda import attention as at
    if kernel == "attn_fwd":
        args = attn_fwd_args(c)
        kern = at.attention_cuda(*args, c["row_ptr"], heads=c["heads"])
        torch.cuda.synchronize()
        return kern, at.attention_plain(*args, c["dst"], heads=c["heads"])
    args = agg_fwd_args(c)
    kern = ag.aggregate_cuda(*args, heads=c["heads"])
    torch.cuda.synchronize()
    return kern, ag.aggregate_plain(*args, c["dst"], heads=c["heads"])


def rung_bwd_inputs(kernel, c, g_seed=0):
    """Kernel 4's or 2's inputs: the forward's, a seeded f32 cotangent g and
    the forward kernel's max and denom."""
    import torch
    from gnnep_tpu_torch.ops.cuda import aggregate as ag
    from gnnep_tpu_torch.ops.cuda import attention as at
    n, hidden = c["q"].shape if "q" in c else (c["n"], c["v"].shape[1])
    gen = torch.Generator(device=c["v"].device).manual_seed(g_seed)
    g = torch.randn((n, hidden), generator=gen, device=c["v"].device)
    if kernel == "attn_bwd":
        _, mx, den = at.attention_cuda(*attn_fwd_args(c), c["row_ptr"],
                                       heads=c["heads"])
        return attn_fwd_args(c) + (c["row_ptr"], g, mx, den)
    _, mx, den = ag.aggregate_cuda(*agg_fwd_args(c), heads=c["heads"])
    return agg_fwd_args(c) + (g, mx, den)


def run_bwd_plain(kernel, c, args):
    """The plain version of kernel 4 (dq, dk, dv) or 2 (dl_t, dv) on the
    kernel's arguments, with dst."""
    from gnnep_tpu_torch.ops.cuda import aggregate as ag
    from gnnep_tpu_torch.ops.cuda import attention as at
    if kernel == "attn_bwd":
        return at.attention_bwd_plain(*args[:6], c["dst"], *args[6:],
                                      heads=c["heads"])
    return ag.aggregate_bwd_plain(*args[:4], c["dst"], *args[4:],
                                  heads=c["heads"])


def run_bwd(kernel, c, args):
    """(kernel result, plain result) of kernel 4 or 2."""
    import torch
    from gnnep_tpu_torch.ops.cuda import aggregate as ag
    from gnnep_tpu_torch.ops.cuda import attention as at
    cuda = (at.attention_bwd_cuda if kernel == "attn_bwd"
            else ag.aggregate_bwd_cuda)
    kern = cuda(*args, heads=c["heads"])
    torch.cuda.synchronize()
    return kern, run_bwd_plain(kernel, c, args)


def _within(kernel, name, what, a, b, tol):
    """|a − b| within `tol` × the plain tensor's largest magnitude (no
    floor) → (max abs error, share of the limit)."""
    import torch
    if not torch.isfinite(a).all():
        raise AssertionError(f"{kernel} {name}: kernel {what} has non-finite "
                             "values")
    scale = b.abs().max().item() if b.numel() else 0.0
    err = (a - b).abs().max().item() if a.numel() else 0.0
    if err > tol * scale:
        raise AssertionError(f"{kernel} {name}: kernel {what} differs from "
                             f"the plain version by {err:.3e} (tol {tol} x "
                             f"{scale:.3e})")
    return err, (err / (tol * scale) if scale > 0 else 0.0)


def check_rung_fwd(kernel, name, c, tol):
    """Kernel 3 or 1 against its plain version on the real rows (all but the
    dummy row n−1): out and denom within `tol` of the plain tensor's largest
    magnitude; max so on rows with a live edge, and exactly −1e30 on the
    others (all-masked and empty rows). Returns out's largest absolute
    difference."""
    kern, plain = run_fwd(kernel, c)
    errs, share = {}, 0.0
    for what, a, b in zip(("out", "max", "denom"), kern, plain):
        a, b = a[:-1].float(), b[:-1].float()
        if what == "max":
            dead = b <= 0.5 * NEG
            if not (a[dead] == NEG).all():
                raise AssertionError(f"{kernel} {name}: max of a row without "
                                     "a live edge is not -1e30")
            a, b = a[~dead], b[~dead]
        errs[what], sh = _within(kernel, name, what, a, b, tol)
        share = max(share, sh)
    say("kernel", kernel=kernel, case=name, tol_rel_to_max=tol,
        **{f"max_abs_err_{k}": f"{v:.3e}" for k, v in errs.items()},
        share_of_limit=f"{share:.3f}")
    return errs["out"]


def check_rung_bwd(kernel, name, c, tol):
    """Kernel 4 or 2 against its plain version, each output within `tol` of
    the plain tensor's largest magnitude; the rows of dead edges (masked,
    or the dummy row's) and the dummy row's dq must be exact zeros. Returns
    the largest absolute difference."""
    kern, plain = run_bwd(kernel, c, rung_bwd_inputs(kernel, c))
    import torch
    n = c["q"].shape[0] if "q" in c else c["n"]
    live = (c["mask2"] > 0) & (c["dst"] != n - 1)
    if kernel == "attn_bwd":
        real = torch.arange(n, device=live.device) < n - 1
        rows = {"dq": (kern[0], plain[0], real),
                "dk": (kern[1], plain[1], live),
                "dv": (kern[2], plain[2], live)}
    else:
        rows = {"dl_t": (kern[0].t(), plain[0].t(), live),
                "dv": (kern[1], plain[1], live)}
    errs, share = {}, 0.0
    for what, (a, b, keep) in rows.items():
        a, b = a.float(), b.float()
        if a[~keep].any():
            raise AssertionError(f"{kernel} {name}: {what} of dead rows is "
                                 "not zero")
        errs[what], sh = _within(kernel, name, what, a[keep], b[keep], tol)
        share = max(share, sh)
    say("kernel", kernel=kernel, case=name, tol_rel_to_max=tol,
        **{f"max_abs_err_{k}": f"{v:.3e}" for k, v in errs.items()},
        share_of_limit=f"{share:.3f}")
    return max(errs.values())


def phase_kernel_rungs(dev, batch):
    """Kernels 3, 4, 1 and 2 on small seeded edge cases (head widths 8, 64
    and 96; interior padding, an all-masked row, empty rows, the dummy
    row's tail, a dropout scale) and at the flagship conv shapes of a
    packed training batch, f32 and bf16 → {kernel: {(conv, dtype): (case,
    err)}}."""
    import torch
    rng = np.random.default_rng(SEED + 30)
    flagship = {k: {} for k in ("attn_fwd", "attn_bwd",
                                "softmax_aggregate_fwd",
                                "softmax_aggregate_bwd")}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        tag = "float32" if dtype == torch.float32 else "bfloat16"
        small = [
            ("small_ch8", eproj_case(
                rng, n=40, heads=2, hidden=16, fe=16,
                degs=rng.integers(0, 7, 40), dtype=dtype, device=dev,
                interior_pad=0.2, dead_rows=(3,), scale=True)),
            ("long_rows_ch64", eproj_case(
                rng, n=24, heads=4, hidden=256, fe=16,
                degs=rng.integers(10, 60, 24), dtype=dtype, device=dev,
                interior_pad=0.1, dead_rows=(5,), scale=True)),
            ("ch96", eproj_case(
                rng, n=16, heads=2, hidden=192, fe=16,
                degs=rng.integers(1, 20, 16), dtype=dtype, device=dev,
                interior_pad=0.1, scale=True))]
        for which in ("lg", "atom"):
            small.append((f"{which}_conv", batch_case(
                rng, batch, which, hidden=256, dtype=dtype, device=dev)))
        for name, case in small:
            a, g = attn_inputs(case), agg_inputs(rng, case)
            err = {"attn_fwd": check_rung_fwd("attn_fwd", f"{name}_{tag}", a,
                                              tol),
                   "attn_bwd": check_rung_bwd("attn_bwd", f"{name}_{tag}", a,
                                              tol),
                   "softmax_aggregate_fwd": check_rung_fwd(
                       "softmax_aggregate_fwd", f"{name}_{tag}", g, tol),
                   "softmax_aggregate_bwd": check_rung_bwd(
                       "softmax_aggregate_bwd", f"{name}_{tag}", g, tol)}
            if name.endswith("_conv"):
                which = name[:-len("_conv")]
                for k, e in err.items():
                    c = a if k.startswith("attn") else g
                    flagship[k][(which, tag)] = (c, e)
    return flagship


# --------------------------------------------------------------- phase 4
def write_fixture(root: Path):
    """256 synthetic graphs and a 5-member flagship ensemble on disk."""
    from gnnep_tpu_torch.data.store import GraphStore, save_sample, write_index
    from gnnep_tpu_torch.data.transforms import FeatureScaler, LogTransformer
    from gnnep_tpu_torch.models.alignn import init_alignn
    from gnnep_tpu_torch.train.artifacts import save_member, save_scaler_state
    from gnnep_tpu_torch.utils.synth import flagship_config, synthetic_samples

    data, ens = root / "data", root / "ensemble"
    ens.mkdir(parents=True)
    samples = synthetic_samples(np.random.default_rng(SEED), N_GRAPHS)
    for s in samples:
        save_sample(data, s)
    store = GraphStore.from_samples(samples)
    write_index(data, store)
    cfg = flagship_config()
    for i in range(MEMBERS):
        save_member(ens / f"model_{i}.npz",
                    init_alignn(np.random.default_rng(SEED + 1 + i), cfg))
    save_scaler_state(ens / "scaler_state.npz",
                      FeatureScaler.fit(store, range(store.n_graphs)),
                      LogTransformer.fit(store.y),
                      dims={"global_scalar_dim": 59})
    return data, ens, cfg


def write_rung_ensemble(root: Path, ens: Path, cfg, rung: str) -> Path:
    """A RUNG_MEMBERS-member flagship ensemble whose members' configs select
    `rung` (with `conv_impl='fused'`), beside the default one and with its
    scaler state."""
    from gnnep_tpu_torch.models.alignn import init_alignn
    from gnnep_tpu_torch.train.artifacts import save_member
    out = root / f"ensemble_{rung}"
    out.mkdir()
    rcfg = dataclasses.replace(cfg, conv_impl="fused", **RUNGS[rung]["cfg"])
    for i in range(RUNG_MEMBERS):
        save_member(out / f"model_{i}.npz",
                    init_alignn(np.random.default_rng(SEED + 1 + i), rcfg))
    (out / "scaler_state.npz").write_bytes(
        (ens / "scaler_state.npz").read_bytes())
    return out


def serve_argv(root: Path, data: Path, ens: Path, dtype: str,
               tag: str = "") -> list:
    """The CLI request each serving run makes."""
    return ["--mode", "random", "--num-samples", str(N_GRAPHS),
            "--batch-size", str(BATCH), "--data-dir", str(data),
            "--ensemble-dir", str(ens), "--compute-dtype", dtype,
            "--output-json", str(root / f"pred{tag}_{dtype}.json")]


def served_batches(argv: list, dev):
    """The batches the CLI serves for `argv`, chosen and packed by the CLI's
    and the ensemble's own functions."""
    from gnnep_tpu_torch.cli import predict as cli
    from gnnep_tpu_torch.infer.predict import Ensemble, pack_batches
    args = cli.build_parser().parse_args(argv)
    store, idx = cli.select_graphs(
        args, Ensemble.load(args.ensemble_dir, device=dev))
    return pack_batches(store, idx, args.batch_size)[1]


def phase_serve(root: Path, data: Path, ens: Path, cfg, batches, dev, *,
                members: int = MEMBERS, kernel: str = "attn_eproj_fwd",
                tag: str = ""):
    """Serves the request in f32 and bf16 from the ensemble in `ens`, whose
    members' convs run the forward kernel `kernel`, and no other kernel;
    returns each run's launches of it."""
    import torch
    from gnnep_tpu_torch.cli import predict as cli
    from gnnep_tpu_torch.train.artifacts import load_member
    from gnnep_tpu_torch.train.loop import make_forward
    from gnnep_tpu_torch.models.alignn import DeviceBatch

    expected = members * len(batches) * 2 * cfg.layers
    launches = {}
    for dtype in ("float32", "bfloat16"):
        argv = serve_argv(root, data, ens, dtype, tag)
        out = Path(argv[-1])
        t0 = time.perf_counter()
        # the CLI's per-material table goes to a file, not this output
        with open(root / f"cli{tag}_{dtype}.txt", "w") as log, \
                contextlib.redirect_stdout(log):
            reset_counts()
            cli.main(argv)
            counts = read_counts()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        grew = counts.pop(kernel)
        if grew != expected:
            raise AssertionError(
                f"{dtype}: {kernel} launched {grew} times, expected "
                f"{members} members x {len(batches)} batches x 2 convs x "
                f"{cfg.layers} layers = {expected}")
        if any(counts.values()):
            raise AssertionError(f"{dtype}: serving with {kernel} also "
                                 f"launched {counts}")
        preds = json.loads(out.read_text())["predictions"]
        mu = np.asarray([p["mu"] for p in preds], np.float64)
        sigma = np.asarray([p["sigma"] for p in preds], np.float64)
        if len(preds) != N_GRAPHS or not (np.isfinite(mu).all()
                                          and np.isfinite(sigma).all()
                                          and (sigma > 0).all()):
            raise AssertionError(f"{dtype}: {len(preds)} predictions, or "
                                 "non-finite mu/sigma, or sigma <= 0")
        launches[dtype] = grew
        say("serve", rung=tag.strip("_") or "eproj", dtype=dtype,
            graphs=len(preds), batches=len(batches), members=members,
            kernel=kernel, kernel_launches=grew, cli_seconds=f"{secs:.2f}",
            mu_mean=f"{mu.mean():.4f}", sigma_mean=f"{sigma.mean():.4f}")
    # member 0, first batch: the card's f32 means against the CPU's plain
    # forward of the same checkpoint
    fwd = make_forward()
    m_gpu = load_member(ens / "model_0.npz", dev)
    m_cpu = load_member(ens / "model_0.npz", "cpu")
    g_mean, _ = fwd(m_gpu, DeviceBatch.from_batch(batches[0], dev))
    c_mean, _ = fwd(m_cpu, DeviceBatch.from_batch(batches[0], "cpu"))
    g_mean = g_mean.cpu()
    if not torch.allclose(g_mean, c_mean, rtol=1e-3, atol=1e-4):
        raise AssertionError("member 0 means on the card differ from the CPU "
                             "plain forward by "
                             f"{(g_mean - c_mean).abs().max().item():.3e}")
    say("serve", rung=tag.strip("_") or "eproj",
        check="member0_batch0_gpu_vs_cpu", rtol=1e-3, atol=1e-4,
        max_abs_err=f"{(g_mean - c_mean).abs().max().item():.3e}")
    return launches


# --------------------------------------------------------------- phase 5
TRAIN_MEMBERS, TRAIN_EPOCHS, TRAIN_SCAN = 2, 3, 2


def train_argv(data: Path, out: Path, dtype: str, members: int,
               epochs: int) -> list:
    """The CLI request of a training run: flagship width (the CLI's
    defaults: hidden 256, 4 layers, 4 heads) on the fixture's graphs."""
    return ["--data-dir", str(data), "--save-dir", str(out),
            "--conv-impl", "fused", "--ensemble-size", str(members),
            "--epochs", str(epochs), "--batch-size", str(BATCH),
            "--compute-dtype", dtype, "--scan-steps", str(TRAIN_SCAN),
            "--seed", str(SEED), "--quiet"]


def training_setup(data: Path, root: Path):
    """The trainer's own setup and packed training batches for the f32
    request: the standardized store, transformer and budget that
    `cli.train` derives."""
    from gnnep_tpu_torch.cli import train as cli
    from gnnep_tpu_torch.data.batching import epoch_batches
    from gnnep_tpu_torch.train.ensemble import prepare
    args = cli.build_parser().parse_args(train_argv(
        data, root / "unused", "float32", TRAIN_MEMBERS, TRAIN_EPOCHS))
    setup = prepare(cli.config_from_args(args))
    return setup, epoch_batches(setup.store, setup.train_idx, setup.budget,
                                shuffle=False)


def run_counted(fn):
    """Run `fn` with every kernel's launch count set to 0 just before and
    read just after → (fn's result, {kernel: launches}, per-step losses,
    {"train": forwards, "eval": forwards}). The train step is wrapped to
    keep each step's loss on the device (no extra synchronisation), and the
    model's trunk to count its train and eval forwards; both wrappers are
    removed afterwards."""
    from gnnep_tpu_torch.models import alignn as pm
    from gnnep_tpu_torch.train import loop
    losses = []
    forwards = {"train": 0, "eval": 0}
    orig, orig_trunk = loop.TrainStep.__call__, pm._shared_trunk

    def recording(self, *a, **k):
        m = orig(self, *a, **k)
        losses.append(m.loss_sum.detach())
        return m

    def counting_trunk(*a, **k):
        forwards["train" if k.get("train") else "eval"] += 1
        return orig_trunk(*a, **k)

    loop.TrainStep.__call__ = recording
    pm._shared_trunk = counting_trunk
    try:
        reset_counts()
        out = fn()
        counts = read_counts()
    finally:
        loop.TrainStep.__call__ = orig
        pm._shared_trunk = orig_trunk
    return out, counts, losses, forwards


def phase_train(root: Path, data: Path, layers: int):
    """Trains through the CLI in f32 and bf16, then serves the f32
    ensemble; returns each run's launches and steps."""
    import torch
    from gnnep_tpu_torch.cli import predict as cli_predict
    from gnnep_tpu_torch.cli import train as cli_train
    runs = {}
    for dtype, members, epochs in (("float32", TRAIN_MEMBERS, TRAIN_EPOCHS),
                                   ("bfloat16", 1, 1)):
        out = root / f"trained_{dtype}"
        t0 = time.perf_counter()
        with open(root / f"train_{dtype}.txt", "w") as log, \
                contextlib.redirect_stdout(log):
            summary, counts, losses, _ = run_counted(
                lambda: cli_train.main(train_argv(data, out, dtype, members,
                                                  epochs)))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        steps = summary["optimizer_steps"]
        loss = torch.stack(losses).cpu().numpy() if losses else np.zeros(0)
        if steps <= 0 or len(loss) != steps or not np.isfinite(loss).all():
            raise AssertionError(f"{dtype}: {steps} optimizer steps "
                                 f"reported, {len(loss)} losses recorded, "
                                 f"finite: {np.isfinite(loss).all()}")
        want = 2 * layers * steps
        for name in ("attn_eproj_bwd", "csr_segment_sum"):
            if counts[name] != want:
                raise AssertionError(
                    f"{dtype}: {name} launched {counts[name]} times, "
                    f"expected 2 convs x {layers} layers x {steps} steps = "
                    f"{want}")
        if counts["attn_eproj_fwd"] < want:
            raise AssertionError(f"{dtype}: attn_eproj_fwd launched "
                                 f"{counts['attn_eproj_fwd']} times, fewer "
                                 f"than the {want} of the train steps")
        for name in ("model_0.npz", "scaler_state.npz", "conformal.json",
                     "train_summary.json"):
            if not (out / name).exists():
                raise AssertionError(f"{dtype}: {name} not written")
        runs[dtype] = dict(counts=counts, steps=steps, seconds=secs,
                           summary=summary)
        say("train", dtype=dtype, members=members, epochs=epochs,
            optimizer_steps=steps, kernel_launches=json.dumps(counts),
            loss_sum_first=f"{loss[0]:.4f}", loss_sum_last=f"{loss[-1]:.4f}",
            test_mae=f"{summary['test_stats']['overall']['mae']:.3f}",
            coverage=f"{summary['conformal_coverage']['overall']:.3f}",
            cli_seconds=f"{secs:.2f}")
    # the written f32 ensemble serves through the predict CLI
    pred = root / "pred_trained.json"
    with open(root / "cli_trained.txt", "w") as log, \
            contextlib.redirect_stdout(log):
        cli_predict.main(["--mode", "random", "--num-samples", str(BATCH),
                          "--batch-size", str(BATCH), "--data-dir",
                          str(data), "--ensemble-dir",
                          str(root / "trained_float32"),
                          "--output-json", str(pred)])
    preds = json.loads(pred.read_text())["predictions"]
    mu = np.asarray([p["mu"] for p in preds], np.float64)
    sigma = np.asarray([p["sigma"] for p in preds], np.float64)
    if len(preds) != BATCH or not (np.isfinite(mu).all()
                                   and np.isfinite(sigma).all()
                                   and (sigma > 0).all()):
        raise AssertionError("the trained ensemble served non-finite or "
                             "missing predictions")
    say("train", served=len(preds), members=TRAIN_MEMBERS,
        mu_mean=f"{mu.mean():.4f}", sigma_mean=f"{sigma.mean():.4f}")
    return runs


def phase_train_rung(root: Path, data: Path, layers: int, rung: str):
    """Trains one member for one epoch in f32 through the CLI on `rung`:
    every loss finite; per optimizer step the rung's backward kernel
    2·layers times and kernel 7 2·layers times per gather (kv, and q on the
    external-logits rung); the rung's forward kernel 2·layers times per
    train and eval forward (the trainer's steps and its validation,
    calibration and test batches, counted apart); kernels 5 and 6 never."""
    import torch
    from gnnep_tpu_torch.cli import train as cli_train
    spec = RUNGS[rung]
    out = root / f"trained_{rung}"
    t0 = time.perf_counter()
    with open(root / f"train_{rung}.txt", "w") as log, \
            contextlib.redirect_stdout(log):
        summary, counts, losses, forwards = run_counted(
            lambda: cli_train.main(train_argv(data, out, "float32", 1, 1)
                                   + [spec["flag"]]))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    steps = summary["optimizer_steps"]
    loss = torch.stack(losses).cpu().numpy() if losses else np.zeros(0)
    if steps <= 0 or len(loss) != steps or not np.isfinite(loss).all():
        raise AssertionError(f"{rung}: {steps} optimizer steps reported, "
                             f"{len(loss)} losses recorded, finite: "
                             f"{np.isfinite(loss).all()}")
    if forwards["train"] != steps:
        raise AssertionError(f"{rung}: {forwards['train']} train forwards "
                             f"for {steps} optimizer steps")
    want = {spec["bwd"]: 2 * layers * steps,
            "csr_segment_sum": 2 * spec["gathers"] * layers * steps,
            spec["fwd"]: 2 * layers * (forwards["train"] + forwards["eval"])}
    for name, n in counts.items():
        if n != want.get(name, 0):
            raise AssertionError(
                f"{rung}: {name} launched {n} times, expected "
                f"{want.get(name, 0)} ({steps} steps, {forwards['eval']} "
                f"eval forwards, {layers} layers)")
    say("train", rung=rung, flag=spec["flag"], dtype="float32", members=1,
        epochs=1, optimizer_steps=steps, eval_forwards=forwards["eval"],
        kernel_launches=json.dumps(counts), loss_sum_first=f"{loss[0]:.4f}",
        loss_sum_last=f"{loss[-1]:.4f}", cli_seconds=f"{secs:.2f}")
    return dict(counts=counts, steps=steps, eval_forwards=forwards["eval"],
                seconds=secs)


# --------------------------------------------------------------- phase 6
# the step's two LR groups differ, so that an update taken at the other
# group's LR shows
CHECK_LR_MEAN, CHECK_LR_SIGMA = 1e-3, 5e-4


def _leaf_err(a, b, floor: float):
    """(max |a − b|, max |b|, allowed): the leaf's largest difference, its
    largest reference magnitude, and 5e-3 of that magnitude plus `floor`."""
    err = (a - b).abs().max().item() if b.numel() else 0.0
    scale = b.abs().max().item() if b.numel() else 0.0
    return err, scale, 5e-3 * scale + floor


def phase_check(setup, batches, dev, rung: str = "eproj"):
    """One train step on the card against the CPU plain step from the same
    parameters and batch, dropout and jitter off, at LRs 1e-3 / 5e-4, on
    `rung` (the card step launches that rung's forward and backward kernel
    2·layers times each):
    - StepMetrics and every gradient element at rtol 5e-3 / atol 1e-4 (the
      JAX package's model gradient tolerance), and each leaf's gradient and
      Adam first moment within 5e-3 of that leaf's largest magnitude (plus
      1e-5 and 1e-6: the noise of a theoretically zero gradient);
    - each leaf's update p_new − p_old within 1e-2 of that leaf's largest
      update (about the LR), leaving out only the elements whose clipped
      gradient is about zero, where the two sides' difference could flip
      Adam's first step or move it by a tenth of the limit; at most 10% of
      them. A skipped
      update, a flipped sign or the other group's LR is off by at least
      half an update."""
    import torch
    from gnnep_tpu_torch.models.alignn import DeviceBatch, init_alignn
    from gnnep_tpu_torch.train.loop import (ADAM_B1, ADAM_EPS, TrainHyper,
                                            make_train_step)
    from gnnep_tpu_torch.utils.synth import flagship_config
    rtol, atol = 5e-3, 1e-4
    store = setup.store
    spec = RUNGS.get(rung, dict(cfg={}, fwd="attn_eproj_fwd",
                                bwd="attn_eproj_bwd"))
    cfg = flagship_config(node_dim=store.node_dim, edge_dim=store.edge_dim,
                          angle_dim=store.angle_dim,
                          global_dim=store.global_scalar_dim + 230,
                          dropout=0.0, **spec["cfg"])
    hyper = TrainHyper(feature_jitter_std=0.0)
    t = setup.transformer
    steps, metrics, before = {}, {}, {}
    for where in ("cuda", "cpu"):
        model = init_alignn(np.random.default_rng(SEED + 99), cfg)
        step = make_train_step(model, hyper, t.means, t.stds,
                               dev if where == "cuda" else "cpu")
        before[where] = [p.detach().cpu().clone() for p in step.params]
        reset_counts()
        m = step(DeviceBatch.from_batch(batches[0], step.params[0].device),
                 None, CHECK_LR_MEAN, CHECK_LR_SIGMA)
        metrics[where] = [float(x) for x in m]
        steps[where] = step
        if where == "cuda":
            counts = read_counts()
            if (counts[spec["fwd"]], counts[spec["bwd"]]) != (
                    2 * cfg.layers, 2 * cfg.layers):
                raise AssertionError(f"train step check on {rung}: launches "
                                     f"{counts}")
    if not all(torch.equal(a, b) for a, b in zip(before["cuda"],
                                                 before["cpu"])):
        raise AssertionError("train step check: the two models start from "
                             "different parameters")
    worst_metric = 0.0
    for name, a, b in zip(("loss_sum", "n_graphs", "abs_err_sum",
                           "sq_err_sum", "n_elements", "logvar_sum",
                           "max_var"), metrics["cuda"], metrics["cpu"]):
        if not np.isfinite(a) or abs(a - b) > atol + rtol * abs(b):
            raise AssertionError(f"train step {name}: card {a} vs CPU {b}")
        worst_metric = max(worst_metric, abs(a - b))
    names = [n for n, _ in steps["cpu"].model.named_parameters()]
    card, ref = steps["cuda"], steps["cpu"]
    # per kind: (leaf, err, leaf scale, err / limit) of the leaf nearest
    # its limit
    worst = {k: ("", 0.0, 0.0, 0.0) for k in ("grad", "mu", "update")}
    left_out = left_sign = total = 0
    for i, name in enumerate(names):
        gc = card.params[i].grad.detach().cpu().float()
        gr = ref.params[i].grad.detach().float()
        if not torch.allclose(gc, gr, rtol=rtol, atol=atol):
            raise AssertionError(f"train step grad of {name}: card vs CPU "
                                 f"differ by {(gc - gr).abs().max():.3e}")
        checks = {
            "grad": _leaf_err(gc, gr, 1e-5),
            "mu": _leaf_err(card.state.mu[i].detach().cpu(),
                            ref.state.mu[i].detach(), 1e-6)}
        uc = card.params[i].detach().cpu().float() - before["cuda"][i].float()
        ur = ref.params[i].detach().float() - before["cpu"][i].float()
        # the clipped gradients Adam took in, from its first moments. Its
        # first step is g / (|g| + eps): an element is left out where the
        # two sides' difference d could flip its sign (|g| <= 4d) or move it
        # by more than a tenth of the limit (d·eps / g² > 1e-3); one of
        # exactly zero on both sides leaves only the decay
        kc = card.state.mu[i].detach().cpu() / (1.0 - ADAM_B1)
        kr = ref.state.mu[i].detach() / (1.0 - ADAM_B1)
        d = (kc - kr).abs()
        sign_open = kr.abs() <= 4.0 * d
        moved = d * ADAM_EPS > 1e-3 * kr * kr
        keep = ~(sign_open | moved) | ((kr == 0) & (kc == 0))
        left_out += int((~keep).sum())
        left_sign += int((sign_open & ~keep).sum())
        total += keep.numel()
        err = (uc - ur)[keep].abs().max().item() if keep.any() else 0.0
        scale = ur.abs().max().item()
        checks["update"] = (err, scale, 1e-2 * scale)
        for kind, (e, leaf_scale, lim) in checks.items():
            if e > lim:
                raise AssertionError(
                    f"train step {kind} of {name}: card vs CPU differ by "
                    f"{e:.3e}, above {lim:.3e} (leaf scale {leaf_scale:.3e})")
            share = e / lim if lim > 0 else 0.0
            if share >= worst[kind][3]:
                worst[kind] = (name, e, leaf_scale, share)
    if left_out > 0.1 * total:
        raise AssertionError(f"train step update: {left_out} of {total} "
                             "elements have a gradient of about zero")
    say("check", rung=rung, what="train_step_card_vs_cpu", rtol=rtol,
        atol=atol, lr_mean=CHECK_LR_MEAN, lr_sigma=CHECK_LR_SIGMA,
        leaves=len(names),
        loss_sum=f"{metrics['cuda'][0]:.6f}",
        max_abs_err_metric=f"{worst_metric:.3e}",
        update_elements_left_out=f"{left_out}/{total}",
        of_them_sign_open=left_sign)
    for kind, (name, e, leaf_scale, share) in worst.items():
        say("check", rung=rung, kind=kind, nearest_limit_leaf=name,
            max_abs_err=f"{e:.3e}", leaf_scale=f"{leaf_scale:.3e}",
            share_of_limit=f"{share:.3f}")


# --------------------------------------------------------------- phase 7
def eproj_bound_ms(case):
    """Least time for the kernel's work on this card → (ms, 'bytes' or
    'operations'): the larger of its bytes over the memory rate and its
    operations over the peak rate of their type. Both count what this run's
    data needs: the edge rows of kv, ea and scale_t are read once for each
    live edge (masked rows, the tail padding among them, do not enter the
    output), mask2, row_ptr, q and W_e once in full, and each output is
    written once."""
    q, ea, w = case["q"], case["ea"], case["w_edge"]
    n, hidden = q.shape
    fe = ea.shape[1]
    heads = case["heads"]
    item = q.element_size()
    live = int((case["mask2"] > 0).sum().item())
    nbytes = (item * (q.numel() + live * (2 * hidden + fe) + w.numel())
              + 4 * (live * heads + case["mask2"].numel()
                     + case["row_ptr"].numel())
              + 4 * (n * hidden + 2 * n * heads))
    # projection, q·k, α·v; the softmax's few operations per (edge, head)
    ops = 2 * live * fe * hidden + 4 * live * hidden + 6 * live * heads
    dtype = "bfloat16" if item == 2 else "float32"
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def phase_times(flagship, batches, ens, dev):
    from gnnep_tpu_torch.models.alignn import DeviceBatch
    from gnnep_tpu_torch.ops.cuda import attention_eproj as ep
    from gnnep_tpu_torch.train.artifacts import load_member
    from gnnep_tpu_torch.train.loop import cast_model, make_forward

    def fwd_args(c):
        return (c["q"], c["kv"], c["ea"], c["w_edge"], c["scale_t"],
                c["mask2"])

    cases = kernel_times(
        "attn_eproj_fwd", flagship,
        lambda c: ep.attention_eproj_cuda(*fwd_args(c), c["row_ptr"],
                                          c["dst"], heads=c["heads"]),
        lambda c: ep.attention_eproj_plain(*fwd_args(c), c["dst"],
                                           heads=c["heads"]),
        eproj_bound_ms)
    model = load_member(ens / "model_0.npz", dev)
    dbs = [DeviceBatch.from_batch(b, dev) for b in batches]
    real = [int(np.asarray(b.graph_mask).sum()) for b in batches]
    for dtype in ("float32", "bfloat16"):
        fwd = make_forward(compute_dtype=dtype)
        run = cast_model(model, dtype)
        state = {"i": 0}

        def one():
            fwd(run, dbs[state["i"] % len(dbs)])
            state["i"] += 1

        ms = median_ms(one)
        say("times", forward=dtype, ms_per_batch=f"{ms:.3f}",
            graphs_per_batch=f"{np.mean(real):.1f}",
            graphs_per_s=f"{np.mean(real) / ms * 1e3:.0f}")
        profile_run(lambda: [fwd(run, db) for db in dbs], "forward", dtype,
                    len(dbs))
    return cases


def eproj_bwd_bound_ms(case):
    """Least time for kernel 6's work → (ms, 'bytes' or 'operations'). Bytes:
    the live edges' rows of kv, ea and scale_t, q, g, W_e, the stats, mask2
    and row_ptr read once; dq, dkv, dea (every row) and dW_e written once.
    Operations: the projection recompute, dea and dW_e (2·live·Fe·H each),
    q·k, g·v, dq, dk, dv and de per live edge and channel, and the softmax
    gradient's few per (edge, head)."""
    q, ea, w = case["q"], case["ea"], case["w_edge"]
    n, hidden = q.shape
    fe = ea.shape[1]
    heads = case["heads"]
    e_total = case["kv"].shape[0]
    item = q.element_size()
    live = int(((case["mask2"] > 0) & (case["dst"] != n - 1)).sum().item())
    nbytes = (item * (q.numel() + live * (2 * hidden + fe) + w.numel())
              + 4 * (live * heads + case["mask2"].numel()
                     + case["row_ptr"].numel())
              + 4 * (n * hidden + 2 * n * heads)
              + item * (n * hidden + e_total * (2 * hidden + fe))
              + 4 * fe * hidden)
    ops = 6 * live * fe * hidden + 12 * live * hidden + 10 * live * heads
    dtype = "bfloat16" if item == 2 else "float32"
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def segsum_bound_ms(case):
    """Least time for kernel 7's work: every row the result needs (those
    before the dummy row's last segment, whose sum is unspecified) and its
    order entry (none for the identity order) read once, the starts read
    once, the f32 output written once; one f32 add per element read."""
    v = case["values"]
    width = v.shape[1]
    n = case["starts"].shape[0]
    rows = int(case["starts"][-1].item())
    orders = rows if case["order"] is not None else 0
    nbytes = (v.element_size() * rows * width + 4 * (orders + n)
              + 4 * n * width)
    ops = rows * width
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS["float32"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def _bound_ms(nbytes: float, ops: float, item: int):
    """(ms, 'bytes' or 'operations'): the larger of the bytes over the
    memory rate and the operations over the peak rate of the input type."""
    dtype = "bfloat16" if item == 2 else "float32"
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def attn_bound_ms(c):
    """Kernel 3: q, the live edges' rows of k, v and scale_t, mask2 and
    row_ptr read once; out and the stats written once. Operations: q·k and
    α·v per live edge and channel, the softmax's few per (edge, head)."""
    n, hidden = c["q"].shape
    heads, item = c["heads"], c["q"].element_size()
    live = int((c["mask2"] > 0).sum().item())
    nbytes = (item * (n * hidden + 2 * live * hidden)
              + 4 * (live * heads + c["mask2"].numel() + n + 1)
              + 4 * (n * hidden + 2 * n * heads))
    return _bound_ms(nbytes, 4 * live * hidden + 6 * live * heads, item)


def attn_bwd_bound_ms(c):
    """Kernel 4: q, g, the stats, the live edges' rows of k, v and scale_t,
    mask2 and row_ptr read once; dq and every row of dk and dv written once.
    Operations: q·k, g·v, dq, dk and dv per live edge and channel, the
    softmax gradient's few per (edge, head)."""
    n, hidden = c["q"].shape
    heads, item = c["heads"], c["q"].element_size()
    e_total = c["k"].shape[0]
    live = int(((c["mask2"] > 0) & (c["dst"] != n - 1)).sum().item())
    nbytes = (item * (2 * n * hidden + 2 * live * hidden
                      + 2 * e_total * hidden)
              + 4 * (n * hidden + 2 * n * heads + live * heads + e_total
                     + n + 1))
    return _bound_ms(nbytes, 10 * live * hidden + 10 * live * heads, item)


def agg_bound_ms(c):
    """Kernel 1: every logit (they carry the mask), the live edges' rows of
    v and scale_t, and row_ptr read once; out and the stats written once.
    Operations: α·v per live edge and channel, the softmax's few per (edge,
    head)."""
    heads, e_total = c["logits_t"].shape
    n, hidden, item = c["n"], c["v"].shape[1], c["v"].element_size()
    live = int((c["mask2"] > 0).sum().item())
    nbytes = (item * live * hidden
              + 4 * (heads * e_total + live * heads + n + 1)
              + 4 * (n * hidden + 2 * n * heads))
    return _bound_ms(nbytes, 2 * live * hidden + 6 * live * heads, item)


def agg_bwd_bound_ms(c):
    """Kernel 2: every logit, the live edges' rows of v and scale_t, g, the
    stats and row_ptr read once; every column of dl_t and row of dv written
    once. Operations: g·v and dv per live edge and channel, the softmax
    gradient's few per (edge, head)."""
    heads, e_total = c["logits_t"].shape
    n, hidden, item = c["n"], c["v"].shape[1], c["v"].element_size()
    live = int(((c["mask2"] > 0) & (c["dst"] != n - 1)).sum().item())
    nbytes = (item * (live * hidden + e_total * hidden)
              + 4 * (2 * heads * e_total + live * heads + n * hidden
                     + 2 * n * heads + n + 1))
    return _bound_ms(nbytes, 3 * live * hidden + 10 * live * heads, item)


def phase_rung_times(rung_flag):
    """Kernels 3, 4, 1 and 2 at the flagship conv shapes → {kernel: cases}."""
    from gnnep_tpu_torch.ops.cuda import aggregate as ag
    from gnnep_tpu_torch.ops.cuda import attention as at
    out = {}
    out["attn_fwd"] = kernel_times(
        "attn_fwd", rung_flag["attn_fwd"],
        lambda c: at.attention_cuda(*attn_fwd_args(c), c["row_ptr"],
                                    heads=c["heads"]),
        lambda c: at.attention_plain(*attn_fwd_args(c), c["dst"],
                                     heads=c["heads"]),
        attn_bound_ms)
    out["softmax_aggregate_fwd"] = kernel_times(
        "softmax_aggregate_fwd", rung_flag["softmax_aggregate_fwd"],
        lambda c: ag.aggregate_cuda(*agg_fwd_args(c), heads=c["heads"]),
        lambda c: ag.aggregate_plain(*agg_fwd_args(c), c["dst"],
                                     heads=c["heads"]),
        agg_bound_ms)
    for kernel, bound in (("attn_bwd", attn_bwd_bound_ms),
                          ("softmax_aggregate_bwd", agg_bwd_bound_ms)):
        args = {id(c): rung_bwd_inputs(kernel, c)
                for c, _ in rung_flag[kernel].values()}
        cuda = (at.attention_bwd_cuda if kernel == "attn_bwd"
                else ag.aggregate_bwd_cuda)
        out[kernel] = kernel_times(
            kernel, rung_flag[kernel],
            lambda c, cuda=cuda: cuda(*args[id(c)], heads=c["heads"]),
            lambda c, kernel=kernel: run_bwd_plain(kernel, c, args[id(c)]),
            bound)
    return out


def kernel_times(name, flagship, run_kernel, run_plain, bound_fn,
                 library=None):
    """Device ms per launch, wall ms per call with host work, plain ms and
    bound of one kernel at each flagship case; `library(case)`, where given,
    is one PyTorch call computing the same function, timed beside it."""
    cases = []
    for (which, dtype), (case, err) in flagship.items():
        kern_ms = device_ms(lambda: run_kernel(case))
        call_ms = median_ms(lambda: run_kernel(case))
        plain_ms = device_ms(lambda: run_plain(case))
        lib_ms = device_ms(lambda: library(case)) if library else None
        bound, bound_by = bound_fn(case)
        cases.append({"conv": which, "dtype": dtype, "ms": kern_ms,
                      "call_ms": call_ms, "plain_ms": plain_ms,
                      "bound_ms": bound, "bound_by": bound_by,
                      "library_ms": lib_ms, "max_abs_err": err})
        say("times", kernel=name, conv=which, dtype=dtype,
            ms=f"{kern_ms:.4f}", call_ms_with_host=f"{call_ms:.4f}",
            bound_ms=f"{bound:.4f}", bound_by=bound_by,
            plain_ms_no_yardstick=f"{plain_ms:.4f}",
            library_ms=("none (no single PyTorch call computes this "
                        "function)" if lib_ms is None else f"{lib_ms:.4f}"))
    return cases


def phase_train_times(bwd_flag, seg_flag, setup, batches, dev):
    """Kernels 6 and 7 at the flagship shapes, then the train step's wall
    time per step (batches already on the card) and its profile."""
    import torch
    from gnnep_tpu_torch.models.alignn import DeviceBatch, init_alignn
    from gnnep_tpu_torch.ops.cuda import attention_eproj as ep
    from gnnep_tpu_torch.ops.cuda import segment_sum as ss
    from gnnep_tpu_torch.train.loop import TrainHyper, make_train_step
    from gnnep_tpu_torch.utils.synth import flagship_config

    bwd_args = {id(case): bwd_inputs(case) for case, _ in bwd_flag.values()}
    bwd = kernel_times(
        "attn_eproj_bwd", bwd_flag,
        lambda c: ep.attention_eproj_bwd_cuda(*bwd_args[id(c)],
                                              heads=c["heads"]),
        lambda c: ep.attention_eproj_bwd_plain(*bwd_args[id(c)],
                                               heads=c["heads"]),
        eproj_bwd_bound_ms)

    def seg_args(c):
        return c["values"], c["order"], c["starts"]

    def index_add(c):
        # the whole kv-gather backward as one library call: scatter-add of
        # the cotangent rows by source index
        v = c["values"]
        return torch.zeros((c["starts"].shape[0], v.shape[1]), dtype=v.dtype,
                           device=v.device).index_add_(0, c["src"], v)

    seg = kernel_times(
        "csr_segment_sum", seg_flag,
        lambda c: ss.csr_segment_sum_cuda(*seg_args(c)),
        lambda c: ss.csr_segment_sum_plain(*seg_args(c)), segsum_bound_ms,
        library=index_add)

    store = setup.store
    # full batches only: an epoch's short last batch is not the step that
    # sets throughput
    full = [b for b in batches
            if int(np.asarray(b.graph_mask).sum()) == BATCH]
    dbs = [DeviceBatch.from_batch(b, dev) for b in full]
    real = [BATCH] * len(full)
    steps = {}
    for rung in ("eproj", *RUNGS):
        cfg = flagship_config(node_dim=store.node_dim,
                              edge_dim=store.edge_dim,
                              angle_dim=store.angle_dim,
                              global_dim=store.global_scalar_dim + 230,
                              **RUNGS.get(rung, {"cfg": {}})["cfg"])
        steps[rung] = {}
        for dtype in ("float32", "bfloat16"):
            step = make_train_step(
                init_alignn(np.random.default_rng(SEED + 7), cfg),
                TrainHyper(compute_dtype=dtype), setup.transformer.means,
                setup.transformer.stds, dev)
            gen = torch.Generator(device=dev)
            gen.manual_seed(SEED)
            state = {"i": 0}

            def one():
                step(dbs[state["i"] % len(dbs)], gen, 1e-4, 1e-4)
                state["i"] += 1

            torch.cuda.reset_peak_memory_stats(dev)
            ms = median_ms(one)
            rec = {"ms_per_step": ms,
                   "graphs_per_s": float(np.mean(real) / ms * 1e3)}
            say("times", rung=rung, train_step=dtype, ms_per_step=f"{ms:.3f}",
                graphs_per_step=f"{np.mean(real):.1f}",
                graphs_per_s=f"{np.mean(real) / ms * 1e3:.0f}",
                peak_mem_gb=f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f}")
            rec["busy_share"], rec["device_ms_per_step"] = profile_run(
                lambda: [step(db, gen, 1e-4, 1e-4) for db in dbs],
                f"train_step_{rung}", dtype, len(dbs))
            steps[rung][dtype] = rec
    return bwd, seg, steps


def profile_run(run_all, label: str, dtype: str, n_calls: int):
    """Device time by kernel over one pass of `run_all` (n_calls forwards
    or train steps), from torch.profiler: the device's busy share of the
    traced wall time (the tracer's own host cost inflates the wall time, so
    this share is a lower bound) and the kernels that take the most of it.
    Returns (busy share, device ms per call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run_all()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_all()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # the kernels themselves (device-side events); host ops would count
    # their kernels' time a second time
    events = sorted((e for e in prof.key_averages()
                     if str(getattr(e, "device_type", "")).endswith("CUDA")),
                    key=dev_us, reverse=True)
    busy_us = sum(dev_us(e) for e in events)
    say("profile", run=label, dtype=dtype, calls=n_calls,
        device_ms_per_call=f"{busy_us / 1e3 / n_calls:.3f}",
        traced_wall_ms_per_call=f"{wall_us / 1e3 / n_calls:.3f}",
        device_busy_share=f"{busy_us / wall_us:.3f}")
    for e in events[:8]:
        say("profile", run=label, kernel=repr(e.key[:60]), calls=e.count,
            device_ms_per_call=f"{dev_us(e) / 1e3 / n_calls:.3f}")
    return busy_us / wall_us, busy_us / 1e3 / n_calls


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 1
    dev, smi = phase_device()
    phase_build()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = Path(tmp)
        data, ens, cfg = write_fixture(root)
        batches = served_batches(serve_argv(root, data, ens, "float32"), dev)
        setup, train_batches = training_setup(data, root)
        flagship = phase_kernel(dev, batches[0])
        bwd_flag = phase_kernel_bwd(dev, train_batches[0])
        seg_flag = phase_kernel_segsum(dev, train_batches[0])
        rung_flag = phase_kernel_rungs(dev, train_batches[0])
        launches = phase_serve(root, data, ens, cfg, batches, dev)
        rung_serve = {
            rung: phase_serve(root, data,
                              write_rung_ensemble(root, ens, cfg, rung), cfg,
                              batches, dev, members=RUNG_MEMBERS,
                              kernel=spec["fwd"], tag=f"_{rung}")
            for rung, spec in RUNGS.items()}
        runs = phase_train(root, data, cfg.layers)
        rung_train = {rung: phase_train_rung(root, data, cfg.layers, rung)
                      for rung in RUNGS}
        for rung in ("eproj", *RUNGS):
            phase_check(setup, train_batches, dev, rung)
        cases = phase_times(flagship, batches, ens, dev)
        rung_cases = phase_rung_times(rung_flag)
        bwd_cases, seg_cases, step_times = phase_train_times(
            bwd_flag, seg_flag, setup, train_batches, dev)

    def head(recs):
        return next(c for c in recs
                    if c["conv"] == "lg" and c["dtype"] == "float32")

    def record(name, recs, launches_f32, launches_bf16, path):
        h = head(recs)
        return {"name": name, "route": "cuda",
                "source": f"gnnep_tpu_torch/csrc/{name}.cu",
                "replaces": REPLACES[name],
                # the f32 run's count; the bf16 run's, counted alone, beside
                "launches": launches_f32, "launches_bfloat16": launches_bf16,
                "launches_path": path, "max_abs_err": h["max_abs_err"],
                "ms": h["ms"], "plain_ms": h["plain_ms"],
                "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
                "library_ms": h.get("library_ms"), "cases": recs}

    train = {d: r["counts"] for d, r in runs.items()}
    kernels = [
        record("attn_eproj_fwd", cases, launches["float32"],
               launches["bfloat16"], "serve"),
        record("attn_eproj_bwd", bwd_cases, train["float32"]["attn_eproj_bwd"],
               train["bfloat16"]["attn_eproj_bwd"], "train"),
        record("csr_segment_sum", seg_cases,
               train["float32"]["csr_segment_sum"],
               train["bfloat16"]["csr_segment_sum"], "train"),
    ]
    kernels[0]["launches_train"] = train["float32"]["attn_eproj_fwd"]
    for rung, spec in RUNGS.items():
        fwd = record(spec["fwd"], rung_cases[spec["fwd"]],
                     rung_serve[rung]["float32"],
                     rung_serve[rung]["bfloat16"], f"serve_{rung}")
        fwd["launches_train"] = rung_train[rung]["counts"][spec["fwd"]]
        kernels += [fwd, record(spec["bwd"], rung_cases[spec["bwd"]],
                                rung_train[rung]["counts"][spec["bwd"]], None,
                                f"train_{rung}")]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels, "train": {
        d: {"optimizer_steps": r["steps"], "cli_seconds": r["seconds"],
            **step_times["eproj"][d]} for d, r in runs.items()},
        "train_rungs": {
            rung: {"optimizer_steps": r["steps"], "cli_seconds": r["seconds"],
                   "eval_forwards": r["eval_forwards"],
                   "step_times": step_times[rung]}
            for rung, r in rung_train.items()}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
