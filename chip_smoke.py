#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`gnnep_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line (a failure anywhere exits non-zero):
  1. device: nvidia-smi's name and power limit, torch and CUDA versions;
     TF32 off for matrix products and convolutions.
  2. build: nvcc builds every kernel of the serving path from `csrc/`.
  3. kernel: each kernel against its plain PyTorch version on the card, on
     small seeded edge cases and at the flagship conv shapes.
  4. serve: 256 synthetic MP-like graphs and a 5-member flagship ensemble
     (hidden 256, 4 layers, 4 heads, random weights from a seed) written to
     disk, then `gnnep_tpu_torch.cli.predict` in float32 and bfloat16; the
     launch counts show every conv went through the kernel, and member 0's
     means on the card match the CPU plain forward.
  5. times: CUDA events, warm-up first. A kernel's (and its plain
     version's) device time per launch is the median of 30 chains of 10
     back-to-back launches; its wall time per call, host work included, and
     the forward's wall time per batch are medians of 30 single calls. A
     profiler pass splits the forward's device time by kernel.

The next-to-last line is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

N_GRAPHS, BATCH, MEMBERS, SEED = 256, 64, 5, 0
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
def phase_build():
    from gnnep_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    build.build(["attn_eproj_fwd"])
    say("build", kernels="attn_eproj_fwd",
        seconds=f"{time.perf_counter() - t0:.1f}")
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)


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


def serve_argv(root: Path, data: Path, ens: Path, dtype: str) -> list:
    """The CLI request each serving run makes."""
    return ["--mode", "random", "--num-samples", str(N_GRAPHS),
            "--batch-size", str(BATCH), "--data-dir", str(data),
            "--ensemble-dir", str(ens), "--compute-dtype", dtype,
            "--output-json", str(root / f"pred_{dtype}.json")]


def served_batches(argv: list, dev):
    """The batches the CLI serves for `argv`, chosen and packed by the CLI's
    and the ensemble's own functions."""
    from gnnep_tpu_torch.cli import predict as cli
    from gnnep_tpu_torch.infer.predict import Ensemble, pack_batches
    args = cli.build_parser().parse_args(argv)
    store, idx = cli.select_graphs(
        args, Ensemble.load(args.ensemble_dir, device=dev))
    return pack_batches(store, idx, args.batch_size)[1]


def phase_serve(root: Path, data: Path, ens: Path, cfg, batches, dev):
    """Serves the request in f32 and bf16; returns each run's launches."""
    import torch
    from gnnep_tpu_torch.cli import predict as cli
    from gnnep_tpu_torch.ops.cuda import attention_eproj as ep
    from gnnep_tpu_torch.train.artifacts import load_member
    from gnnep_tpu_torch.train.loop import make_forward
    from gnnep_tpu_torch.models.alignn import DeviceBatch

    expected = MEMBERS * len(batches) * 2 * cfg.layers
    launches = {}
    for dtype in ("float32", "bfloat16"):
        argv = serve_argv(root, data, ens, dtype)
        out = Path(argv[-1])
        t0 = time.perf_counter()
        # the CLI's per-material table goes to a file, not this output
        with open(root / f"cli_{dtype}.txt", "w") as log, \
                contextlib.redirect_stdout(log):
            ep.launches = 0
            cli.main(argv)
            grew = ep.launches
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if grew != expected:
            raise AssertionError(
                f"{dtype}: eproj kernel launched {grew} times, expected "
                f"{MEMBERS} members x {len(batches)} batches x 2 convs x "
                f"{cfg.layers} layers = {expected}")
        preds = json.loads(out.read_text())["predictions"]
        mu = np.asarray([p["mu"] for p in preds], np.float64)
        sigma = np.asarray([p["sigma"] for p in preds], np.float64)
        if len(preds) != N_GRAPHS or not (np.isfinite(mu).all()
                                          and np.isfinite(sigma).all()
                                          and (sigma > 0).all()):
            raise AssertionError(f"{dtype}: {len(preds)} predictions, or "
                                 "non-finite mu/sigma, or sigma <= 0")
        launches[dtype] = grew
        say("serve", dtype=dtype, graphs=len(preds), batches=len(batches),
            members=MEMBERS, kernel_launches=grew,
            cli_seconds=f"{secs:.2f}", mu_mean=f"{mu.mean():.4f}",
            sigma_mean=f"{sigma.mean():.4f}")
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
    say("serve", check="member0_batch0_gpu_vs_cpu", rtol=1e-3, atol=1e-4,
        max_abs_err=f"{(g_mean - c_mean).abs().max().item():.3e}")
    return launches


# --------------------------------------------------------------- phase 5
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

    cases = []
    for (which, dtype), (case, err) in flagship.items():
        args = (case["q"], case["kv"], case["ea"], case["w_edge"],
                case["scale_t"], case["mask2"])

        def kernel():
            ep.attention_eproj_cuda(*args, case["row_ptr"], case["dst"],
                                    heads=case["heads"])

        kern_ms = device_ms(kernel)
        call_ms = median_ms(kernel)
        plain_ms = device_ms(lambda: ep.attention_eproj_plain(
            *args, case["dst"], heads=case["heads"]))
        bound, bound_by = eproj_bound_ms(case)
        rec = {"conv": which, "dtype": dtype, "n": int(case["q"].shape[0]),
               "e": int(case["kv"].shape[0]),
               "live_edges": int((case["mask2"] > 0).sum().item()),
               "ms": kern_ms, "call_ms": call_ms, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": bound_by, "max_abs_err": err}
        cases.append(rec)
        say("times", kernel="attn_eproj_fwd", conv=which, dtype=dtype,
            n=rec["n"], e=rec["e"], live_edges=rec["live_edges"],
            ms=f"{kern_ms:.4f}", call_ms_with_host=f"{call_ms:.4f}",
            bound_ms=f"{bound:.4f}", bound_by=bound_by,
            plain_ms_no_yardstick=f"{plain_ms:.4f}",
            library_ms="none (no single PyTorch call computes this function)")
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
        profile_forward(lambda: [fwd(run, db) for db in dbs], dtype,
                        len(dbs))
    return cases


def profile_forward(run_all, dtype: str, n_batches: int) -> None:
    """Device time by kernel over one pass of the batches, from
    torch.profiler: the device's busy share of the traced wall time (the
    tracer's own host cost inflates the wall time, so this share is a lower
    bound) and the kernels that take the most of it."""
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
    say("profile", forward=dtype, batches=n_batches,
        device_ms_per_batch=f"{busy_us / 1e3 / n_batches:.3f}",
        traced_wall_ms_per_batch=f"{wall_us / 1e3 / n_batches:.3f}",
        device_busy_share=f"{busy_us / wall_us:.3f}")
    for e in events[:6]:
        say("profile", kernel=repr(e.key[:60]), calls=e.count,
            device_ms_per_batch=f"{dev_us(e) / 1e3 / n_batches:.3f}")


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
        flagship = phase_kernel(dev, batches[0])
        launches = phase_serve(root, data, ens, cfg, batches, dev)
        cases = phase_times(flagship, batches, ens, dev)
    head = next(c for c in cases
                if c["conv"] == "lg" and c["dtype"] == "float32")
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "attn_eproj_fwd", "route": "cuda",
        "source": "gnnep_tpu_torch/csrc/attn_eproj_fwd.cu",
        "replaces": "gnnep_tpu/ops/pallas/csr_attention.py:983",
        # the f32 run's count; the bf16 run's, counted alone, beside it
        "launches": launches["float32"],
        "launches_bfloat16": launches["bfloat16"],
        "max_abs_err": head["max_abs_err"],
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "cases": cases}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
