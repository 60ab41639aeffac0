#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`gnnep_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line (a failure anywhere exits non-zero):
  1. device: nvidia-smi's name and power limit, torch and CUDA versions;
     TF32 off for matrix products and convolutions.
  2. build: nvcc builds the ten CUDA sources of `csrc/` (one nvcc per
     source, all started together) and prints each kernel's registers and
     spills (kernels 5 and 8's bf16 builds must spill nothing at the
     flagship's 64-channel tile, kernels 1-4 nothing at the flagship's
     plans); `cuobjdump` counts the tensor-core instructions (HGMMA, HMMA)
     of kernels 5, 6, 8 and 9, which must have some in every product
     kernel, both types.
  3. kernel: each kernel against its plain PyTorch version on the card, on
     small seeded edge cases and at the flagship conv shapes, f32 and bf16:
     the eproj forward (kernel 5) and backward (kernel 6), the CSR
     segment-sum (kernel 7, permuted and identity order; also a 1,000-row
     segment, 100 segments, the dummy's alone, widths 6 to 1024, a
     misaligned base; its output in the values' type bitwise its f32
     output cast, deterministic; the bf16 kv gather's backward one launch
     of it, no cast kernel; each conv's source-segment lengths), the kv+e
     attention forward (kernel 3) and backward (kernel 4; also with 1, 2
     and all heads to a warp and 1 or 4 warps to a row, on a row of 1,000
     live edges, and with q, k_e and v_e 2 and 4 bytes off an aligned
     base, bitwise the aligned run; kernel 4 one CUDA kernel per call), the
     external-logits softmax-aggregate forward (kernel 1) and backward
     (kernel 2; the same layouts, 1, 2 and 4 warps to a row, the 1,000-edge
     row and v and g 2 and 4 bytes off, bitwise; kernel 2 one CUDA kernel
     per call), and the span forward (kernel 8) and backward (kernel 9),
     these two also against kernel 5 on the gathered kv and against kernel
     6's dkv folded by kernel 7. Dead rows of every backward must be exact
     zeros. Kernels 6 and 9 also on the shapes their tiling must take (a
     1,200-edge hub, a tile of dead edges, Fe 36, E not a multiple of 64,
     head widths 8, 64 and 96), and in f32 at the line-graph conv against
     a float64 reference beside the plain f32 version's own error; kernels
     5 and 8 the same (their f32 error at most twice the plain version's).
     Then the widths beyond the kernels' old limits (`WIDTHS`: hidden 512 /
     4 heads, 256 / 1, 384 / 2, Fe = hidden): kernels 1-6, 8 and 9 against
     their plain versions, f32 and bf16, dead rows exact zeros.
  4. serve: 256 synthetic MP-like graphs and a 5-member flagship ensemble
     (hidden 256, 4 layers, 4 heads, random weights from a seed) written to
     disk, then `gnnep_tpu_torch.cli.predict` in float32 and bfloat16; each
     member's forward is a captured CUDA graph (its first batch runs
     eagerly, every other one replays the capture: the replay counts show
     it), the launch counts (each graph adds its capture's launches on
     every replay) show every conv went through the kernel, and member 0's
     means on the card match the CPU plain forward. The same for a
     2-member ensemble on each other rung (`conv_impl='fused'` with
     `attn_eproj=False`: kernel 3; with `attn_fused=False`: kernel 1), whose
     convs never reach kernel 5. Then the span rung: member 0 under a
     span config (`attn_span=True`, bounds from `measure_span64`) through
     `make_forward` (kernel 8 2·layers times per forward, nothing else;
     card vs CPU means), and saved with that config and served through
     `cli.predict`, which repacks and so runs kernel 5, never kernel 8.
  5. train: `gnnep_tpu_torch.cli.train --conv-impl fused` on the same 256
     graphs at flagship width, 2 members × 3 epochs in float32 and 1 × 2
     in bfloat16; every member's steps after its eager warm-up are replays
     of its captured step, its validation forwards from the second epoch
     replays of its captured forward; every step's loss is finite, kernels
     6 and 7 ran 2·layers times per optimizer step (the trainer reports
     its steps), and the written f32 ensemble serves through
     `cli.predict`. Then one member for two epochs in float32 with
     `--no-attn-eproj` (kernels 4 and 7, 2·layers each per step) and with
     `--no-attn-fused` (kernel 2 2·layers, kernel 7 4·layers: the kv and
     the q gathers), the forward kernel 2·layers per train and eval
     forward, kernels 5 and 6 never. Then `make_train_step` on the span
     config for one epoch, f32 and bf16: kernels 8 and 9 2·layers times
     per step, nothing else.
     Then the slice's stages on the trained artifacts. evaluate:
     `gnnep_tpu_torch.cli.evaluate --no-plots` on the trained f32 ensemble
     (test and calib splits, batches of 16) on the card in f32 and bf16 and
     on the CPU in f32: the card's f32 metrics.json equals the CPU's (every
     finite float within rtol 1e-3 / atol 1e-4, NaN where the CPU has
     NaN), kernel 5 runs 2·layers times per member per batch and nothing
     else, and each member's forwards after its first batch replay its one
     capture; the same on the kv+e rung's ensemble with kernel 3.
     featurize: `cli.fetch --from-json examples/custom_materials.json` with
     the fetcher's defaults (crystalnn, so the 7.5 Å cutoff without
     pymatgen; MgO gives 1,424 bonds and 252,048 line-graph edges, up to
     178 edges into one target), each structure's host seconds and
     longest segments; then `cli.predict --mode custom` on those
     structures through the 5-member flagship ensemble, one a batch, on the
     card in f32 and bf16 and on the CPU: kernel 5 2·layers times per
     member per batch, the card's f32 means equal the CPU's. knn:
     `cli.train` with KNN density weighting refreshed after every epoch and
     `--save-embeddings` (1 member, 3 epochs, f32): finite losses, replayed
     steps, kernels 6 and 7 2·layers times per step, each snapshot's
     weights mean 1, the embedding files [n_split, hidden]; on the last
     snapshot the device kNN on the card equals the host backend's
     (distances and weights within 1e-4, neighbour sets equal but at
     distance ties), and a captured step on batches carrying those weights
     equals the eager step.
     Then resume, member processes, profiling, bundles and conversion.
     resume: `cli.train --checkpoint-every 1`, one member × 4 epochs, f32
     and bf16, its epoch-2 resume file copied aside as a run stopped
     there would leave it, then 3 runs of `--resume` from the copies:
     'resumed at epoch 3', the steps of the uninterrupted run less the
     first two epochs', replays after the warm-up, kernels 6 and 7
     2·layers times a step and 5 2·layers times a forward; at epoch 4
     Adam's count and the generator's state equal the uninterrupted run's;
     the parameters after the first step from the epoch-2 state lie from
     the uninterrupted run's at that step within 4× the resumed runs'
     distance from each other (float atomics), and their distances at
     epoch 4 are printed; a captured step from the epoch-2 state equals
     the eager steps from it, at the `check` limits below. isolation:
     `cli.train --member-isolation process` (2 members × 1 epoch f32):
     each child's launch counts (kernels 6 and 7 2·layers a step, none in
     the parent), and each member within 4× three in-process runs'
     distance from each other. profile: `cli.train
     --profile-dir` (1 member × 2 epochs): one trace, the first epoch
     replayed its captured step, and the trace's calls of kernels 5, 6 and
     7 equal their launches over that epoch, the epoch's `gnnep::` spans
     (its pack wait, steps, staging, replays, readbacks and val) are there
     as host records only, the epoch captured its step once and its
     forward at most once; the first epoch's wall traced and untraced.
     bundle: `cli.bundle export` of the 5-member flagship
     ensemble (f32, bf16) and the kv+e and external-logits ensembles,
     `python -m gnnep_tpu_torch.cli.bundle predict` in a fresh process on
     `[serve]`'s request (bitwise `cli.predict`'s, else the op named and
     the serving tolerance), then loaded and counted here (kernel 5, 3 or
     1 members × batches × 2·layers times, each member's program captured
     and replayed), and member 0's program beside its captured `Forward`
     (ms per batch). convert: `cli.convert` of a flagship-width reference
     state dict (`.pt`, random weights from a seed), served through
     `cli.predict` on the card and the CPU: kernel 5 2·layers a batch,
     card equal to CPU at the serving tolerance.
     Run between knn and resume: the parallel/ group, over two gloo rank
     processes on the one card (a two-card mesh's slots), started once.
     mesh: the aligned step
     on two 64-graph sub-batches a step, f32 and bf16, against the card's
     step over their 128-graph union (f32: metrics at rtol 5e-3,
     gradients within 5e-3 of each leaf's largest; bf16: each metric, and
     all gradients together in L2, at most NOISE_FACTOR times as far from
     the f32 step as the union step's bf16 ones, plus for a metric 5e-2
     of its f32 value and 1e-2 a cell, for the gradients 1e-3 of the f32
     norm), parameters
     bitwise equal on both ranks, kernels 5, 6 and 7
     2·layers a step on each; its wall beside the captured single-card
     step; `cli.train --data-shards 1 --edge-shards 1` unchanged.
     member_parallel: `cli.train --member-parallel vmap` (2 members × 2
     epochs: one replay a lock-step for both members, kernels 2·layers a
     member a step; the stacked step profiled, its calls equal to the
     launch counts), `--member-parallel shard` with one member (this
     process), and shard mode's two members over the pair (each rank's
     launches and checkpoint). giant: the fixture's graphs with MgO
     (252,048 angles) and a 2,040-atom synthetic crystal (295,298), both
     beyond a batch's 74,880-row line-graph arena; `cli.train
     --giant-graphs boundary --edge-shards 1` (the giants' eager boundary
     steps beside the replayed packed steps), `cli.predict` /
     `cli.evaluate --giant-shards 1` (the giants' rows last); then each
     giant at S = 2 over the pair, f32 and bf16, against its unpartitioned
     forward and step on the card (in bf16 against the S = 1 boundary
     path, which rounds the same weights and pools in f32 as S = 2 does,
     within a tenth of its distance from f32), the bytes each rank sent
     equal to `BoundaryPlan.comm_bytes_per_conv` × 3 × layers (MgO's 8
     atoms fit one window: nothing sent); the boundary step's walls at
     S = 2 and 1 and its device time at S = 1. edge_shard: the
     edge-sharded formulation on one 64-graph batch, f32, at S = 1 in
     this process (COO and windowed) and S = 2 over the pair (windowed,
     row windows measured), each forward and step against the card's
     captured forward and step, the trainer's dropout windowed against
     COO from the same seeds, kernel 7 exactly once a conv a forward
     and twice a conv a step (four times with the trainer's dropout),
     parameters bitwise equal on both ranks, the bytes handed to the
     collectives equal to the formulation's count, walls, device time at
     S = 1; and a conv whose row window's last row is real, windowed
     against COO.
  6. check: one eager train step on the card against the CPU plain step
     from the same parameters and batch, dropout and jitter off, on each
     rung (span included), and on the default rung at hidden 512 / 4 heads
     and 256 / 1 head (2 layers); on each rung in f32 and bf16, a replay
     of the captured step against the eager step from the same state at
     the same limits; with dropout 0.15 and jitter 0.1 on, 8 replays
     against 8 eager steps from one generator seed (another seed must
     differ); and one K-step chunk of replays and 8 captured forwards
     under `torch.cuda.set_sync_debug_mode('error')`.
  7. times: CUDA events, warm-up first. A kernel's (and its plain
     version's) device time per launch is the median of 30 chains of 10
     back-to-back launches; its wall time per call, host work included, is
     the median of 30 single calls. The train step on each rung, eager and
     captured side by side: wall ms per step of a K = 8 chunk from host
     batches (the member loop's), graphs/s, device ms and busy share from
     a profiled chunk; the forward the same over 16 served batches.
     Kernels 6 and 9 also by CUDA kernel (torch.profiler), beside their
     three products as `torch.matmul` calls (a diagnostic floor the port
     never calls). Kernels 1-4, 7 and 11 also beside an empty kernel
     launched on their own grid and block, timed the same way (the launch
     floor),
     and kernel 7's identity order beside `torch.segment_reduce`. In each
     profiled captured run the profiler's calls of every kernel equal the
     launch counts (each trace holds TRACE_MARGIN_S of idle time on either
     side of its work, so that no kernel record falls outside its window).
  8. probes: the two dev probes as timing phases. The row gather (kernel
     11) bitwise on every case of the JAX probe and on a misaligned
     table, timed beside
     `torch.index_select`, also at the span kernels' own gather; the
     ladder (kernel 10, kernel 5 cut short after each phase) at the
     line-graph conv's shapes, its `full` stage bitwise kernel 5, device ms
     per stage.

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
# the timed train chunk (the trainer's default --scan-steps) and the timed
# run of served batches
TIMING_K, TIMING_BATCHES = 8, 16
REPS, WARMUP = 30, 5
# kernel timing: launches per timed chain, and the card-side spin (about
# 25 ms at the H100's clock) that covers the host's enqueuing of a chain
CHAIN, SPIN_CYCLES = 10, 50_000_000
# NVIDIA H100 SXM data sheet (dense): memory rate, f32 on the CUDA cores,
# bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# dense TF32 on the tensor cores: kernels 5 and 8 run their f32 projection
# there as three TF32 products (3xTF32)
PEAK_TF32 = 495e12
# (hidden, heads) beyond the kernels' old limits (Fe = hidden > 256, head
# width > 128), all of which the trainer takes: head widths 128, 256, 192
WIDTHS = ((512, 4), (256, 1), (384, 2))


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


@contextlib.contextmanager
def traced():
    """A torch.profiler trace of the card and the host whose window holds
    TRACE_MARGIN_S of idle time on each side of the block's work (the
    trainer's `--profile-dir` trace holds the same,
    `gnnep_tpu_torch.utils.profiling`); the block synchronizes the card
    before it ends."""
    import torch
    from gnnep_tpu_torch.utils.profiling import TRACE_MARGIN_S
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_MARGIN_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)


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
# the CUDA sources, one nvcc each
KERNELS = ("attn_eproj_fwd", "attn_eproj_bwd", "csr_segment_sum",
           "attn_fwd", "attn_bwd", "softmax_aggregate_fwd",
           "softmax_aggregate_bwd", "attn_span_fwd", "attn_span_bwd",
           "row_gather")
_PALLAS = "gnnep_tpu/ops/pallas/csr_attention.py"
# the TPU kernel each kernel replaces; the ladder is kernel 5's source with
# its stage switch
REPLACES = {"attn_eproj_fwd": f"{_PALLAS}:983",
            "attn_eproj_bwd": f"{_PALLAS}:1065",
            "csr_segment_sum": f"{_PALLAS}:1533",
            "attn_fwd": f"{_PALLAS}:535",
            "attn_bwd": f"{_PALLAS}:613",
            "softmax_aggregate_fwd": f"{_PALLAS}:38",
            "softmax_aggregate_bwd": f"{_PALLAS}:189",
            "attn_span_fwd": f"{_PALLAS}:1726",
            "attn_span_bwd": f"{_PALLAS}:1819",
            "attn_eproj_ladder": "scripts_dev/exp_kernel_ladder.py:28",
            "row_gather": "scripts_dev/exp_gather_probe.py:21"}
SOURCES = {"attn_eproj_ladder": "attn_eproj_fwd"}
# each kernel's launch count: (module, attribute)
_OPS = "gnnep_tpu_torch.ops.cuda"
COUNTERS = {"attn_eproj_fwd": (f"{_OPS}.attention_eproj", "launches"),
            "attn_eproj_bwd": (f"{_OPS}.attention_eproj", "bwd_launches"),
            "csr_segment_sum": (f"{_OPS}.segment_sum", "launches"),
            "attn_fwd": (f"{_OPS}.attention", "launches"),
            "attn_bwd": (f"{_OPS}.attention", "bwd_launches"),
            "softmax_aggregate_fwd": (f"{_OPS}.aggregate", "launches"),
            "softmax_aggregate_bwd": (f"{_OPS}.aggregate", "bwd_launches"),
            "attn_span_fwd": (f"{_OPS}.attention_span", "launches"),
            "attn_span_bwd": (f"{_OPS}.attention_span", "bwd_launches"),
            "attn_eproj_ladder": ("gnnep_tpu_torch.dev.kernel_ladder",
                                  "launches"),
            "row_gather": ("gnnep_tpu_torch.dev.gather_probe", "launches")}


def _counter_module(name: str):
    return importlib.import_module(COUNTERS[name][0])


def reset_counts() -> None:
    """Every kernel's launch count and the graph replay and capture counts
    to 0."""
    from gnnep_tpu_torch.ops.cuda import graphs
    for name, (_, attr) in COUNTERS.items():
        setattr(_counter_module(name), attr, 0)
    graphs.replays.update(train=0, eval=0)
    graphs.captures.update(train=0, eval=0)


def read_counts() -> dict:
    return {name: getattr(_counter_module(name), attr)
            for name, (_, attr) in COUNTERS.items()}


def read_replays() -> dict:
    """Captured train steps and eval forwards replayed since the reset."""
    from gnnep_tpu_torch.ops.cuda import graphs
    return dict(graphs.replays)


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
                        .replace("Lb0E", ",false").replace("Lb1E", ",true")
                        .replace("Li", ",").replace("E", ""))
                entry = f" {m.group(1)}<{args}>"
            elif "registers" in line or "spill" in line:
                print(f"  {name}{entry}: {line.strip()}", flush=True)
    forward_spills(build.build_logs)
    layout_spills(build.build_logs)
    sass_tensor_cores()


def sass_tensor_cores():
    """Tensor-core (HGMMA, HMMA) and FFMA instructions of each kernel of
    kernels 5, 6, 8 and 9, from `cuobjdump --dump-sass` of the built
    libraries; fails unless every product kernel has tensor-core
    instructions in both types (bf16 mma, and 3xTF32 in f32). The ladder's
    load-only stage (kernel 5's source, stage 0) computes no product."""
    from gnnep_tpu_torch.dev.bwd_bench import sass_counts
    for name in ("attn_eproj_fwd", "attn_span_fwd", "attn_eproj_bwd",
                 "attn_span_bwd"):
        for func, counts in sass_counts(name).items():
            say("sass", kernel=name, function=func,
                **{op: n for op, n in counts.items()})
            load_only = func.startswith("attn_eproj_fwd_kernel") and \
                func.split(",")[2] == "0"
            if "cast_kernel" not in func and not load_only and not (
                    counts["HGMMA"] + counts["HMMA"]):
                raise AssertionError(f"{name} {func}: no tensor-core "
                                     "instruction in its SASS")


def forward_spills(logs: dict) -> None:
    """Kernels 5 and 8's bf16 builds at the flagship's column tile (64
    channels) must spill nothing: nvcc's report of each instantiation. The
    f32 builds' spills (a few bytes at 128 registers) are printed."""
    for name in ("attn_eproj_fwd", "attn_span_fwd"):
        func = ""
        for line in logs.get(name, "").splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                func = m.group(1)
            m = re.search(r"(\d+) bytes spill stores", line)
            if not (m and int(m.group(1)) and "attn_eproj_fwd_kernel" in func
                    and "Li64ELi4E" in func):
                continue
            if "bfloat16" in func:
                raise AssertionError(f"{name} {func}: spills {m.group(1)} "
                                     "bytes at the flagship width")
            say("build", kernel=name, f32_flagship_spill_bytes=m.group(1))


def layout_spills(logs: dict) -> None:
    """Kernels 3, 4, 1 and 2 (attn_kv.cuh's layout) at the flagship's plans
    (line-graph and atom conv, f32 and bf16: hidden 256, 4 heads) must
    spill nothing: nvcc's report of each of those instantiations (a library
    built by an earlier run in the same checkout has none to read)."""
    from gnnep_tpu_torch.ops.cuda import aggregate as ag
    from gnnep_tpu_torch.ops.cuda import attention as at
    for name in ("attn_fwd", "attn_bwd", "softmax_aggregate_fwd",
                 "softmax_aggregate_bwd"):
        if name not in logs:
            say("build", kernel=name, spill_report="none: built by an "
                "earlier run in this checkout")
            continue
        flagship = {}
        for item, mangled in ((4, "f"), (2, "13__nv_bfloat16")):
            for n, e_total in ((7552, 74880), (768, 7552)):
                backward = name.endswith("_bwd")
                plan = (at.attention_plan(n, e_total, 256, 4, item, 0, 0, 0,
                                          backward=backward)
                        if name.startswith("attn") else
                        ag.aggregate_plan(n, e_total, 256, 4, item, 0,
                                          backward=backward))
                key = (f"{mangled}Li{plan.span}ELi{plan.word}ELi"
                       f"{plan.slabs}E")
                if not backward or name == "softmax_aggregate_bwd":
                    key += f"Lb{int(plan.stream)}E"
                flagship[key] = plan
        func, seen = "", {}
        for line in logs.get(name, "").splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                func = m.group(1)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if not (m and f"{name}_kernelI" in func):
                continue
            args = func.split(f"{name}_kernelI", 1)[1]
            for key in flagship:
                if args.startswith(key):
                    seen[key] = int(m.group(1)) + int(m.group(2))
        if set(seen) != set(flagship) or any(seen.values()):
            raise AssertionError(f"{name}: the flagship instantiations' "
                                 f"spill bytes {seen}, want 0 for each of "
                                 f"{sorted(flagship)}")
        say("build", kernel=name, flagship_instantiations=len(seen),
            spill_bytes=0)


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
    from gnnep_tpu_torch.ops.cuda import attention_eproj as ep
    c = flagship[("lg", "float32")][0]
    args = (c["q"], c["kv"], c["ea"], c["w_edge"], c["scale_t"], c["mask2"])
    fwd_f64_line("attn_eproj_fwd", c,
                 lambda: ep.attention_eproj_cuda(*args, c["row_ptr"],
                                                 c["dst"], heads=c["heads"]),
                 lambda: ep.attention_eproj_plain(*args, c["dst"],
                                                  heads=c["heads"]))
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


def odd_cases(rng):
    """Kernel 6 and 9's shapes for the tiling of `attn_eproj_bwd.cuh`, each
    (name, eproj_case keywords): a hub target of 1,200 in-edges (across
    64-edge chunks, 32-edge slices and tile boundaries), a run of 20
    ten-edge targets all masked (longer than a tile's share, so some tile
    holds only dead edges), E not a multiple of 64, Fe 36 (not a multiple
    of 16) and head widths 64, 8 and 96."""
    out = []
    for name, heads, hidden, fe in (("hub_fe36_ch64", 4, 256, 36),
                                    ("hub_ch8", 2, 16, 16),
                                    ("hub_fe36_ch96", 2, 192, 36)):
        n = 120
        degs = rng.integers(0, 12, n)
        degs[n // 3] = 1200
        degs[n // 2:n // 2 + 20] = 10
        degs[-1] = 0
        if (degs.sum() + 16) % 64 == 0:
            degs[0] += 1
        out.append((name, dict(n=n, heads=heads, hidden=hidden, fe=fe,
                               degs=degs, interior_pad=0.1,
                               dead_rows=tuple(range(n // 2, n // 2 + 20)))))
    return out


def check_odd_tiling(name, case):
    """The case has E not a multiple of 64 and a tile (as the wrappers cut
    them on this card) whose edges are all dead."""
    import torch
    from gnnep_tpu_torch.ops.cuda import attention_eproj as ep
    n, e_total = case["q"].shape[0], case["mask2"].shape[0]
    sms = torch.cuda.get_device_properties(
        case["q"].device).multi_processor_count
    ptr = ep.bwd_tile_ptr(case["row_ptr"], ep.bwd_tiles(
        n, case["heads"], sms)).tolist()
    rp, mask = case["row_ptr"].tolist(), case["mask2"].cpu().numpy()
    dead = sum(rp[b] > rp[a] and not mask[rp[a]:rp[b]].any()
               for a, b in zip(ptr, ptr[1:]))
    if e_total % 64 == 0 or not dead:
        raise AssertionError(f"{name}: E={e_total}, {dead} all-dead tiles")
    return dead


def phase_kernel_bwd(dev, batch):
    """Kernel 6 on small seeded edge cases, on the tiling's odd shapes
    (`odd_cases`) and at the flagship conv shapes of a packed training
    batch; at the line-graph conv in f32 also against float64."""
    import torch
    rng = np.random.default_rng(SEED + 10)
    flagship = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for name, kw in odd_cases(rng):
            case = eproj_case(rng, dtype=dtype, device=dev, scale=True, **kw)
            check_odd_tiling(name, case)
            check_bwd_case(f"{name}_{tag}", case, tol)
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
    from gnnep_tpu_torch.ops.cuda import attention_eproj as ep
    case = flagship[("lg", "float32")][0]
    args = bwd_inputs(case)
    f64_line("attn_eproj_bwd", case,
             lambda: ep.attention_eproj_bwd_cuda(*args, heads=case["heads"]),
             lambda: ep.attention_eproj_bwd_plain(*args, heads=case["heads"]),
             args)
    return flagship


def f64_line(kernel, case, run_kernel, run_plain, ref_args, **ref_kw):
    """The kernel's f32 error and the plain f32 version's against a float64
    reference computed on the card (`bwd_bench.eproj_bwd_f64`), each
    output's largest absolute difference over the reference's largest
    magnitude."""
    import torch
    from gnnep_tpu_torch.dev.bwd_bench import (OUTPUTS, eproj_bwd_f64,
                                               f64_errors)
    ref = eproj_bwd_f64(*ref_args, heads=case["heads"], **ref_kw)
    kern = f64_errors(run_kernel(), ref, OUTPUTS[kernel])
    torch.cuda.synchronize()
    plain = f64_errors(run_plain(), ref, OUTPUTS[kernel])
    say("kernel", kernel=kernel, check="f32_vs_float64", conv="lg",
        **{f"kernel_err_{k}": f"{v:.3e}" for k, v in kern.items()},
        **{f"plain_err_{k}": f"{v:.3e}" for k, v in plain.items()},
        worst_ratio_kernel_to_plain=(
            f"{max(kern[k] / max(plain[k], 1e-30) for k in kern):.2f}"))
    for k, v in kern.items():
        if not np.isfinite(v) or v > 1e-4:
            raise AssertionError(f"{kernel}: f32 {k} differs from float64 "
                                 f"by {v:.3e} of its largest value")


def fwd_f64_line(kernel, case, run_kernel, run_plain, **ref_kw):
    """Kernel 5's or 8's f32 output error against a float64 reference
    (`fwd_bench.eproj_fwd_f64`), beside the plain f32 version's own, each
    the largest absolute difference on the real rows over the reference's
    largest magnitude; fails if the kernel's is over twice the plain's."""
    import torch
    from gnnep_tpu_torch.dev.fwd_bench import eproj_fwd_f64, f64_error
    kv = case["kvn"] if "src" in ref_kw else case["kv"]
    ref = eproj_fwd_f64(case["q"], kv, case["ea"], case["w_edge"],
                        case["scale_t"], case["mask2"], case["dst"],
                        heads=case["heads"], **ref_kw)
    kern = f64_error(run_kernel()[0], ref)
    torch.cuda.synchronize()
    plain = f64_error(run_plain()[0], ref)
    say("kernel", kernel=kernel, check="f32_vs_float64", conv="lg",
        kernel_err_out=f"{kern:.3e}", plain_err_out=f"{plain:.3e}",
        ratio_kernel_to_plain=f"{kern / max(plain, 1e-30):.2f}")
    if not np.isfinite(kern) or kern > 2 * plain:
        raise AssertionError(f"{kernel}: f32 out differs from float64 by "
                             f"{kern:.3e}, over twice the plain version's "
                             f"{plain:.3e}")


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
    """Kernel 7 on one case: its f32 output bitwise the plain version on
    the CPU (a sequential sum in row order, the kernel's order) and within
    (rtol, atol) of the plain version on the card (whose `index_add_` adds
    with float atomics in another order); its output in the values' type
    (the kv-gather backward's) bitwise its own f32 output cast; both
    deterministic on a rerun."""
    import torch
    from gnnep_tpu_torch.ops.cuda import segment_sum as ss
    args = (case["values"], case["order"], case["starts"])
    kern = ss.csr_segment_sum_cuda(*args)
    low = ss.csr_segment_sum_cuda(*args, case["values"].dtype)
    torch.cuda.synchronize()
    if not torch.equal(kern.cpu(), ss.csr_segment_sum_plain(
            *(None if a is None else a.cpu() for a in args))):
        raise AssertionError(f"{name}: segment-sum kernel is not bitwise the "
                             "CPU's sequential sum")
    plain = ss.csr_segment_sum_plain(*args)
    err = (kern - plain).abs().max().item() if kern.numel() else 0.0
    if not torch.isfinite(kern).all() or not torch.allclose(
            kern, plain, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: segment-sum kernel differs from the "
                             f"plain version by {err:.3e} (rtol {rtol}, "
                             f"atol {atol})")
    if low.dtype != case["values"].dtype or not torch.equal(
            low, kern.to(low.dtype)):
        raise AssertionError(f"{name}: the segment-sum's {low.dtype} output "
                             "is not its f32 output cast")
    if not (torch.equal(ss.csr_segment_sum_cuda(*args), kern) and torch.equal(
            ss.csr_segment_sum_cuda(*args, low.dtype), low)):
        raise AssertionError(f"{name}: segment-sum kernel is not "
                             "deterministic")
    say("kernel", kernel="csr_segment_sum", case=name, rtol=rtol, atol=atol,
        max_abs_err=f"{err:.3e}", bitwise_cpu_sequential_sum=True,
        out_in_values_type_is_f32_cast=True, deterministic=True)
    return err


def segment_stats(batch) -> None:
    """Each conv's source segments in the packed batch (the kv gather's
    backward walks them): rows, the real segments' length mean, p99 and
    max and how many are empty, and the dummy's tail, which the kernel
    does not walk."""
    for which, starts, e_total in (
            ("lg", batch.lg_src_starts, batch.lg_src.shape[0]),
            ("atom", batch.edge_src_starts, batch.edge_src.shape[0])):
        starts = np.asarray(starts, np.int64)
        lengths = np.diff(starts)
        say("segments", conv=which, segments=starts.shape[0], rows=e_total,
            mean=f"{lengths.mean():.2f}",
            p99=f"{np.percentile(lengths, 99):.0f}", max=int(lengths.max()),
            empty=int((lengths == 0).sum()),
            dummy_tail_rows=int(e_total - starts[-1]))


def segsum_small_case(rng, kind, *, width, dtype, device):
    """A seeded arena of source-sorted segments: `mixed` (300 segments of
    about 10 rows, the dummy's tail 100), `hub1000` (the same with a
    1,000-row segment), `n100` (100 segments, fewer than the SMs), `n1`
    (the dummy's segment alone), `misaligned` (`mixed` with values one
    element off a 16-byte boundary: one-column loads)."""
    import torch
    n = {"n100": 100, "n1": 1}.get(kind, 300)
    idx = rng.integers(0, max(n - 1, 1), 3000) if n > 1 else np.zeros(3000)
    if kind == "hub1000":
        idx = np.concatenate([idx, np.full(1000, 17)])
    idx[-100:] = n - 1
    order = np.argsort(idx, kind="stable")
    starts = np.searchsorted(idx[order], np.arange(n))
    e_total = idx.shape[0]
    flat = torch.from_numpy(rng.normal(size=e_total * width + 1)).to(
        device, dtype)
    values = (flat[1:] if kind == "misaligned" else flat[:-1]).view(
        e_total, width)
    return dict(values=values,
                order=torch.from_numpy(order).to(device, torch.int32),
                starts=torch.from_numpy(starts).to(device, torch.int32))


def check_gather_backward(dev):
    """The bf16 kv gather's backward on the card is kernel 7 alone: its
    gradient comes out bf16 from one launch, the profiler sees no cast."""
    import torch
    from gnnep_tpu_torch.ops.cuda import segment_sum as ss
    c = segsum_small_case(np.random.default_rng(SEED + 21), "mixed",
                          width=512, dtype=torch.bfloat16, device=dev)
    idx = torch.searchsorted(c["starts"], torch.arange(
        c["values"].shape[0], device=dev), right=True) - 1
    src = torch.empty_like(idx).scatter_(0, c["order"].long(), idx)
    x = torch.zeros((c["starts"].shape[0], 512), dtype=torch.bfloat16,
                    device=dev, requires_grad=True)
    out = ss.csr_gather_ordered(x, src, c["order"], c["starts"])
    torch.cuda.synchronize()
    before = ss.launches
    with traced() as prof:
        (dx,) = torch.autograd.grad(out, x, c["values"])
        torch.cuda.synchronize()
    kernels = [e.key for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    if (dx.dtype != torch.bfloat16 or ss.launches != before + 1
            or len(kernels) != 1 or "csr_segment_sum_kernel" not in kernels[0]):
        raise AssertionError(f"the bf16 kv-gather backward gave {dx.dtype} "
                             f"from kernels {kernels}, not kernel 7 alone")
    want = ss.csr_segment_sum_cuda(c["values"], c["order"], c["starts"])
    if not torch.equal(dx, want.to(torch.bfloat16)):
        raise AssertionError("the kv-gather backward is not kernel 7's sum")
    say("kernel", kernel="csr_segment_sum", case="kv_gather_backward_bf16",
        grad_dtype="bfloat16", cuda_kernels=len(kernels), cast_kernel=False)


def phase_kernel_segsum(dev, batch):
    """Kernel 7 on small seeded cases (empty segments, odd and wide widths,
    a 1,000-row segment, fewer segments than SMs, the dummy's alone, a
    misaligned base) and at the flagship kv-gather backward shapes; then
    the kv gather's bf16 backward as one launch in the cotangent's type."""
    import torch
    rng = np.random.default_rng(SEED + 20)
    segment_stats(batch)
    flagship = {}
    for dtype, tol in ((torch.float32, (1e-5, 1e-5)),
                       (torch.bfloat16, (1e-4, 1e-4))):
        tag = "float32" if dtype == torch.float32 else "bfloat16"
        for kind, width in (("mixed", 6), ("mixed", 16), ("mixed", 512),
                            ("mixed", 1024), ("hub1000", 512),
                            ("n100", 512), ("n1", 512), ("misaligned", 512)):
            case = segsum_small_case(rng, kind, width=width, dtype=dtype,
                                     device=dev)
            # the card's plain version adds a 1,000-row segment's f32 sums
            # (up to about 100) in another order: atol 1e-3 there
            check_segsum_case(f"{kind}_w{width}_{tag}", case, tol[0],
                              1e-3 if kind == "hub1000" else tol[1])
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
    check_gather_backward(dev)
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
    """Kernel 1's inputs from an eproj case, in the kernels' [E, heads]
    layout: f32 logits from the rng (spread as q·k/√c of unit rows, about
    2), written as −1e30 where mask2 is 0 as the conv writes them, and the
    case's dropout scale transposed; v is kv's second half."""
    import torch
    heads, e_total = case["scale_t"].shape
    logits = torch.from_numpy(rng.normal(size=(heads, e_total)).astype(
        np.float32) * 2.0).to(case["q"].device).t()
    logits = torch.where(case["mask2"][:, None] > 0, logits,
                         torch.full_like(logits, NEG)).contiguous()
    return dict(logits=logits, scale=case["scale_t"].t().contiguous(),
                v=case["kv"][:, case["q"].shape[1]:].contiguous(),
                row_ptr=case["row_ptr"], dst=case["dst"], mask2=case["mask2"],
                heads=heads, n=case["q"].shape[0])


def attn_fwd_args(c):
    return (c["q"], c["k"], c["v"], c["scale_t"], c["mask2"])


def attn_plan(c, backward=False):
    """Kernel 3's plan (kernel 4's with `backward`) for case `c`: the
    wrapper's own (None), or with `c["hpw"]` heads to a warp and
    `c["split"]` warps to a row."""
    if c.get("hpw") is None and c.get("split") is None:
        return None
    from gnnep_tpu_torch.ops.cuda import attention as at
    q, k = c["q"], c["k"]
    return at.attention_plan(q.shape[0], k.shape[0], q.shape[1], c["heads"],
                             q.element_size(), q.data_ptr(), k.data_ptr(),
                             c["v"].data_ptr(), heads_per_warp=c.get("hpw"),
                             split=c.get("split"), backward=backward)


def agg_fwd_args(c):
    return (c["logits"], c["scale"], c["v"], c["row_ptr"])


def agg_plan(c, backward=False):
    """Kernel 1's plan (kernel 2's with `backward`) for case `c`: the
    wrapper's own (None), or with `c["hpw"]` heads to a warp and
    `c["split"]` warps to a row."""
    if c.get("hpw") is None and c.get("split") is None:
        return None
    from gnnep_tpu_torch.ops.cuda import aggregate as ag
    v = c["v"]
    return ag.aggregate_plan(c["n"], v.shape[0], v.shape[1], c["heads"],
                             v.element_size(), v.data_ptr(),
                             heads_per_warp=c.get("hpw"),
                             split=c.get("split"), backward=backward)


def run_fwd(kernel, c):
    """(kernel result, plain result) of kernel 3 or 1, each (out, max,
    denom)."""
    import torch
    from gnnep_tpu_torch.ops.cuda import aggregate as ag
    from gnnep_tpu_torch.ops.cuda import attention as at
    if kernel == "attn_fwd":
        args = attn_fwd_args(c)
        kern = at.attention_cuda(*args, c["row_ptr"], heads=c["heads"],
                                 plan=attn_plan(c))
        torch.cuda.synchronize()
        return kern, at.attention_plain(*args, c["dst"], heads=c["heads"])
    args = agg_fwd_args(c)
    kern = ag.aggregate_cuda(*args, heads=c["heads"], plan=agg_plan(c))
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
                                       heads=c["heads"], plan=attn_plan(c))
        return attn_fwd_args(c) + (c["row_ptr"], g, mx, den)
    _, mx, den = ag.aggregate_cuda(*agg_fwd_args(c), heads=c["heads"],
                                   plan=agg_plan(c))
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
    if kernel == "attn_bwd":
        kern = at.attention_bwd_cuda(*args, heads=c["heads"],
                                     plan=attn_plan(c, backward=True))
    else:
        kern = ag.aggregate_bwd_cuda(*args, heads=c["heads"],
                                     plan=agg_plan(c, backward=True))
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
        rows = {"dl": (kern[0], plain[0], live),
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


def attn_at_offset(c, offset):
    """Case `c` with q, k_e and v_e copied into contiguous views `offset`
    bytes past a 256-byte aligned base (the plan's narrower words)."""
    import torch
    out = dict(c)
    for key in ("q", "k", "v"):
        t = c[key]
        skip = offset // t.element_size()
        flat = torch.empty(t.numel() + skip, dtype=t.dtype, device=t.device)
        out[key] = flat[skip:].view(t.shape).copy_(t)
    return out


def attn_outputs(c):
    """Kernel 3's (out, max, denom) and kernel 4's (dq, dk, dv) of case
    `c`, the cotangent seeded."""
    import torch
    from gnnep_tpu_torch.ops.cuda import attention as at
    fwd = at.attention_cuda(*attn_fwd_args(c), c["row_ptr"], heads=c["heads"],
                            plan=attn_plan(c))
    bwd = at.attention_bwd_cuda(*rung_bwd_inputs("attn_bwd", c),
                                heads=c["heads"],
                                plan=attn_plan(c, backward=True))
    torch.cuda.synchronize()
    return fwd + bwd


def check_attn_layouts(rng, dev, dtype, tol, tag):
    """Kernels 3 and 4 on small seeded cases with 1, 2 and all heads to a
    warp (where a warp holds them), each with one warp to a row and with
    four: head widths 8, 64 and 96, a row of
    1,000 live edges (the scratch path), interior padding, an all-masked
    row, the dummy row's tail, a dropout scale; and with q, k_e and v_e at
    2- and 4-byte offsets (the plan's narrow words), each output bitwise
    the aligned run's. Returns the cases checked."""
    import torch
    from gnnep_tpu_torch.ops.cuda import attention as at
    degs = rng.integers(0, 12, 48)
    degs[7] = 1000
    cases = [("ch8", dict(n=40, heads=2, hidden=16, interior_pad=0.2,
                          degs=rng.integers(0, 7, 40))),
             ("ch64", dict(n=24, heads=4, hidden=256, interior_pad=0.1,
                           degs=rng.integers(10, 60, 24))),
             ("ch96", dict(n=16, heads=2, hidden=192, interior_pad=0.1,
                           degs=rng.integers(1, 20, 16))),
             ("row1000", dict(n=48, heads=4, hidden=256, interior_pad=0.0,
                              degs=degs))]
    checked = 0
    for name, kw in cases:
        case = attn_inputs(eproj_case(rng, fe=16, dtype=dtype, device=dev,
                                      dead_rows=(3,), scale=True, **kw))
        if name == "row1000":
            live = int((case["mask2"][case["dst"] == 7] > 0).sum().item())
            if live != 1000:
                raise AssertionError(f"row1000 has {live} live edges")
        for hpw, split in ((h, w) for h in sorted({1, 2, case["heads"]})
                           for w in (1, 4)):
            c = dict(case, hpw=hpw, split=split)
            try:
                attn_plan(c)
            except ValueError:  # a layout these heads cannot take
                continue
            label = f"{name}_hpw{hpw}_split{split}_{tag}"
            check_rung_fwd("attn_fwd", label, c, tol)
            check_rung_bwd("attn_bwd", label, c, tol)
            want = attn_outputs(c)
            for offset in (2, 4):
                if offset % c["q"].element_size():
                    continue  # an f32 tensor 2 bytes off takes no word
                moved = attn_at_offset(c, offset)
                plan = attn_plan(moved)
                got = attn_outputs(moved)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(
                        f"attn {label}: q, k_e, v_e {offset} bytes off "
                        f"(words of {plan.word}) differ from the aligned run")
                say("kernel", kernel="attn_fwd+attn_bwd", case=label,
                    base_offset_bytes=offset, word_bytes=plan.word,
                    span_bytes=plan.span, bitwise_equal_aligned=True)
            checked += 1
    return checked


def check_attn_bwd_one_kernel(c):
    """Kernel 4 is one CUDA kernel per call: the profiler sees the one
    launch of `attn_bwd_kernel`, which also zeroes the dummy row's dk and
    dv rows, and nothing else."""
    import torch
    from gnnep_tpu_torch.ops.cuda import attention as at
    args = rung_bwd_inputs("attn_bwd", c)
    at.attention_bwd_cuda(*args, heads=c["heads"])
    torch.cuda.synchronize()
    before = at.bwd_launches
    with traced() as prof:
        at.attention_bwd_cuda(*args, heads=c["heads"])
        torch.cuda.synchronize()
    kernels = [e.key for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    if (at.bwd_launches != before + 1 or len(kernels) != 1
            or not re.search(r"\battn_bwd_kernel\b", kernels[0])):
        raise AssertionError(f"a kernel 4 call ran the CUDA kernels "
                             f"{kernels}, not attn_bwd_kernel alone")
    say("kernel", kernel="attn_bwd", case="attn_bwd",
        cuda_kernels=len(kernels), name=repr(kernels[0][:60]))


def agg_outputs(c, offset=0):
    """Kernel 1's (out, max, denom) and kernel 2's (dl_t, dv) of case `c`
    on its plan, the cotangent seeded; with `offset`, v and g copied into
    contiguous views that many bytes past a 256-byte aligned base (a
    tensor whose elements cannot sit there stays where it is)."""
    import torch
    from gnnep_tpu_torch.ops.cuda import aggregate as ag

    def moved(t):
        if offset % t.element_size():
            return t
        skip = offset // t.element_size()
        flat = torch.empty(t.numel() + skip, dtype=t.dtype, device=t.device)
        return flat[skip:].view(t.shape).copy_(t)

    c = dict(c, v=moved(c["v"]))
    fwd = ag.aggregate_cuda(*agg_fwd_args(c), heads=c["heads"],
                            plan=agg_plan(c))
    gen = torch.Generator(device=c["v"].device).manual_seed(0)
    g = moved(torch.randn((c["n"], c["v"].shape[1]), generator=gen,
                          device=c["v"].device))
    bwd = ag.aggregate_bwd_cuda(*agg_fwd_args(c), g, fwd[1], fwd[2],
                                heads=c["heads"],
                                plan=agg_plan(c, backward=True))
    torch.cuda.synchronize()
    return fwd + bwd, agg_plan(c) or ag.aggregate_plan(
        c["n"], c["v"].shape[0], c["v"].shape[1], c["heads"],
        c["v"].element_size(), c["v"].data_ptr())


def check_agg_layouts(rng, dev, dtype, tol, tag):
    """Kernels 1 and 2 on small seeded cases with 1, 2 and all heads to a
    warp (where a warp holds them), each with 1, 2 and 4 warps to a row:
    head widths 8, 64 and 96, a row of 1,000 live edges (kernel 2's long
    row, its u kept in dl_t), interior padding, an all-masked row, the
    dummy row's tail, a dropout scale; and with v and g at 2- and 4-byte
    offsets (the plan's narrow words), each output bitwise the aligned
    run's. Returns the cases checked."""
    import torch
    degs = rng.integers(0, 12, 48)
    degs[7] = 1000
    cases = [("ch8", dict(n=40, heads=2, hidden=16, interior_pad=0.2,
                          degs=rng.integers(0, 7, 40))),
             ("ch64", dict(n=24, heads=4, hidden=256, interior_pad=0.1,
                           degs=rng.integers(10, 60, 24))),
             ("ch96", dict(n=16, heads=2, hidden=192, interior_pad=0.1,
                           degs=rng.integers(1, 20, 16))),
             ("row1000", dict(n=48, heads=4, hidden=256, interior_pad=0.0,
                              degs=degs))]
    checked = 0
    for name, kw in cases:
        case = agg_inputs(rng, eproj_case(rng, fe=16, dtype=dtype,
                                          device=dev, dead_rows=(3,),
                                          scale=True, **kw))
        if name == "row1000":
            live = int((case["mask2"][case["dst"] == 7] > 0).sum().item())
            if live != 1000:
                raise AssertionError(f"row1000 has {live} live edges")
        for hpw, split in ((h, w) for h in sorted({1, 2, case["heads"]})
                           for w in (1, 2, 4)):
            c = dict(case, hpw=hpw, split=split)
            try:
                agg_plan(c)
            except ValueError:  # a layout these heads cannot take
                continue
            label = f"{name}_hpw{hpw}_split{split}_{tag}"
            check_rung_fwd("softmax_aggregate_fwd", label, c, tol)
            check_rung_bwd("softmax_aggregate_bwd", label, c, tol)
            want, _ = agg_outputs(c)
            for offset in (2, 4):
                if offset % c["v"].element_size():
                    continue  # an f32 v 2 bytes off takes no word
                got, plan = agg_outputs(c, offset)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(
                        f"aggregate {label}: v and g {offset} bytes off "
                        f"(words of {plan.word}) differ from the aligned "
                        "run")
                say("kernel", kernel="softmax_aggregate_fwd+bwd",
                    case=label, base_offset_bytes=offset,
                    word_bytes=plan.word, span_bytes=plan.span,
                    bitwise_equal_aligned=True)
            checked += 1
    return checked


def check_agg_bwd_one_kernel(c):
    """Kernel 2 is one CUDA kernel per call: the profiler sees the one
    launch of `softmax_aggregate_bwd_kernel`, which also zeroes the dummy
    row's dl_t and dv, and nothing else."""
    import torch
    from gnnep_tpu_torch.ops.cuda import aggregate as ag
    args = rung_bwd_inputs("softmax_aggregate_bwd", c)
    ag.aggregate_bwd_cuda(*args, heads=c["heads"])
    torch.cuda.synchronize()
    before = ag.bwd_launches
    with traced() as prof:
        ag.aggregate_bwd_cuda(*args, heads=c["heads"])
        torch.cuda.synchronize()
    kernels = [e.key for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    if (ag.bwd_launches != before + 1 or len(kernels) != 1 or not re.search(
            r"\bsoftmax_aggregate_bwd_kernel\b", kernels[0])):
        raise AssertionError(f"a kernel 2 call ran the CUDA kernels "
                             f"{kernels}, not softmax_aggregate_bwd_kernel "
                             "alone")
    say("kernel", kernel="softmax_aggregate_bwd",
        case="softmax_aggregate_bwd", cuda_kernels=len(kernels),
        name=repr(kernels[0][:60]))


def phase_kernel_rungs(dev, batch):
    """Kernels 3, 4, 1 and 2 on small seeded edge cases (head widths 8, 64
    and 96; interior padding, an all-masked row, empty rows, the dummy
    row's tail, a dropout scale) and at the flagship conv shapes of a
    packed training batch, f32 and bf16; each also on every layout of its
    plan, at misaligned bases (bitwise) and on a row of 1,000 live edges
    (`check_attn_layouts`, `check_agg_layouts`), and kernels 4 and 2 as one
    CUDA kernel per call → {kernel: {(conv, dtype): (case, err)}}."""
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
                # the flagship convs on the other layouts: one head a
                # warp, all heads a warp, four warps a row on the line graph
                # and one on the atom conv
                for hpw, split in ((1, None), (4, None),
                                   (None, 4 if which == "lg" else 1)):
                    label = f"{name}_hpw{hpw}_split{split}_{tag}"
                    c = dict(a, hpw=hpw, split=split)
                    check_rung_fwd("attn_fwd", label, c, tol)
                    check_rung_bwd("attn_bwd", label, c, tol)
                    c = dict(g, hpw=hpw, split=split)
                    check_rung_fwd("softmax_aggregate_fwd", label, c, tol)
                    check_rung_bwd("softmax_aggregate_bwd", label, c, tol)
        say("kernel", kernel="attn_fwd+attn_bwd", dtype=tag,
            layout_and_base_cases=check_attn_layouts(rng, dev, dtype, tol,
                                                     tag))
        say("kernel", kernel="softmax_aggregate_fwd+bwd", dtype=tag,
            layout_and_base_cases=check_agg_layouts(rng, dev, dtype, tol,
                                                    tag))
    check_attn_bwd_one_kernel(flagship["attn_bwd"][("lg", "bfloat16")][0])
    check_agg_bwd_one_kernel(
        flagship["softmax_aggregate_bwd"][("lg", "bfloat16")][0])
    return flagship


# ------------------------------------------------- phase 3, kernels 8 and 9
def span_bounds(batches):
    """(edge_span64, lg_span64): the largest span bounds `measure_span64`
    gives over `batches`, for a span config that covers them all."""
    from gnnep_tpu_torch.data.batching import measure_span64
    spans = [measure_span64(np.asarray(b.node_graph), np.asarray(b.edge_dst),
                            np.asarray(b.edge_mask), np.asarray(b.y).shape[0])
             for b in batches]
    return max(s[0] for s in spans), max(s[1] for s in spans)


def span_small_case(rng, *, n, heads, hidden, fe, degs, dtype, device,
                    interior_pad=0.0, dead_rows=(), scale=False):
    """`eproj_case`'s arena (tail padding owned by the dummy row, masked
    interior rows, all-masked and empty rows, a dropout scale) over a
    node-space kv table of n + 7 rows: each live edge sources a row below
    the table's last (the dummy source, whose kernel-7 fold is zeros), and
    each dead edge carries a padding src far beyond the table, which the
    kernels must never read. `src_plain` is the same with the dead edges'
    src set to 0, for the plain versions' kvn[src]."""
    import torch
    c = eproj_case(rng, n=n, heads=heads, hidden=hidden, fe=fe, degs=degs,
                   dtype=dtype, device=device, interior_pad=interior_pad,
                   dead_rows=dead_rows, scale=scale)
    n_src = n + 7
    e_total = c["kv"].shape[0]
    src = rng.integers(0, n_src - 1, e_total)
    live = (c["mask2"] > 0).cpu().numpy()
    c["kvn"] = torch.from_numpy(rng.normal(size=(n_src, 2 * hidden))).to(
        device, dtype)
    c["src"] = torch.from_numpy(np.where(live, src, n_src + 10 ** 6)).to(
        device, torch.int64)
    c["src_plain"] = torch.from_numpy(np.where(live, src, 0)).to(
        device, torch.int64)
    return c


def span_batch_case(rng, batch, which, *, hidden, dtype, device):
    """`batch_case` with the conv's node-space kv table and its src, from a
    packed batch that carries span metadata."""
    import torch
    c = batch_case(rng, batch, which, hidden=hidden, dtype=dtype,
                   device=device)
    src = batch.lg_src if which == "lg" else batch.edge_src
    n = c["q"].shape[0]
    c["kvn"] = torch.from_numpy(rng.normal(size=(n, 2 * hidden))).to(
        device, dtype)
    c["src"] = c["src_plain"] = torch.from_numpy(
        np.asarray(src, np.int64)).to(device)
    return c


def span_fwd_args(c):
    return (c["q"], c["kvn"], c["ea"], c["w_edge"], c["scale_t"],
            c["mask2"])


def span_bwd_inputs(c, g_seed=0):
    """Kernel 9's inputs: kernel 8's, a seeded f32 cotangent g and kernel
    8's max and denom."""
    import torch
    from gnnep_tpu_torch.ops.cuda import attention_span as sp
    _, mx, den = sp.attention_span_cuda(*span_fwd_args(c), c["row_ptr"],
                                        c["src"], c["dst"],
                                        heads=c["heads"])
    gen = torch.Generator(device=c["q"].device).manual_seed(g_seed)
    g = torch.randn(c["q"].shape, generator=gen, device=c["q"].device)
    return g, mx, den


def check_span_case(name, c, tol):
    """Kernels 8 and 9 against their plain versions on the card, each
    output within `tol` of the plain tensor's largest magnitude (no floor):
    out and denom on the real rows, max so where a row has a live edge
    (exactly −1e30 where it has none); dq on the real rows, dkvn on every
    node row, dea on the live edges and dW_e in full, the dead edges' dea
    rows and the dummy row's dq exact zeros. Then the cross-checks: kernel
    8 against kernel 5 on kvn[src], and kernel 9's dkvn against kernel 6's
    dkv folded into node space by kernel 7. Returns (forward's largest
    absolute difference, backward's)."""
    import torch
    from gnnep_tpu_torch.ops.cuda import attention_eproj as ep
    from gnnep_tpu_torch.ops.cuda import attention_span as sp
    from gnnep_tpu_torch.ops.cuda import segment_sum as ss
    heads, n = c["heads"], c["q"].shape[0]
    fwd = span_fwd_args(c)
    kern = sp.attention_span_cuda(*fwd, c["row_ptr"], c["src"], c["dst"],
                                  heads=heads)
    torch.cuda.synchronize()
    plain = sp.attention_span_plain(*fwd, c["src_plain"], c["dst"],
                                    heads=heads)
    errs, share = {}, 0.0
    for what, a, b in zip(("out", "max", "denom"), kern, plain):
        a, b = a[:-1].float(), b[:-1].float()
        if what == "max":
            dead = b <= 0.5 * NEG
            if not (a[dead] == NEG).all():
                raise AssertionError(f"attn_span_fwd {name}: max of a row "
                                     "without a live edge is not -1e30")
            a, b = a[~dead], b[~dead]
        errs[what], sh = _within("attn_span_fwd", name, what, a, b, tol)
        share = max(share, sh)
    # kernel 8 is kernel 5 on the gathered arena
    k5 = ep.attention_eproj_cuda(c["q"], c["kvn"][c["src_plain"]],
                                 *fwd[2:], c["row_ptr"], c["dst"],
                                 heads=heads)
    bitwise = all(torch.equal(a[:-1], b[:-1]) for a, b in zip(kern, k5))
    for what, a, b in zip(("out", "denom"), (kern[0], kern[2]),
                          (k5[0], k5[2])):
        _within("attn_span_fwd", f"{name} vs attn_eproj_fwd", what,
                a[:-1], b[:-1], tol)
    say("kernel", kernel="attn_span_fwd", case=name, tol_rel_to_max=tol,
        **{f"max_abs_err_{k}": f"{v:.3e}" for k, v in errs.items()},
        share_of_limit=f"{share:.3f}", bitwise_kernel5=bitwise)
    fwd_err = errs["out"]

    g, mx, den = span_bwd_inputs(c)
    args = fwd + (c["row_ptr"],)
    kern = sp.attention_span_bwd_cuda(*args, c["src"], c["dst"], g, mx, den,
                                      heads=heads)
    torch.cuda.synchronize()
    plain = sp.attention_span_bwd_plain(*args, c["src_plain"], c["dst"], g,
                                        mx, den, heads=heads)
    live = (c["mask2"] > 0) & (c["dst"] != n - 1)
    errs, share = {}, 0.0
    for what, a, b in zip(("dq", "dkvn", "dea", "dw"), kern, plain):
        a, b = a.float(), b.float()
        if what == "dq":
            if a[-1].any():
                raise AssertionError(f"attn_span_bwd {name}: dq of the dummy "
                                     "row is not zero")
            a, b = a[:-1], b[:-1]
        elif what == "dea":
            if a[~live].any():
                raise AssertionError(f"attn_span_bwd {name}: dea of dead "
                                     "edges is not zero")
            a, b = a[live], b[live]
        errs[what], sh = _within("attn_span_bwd", name, what, a, b, tol)
        share = max(share, sh)
    # kernel 9's dkvn is kernel 6's dkv folded into node space by kernel 7
    # over the source-sorted order, the eproj rung's own kv-gather backward
    k6 = ep.attention_eproj_bwd_cuda(c["q"], c["kvn"][c["src_plain"]],
                                     *fwd[2:], c["row_ptr"], c["dst"], g, mx,
                                     den, heads=heads)
    src = c["src_plain"]
    order = torch.argsort(src, stable=True)
    starts = torch.searchsorted(src[order], torch.arange(
        c["kvn"].shape[0], device=src.device))
    folded = ss.csr_segment_sum_cuda(k6[1], order.to(torch.int32),
                                     starts.to(torch.int32))
    _within("attn_span_bwd", f"{name} vs attn_eproj_bwd+csr_segment_sum",
            "dkvn", kern[1].float(), folded.float(), tol)
    for what, i in (("dq", 0), ("dea", 2), ("dw", 3)):
        _within("attn_span_bwd", f"{name} vs attn_eproj_bwd", what,
                kern[i].float(), k6[i].float(), tol)
    say("kernel", kernel="attn_span_bwd", case=name, tol_rel_to_max=tol,
        **{f"max_abs_err_{k}": f"{v:.3e}" for k, v in errs.items()},
        share_of_limit=f"{share:.3f}")
    return fwd_err, max(errs.values())


def phase_kernel_span(dev, batch):
    """Kernels 8 and 9 on small seeded edge cases (head widths 8, 64 and
    96; interior padding, an all-masked row, empty rows, the dummy row's
    tail, padding src values, a dropout scale) and at both convs' flagship
    shapes of a packed training batch, f32 and bf16 → {kernel: {(conv,
    dtype): (case, err)}}."""
    import torch
    rng = np.random.default_rng(SEED + 40)
    flagship = {"attn_span_fwd": {}, "attn_span_bwd": {}}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        tag = "float32" if dtype == torch.float32 else "bfloat16"
        small = [
            ("small_ch8", dict(n=40, heads=2, hidden=16, fe=16,
                               degs=rng.integers(0, 7, 40), interior_pad=0.2,
                               dead_rows=(3,))),
            ("long_rows_ch64", dict(n=24, heads=4, hidden=256, fe=256,
                                    degs=rng.integers(10, 60, 24),
                                    interior_pad=0.1, dead_rows=(5,))),
            ("ch96", dict(n=16, heads=2, hidden=192, fe=32,
                          degs=rng.integers(1, 20, 16), interior_pad=0.1))]
        for name, kw in small + odd_cases(rng):
            c = span_small_case(rng, dtype=dtype, device=dev, scale=True,
                                **kw)
            if name.startswith("hub"):
                check_odd_tiling(name, c)
            check_span_case(f"{name}_{tag}", c, tol)
        for which in ("lg", "atom"):
            c = span_batch_case(rng, batch, which, hidden=256, dtype=dtype,
                                device=dev)
            errs = check_span_case(f"{which}_conv_{tag}", c, tol)
            for kernel, err in zip(flagship, errs):
                flagship[kernel][(which, tag)] = (c, err)
    from gnnep_tpu_torch.ops.cuda import attention_span as sp
    c = flagship["attn_span_fwd"][("lg", "float32")][0]
    fwd_f64_line("attn_span_fwd", c,
                 lambda: sp.attention_span_cuda(*span_fwd_args(c),
                                                c["row_ptr"], c["src"],
                                                c["dst"], heads=c["heads"]),
                 lambda: sp.attention_span_plain(*span_fwd_args(c),
                                                 c["src_plain"], c["dst"],
                                                 heads=c["heads"]),
                 src=c["src_plain"])
    c = flagship["attn_span_bwd"][("lg", "float32")][0]
    g, mx, den = span_bwd_inputs(c)
    head = span_fwd_args(c) + (c["row_ptr"],)
    tail = (c["dst"], g, mx, den)
    f64_line("attn_span_bwd", c,
             lambda: sp.attention_span_bwd_cuda(*head, c["src"], *tail,
                                                heads=c["heads"]),
             lambda: sp.attention_span_bwd_plain(*head, c["src_plain"],
                                                 *tail, heads=c["heads"]),
             head + tail, src=c["src_plain"], n_src=c["kvn"].shape[0])
    return flagship


# ------------------------------------------------- phase 3, the widths
def phase_kernel_widths(dev):
    """Kernels 1-6, 8 and 9 at each of WIDTHS (Fe = hidden), f32 and bf16,
    against their plain versions at the tolerances of their other cases:
    rows longer than a projection tile (a 300-edge hub), interior padding,
    an all-masked row, empty rows, the dummy row's tail, a dropout scale;
    every backward's dead rows exact zeros. Returns the cases checked."""
    import torch
    rng = np.random.default_rng(SEED + 60)
    n = 48
    checked = 0
    for hidden, heads in WIDTHS:
        for dtype, tol5, tol in ((torch.float32, (1e-4, 1e-5), 1e-4),
                                 (torch.bfloat16, (0.05, 0.05), 1e-2)):
            tag = "f32" if dtype == torch.float32 else "bf16"
            name = f"h{hidden}x{heads}_{tag}"
            degs = rng.integers(0, 40, n)
            degs[7] = 300
            kw = dict(n=n, heads=heads, hidden=hidden, fe=hidden, degs=degs,
                      dtype=dtype, device=dev, interior_pad=0.1,
                      dead_rows=(5,), scale=True)
            case = eproj_case(rng, **kw)
            check_case(name, case, *tol5)
            check_bwd_case(name, case, tol)
            a, g = attn_inputs(case), agg_inputs(rng, case)
            check_rung_fwd("attn_fwd", name, a, tol)
            check_rung_bwd("attn_bwd", name, a, tol)
            check_rung_fwd("softmax_aggregate_fwd", name, g, tol)
            check_rung_bwd("softmax_aggregate_bwd", name, g, tol)
            check_span_case(name, span_small_case(rng, **kw), tol)
            checked += 1
    say("widths", configs=",".join(f"{h}x{k}" for h, k in WIDTHS),
        cases=checked, kernels="1,2,3,4,5,6,8,9", result="ok")
    return checked


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
            counts, replays = read_counts(), read_replays()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        # each member's first batch runs eagerly (the warm-up), every other
        # one as a replay of its captured forward
        if replays != {"train": 0, "eval": members * (len(batches) - 1)}:
            raise AssertionError(f"{dtype}: {replays} replays, expected "
                                 f"{members} members x {len(batches) - 1} "
                                 "captured forwards")
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
            kernel=kernel, kernel_launches=grew,
            forward_replays=replays["eval"], cli_seconds=f"{secs:.2f}",
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
    """Run `fn` with every kernel's launch count and the replay counts set
    to 0 just before and read just after → (fn's result, {kernel:
    launches}, per-step losses, {"train": forwards, "eval": forwards},
    {"train": replays, "eval": replays}). The member loop's metric readback
    is wrapped to keep each step's loss, and the model's trunk to count the
    train and eval forwards it runs eagerly (a capture runs the trunk's
    Python but nothing on the card, so it is not counted); a replay counts
    as the forward it holds. Both wrappers are removed afterwards."""
    import torch
    from gnnep_tpu_torch.models import alignn as pm
    from gnnep_tpu_torch.train import member
    losses = []
    forwards = {"train": 0, "eval": 0}
    orig_sums, orig_trunk = member._metric_sums, pm._shared_trunk

    def recording(ms):
        losses.append(ms.loss_sum.detach().reshape(-1))
        return orig_sums(ms)

    def counting_trunk(*a, **k):
        if not torch.cuda.is_current_stream_capturing():
            forwards["train" if k.get("train") else "eval"] += 1
        return orig_trunk(*a, **k)

    member._metric_sums = recording
    pm._shared_trunk = counting_trunk
    try:
        reset_counts()
        out = fn()
        counts, replays = read_counts(), read_replays()
    finally:
        member._metric_sums = orig_sums
        pm._shared_trunk = orig_trunk
    for kind, n in replays.items():
        forwards[kind] += n
    return out, counts, losses, forwards, replays


def check_replays(what: str, replays: dict, steps: int, members: int):
    """Every step after each member's warm-up ran as a replay of its
    captured step, and the validation and test forwards replayed too."""
    from gnnep_tpu_torch.train.loop import WARMUP_STEPS
    want = steps - members * WARMUP_STEPS
    if replays["train"] != want or replays["eval"] <= 0:
        raise AssertionError(f"{what}: {replays} replays; expected "
                             f"{want} train steps replayed ({steps} steps, "
                             f"{members} members, {WARMUP_STEPS} eager "
                             "warm-up each) and some eval forwards")


def phase_train(root: Path, data: Path, layers: int):
    """Trains through the CLI in f32 and bf16, then serves the f32
    ensemble; returns each run's launches and steps."""
    import torch
    from gnnep_tpu_torch.cli import predict as cli_predict
    from gnnep_tpu_torch.cli import train as cli_train
    runs = {}
    for dtype, members, epochs in (("float32", TRAIN_MEMBERS, TRAIN_EPOCHS),
                                   ("bfloat16", 1, 2)):
        out = root / f"trained_{dtype}"
        t0 = time.perf_counter()
        with open(root / f"train_{dtype}.txt", "w") as log, \
                contextlib.redirect_stdout(log):
            summary, counts, losses, forwards, replays = run_counted(
                lambda: cli_train.main(train_argv(data, out, dtype, members,
                                                  epochs)))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        steps = summary["optimizer_steps"]
        loss = torch.cat(losses).cpu().numpy() if losses else np.zeros(0)
        if steps <= 0 or len(loss) != steps or not np.isfinite(loss).all():
            raise AssertionError(f"{dtype}: {steps} optimizer steps "
                                 f"reported, {len(loss)} losses recorded, "
                                 f"finite: {np.isfinite(loss).all()}")
        check_replays(dtype, replays, steps, members)
        if forwards["train"] != steps:
            raise AssertionError(f"{dtype}: {forwards['train']} train "
                                 f"forwards for {steps} optimizer steps")
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
                           summary=summary, replays=replays)
        say("train", dtype=dtype, members=members, epochs=epochs,
            optimizer_steps=steps, step_replays=replays["train"],
            forward_replays=replays["eval"],
            kernel_launches=json.dumps(counts),
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
    """Trains one member for two epochs in f32 through the CLI on `rung`,
    its steps and (from the second epoch) its validation forwards as
    replays of their captures: every loss finite; per optimizer step the rung's backward kernel
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
        summary, counts, losses, forwards, replays = run_counted(
            lambda: cli_train.main(train_argv(data, out, "float32", 1, 2)
                                   + [spec["flag"]]))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    steps = summary["optimizer_steps"]
    loss = torch.cat(losses).cpu().numpy() if losses else np.zeros(0)
    if steps <= 0 or len(loss) != steps or not np.isfinite(loss).all():
        raise AssertionError(f"{rung}: {steps} optimizer steps reported, "
                             f"{len(loss)} losses recorded, finite: "
                             f"{np.isfinite(loss).all()}")
    check_replays(rung, replays, steps, 1)
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
        epochs=2, optimizer_steps=steps, eval_forwards=forwards["eval"],
        step_replays=replays["train"], forward_replays=replays["eval"],
        kernel_launches=json.dumps(counts), loss_sum_first=f"{loss[0]:.4f}",
        loss_sum_last=f"{loss[-1]:.4f}", cli_seconds=f"{secs:.2f}")
    return dict(counts=counts, steps=steps, eval_forwards=forwards["eval"],
                seconds=secs, replays=replays)


# --------------------------------------------------------------- phase 6
# evaluate: the trained ensemble's test split (and its calib split, for the
# sharpness curves) in batches of EVAL_BATCH graphs
EVAL_BATCH = 16
# the serving tolerance of a card result against the CPU's
SERVE_RTOL, SERVE_ATOL = 1e-3, 1e-4
EXAMPLES = Path(__file__).resolve().parent / "examples" / "custom_materials.json"


def eval_argv(data: Path, ens: Path, out: Path, dtype: str,
              device: str) -> list:
    """The CLI request of an evaluation run: the test split of the splits
    the trainer drew (its seed and fractions, TRAIN_MEMBERS folds)."""
    return ["--ensemble-dir", str(ens), "--data-dir", str(data),
            "--output-dir", str(out), "--no-plots",
            "--batch-size", str(EVAL_BATCH), "--seed", str(SEED),
            "--ensemble-size", str(TRAIN_MEMBERS), "--compute-dtype", dtype,
            "--device", device]


def close_to(got, want, path: str = "metrics") -> float:
    """Hold `got` to `want` (nested dicts and lists of the same keys and
    lengths): every finite float within SERVE_RTOL / SERVE_ATOL, NaN where
    `want` has NaN, strings and None equal. Returns the largest absolute
    difference of a finite float."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or got.keys() != want.keys():
            raise AssertionError(f"{path}: keys {sorted(got)} vs "
                                 f"{sorted(want)}")
        return max([close_to(got[k], want[k], f"{path}.{k}") for k in want],
                   default=0.0)
    if isinstance(want, list):
        if len(got) != len(want):
            raise AssertionError(f"{path}: lengths {len(got)}, {len(want)}")
        return max([close_to(g, w, f"{path}[{i}]")
                    for i, (g, w) in enumerate(zip(got, want))], default=0.0)
    if want is None or isinstance(want, str):
        if got != want:
            raise AssertionError(f"{path}: {got!r} vs {want!r}")
        return 0.0
    g, w = float(got), float(want)
    if not np.isfinite(w):
        if not (np.isnan(w) and np.isnan(g)) and g != w:
            raise AssertionError(f"{path}: {g} where the CPU has {w}")
        return 0.0
    if not abs(g - w) <= SERVE_ATOL + SERVE_RTOL * abs(w):
        raise AssertionError(f"{path}: {g} vs the CPU's {w}")
    return abs(g - w)


def phase_evaluate(root: Path, data: Path, ens: Path, layers: int,
                   members: int, kernel: str, rung: str):
    """`cli.evaluate --no-plots` on the ensemble in `ens`, on the card in
    f32 and bf16 and on the CPU in f32: the card's f32 metrics.json equals
    the CPU's (`close_to`); on the card `kernel` runs 2·layers times per
    member per batch of the test and calib splits and no other kernel runs,
    and each member's forwards after its first batch are replays of its one
    capture (one `Forward` serves both splits, packed to one budget).
    Returns {dtype: launches} of the card runs and their wall seconds."""
    import torch
    from gnnep_tpu_torch.cli import evaluate as cli
    from gnnep_tpu_torch.evaluate import runner
    sizes = []
    orig = runner._collect_members

    def recording(rows, runs, batches, *giants):
        sizes.append(len(batches))
        return orig(rows, runs, batches, *giants)

    metrics, launches, seconds = {}, {}, {}
    runner._collect_members = recording
    try:
        for dtype, device in (("float32", "cuda"), ("bfloat16", "cuda"),
                              ("float32", "cpu")):
            sizes.clear()
            out = root / f"eval_{rung}_{dtype}_{device}"
            t0 = time.perf_counter()
            with open(root / f"eval_{rung}_{dtype}_{device}.txt", "w") as log, \
                    contextlib.redirect_stdout(log):
                reset_counts()
                cli.main(eval_argv(data, ens, out, dtype, device))
                counts, replays = read_counts(), read_replays()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            res = json.loads((out / "test" / "metrics.json").read_text())
            if not np.isfinite([res["overall"]["rmse"],
                                res["overall"]["mae"]]).all():
                raise AssertionError(f"evaluate {rung} {dtype} {device}: "
                                     f"{res['overall']}")
            n_batches = sum(sizes)
            grew = counts.pop(kernel)
            want = 2 * layers * members * n_batches if device == "cuda" else 0
            want_replays = {"train": 0, "eval": members * (n_batches - 1)
                            if device == "cuda" else 0}
            if grew != want or any(counts.values()):
                raise AssertionError(
                    f"evaluate {rung} {dtype} {device}: {kernel} launched "
                    f"{grew} times, expected 2 convs x {layers} layers x "
                    f"{members} members x {n_batches} batches = {want}; "
                    f"others {counts}")
            if replays != want_replays:
                raise AssertionError(f"evaluate {rung} {dtype} {device}: "
                                     f"{replays} replays, expected "
                                     f"{want_replays}")
            if device == "cuda":
                launches[dtype], seconds[dtype] = grew, secs
            metrics[(dtype, device)] = res
            say("evaluate", rung=rung, dtype=dtype, device=device,
                members=members, test_batches=sizes[0],
                calib_batches=sizes[1], kernel=kernel, kernel_launches=grew,
                forward_replays=replays["eval"], cli_seconds=f"{secs:.2f}",
                rmse=f"{res['overall']['rmse']:.4f}",
                conformal_coverage=res["overall"]["conformal_coverage"])
    finally:
        runner._collect_members = orig
    err = close_to(metrics[("float32", "cuda")], metrics[("float32", "cpu")])
    say("evaluate", rung=rung, check="metrics_json_card_f32_vs_cpu",
        rtol=SERVE_RTOL, atol=SERVE_ATOL, max_abs_err=f"{err:.3e}")
    return dict(launches=launches, cli_seconds=seconds)


def phase_featurize(root: Path, ens: Path, layers: int):
    """`cli.fetch --from-json examples/custom_materials.json` with the
    fetcher's defaults (crystalnn; without pymatgen the 7.5 Å cutoff, and
    the bundled mat2vec table), each structure's host seconds and its
    graph's sizes and longest segments (per conv: the most edges into one
    target, kernel 5's row, and out of one source); then `cli.predict
    --mode custom` on those structures through the flagship ensemble in
    `ens`, one structure a batch, on the card in f32 and bf16 and on the
    CPU in f32: kernel 5 2·layers times per member per batch, every
    member's batches after its first replays, the card's f32 means equal
    the CPU's. Returns the fetch's and the card runs' numbers."""
    import torch
    from gnnep_tpu_torch.cli import fetch
    from gnnep_tpu_torch.cli import predict as cli_predict
    from gnnep_tpu_torch.data.store import GraphStore
    out = root / "fetched"
    host = {}
    orig = fetch.build_graph

    def timed(structure, **kw):
        t0 = time.perf_counter()
        sample = orig(structure, **kw)
        host[kw["material_id"]] = time.perf_counter() - t0
        return sample

    fetch.build_graph = timed
    try:
        t0 = time.perf_counter()
        with open(root / "fetch.txt", "w") as log, \
                contextlib.redirect_stdout(log):
            fetch.main(["--out-dir", str(out), "--from-json", str(EXAMPLES)])
        fetch_secs = time.perf_counter() - t0
    finally:
        fetch.build_graph = orig
    store = GraphStore.load_dir(out, require_target=False, use_cache=False)
    graphs = {}
    for g, mid in enumerate(store.material_ids):
        s = store.sample(g)
        longest = {}
        for conv, src, dst, rows in (("atom", s.edge_src, s.edge_dst,
                                      s.n_nodes),
                                     ("lg", s.lg_src, s.lg_dst, s.n_edges)):
            longest[f"{conv}_dst"] = int(np.bincount(dst, minlength=rows)
                                         .max())
            longest[f"{conv}_src"] = int(np.bincount(src, minlength=rows)
                                         .max())
        graphs[mid] = dict(atoms=s.n_nodes, bonds=s.n_edges,
                           lg_edges=s.n_lg_edges, node_dim=s.node_feats
                           .shape[1], host_seconds=host[mid], **longest)
        say("featurize", material=mid, atoms=s.n_nodes, bonds=s.n_edges, lg_edges=s.n_lg_edges,
            **{f"longest_{k}": v for k, v in longest.items()},
            host_seconds=f"{host[mid]:.3f}")
    if (store.n_graphs != 3 or store.node_dim != 206
            or store.edge_dim != 36 or store.angle_dim != 11):
        raise AssertionError(f"fetched {store.n_graphs} graphs of widths "
                             f"{store.node_dim}/{store.edge_dim}/"
                             f"{store.angle_dim}")
    mat2vec = Path(fetch._default_mat2vec())
    mu, launches, seconds = {}, {}, {}
    for dtype, device in (("float32", "cuda"), ("bfloat16", "cuda"),
                          ("float32", "cpu")):
        pred = root / f"pred_custom_{dtype}_{device}.json"
        t0 = time.perf_counter()
        with open(root / f"cli_custom_{dtype}_{device}.txt", "w") as log, \
                contextlib.redirect_stdout(log):
            reset_counts()
            cli_predict.main(["--mode", "custom", "--input-file",
                              str(EXAMPLES), "--ensemble-dir", str(ens),
                              "--mat2vec-path", str(mat2vec),
                              "--batch-size", "1", "--compute-dtype", dtype,
                              "--device", device, "--output-json", str(pred)])
            counts, replays = read_counts(), read_replays()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        preds = json.loads(pred.read_text())["predictions"]
        m = np.asarray([p["mu"] for p in preds], np.float64)
        sigma = np.asarray([p["sigma"] for p in preds], np.float64)
        if m.shape != (3, 2) or not (np.isfinite(m).all()
                                     and np.isfinite(sigma).all()
                                     and (sigma > 0).all()):
            raise AssertionError(f"custom {dtype} {device}: mu {m}, "
                                 f"sigma {sigma}")
        on_card = device == "cuda"
        grew = counts.pop("attn_eproj_fwd")
        want = 2 * layers * MEMBERS * 3 if on_card else 0
        want_replays = {"train": 0, "eval": MEMBERS * 2 if on_card else 0}
        if grew != want or any(counts.values()) or replays != want_replays:
            raise AssertionError(
                f"custom {dtype} {device}: attn_eproj_fwd launched {grew} "
                f"times (expected 2 convs x {layers} layers x {MEMBERS} "
                f"members x 3 batches = {want}), others {counts}, replays "
                f"{replays} (expected {want_replays})")
        mu[(dtype, device)] = m
        if on_card:
            launches[dtype], seconds[dtype] = grew, secs
        say("featurize", serve="custom", dtype=dtype, device=device,
            members=MEMBERS, batches=3, kernel_launches=grew,
            forward_replays=replays["eval"], cli_seconds=f"{secs:.2f}",
            mu=json.dumps(np.round(m, 3).tolist()))
    got, want = mu[("float32", "cuda")], mu[("float32", "cpu")]
    if not np.allclose(got, want, rtol=SERVE_RTOL, atol=SERVE_ATOL):
        raise AssertionError(f"custom structures: the card's f32 mu {got} "
                             f"differ from the CPU's {want}")
    say("featurize", check="custom_mu_card_f32_vs_cpu", rtol=SERVE_RTOL,
        atol=SERVE_ATOL, max_abs_err=f"{np.abs(got - want).max():.3e}")
    return dict(fetch_seconds=fetch_secs, graphs=graphs, launches=launches,
                cli_seconds=seconds)


# the trainer's default clip, [0.2, 1.0], takes every weight of the
# fixture to one bound (the local label variance is in GPa², so
# 1 + β·var is in the thousands): the run widens it, so that the weights
# carry both the density and the label-variance terms
KNN_FLAGS = ["--enable-density-weighting", "--weight-warmup-epochs", "0",
             "--knn-refresh", "1", "--save-embeddings",
             "--knn-weight-min", "1e-4", "--knn-weight-max", "1e4"]


def phase_knn(root: Path, data: Path, layers: int, setup, train_batches,
              dev):
    """`cli.train` with KNN density weighting (one member, 3 epochs, f32,
    weights refreshed after every epoch from the first) and
    `--save-embeddings`: every loss finite, every step after the warm-up a
    replay of the captured step, kernels 6 and 7 2·layers times per step
    and kernel 5 2·layers times per forward (train, eval and embedding),
    each snapshot's weights mean 1 and within the clip ratio, the four
    embedding files [n_split, hidden]. On the last snapshot's embeddings
    the device kNN on the card equals the host's (distances and weights
    within 1e-4, neighbour sets equal but where distances tie), and one
    captured step on batches carrying those weights equals the eager step
    (`phase_check_captured`)."""
    import torch
    from gnnep_tpu_torch.cli import train as cli_train
    from gnnep_tpu_torch.train import knn_weights as kw
    from gnnep_tpu_torch.train import member
    from gnnep_tpu_torch.train.ensemble import prepare
    out = root / "trained_knn"
    argv = train_argv(data, out, "float32", 1, 3) + KNN_FLAGS
    cfg = cli_train.config_from_args(cli_train.build_parser()
                                     .parse_args(argv))
    snaps, weights, snap_secs = [], [], []
    orig_snap, orig_weights = kw.snapshot_embeddings, member.compute_knn_weights

    def recording_snapshot(*a, **k):
        snaps.append(orig_snap(*a, **k))
        return snaps[-1]

    def timed_weights(*a, **k):
        t0 = time.perf_counter()
        weights.append(orig_weights(*a, **k))
        snap_secs.append(time.perf_counter() - t0)
        return weights[-1]

    kw.snapshot_embeddings = recording_snapshot
    member.compute_knn_weights = timed_weights
    t0 = time.perf_counter()
    try:
        with open(root / "train_knn.txt", "w") as log, \
                contextlib.redirect_stdout(log):
            summary, counts, losses, forwards, replays = run_counted(
                lambda: cli_train.main(argv))
    finally:
        kw.snapshot_embeddings = orig_snap
        member.compute_knn_weights = orig_weights
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    steps = summary["optimizer_steps"]
    loss = torch.cat(losses).cpu().numpy() if losses else np.zeros(0)
    if steps <= 0 or len(loss) != steps or not np.isfinite(loss).all():
        raise AssertionError(f"knn: {steps} optimizer steps, {len(loss)} "
                             f"losses, finite: {np.isfinite(loss).all()}")
    check_replays("knn", replays, steps, 1)
    want = {"attn_eproj_bwd": 2 * layers * steps,
            "csr_segment_sum": 2 * layers * steps,
            "attn_eproj_fwd": 2 * layers * (forwards["train"]
                                            + forwards["eval"])}
    for name, n in counts.items():
        if n != want.get(name, 0):
            raise AssertionError(f"knn: {name} launched {n} times, expected "
                                 f"{want.get(name, 0)} ({steps} steps, "
                                 f"forwards {forwards})")
    if len(weights) != 3:
        raise AssertionError(f"knn: {len(weights)} weight snapshots in 3 "
                             "epochs with --knn-refresh 1")
    ratio = cfg.knn_weight_max / cfg.knn_weight_min
    for w in weights:
        vals = np.asarray(list(w.values()))
        # clipped to [knn_weight_min, knn_weight_max], then divided by their
        # mean: the clip survives as the ratio
        if (abs(vals.mean() - 1.0) > 1e-5 or not (vals > 0).all()
                or vals.max() / vals.min() > ratio * (1 + 1e-6)):
            raise AssertionError(f"knn weights: mean {vals.mean()}, min "
                                 f"{vals.min()}, max {vals.max()}")
    split_setup = prepare(cfg)
    for split in ("train", "val", "calib", "test"):
        z = np.load(out / f"embeddings_{split}.npz")["z"]
        n = len(getattr(split_setup, f"{split}_idx"))
        if z.shape != (n, cfg.hidden) or not np.isfinite(z).all():
            raise AssertionError(f"embeddings_{split}: {z.shape}, expected "
                                 f"({n}, {cfg.hidden})")
    # the last snapshot: device kNN on the card against the host backend
    Z, Y, I = snaps[-1]
    Zs = kw.zscore(Z)
    k_eff = max(1, min(cfg.knn_k, Zs.shape[0] - 1))
    dd, di = kw.knn_neighbors(Zs, k_eff, backend="device", device=dev)
    hd, hi = kw.knn_neighbors(Zs, k_eff, backend="host")
    if not np.allclose(dd, hd, rtol=1e-4, atol=1e-4):
        raise AssertionError("knn: device distances differ from the host's "
                             f"by {np.abs(dd - hd).max():.3e}")
    full = np.linalg.norm(Zs[:, None].astype(np.float64) - Zs[None], axis=-1)
    np.fill_diagonal(full, np.inf)
    full = np.sort(full, axis=1)
    ties = np.abs(full[:, k_eff] - full[:, k_eff - 1]) <= 1e-4
    differ = np.array([set(a) != set(b) for a, b in zip(di, hi)])
    if (differ & ~ties).any():
        raise AssertionError(f"knn: {int((differ & ~ties).sum())} rows "
                             "without a distance tie have other neighbours "
                             "on the card")
    knn_kw = dict(k=cfg.knn_k, eps=cfg.knn_eps, alpha=cfg.knn_alpha,
                  beta=cfg.knn_beta, clip_min=cfg.knn_weight_min,
                  clip_max=cfg.knn_weight_max)
    wd = kw.density_weights(Z, Y, I, backend="device", device=dev, **knn_kw)
    wh = kw.density_weights(Z, Y, I, backend="host", **knn_kw)
    w_err = max(abs(wd[i] - wh[i]) for i in wh)
    if wd.keys() != wh.keys() or w_err > 1e-4:
        raise AssertionError(f"knn: device weights differ from the host's "
                             f"by {w_err:.3e}")
    say("knn", dtype="float32", members=1, epochs=3, optimizer_steps=steps,
        step_replays=replays["train"], forward_replays=replays["eval"],
        eval_forwards=forwards["eval"], kernel_launches=json.dumps(counts),
        snapshots=len(weights), snapshot_graphs=Zs.shape[0],
        snapshot_seconds=json.dumps([round(s, 3) for s in snap_secs]),
        weight_min=f"{min(weights[-1].values()):.4f}",
        weight_max=f"{max(weights[-1].values()):.4f}",
        loss_sum_first=f"{loss[0]:.4f}", loss_sum_last=f"{loss[-1]:.4f}",
        cli_seconds=f"{secs:.2f}")
    say("knn", check="device_vs_host", k=k_eff, rows=Zs.shape[0],
        max_abs_err_dist=f"{np.abs(dd - hd).max():.3e}",
        rows_other_neighbours=int(differ.sum()), tie_rows=int(ties.sum()),
        max_abs_err_weight=f"{w_err:.3e}")
    # the last snapshot's weights on the trainer's batches, through the
    # captured step's buffers
    weight_arr = np.ones(setup.store.n_graphs, np.float32)
    for g, w in weights[-1].items():
        weight_arr[g] = w
    weighted = member._graft_weights(train_batches[:3], weight_arr)
    real = np.asarray(weighted[2].graph_mask) > 0
    if np.ptp(np.asarray(weighted[2].weight)[real]) <= 0:
        raise AssertionError("knn: the checked batch's weights are uniform")
    phase_check_captured(setup, weighted, dev, "eproj", "float32",
                         what="captured_step_vs_eager_knn_weights")
    return dict(counts=counts, steps=steps, seconds=secs,
                snapshot_seconds=snap_secs, snapshot_graphs=Zs.shape[0])


# ------------------------------------------- phase 5b (resume, processes,
# profiling, bundles, conversion)
RESUME_EPOCHS = 4


@contextlib.contextmanager
def archives(copy_at=None, copy_to=()):
    """`member.save_pytree` wrapped: every resume archive a member writes
    (its leaves as host arrays, and its meta) is also kept by (member seed,
    epoch), and the file of epoch `copy_at` is copied into each directory
    of `copy_to`, as a run stopped after that epoch would have left it.
    The wrapper goes afterwards."""
    import shutil
    import torch
    from gnnep_tpu_torch.train import member
    real, kept = member.save_pytree, {}

    def saving(path, leaves, meta=None):
        real(path, leaves, meta)
        seed = int(Path(path).stem.rsplit("_", 1)[1])
        kept[(seed, meta["epoch"])] = dict(
            leaves=[np.array(x.detach().cpu()) if isinstance(x, torch.Tensor)
                    else np.asarray(x) for x in leaves], meta=dict(meta))
        if meta["epoch"] == copy_at:
            for d in copy_to:
                Path(d).mkdir(parents=True, exist_ok=True)
                shutil.copy2(path, Path(d) / Path(path).name)

    member.save_pytree = saving
    try:
        yield kept
    finally:
        member.save_pytree = real


def quiet_off(argv: list) -> list:
    """The request with the trainer's per-epoch and best-epoch lines on."""
    return [a for a in argv if a != "--quiet"]


def _rel(a, b, scale) -> float:
    """‖a − b‖ / ‖scale‖ over lists of arrays."""
    d = np.sqrt(sum(float(np.sum((x.astype(np.float64) - y) ** 2))
                    for x, y in zip(a, b)))
    s = np.sqrt(sum(float(np.sum(np.asarray(x, np.float64) ** 2))
                    for x in scale))
    return d / max(s, 1e-30)


def member_init(cfg_argv: list, setup, i: int):
    """Member i's initial parameters (leaf order) and its seed, as
    `run_training` draws them for the request `cfg_argv`."""
    from gnnep_tpu_torch.cli import train as cli_train
    from gnnep_tpu_torch.models.alignn import init_alignn
    from gnnep_tpu_torch.train.artifacts import leaves_from_params
    from gnnep_tpu_torch.train.ensemble import member_plan
    cfg = cli_train.config_from_args(cli_train.build_parser()
                                     .parse_args(cfg_argv))
    seed_i, _, _, _, mc, _ = member_plan(cfg, setup, i)
    return leaves_from_params(init_alignn(np.random.default_rng(seed_i),
                                          mc)), seed_i


def npz_leaves(path: Path) -> list:
    with np.load(path) as d:
        return [d[k] for k in sorted(k for k in d.files
                                     if k.startswith("leaf_"))]


# how far, at most, a run under test may lie from the runs it is held
# against, in multiples of those runs' own largest distance from each
# other: on the card float atomics (kernel 6's dW_e, the pooling's
# `index_add_`) move two runs of one member apart, by an amount that
# varied fourfold between pairs of one call on an H100 (PERF.md §6).
# Held where the runs' spread is tight: within the first two steps from
# one state, 66 pairs of 12 runs lie within 1.3-1.8x of each other; by
# the eighth the pairs spread 5-44x, in jumps, as Adam turns rounding
# noise in gradients of about zero into whole steps (PERF.md §6, PR 13;
# `dev/repro_probe.py`), so later distances are printed, not held
NOISE_FACTOR = 4.0


def noise_reading(pairs, refs, scale) -> dict:
    """`pairs`: (got, want) leaf lists that should agree but for float
    atomics; `refs`: leaf lists of runs that differ only by them → the
    largest ‖got − want‖ / ‖scale‖ and the largest such distance between
    two of `refs`."""
    return {"rel_dist": max(_rel(g, w, scale) for g, w in pairs),
            "runs_rel_dist": max(_rel(refs[i], refs[j], scale)
                                 for i in range(len(refs))
                                 for j in range(i + 1, len(refs)))}


def check_noise(what: str, pairs, refs, scale) -> dict:
    """`noise_reading`, whose first distance must be within NOISE_FACTOR
    times the second, plus 1e-6. Returns both."""
    reading = noise_reading(pairs, refs, scale)
    got, noise = reading["rel_dist"], reading["runs_rel_dist"]
    if not got <= NOISE_FACTOR * noise + 1e-6:
        raise AssertionError(f"{what}: {got:.3e} of the update away, beyond "
                             f"{NOISE_FACTOR:g}x the runs' own {noise:.3e}")
    return reading


RESUMES = 3


@contextlib.contextmanager
def step_states():
    """`GraphTrainStep._one` wrapped: after each optimizer step of every
    member's captured step, a device copy of its parameters (flat, the
    step's order) is appended to the yielded list. The wrapper goes
    afterwards."""
    import torch
    from gnnep_tpu_torch.train.loop import GraphTrainStep
    real, kept = GraphTrainStep._one, []

    def recording(self, batch, generator):
        out = real(self, batch, generator)
        kept.append(torch.cat([p.detach().reshape(-1)
                               for p in self.params]).clone())
        return out

    GraphTrainStep._one = recording
    try:
        yield kept
    finally:
        GraphTrainStep._one = real


def phase_resume(root: Path, data: Path, layers: int, setup, train_batches,
                 dev):
    """Mid-training resume on the default rung through `cli.train`, f32 and
    bf16: one member for RESUME_EPOCHS epochs with `--checkpoint-every 1`,
    whose epoch-2 archive is copied aside as a run stopped there would have
    left it; then RESUMES runs of `cli.train --resume` from those copies,
    each to epoch RESUME_EPOCHS (the LR schedule the 4-epoch one). Each
    resumed run prints 'resumed at epoch 3' and no earlier epoch, takes
    the uninterrupted run's steps less the first two epochs' (Adam's count
    in the epoch-2 archive), replays its captured step after its warm-up,
    launches kernels 6 and 7 2·layers times a step and kernel 5 2·layers
    times a forward (train and eval), and ends with Adam's count and the
    generator's state equal to the uninterrupted run's. Their parameters
    after their first step lie from the uninterrupted run's after its
    first step from the epoch-2 state within NOISE_FACTOR times the
    resumed runs' distance from each other (all start from the same bits:
    only float atomics part them; `check_noise`, over that step's update);
    their parameters at epoch RESUME_EPOCHS, and their `model_0.npz`
    against the uninterrupted run's parameters at their best epoch, are
    printed beside the same spread. Then a captured step from the epoch-2
    state (written into the step after its capture) against eager steps
    from it (`phase_check_captured`)."""
    import torch
    from gnnep_tpu_torch.cli import train as cli_train
    res = {}
    for dtype in ("float32", "bfloat16"):
        base = quiet_off(train_argv(data, root / "unused", dtype, 1,
                                    RESUME_EPOCHS)) + ["--checkpoint-every",
                                                       "1"]
        init, seed = member_init(base, setup, 0)
        n = len(init)
        outs = {k: root / f"resume_{dtype}_{k}"
                for k in ["full"] + [f"r{i}" for i in range(RESUMES)]}
        runs, secs = {}, {}
        for kind, out in outs.items():
            args = [a if a != str(root / "unused") else str(out)
                    for a in base] + ([] if kind == "full" else ["--resume"])
            copies = ([outs[k] for k in outs if k != "full"]
                      if kind == "full" else [])
            t0 = time.perf_counter()
            log_path = root / f"resume_{dtype}_{kind}.txt"
            with open(log_path, "w") as log, \
                    contextlib.redirect_stdout(log), \
                    archives(2, copies) as kept, step_states() as states:
                result = run_counted(lambda: cli_train.main(args))
            torch.cuda.synchronize()
            secs[kind] = time.perf_counter() - t0
            runs[kind] = dict(kept=kept, out=out, result=result,
                              log=log_path.read_text(), states=[
                                  x.cpu().numpy() for x in states])
        full = runs["full"]
        first_two = int(full["kept"][(seed, 2)]["leaves"][4 * n])
        total = full["result"][0]["optimizer_steps"]
        last_full = full["kept"][(seed, RESUME_EPOCHS)]["leaves"]
        resumed = [runs[k] for k in outs if k != "full"]
        for r in resumed:
            summary, counts, _, forwards, replays = r["result"]
            log = r["log"]
            if ("resumed at epoch 3" not in log or "Epoch 001" in log
                    or "Epoch 002" in log or "Epoch 003" not in log):
                raise AssertionError(f"resume {dtype}: a resumed run's log "
                                     "does not start at epoch 3")
            steps = summary["optimizer_steps"]
            if steps != total - first_two or steps <= 0:
                raise AssertionError(f"resume {dtype}: {steps} steps "
                                     f"resumed, {total} uninterrupted, "
                                     f"{first_two} in the first two epochs")
            check_replays(f"resume {dtype}", replays, steps, 1)
            want = {"attn_eproj_bwd": 2 * layers * steps,
                    "csr_segment_sum": 2 * layers * steps,
                    "attn_eproj_fwd": 2 * layers * (forwards["train"]
                                                    + forwards["eval"])}
            for name, n_want in want.items():
                if counts[name] != n_want or forwards["train"] != steps:
                    raise AssertionError(
                        f"resume {dtype}: {name} launched {counts[name]} "
                        f"times, expected {n_want} ({steps} steps, "
                        f"{forwards} forwards)")
            last = r["kept"][(seed, RESUME_EPOCHS)]
            r["best"] = int(last["meta"]["best_epoch"])
            if int(last["leaves"][4 * n]) != int(last_full[4 * n]):
                raise AssertionError(f"resume {dtype}: Adam's count differs")
            if not np.array_equal(last["leaves"][4 * n + 1],
                                  last_full[4 * n + 1]):
                raise AssertionError(f"resume {dtype}: the generator's state "
                                     f"at epoch {RESUME_EPOCHS} differs")
            if (r["out"] / f"resume_member_{seed}.npz").exists():
                raise AssertionError(f"resume {dtype}: the resume file "
                                     "outlived the member")
        # the first step from the epoch-2 state: the uninterrupted run's
        # step first_two + 1 against each resumed run's first
        states = full["states"]
        if len(states) != total or any(len(r["states"]) != total - first_two
                                       for r in resumed):
            raise AssertionError(f"resume {dtype}: recorded "
                                 f"{len(states)} and "
                                 f"{[len(r['states']) for r in resumed]} "
                                 "steps")
        firsts = [[r["states"][0]] for r in resumed]
        first = check_noise(
            f"resume {dtype} parameters after the first resumed step",
            [(f, [states[first_two]]) for f in firsts], firsts,
            [states[first_two] - states[first_two - 1]])
        scale = [a - b for a, b in zip(last_full[:n],
                                       full["kept"][(seed, 2)]["leaves"][:n])]
        finals = [r["kept"][(seed, RESUME_EPOCHS)]["leaves"][:n]
                  for r in resumed]
        final = noise_reading([(f, last_full[:n]) for f in finals], finals,
                              scale)
        saved = noise_reading(
            [(npz_leaves(r["out"] / "model_0.npz"),
              full["kept"][(seed, r["best"])]["leaves"][:n])
             for r in resumed], finals, scale)
        names = leaf_names_of(setup)
        arch = full["kept"][(seed, 2)]["leaves"]
        state = dict(params=dict(zip(names, arch[:n])),
                     mu=dict(zip(names, arch[2 * n:3 * n])),
                     nu=dict(zip(names, arch[3 * n:4 * n])),
                     count=int(arch[4 * n]))
        phase_check_captured(setup, train_batches, dev, "eproj", dtype,
                             what="captured_step_vs_eager_resumed",
                             state=state)
        summary, counts, _, forwards, replays = resumed[0]["result"]
        res[dtype] = dict(counts=counts, steps=summary["optimizer_steps"],
                          uninterrupted_steps=total,
                          first_two_epochs_steps=first_two,
                          best_epochs=[r["best"] for r in resumed],
                          seconds=secs, first_step=first, final=final,
                          model_0=saved)
        say("resume", dtype=dtype, epochs=RESUME_EPOCHS, resumed_from=2,
            resumed_runs=RESUMES, resumed_steps=summary["optimizer_steps"],
            uninterrupted_steps=total, first_two_epochs_steps=first_two,
            step_replays=replays["train"], eval_forwards=forwards["eval"],
            kernel_launches=json.dumps(counts),
            adam_count_equal=True, generator_state_equal=True,
            first_step_rel_dist=f"{first['rel_dist']:.3e}",
            first_step_resumed_runs_rel_dist=f"{first['runs_rel_dist']:.3e}",
            final_rel_dist=f"{final['rel_dist']:.3e}",
            final_resumed_runs_rel_dist=f"{final['runs_rel_dist']:.3e}",
            best_epochs=",".join(str(r["best"]) for r in resumed),
            model0_rel_dist=f"{saved['rel_dist']:.3e}",
            cli_seconds="|".join(f"{k}={v:.2f}" for k, v in secs.items()))
    return res


def leaf_names_of(setup):
    """The flagship member's leaf names (the checkpoint's order)."""
    from gnnep_tpu_torch.models.alignn import leaf_names
    return leaf_names(check_config(setup, [], "eproj")[0])


INPROC_RUNS = 3
ISOLATION_EPOCHS = 1
_CHILD_LINE = re.compile(r"^\[member_proc (\d+)\] launches=(\{.*\})$",
                         re.MULTILINE)
_BEST_LINE = re.compile(r"^\[Member (\d+)\] Best epoch (\d+) ", re.MULTILINE)


def child_counts(log: str) -> dict:
    """{member: {kernel: launches}} from the member processes' lines."""
    by_key = {f"{mod.rsplit('.', 1)[1]}.{attr}": name
              for name, (mod, attr) in COUNTERS.items()}
    return {int(i): {by_key[k]: v for k, v in json.loads(js).items()
                     if k in by_key}
            for i, js in _CHILD_LINE.findall(log)}


def phase_isolation(root: Path, data: Path, layers: int, setup):
    """`cli.train --member-isolation process`, TRAIN_MEMBERS members ×
    ISOLATION_EPOCHS epoch in f32 (phase_train's f32 request but the
    epochs): each member trained in its own `python -m
    gnnep_tpu_torch.train.member_proc` process, which prints its launch
    counts (kernels 6 and 7 2·layers times per optimizer step that it
    reports); the parent launches neither. Against INPROC_RUNS in-process
    runs of the same request, each process member's `model_{i}.npz` lies
    within NOISE_FACTOR times their distance from each other of theirs
    (`check_noise`, over the update from the member's initial
    parameters). One epoch is two optimizer steps, where runs of one
    member on the card stay within 1.3x of each other (NOISE_FACTOR)."""
    import torch
    from gnnep_tpu_torch.cli import train as cli_train
    base = quiet_off(train_argv(data, root / "unused", "float32",
                                TRAIN_MEMBERS, ISOLATION_EPOCHS))

    def argv_for(out, extra):
        return [a if a != str(root / "unused") else str(out)
                for a in base] + extra

    inproc = []
    for k in range(INPROC_RUNS):
        out = root / f"isolation_inproc_{k}"
        with open(root / f"isolation_inproc_{k}.txt", "w") as log, \
                contextlib.redirect_stdout(log):
            cli_train.main(argv_for(out, []))
        inproc.append(out)
    out = root / "isolation_proc"
    t0 = time.perf_counter()
    with open(root / "isolation_proc.txt", "w") as log, \
            contextlib.redirect_stdout(log):
        summary, counts, _, _, _ = run_counted(lambda: cli_train.main(
            argv_for(out, ["--member-isolation", "process"])))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log = (root / "isolation_proc.txt").read_text()
    kids = child_counts(log)
    best = {int(s): int(e) for s, e in _BEST_LINE.findall(log)}
    steps = summary["member_optimizer_steps"]
    if sorted(kids) != list(range(TRAIN_MEMBERS)) or len(best) != \
            TRAIN_MEMBERS:
        raise AssertionError(f"isolation: launch lines of members "
                             f"{sorted(kids)}, best-epoch lines {best}")
    if counts["attn_eproj_bwd"] or counts["csr_segment_sum"]:
        raise AssertionError(f"isolation: the parent trained ({counts})")
    members = []
    for i in range(TRAIN_MEMBERS):
        for name in ("attn_eproj_bwd", "csr_segment_sum"):
            if kids[i][name] != 2 * layers * steps[i]:
                raise AssertionError(
                    f"isolation: member {i}'s process launched {name} "
                    f"{kids[i][name]} times for {steps[i]} steps")
        init, _ = member_init(base, setup, i)
        got = npz_leaves(out / f"model_{i}.npz")
        refs = [npz_leaves(d / f"model_{i}.npz") for d in inproc]
        upd = [w - v for w, v in zip(refs[0], init)]
        close = check_noise(f"isolation member {i}",
                            [(got, r) for r in refs], refs, upd)
        members.append(close)
        say("isolation", member=i, process_steps=steps[i],
            child_kernel_launches=json.dumps(kids[i]),
            rel_dist=f"{close['rel_dist']:.3e}",
            inproc_runs_rel_dist=f"{close['runs_rel_dist']:.3e}")
    launches = {name: sum(k[name] for k in kids.values())
                for name in ("attn_eproj_fwd", "attn_eproj_bwd",
                             "csr_segment_sum")}
    say("isolation", members=TRAIN_MEMBERS, epochs=ISOLATION_EPOCHS,
        cli_seconds=f"{secs:.2f}", parent_kernel_launches=json.dumps(counts),
        children_kernel_launches=json.dumps(launches))
    return dict(launches=launches, seconds=secs, members=members,
                member_optimizer_steps=steps)


def kernel_calls(trace: Path) -> dict:
    """{kernel: calls} of the CUDA kernel records in a Chrome trace
    (`PROFILED`'s patterns)."""
    events = json.loads(trace.read_text())["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {pattern: sum(1 for k in names
                         if re.search(rf"\b{pattern}\b", k))
            for pattern in PROFILED}


def phase_profile(root: Path, data: Path, layers: int):
    """`cli.train --profile-dir` (one member, 2 epochs, f32) beside the same
    run untraced: one trace file, written by the trainer's own
    `utils.profiling.maybe_trace`; the traced (first) epoch ran the captured
    step (replays); the trace's calls of kernels 5, 6 and 7 equal their
    launch counts over that epoch; the epoch's program spans are in the
    trace, each only as a host record (no device-side copy on the card's
    timeline); the epoch captured one step and at most one forward (a
    one-batch val set captures none). Also the first epoch's wall, traced
    and untraced (from a wrapper around the trainer's `maybe_trace`, which
    times the whole epoch inside the trace's window)."""
    import torch
    from gnnep_tpu_torch.cli import train as cli_train
    from gnnep_tpu_torch.ops.cuda import graphs
    from gnnep_tpu_torch.train import member
    from gnnep_tpu_torch.utils.profiling import SPAN_PREFIX
    real = member.maybe_trace
    epochs = []

    @contextlib.contextmanager
    def timed(trace_dir):
        with real(trace_dir):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            epochs.append(dict(wall_s=time.perf_counter() - t0,
                               counts=read_counts(), replays=read_replays(),
                               captures=dict(graphs.captures)))

    walls, first = {}, {}
    member.maybe_trace = timed
    try:
        for kind in ("untraced", "traced"):
            epochs.clear()
            trace_dir = root / f"profile_{kind}"
            argv = train_argv(data, root / f"trained_profile_{kind}",
                              "float32", 1, 2)
            if kind == "traced":
                argv += ["--profile-dir", str(trace_dir)]
            t0 = time.perf_counter()
            with open(root / f"profile_{kind}.txt", "w") as log, \
                    contextlib.redirect_stdout(log):
                cli_train.main(argv)
            torch.cuda.synchronize()
            walls[kind] = time.perf_counter() - t0
            first[kind] = epochs[0]
    finally:
        member.maybe_trace = real
    traces = sorted((root / "profile_traced").glob("*.pt.trace.json"))
    if len(traces) != 1 or (root / "profile_untraced").exists():
        raise AssertionError(f"profile: trace files {traces}")
    calls = kernel_calls(traces[0])
    counts, replays = first["traced"]["counts"], first["traced"]["replays"]
    if replays["train"] <= 0:
        raise AssertionError(f"profile: the traced epoch replayed no "
                             f"captured step ({replays})")
    seen = {}
    for pattern in (r"attn_eproj_fwd_kernel", r"attn_eproj_bwd_attn_kernel",
                    r"csr_segment_sum_kernel"):
        launched = sum(counts[n] for n in PROFILED[pattern])
        seen[pattern] = (calls[pattern], launched)
        if calls[pattern] != launched or launched <= 0:
            raise AssertionError(f"profile: the trace holds {calls[pattern]} "
                                 f"calls of {pattern}, the first epoch "
                                 f"launched {launched}")
    captures = first["traced"]["captures"]
    if captures["train"] != 1 or captures["eval"] > 1:
        raise AssertionError(f"profile: the first epoch captured {captures}, "
                             "not one step and at most one forward")
    spans: dict = {}
    for e in json.loads(traces[0].read_text())["traceEvents"]:
        name = e.get("name", "")
        if name.startswith(SPAN_PREFIX):
            spans.setdefault(name[len(SPAN_PREFIX):], set()).add(e.get("cat"))
    want = {"member.pack_wait", "member.steps", "stage.wait", "stage.copy",
            "step.eager", "graph.capture", "graph.replay", "step.readback",
            "member.val", "val.readback", "val.metrics", "member.select",
            "member.epoch_end"}
    if not want <= set(spans) or any(c != {"cpu_op"} for c in spans.values()):
        raise AssertionError(f"profile: the trace's spans {spans}, wanted "
                             f"{sorted(want)} as host records only")
    launches = {n: counts[n] for n in ("attn_eproj_fwd", "attn_eproj_bwd",
                                       "csr_segment_sum")}
    say("profile", run="cli_train_profile_dir", trace=traces[0].name,
        trace_mb=f"{traces[0].stat().st_size / 1e6:.1f}",
        first_epoch_step_replays=replays["train"],
        first_epoch_captures=f"train={captures['train']}|"
                             f"eval={captures['eval']}",
        trace_calls_equal_launch_counts=",".join(
            f"{p}={c}" for p, (c, _) in seen.items()),
        trace_spans=",".join(sorted(spans)),
        first_epoch_wall_s=f"traced={first['traced']['wall_s']:.3f}|"
                           f"untraced={first['untraced']['wall_s']:.3f}",
        cli_seconds=f"traced={walls['traced']:.2f}|"
                    f"untraced={walls['untraced']:.2f}")
    return dict(launches=launches, replays=replays, cli_seconds=walls,
                first_epoch_wall_s={k: v["wall_s"]
                                    for k, v in first.items()})


def _preds(path: Path):
    preds = json.loads(path.read_text())["predictions"]
    return ([p["material_id"] for p in preds],
            np.asarray([p["mu"] for p in preds], np.float64),
            np.asarray([p["sigma"] for p in preds], np.float64))


def phase_bundle(root: Path, data: Path, ens: Path, rung_ens: dict, cfg,
                 batches, dev):
    """AOT serving bundles: `cli.bundle export` of the 5-member flagship
    ensemble in f32 and bf16 and of the kv+e and external-logits ensembles
    in f32, each then served by `python -m gnnep_tpu_torch.cli.bundle
    predict` in a fresh process (the four at once) on the serving request
    of `[serve]` (the
    same 256 graphs in the same order): its predictions equal `cli.predict`'s
    to the bit, or else (named) at the serving tolerance in f32 and at 1e-1
    in bf16. Loaded in this process and counted: the rung's forward kernel
    (5, 3 or 1) runs members × batches × 2·layers times and nothing else,
    each member's program captured once and replayed on every later batch.
    Then member 0's bundle program and its captured `Forward` side by side
    over TIMING_BATCHES batches (wall and device ms per batch; the traced
    pass's kernel calls equal the launch counts)."""
    import torch
    from gnnep_tpu_torch.cli import bundle as cli_bundle
    from gnnep_tpu_torch.cli import predict as cli_predict
    from gnnep_tpu_torch.data.store import GraphStore
    from gnnep_tpu_torch.infer.bundle import ServingBundle
    jobs = (("eproj", "float32", ens, "attn_eproj_fwd", MEMBERS, ""),
            ("eproj", "bfloat16", ens, "attn_eproj_fwd", MEMBERS, ""),
            ("kv+e", "float32", rung_ens["kv+e"], RUNGS["kv+e"]["fwd"],
             RUNG_MEMBERS, "_kv+e"),
            ("logits", "float32", rung_ens["logits"], RUNGS["logits"]["fwd"],
             RUNG_MEMBERS, "_logits"))
    here = Path(__file__).resolve().parent
    metas, export_s, procs = {}, {}, {}
    for rung, dtype, src, _, _, _ in jobs:
        out = root / f"bundle_{rung}_{dtype}"
        t0 = time.perf_counter()
        with open(root / f"bundle_export_{rung}_{dtype}.txt", "w") as log, \
                contextlib.redirect_stdout(log):
            metas[rung, dtype] = cli_bundle.main(
                ["export", "--ensemble-dir", str(src), "--data-dir",
                 str(data), "--out", str(out), "--batch-size", str(BATCH),
                 "--compute-dtype", dtype])
        export_s[rung, dtype] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for rung, dtype, *_ in jobs:
        log = open(root / f"bundle_predict_{rung}_{dtype}.txt", "w")
        procs[rung, dtype] = (subprocess.Popen(
            [sys.executable, "-m", "gnnep_tpu_torch.cli.bundle", "predict",
             "--bundle-dir", str(root / f"bundle_{rung}_{dtype}"),
             "--data-dir", str(data), "--num-samples", str(N_GRAPHS),
             "--output-json", str(root / f"pred_bundle_{rung}_{dtype}.json")],
            cwd=here, stdout=log, stderr=subprocess.STDOUT), log)
    process_s = {}
    try:
        for key, (proc, log) in procs.items():
            rc = proc.wait(timeout=600)
            process_s[key] = time.perf_counter() - t0
            log.close()
            if rc != 0:
                raise AssertionError(
                    f"bundle {key}: cli.bundle predict failed:\n"
                    + Path(log.name).read_text()[-3000:])
    finally:
        for proc, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    out_all = {}
    for rung, dtype, src, kernel, members, tag in jobs:
        out, meta = root / f"bundle_{rung}_{dtype}", metas[rung, dtype]
        ids, mu, sigma = _preds(root / f"pred_bundle_{rung}_{dtype}.json")
        ids_c, mu_c, sigma_c = _preds(root / f"pred{tag}_{dtype}.json")
        bitwise = ids == ids_c and np.array_equal(mu, mu_c) \
            and np.array_equal(sigma, sigma_c)
        err = max(np.abs(mu - mu_c).max(), np.abs(sigma - sigma_c).max())
        # bf16: a bf16 unit flipped by the atomics early in the trunk moves
        # a prediction by about 1 % on an H100 (PERF.md §6); a wrong member
        # moves it by tens of percent
        rtol, atol = ((SERVE_RTOL, SERVE_ATOL) if dtype == "float32"
                      else (1e-1, 1e-3))
        if ids != ids_c or not (np.allclose(mu, mu_c, rtol=rtol, atol=atol)
                                and np.allclose(sigma, sigma_c, rtol=rtol,
                                                atol=atol)):
            raise AssertionError(f"bundle {rung} {dtype}: predictions differ "
                                 f"from cli.predict's by {err:.3e}")
        # loaded here, counted
        t0 = time.perf_counter()
        bundle = ServingBundle.load(out, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        store = bundle.ensemble.scaler.apply(GraphStore.load_dir(data))
        idx = np.random.default_rng(42).choice(
            store.n_graphs, size=N_GRAPHS, replace=False).tolist()
        reset_counts()
        bundle.predict(store, idx)
        counts, replays = read_counts(), read_replays()
        grew = counts.pop(kernel)
        want = members * len(batches) * 2 * cfg.layers
        want_replays = {"train": 0, "eval": members * (len(batches) - 1)}
        if grew != want or any(counts.values()) or replays != want_replays:
            raise AssertionError(
                f"bundle {rung} {dtype}: {kernel} launched {grew} times "
                f"(expected {members} members x {len(batches)} batches x 2 "
                f"convs x {cfg.layers} layers = {want}), others {counts}, "
                f"replays {replays} (expected {want_replays})")
        rec = dict(kernel=kernel, launches=grew,
                   export_s=export_s[rung, dtype], load_s=load_s,
                   process_s=process_s[rung, dtype], bitwise=bool(bitwise),
                   max_abs_err=float(err), programs=max(
                       meta["member_programs"]) + 1)
        if dtype == "float32" and not bitwise:
            # the same request through cli.predict once more: whether the
            # forward itself differs between runs (the pooling's
            # `index_add_` adds in float atomics on the card)
            again = root / f"pred{tag}_{dtype}_again.json"
            with open(root / f"cli{tag}_again.txt", "w") as log, \
                    contextlib.redirect_stdout(log):
                cli_predict.main(serve_argv(root, data, src, dtype,
                                            tag + "_again_")[:-1]
                                 + [str(again)])
            _, mu_a, sigma_a = _preds(again)
            rec["cli_vs_cli_bitwise"] = bool(np.array_equal(mu_a, mu_c)
                                             and np.array_equal(sigma_a,
                                                                sigma_c))
            rec["not_bitwise_op"] = ("index_add_ (segment_mean pooling, "
                                     "float atomics)")
        if rung == "eproj":
            rec.update(_bundle_times(bundle, ens, batches, dev, dtype))
        out_all[f"{rung}_{dtype}"] = rec
        say("bundle", rung=rung, dtype=dtype, members=members,
            programs=rec["programs"], kernel=kernel, kernel_launches=grew,
            forward_replays=replays["eval"],
            export_s=f"{rec['export_s']:.2f}", load_s=f"{load_s:.2f}",
            fresh_process_predict_s=f"{rec['process_s']:.2f}",
            bitwise_vs_cli_predict=bitwise, max_abs_err=f"{err:.3e}",
            **{k: (f"{v:.3f}" if isinstance(v, float) else v)
               for k, v in rec.items()
               if k.startswith(("cli_vs", "not_bitwise", "ms_", "device_",
                                "forward_"))})
        del bundle
    return out_all


def _bundle_times(bundle, ens: Path, batches, dev, dtype: str) -> dict:
    """Member 0 through its bundle program and through the captured
    `Forward`, each over TIMING_BATCHES batches read back once: wall ms per
    batch (median of 5 passes) and device ms per batch (one traced pass,
    its kernel calls held to the launch counts)."""
    import torch
    from gnnep_tpu_torch.infer.bundle import BundleForward
    from gnnep_tpu_torch.train.artifacts import load_member
    from gnnep_tpu_torch.train.loop import cast_model, make_forward
    seq = [batches[i % len(batches)] for i in range(TIMING_BATCHES)]
    out = {}
    for kind in ("bundle", "forward"):
        if kind == "bundle":
            fwd, run = BundleForward(), bundle.members[0]
        else:
            fwd = make_forward(compute_dtype=dtype)
            run = cast_model(load_member(ens / "model_0.npz", dev), dtype)
        for b in seq[:2]:
            fwd(run, b)[0].cpu()

        def one_pass():
            return torch.stack([torch.stack(fwd(run, b)) for b in seq]).cpu()

        ms = chunk_ms(one_pass)[0] / len(seq)
        label = {"bundle": "bundle_program",
                 "forward": "forward_beside_bundle"}[kind]
        _, dev_ms = profile_run(one_pass, label, dtype, len(seq),
                                counted=True)
        fwd.close()
        out[f"ms_per_batch_{kind}"] = ms
        out[f"device_ms_per_batch_{kind}"] = dev_ms
    return out


def reference_state(rng, cfg) -> dict:
    """A HeteroAlignnRegressor state dict with the reference's parameter
    names and torch layouts ([out, in]), weights U(±1/√fan_in), at `cfg`'s
    widths; the base model's unused output heads included."""
    import torch
    h = cfg.hidden
    sd = {}

    def lin(name, out_dim, in_dim, bias=True):
        b = 1.0 / np.sqrt(in_dim)
        sd[f"{name}.weight"] = torch.from_numpy(
            rng.uniform(-b, b, (out_dim, in_dim)).astype(np.float32))
        if bias:
            sd[f"{name}.bias"] = torch.from_numpy(
                rng.uniform(-b, b, out_dim).astype(np.float32))

    for name, dim in (("node", cfg.node_dim), ("edge", cfg.edge_dim),
                      ("angle", cfg.angle_dim)):
        lin(f"base.{name}_encoder.0", h, dim)
        lin(f"base.{name}_encoder.2", h, h)
    for i in range(cfg.layers):
        for blk in (f"base.edge_blocks.{i}", f"base.node_blocks.{i}"):
            if "node" in blk:
                lin(f"{blk}.edge_proj", h, h)
            for name in ("lin_query", "lin_key", "lin_value", "lin_skip"):
                lin(f"{blk}.conv.{name}", h, h)
            lin(f"{blk}.conv.lin_edge", h, h, bias=False)
            lin(f"{blk}.conv.lin_beta", 1, 3 * h, bias=False)
            sd[f"{blk}.norm.weight"] = torch.from_numpy(
                rng.uniform(0.9, 1.1, h).astype(np.float32))
            sd[f"{blk}.norm.bias"] = torch.from_numpy(
                rng.uniform(-0.1, 0.1, h).astype(np.float32))
    lin("base.feat_proj.0", h, h + cfg.global_dim)
    for t in range(cfg.target_dim):
        for name in ("base.output_heads", "mean_heads", "logvar_heads"):
            lin(f"{name}.{t}", 1, h)
    return sd


def phase_convert(root: Path, data: Path, ens: Path, cfg, dev):
    """`cli.convert` on a reference directory written on the host (a
    flagship-width HeteroAlignnRegressor state dict with random weights
    from a seed, and the fixture's scaler and a conformal record as `.pt`
    files), then the converted member served through `cli.predict` on the
    card and on the CPU (one batch of BATCH graphs): kernel 5 2·layers
    times per batch, the card's means and σ equal the CPU's at the serving
    tolerance."""
    import torch
    from gnnep_tpu_torch.cli import convert as cli_convert
    from gnnep_tpu_torch.cli import predict as cli_predict
    from gnnep_tpu_torch.train.artifacts import load_scaler_state
    ref, conv = root / "reference_pt", root / "converted"
    ref.mkdir()
    t0 = time.perf_counter()
    torch.save(reference_state(np.random.default_rng(SEED + 5), cfg),
               ref / "model_0.pt")
    scaler, transformer, _ = load_scaler_state(ens / "scaler_state.npz")
    raw = {k: torch.from_numpy(np.array(v, np.float32))
           for k, v in scaler.state_dict().items() if v is not None}
    raw.update(target_transform="log", log_transform={
        "means": torch.from_numpy(np.asarray(transformer.means)),
        "stds": torch.from_numpy(np.asarray(transformer.stds))})
    torch.save(raw, ref / "scaler_state.pt")
    torch.save({"q": torch.tensor([0.9, 1.5]), "method": "scaled",
                "alpha": 0.1, "affine_a": torch.ones(2),
                "affine_b": torch.zeros(2)}, ref / "conformal.pt")
    with open(root / "convert.txt", "w") as log, \
            contextlib.redirect_stdout(log):
        n = cli_convert.main(["--reference-dir", str(ref), "--out-dir",
                              str(conv), "--heads", str(cfg.heads)])
    convert_s = time.perf_counter() - t0
    if n != 1:
        raise AssertionError(f"convert: {n} members converted")
    preds, launches = {}, {}
    for device in ("cuda", "cpu"):
        out = root / f"pred_converted_{device}.json"
        with open(root / f"cli_converted_{device}.txt", "w") as log, \
                contextlib.redirect_stdout(log):
            reset_counts()
            cli_predict.main(["--mode", "random", "--num-samples",
                              str(BATCH), "--batch-size", str(BATCH),
                              "--data-dir", str(data), "--ensemble-dir",
                              str(conv), "--output-json", str(out),
                              "--device", device])
            launches[device] = read_counts()
        preds[device] = _preds(out)
    want = 2 * cfg.layers
    got = launches["cuda"].pop("attn_eproj_fwd")
    if got != want or any(launches["cuda"].values()):
        raise AssertionError(f"convert: kernel 5 launched {got} times "
                             f"(expected {want}), others {launches['cuda']}")
    (ids_g, mu_g, sig_g), (ids_c, mu_c, sig_c) = preds["cuda"], preds["cpu"]
    err = max(np.abs(mu_g - mu_c).max(), np.abs(sig_g - sig_c).max())
    if ids_g != ids_c or not (
            np.allclose(mu_g, mu_c, rtol=SERVE_RTOL, atol=SERVE_ATOL)
            and np.allclose(sig_g, sig_c, rtol=SERVE_RTOL, atol=SERVE_ATOL)
            and np.isfinite(mu_g).all()):
        raise AssertionError(f"convert: the converted member's card "
                             f"predictions differ from the CPU's by "
                             f"{err:.3e}")
    say("convert", members=n, hidden=cfg.hidden, layers=cfg.layers,
        heads=cfg.heads, convert_s=f"{convert_s:.2f}", graphs=len(ids_g),
        kernel="attn_eproj_fwd", kernel_launches=got, rtol=SERVE_RTOL,
        atol=SERVE_ATOL, max_abs_err=f"{err:.3e}",
        mu_mean=f"{mu_g.mean():.4f}")
    return dict(launches=got, convert_s=convert_s, max_abs_err=float(err))


def span_config(store_or_none, batches, **kw):
    """The flagship config on the span rung (`conv_impl='fused'`,
    `attn_span=True`) with the span bounds `measure_span64` gives over
    `batches`, which `verify_win64` then holds them to; at the store's
    feature widths where one is given."""
    from gnnep_tpu_torch.data.batching import verify_win64
    from gnnep_tpu_torch.utils.synth import flagship_config
    nsp, bsp = span_bounds(batches)
    dims = {} if store_or_none is None else dict(
        node_dim=store_or_none.node_dim, edge_dim=store_or_none.edge_dim,
        angle_dim=store_or_none.angle_dim,
        global_dim=store_or_none.global_scalar_dim + 230)
    cfg = flagship_config(conv_impl="fused", attn_span=True,
                          edge_span64=nsp, lg_span64=bsp, **dims, **kw)
    verify_win64(batches, cfg)
    return cfg


def _only(counts: dict, want: dict, what: str) -> None:
    """Every kernel launched as `want` says, and no other."""
    for name, n in counts.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{what}: {name} launched {n} times, "
                                 f"expected {want.get(name, 0)} ({counts})")


def phase_span_forward(ens: Path, batches, dev):
    """`make_forward` over the served batches, at flagship width, with
    member 0's weights under a span config: kernel 8 2·layers times per
    forward and nothing else, in f32 and bf16; member 0's f32 means on the
    card against the CPU forward of the same member and config. Returns
    the config and kernel 8's launches over the f32 forwards."""
    import torch
    from gnnep_tpu_torch.models.alignn import DeviceBatch
    from gnnep_tpu_torch.train.artifacts import load_member
    from gnnep_tpu_torch.train.loop import cast_model, make_forward, with_config
    cfg = span_config(None, batches)
    model = with_config(load_member(ens / "model_0.npz", dev), cfg)
    dbs = [DeviceBatch.from_batch(b, dev) for b in batches]
    for dtype in ("float32", "bfloat16"):
        fwd, run = make_forward(compute_dtype=dtype), cast_model(model, dtype)
        for i, db in enumerate(dbs):
            reset_counts()
            mean, logvar = fwd(run, db)
            counts = read_counts()
            _only(counts, {"attn_span_fwd": 2 * cfg.layers},
                  f"span forward {dtype} batch {i}")
            if read_replays()["eval"] != int(i > 0):
                raise AssertionError(f"span forward {dtype} batch {i}: "
                                     f"{read_replays()} replays")
            if not (torch.isfinite(mean).all() and torch.isfinite(logvar).all()):
                raise AssertionError(f"span forward {dtype} batch {i}: "
                                     "non-finite outputs")
        fwd.close()
        say("span", forward=dtype, batches=len(dbs), replayed=len(dbs) - 1,
            edge_span64=cfg.edge_span64, lg_span64=cfg.lg_span64,
            attn_span_fwd_per_forward=2 * cfg.layers)
    fwd = make_forward()
    g_mean, _ = fwd(model, dbs[0])
    cpu = with_config(load_member(ens / "model_0.npz", "cpu"), cfg)
    c_mean, _ = fwd(cpu, DeviceBatch.from_batch(batches[0], "cpu"))
    err = (g_mean.cpu() - c_mean).abs().max().item()
    if not torch.allclose(g_mean.cpu(), c_mean, rtol=1e-3, atol=1e-4):
        raise AssertionError(f"span forward: member 0 means on the card "
                             f"differ from the CPU forward by {err:.3e}")
    say("span", check="member0_batch0_gpu_vs_cpu", rtol=1e-3, atol=1e-4,
        max_abs_err=f"{err:.3e}")
    return cfg, 2 * cfg.layers * len(dbs)


def write_span_ensemble(root: Path, ens: Path, cfg) -> Path:
    """Member 0 saved under the span config, with the scaler state."""
    from gnnep_tpu_torch.train.artifacts import load_member, save_member
    from gnnep_tpu_torch.train.loop import with_config
    out = root / "ensemble_span"
    out.mkdir()
    save_member(out / "model_0.npz",
                with_config(load_member(ens / "model_0.npz", "cpu"), cfg))
    (out / "scaler_state.npz").write_bytes(
        (ens / "scaler_state.npz").read_bytes())
    return out


def phase_span_train(setup, batches, dev):
    """`make_train_step` on the span config for one epoch over the
    trainer's batches, at flagship width, f32 and bf16, dropout and jitter
    at the trainer's defaults: per optimizer step every loss finite and
    kernels 8 and 9 2·layers times each, nothing else; every step after
    the warm-up a replay of the captured step."""
    import torch
    from gnnep_tpu_torch.models.alignn import DeviceBatch, init_alignn
    from gnnep_tpu_torch.train.loop import (WARMUP_STEPS, TrainHyper,
                                            make_train_step)
    cfg = span_config(setup.store, batches)
    t = setup.transformer
    out = {}
    for dtype in ("float32", "bfloat16"):
        step = make_train_step(init_alignn(np.random.default_rng(SEED + 5),
                                           cfg),
                               TrainHyper(compute_dtype=dtype), t.means,
                               t.stds, dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        losses = []
        t0 = time.perf_counter()
        for i, b in enumerate(batches):
            db = DeviceBatch.from_batch(b, dev)
            reset_counts()
            m = step(db, gen, 1e-4, 1e-4)
            counts = read_counts()
            _only(counts, {"attn_span_fwd": 2 * cfg.layers,
                           "attn_span_bwd": 2 * cfg.layers},
                  f"span train step {dtype} {i}")
            if read_replays()["train"] != int(i >= WARMUP_STEPS):
                raise AssertionError(f"span train step {dtype} {i}: "
                                     f"{read_replays()} replays")
            losses.append(float(m.loss_sum))
        secs = time.perf_counter() - t0
        step.close()
        if not np.isfinite(losses).all():
            raise AssertionError(f"span train {dtype}: losses {losses}")
        out[dtype] = dict(steps=len(losses), counts=dict(
            attn_span_fwd=2 * cfg.layers * len(losses),
            attn_span_bwd=2 * cfg.layers * len(losses)))
        say("span", train=dtype, optimizer_steps=len(losses),
            per_step="attn_span_fwd=%d,attn_span_bwd=%d" % (
                2 * cfg.layers, 2 * cfg.layers),
            loss_sum_first=f"{losses[0]:.4f}",
            loss_sum_last=f"{losses[-1]:.4f}", seconds=f"{secs:.2f}")
    return cfg, out


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


def check_config(setup, batches, rung: str, **width):
    """(flagship config on `rung` with dropout off and `width`'s fields,
    {fwd, bwd kernel}) for the step checks; on 'span' with the first
    batch's measured bounds."""
    from gnnep_tpu_torch.utils.synth import flagship_config
    store = setup.store
    spec = RUNGS.get(rung, dict(cfg={}, fwd="attn_eproj_fwd",
                                bwd="attn_eproj_bwd"))
    if rung == "span":
        nsp, bsp = span_bounds(batches[:1])
        spec = dict(cfg=dict(attn_span=True, edge_span64=nsp,
                             lg_span64=bsp),
                    fwd="attn_span_fwd", bwd="attn_span_bwd")
    cfg = flagship_config(node_dim=store.node_dim, edge_dim=store.edge_dim,
                          angle_dim=store.angle_dim,
                          global_dim=store.global_scalar_dim + 230,
                          dropout=0.0, **spec["cfg"], **width)
    return cfg, spec


def compare_steps(what: str, steps: dict, before: dict, metrics: dict):
    """Hold the step 'card' to the step 'ref' after one step of each from
    equal parameters and Adam state on the same batch (`before`: each
    side's parameters before it, on the CPU; `metrics`: each side's
    StepMetrics as floats):
    - StepMetrics and every gradient element at rtol 5e-3 / atol 1e-4 (the
      JAX package's model gradient tolerance), and each leaf's gradient and
      Adam first moment within 5e-3 of that leaf's largest magnitude (plus
      1e-5 and 1e-6: the noise of a theoretically zero gradient);
    - each leaf's update p_new − p_old within 1e-2 of that leaf's largest
      update (about the LR), leaving out only the elements whose
      bias-corrected first moment is about zero, where the two sides'
      difference could flip Adam's step or move it by a tenth of the limit;
      at most 10% of them. A skipped update, a flipped sign or the other
      group's LR is off by at least half an update.
    Returns (the printed summary's fields, the worst leaf per kind, the
    largest share of its limit any comparison reached)."""
    import torch
    from gnnep_tpu_torch.train.loop import ADAM_B1, ADAM_EPS
    rtol, atol = 5e-3, 1e-4
    top = 0.0

    def over(share, message):
        nonlocal top
        top = max(top, share)
        if share > 1.0:
            raise AssertionError(f"{what} {message}")

    worst_metric = 0.0
    for name, a, b in zip(("loss_sum", "n_graphs", "abs_err_sum",
                           "sq_err_sum", "n_elements", "logvar_sum",
                           "max_var"), metrics["card"], metrics["ref"]):
        if not np.isfinite(a):
            raise AssertionError(f"{what} {name}: {a}")
        over(abs(a - b) / (atol + rtol * abs(b)), f"{name}: {a} vs {b}")
        worst_metric = max(worst_metric, abs(a - b))
    card, ref = steps["card"], steps["ref"]
    names = [n for n, _ in ref.model.named_parameters()]
    count = int(ref.state.count)
    if int(card.state.count) != count:
        raise AssertionError(f"{what}: Adam counts {int(card.state.count)} "
                             f"and {count}")
    # per kind: (leaf, err, leaf scale, err / limit) of the leaf nearest
    # its limit
    worst = {k: ("", 0.0, 0.0, 0.0) for k in ("grad", "mu", "update")}
    left_out = left_sign = total = 0
    for i, name in enumerate(names):
        gc = card.params[i].grad.detach().cpu().float()
        gr = ref.params[i].grad.detach().cpu().float()
        over(float(((gc - gr).abs() / (atol + rtol * gr.abs())).max()),
             f"grad of {name}: differ by {(gc - gr).abs().max():.3e}")
        mc = card.state.mu[i].detach().cpu()
        mr = ref.state.mu[i].detach().cpu()
        checks = {"grad": _leaf_err(gc, gr, 1e-5),
                  "mu": _leaf_err(mc, mr, 1e-6)}
        uc = card.params[i].detach().cpu().float() - before["card"][i].float()
        ur = ref.params[i].detach().cpu().float() - before["ref"][i].float()
        # the bias-corrected first moments Adam stepped by (on the first
        # step, the clipped gradients). Its step is about m / (|m| + eps):
        # an element is left out where the two sides' difference d could
        # flip its sign (|m| <= 4d) or move it by more than a tenth of the
        # limit (d·eps / m² > 1e-3); one of exactly zero on both sides
        # leaves only the decay
        kc = mc / (1.0 - ADAM_B1 ** count)
        kr = mr / (1.0 - ADAM_B1 ** count)
        d = (kc - kr).abs()
        sign_open = kr.abs() <= 4.0 * d
        moved = d * ADAM_EPS > 1e-3 * kr * kr
        keep = ~(sign_open | moved) | ((kr == 0) & (kc == 0))
        left_out += int((~keep).sum())
        left_sign += int((sign_open & ~keep).sum())
        total += keep.numel()
        err = (uc - ur)[keep].abs().max().item() if keep.any() else 0.0
        leaf = ur.abs().max().item()
        checks["update"] = (err, leaf, 1e-2 * leaf)
        for kind, (e, leaf_scale, lim) in checks.items():
            share = e / lim if lim > 0 else 0.0
            over(share, f"{kind} of {name}: differ by {e:.3e}, above "
                        f"{lim:.3e} (leaf scale {leaf_scale:.3e})")
            if share >= worst[kind][3]:
                worst[kind] = (name, e, leaf_scale, share)
    if left_out > 0.1 * total:
        raise AssertionError(f"{what} update: {left_out} of {total} "
                             "elements have a first moment of about zero")
    return dict(leaves=len(names), adam_count=count,
                loss_sum=f"{metrics['card'][0]:.6f}",
                max_abs_err_metric=f"{worst_metric:.3e}",
                update_elements_left_out=f"{left_out}/{total}",
                of_them_sign_open=left_sign), worst, top


def say_worst(rung, worst, **kw):
    for kind, (name, e, leaf_scale, share) in worst.items():
        say("check", rung=rung, **kw, kind=kind, nearest_limit_leaf=name,
            max_abs_err=f"{e:.3e}", leaf_scale=f"{leaf_scale:.3e}",
            share_of_limit=f"{share:.3f}")


def phase_check(setup, batches, dev, rung: str = "eproj", **width):
    """One eager train step on the card against the CPU plain step from
    the same parameters and batch, dropout and jitter off, at LRs 1e-3 /
    5e-4, on `rung` (the card step launches that rung's forward and
    backward kernel 2·layers times each; on 'span' with the batch's
    measured bounds), at the flagship config or with `width`'s fields
    (hidden, heads, layers) replacing its own; `compare_steps` holds them."""
    import torch
    from gnnep_tpu_torch.models.alignn import DeviceBatch, init_alignn
    from gnnep_tpu_torch.train.loop import (TrainHyper, TrainStep,
                                            make_train_step)
    cfg, spec = check_config(setup, batches, rung, **width)
    hyper = TrainHyper(feature_jitter_std=0.0)
    t = setup.transformer
    steps, metrics, before = {}, {}, {}
    for where in ("card", "ref"):
        model = init_alignn(np.random.default_rng(SEED + 99), cfg)
        step = (TrainStep(model.to(dev), hyper, t.means, t.stds)
                if where == "card" else
                make_train_step(model, hyper, t.means, t.stds, "cpu"))
        before[where] = [p.detach().cpu().clone() for p in step.params]
        reset_counts()
        m = step(DeviceBatch.from_batch(batches[0], step.device), None,
                 CHECK_LR_MEAN, CHECK_LR_SIGMA)
        metrics[where] = [float(x) for x in m]
        steps[where] = step
        if where == "card":
            counts = read_counts()
            if (counts[spec["fwd"]], counts[spec["bwd"]]) != (
                    2 * cfg.layers, 2 * cfg.layers):
                raise AssertionError(f"train step check on {rung}: launches "
                                     f"{counts}")
    if not all(torch.equal(a, b) for a, b in zip(before["card"],
                                                 before["ref"])):
        raise AssertionError("train step check: the two models start from "
                             "different parameters")
    fields, worst, _ = compare_steps(f"train step card vs CPU ({rung})",
                                     steps, before, metrics)
    say("check", rung=rung, what="train_step_card_vs_cpu",
        hidden=cfg.hidden, heads=cfg.heads, layers=cfg.layers, rtol=5e-3,
        atol=1e-4, lr_mean=CHECK_LR_MEAN, lr_sigma=CHECK_LR_SIGMA, **fields)
    say_worst(rung, worst, hidden=cfg.hidden, heads=cfg.heads)


def rel_gaps(a, b, before_a, before_b, metrics_a, metrics_b) -> dict:
    """How far step `a` landed from step `b` after one step each from equal
    state: the largest relative difference of a StepMetrics field, and the
    relative L2 distance of all gradients, all Adam first moments and all
    updates (p_new − p_old), each over the whole model."""
    import torch

    def rel(xs, ys):
        x = torch.cat([t.detach().cpu().float().flatten() for t in xs])
        y = torch.cat([t.detach().cpu().float().flatten() for t in ys])
        return float(torch.linalg.vector_norm(x - y)
                     / torch.linalg.vector_norm(y).clamp_min(1e-30))

    return dict(
        metrics=max(abs(x - y) / max(abs(y), 1e-30)
                    for x, y in zip(metrics_a, metrics_b)),
        grad=rel([p.grad for p in a.params], [p.grad for p in b.params]),
        mu=rel(a.state.mu, b.state.mu),
        update=rel([p.detach().cpu() - q for p, q in zip(a.params, before_a)],
                   [p.detach().cpu() - q for p, q in zip(b.params, before_b)]))


def phase_check_captured(setup, batches, dev, rung: str, dtype: str,
                         what: str = "captured_step_vs_eager", state=None):
    """The card's captured step against its eager step, on `rung` in
    `dtype`, dropout and jitter off: the captured step takes batch 0 as its
    eager warm-up and batch 1 as its capture and first replay; then its
    parameters go back to their initial values and its Adam moments and
    count to zero (in place: the graph reads them where they are), and it
    and eager steps from the same initial parameters take batch 2 as their
    first optimizer step (for the captured step, its capture's second
    replay; each launches the rung's forward and backward kernel 2·layers
    times). In f32 `compare_steps` holds the replay to the eager step at
    phase_check's limits. In bf16 the eager step does not meet those limits
    against itself (float atomics in the pooling's `index_add_` and in
    kernels 6 / 9 add in another order each run, and bf16 rounds the
    difference up; one pair's largest elementwise gap swings by 3× from run
    to run): there the replay's relative distance from the eager step
    (`rel_gaps`: metrics, and the L2 distance of all gradients, moments and
    updates) must be within twice the larger of two eager steps' own
    distances from it, the metrics at least within one bf16 unit (2^-7).
    With `state` (parameters, Adam moments by name and Adam's count, as a
    resume archive holds them) the steps start from that state instead,
    written into each step's own tensors with `load_state` (the captured
    step's after its capture) at the trainer's LR groups."""
    import torch
    from gnnep_tpu_torch.models.alignn import init_alignn
    from gnnep_tpu_torch.train.loop import (GraphTrainStep, TrainHyper,
                                            TrainStep, make_train_step)
    cfg, spec = check_config(setup, batches, rung)
    hyper = TrainHyper(feature_jitter_std=0.0, compute_dtype=dtype)
    t = setup.transformer
    card = make_train_step(init_alignn(np.random.default_rng(SEED + 98),
                                       cfg), hyper, t.means, t.stds, dev)
    if not isinstance(card, GraphTrainStep):
        raise AssertionError("make_train_step on the card is not captured")
    for b in batches[:2]:
        card(b, None, CHECK_LR_MEAN, CHECK_LR_SIGMA)
    init = init_alignn(np.random.default_rng(SEED + 98), cfg)
    if state is not None:
        card.load_state(**state)
    else:
        with torch.no_grad():
            for p, q in zip(card.params, init.parameters()):
                p.copy_(q)
            for m in card.state.mu + card.state.nu:
                m.zero_()
            card.state.count.zero_()
    f32 = dtype == "float32"
    steps = {"card": card}
    for k in ("ref", "ref2") if f32 else ("ref", "ref2", "ref3"):
        steps[k] = TrainStep(init_alignn(np.random.default_rng(SEED + 98),
                                         cfg).to(dev), hyper, t.means, t.stds)
        if state is not None:
            steps[k].load_state(**state)
    before = {k: [p.detach().cpu().clone() for p in s.params]
              for k, s in steps.items()}
    metrics = {}
    for k, s in steps.items():
        reset_counts()
        metrics[k] = [float(x) for x in s(batches[2], None, CHECK_LR_MEAN,
                                          CHECK_LR_SIGMA)]
        counts, replays = read_counts(), read_replays()
        want = (2 * cfg.layers, 2 * cfg.layers, int(k == "card"))
        if (counts[spec["fwd"]], counts[spec["bwd"]],
                replays["train"]) != want:
            raise AssertionError(f"captured step check on {rung} {dtype} "
                                 f"({k}): launches {counts}, replays "
                                 f"{replays}")

    def gaps(k):
        return rel_gaps(steps[k], steps["ref"], before[k], before["ref"],
                        metrics[k], metrics["ref"])

    got = gaps("card")
    spread = {name: max(gaps(k)[name] for k in steps if k.startswith("ref")
                        and k != "ref") for name in got}
    if f32:
        fields, worst, share = compare_steps(
            f"captured vs eager step ({rung}, {dtype})",
            {"card": card, "ref": steps["ref"]}, before, metrics)
        verdict = dict(rtol=5e-3, atol=1e-4,
                       share_of_limit=f"{share:.3f}", **fields)
    else:
        limit = {name: 2.0 * v + 1e-6 for name, v in spread.items()}
        # a StepMetrics field is one sum or max, not an average over the
        # model: it may move by one bf16 unit (max_var is exp of one bf16
        # logvar), whatever one pair of eager steps showed
        limit["metrics"] = max(limit["metrics"], 2.0 ** -7)
        bad = {n: v for n, v in got.items() if v > limit[n]}
        if bad:
            raise AssertionError(f"captured vs eager step ({rung}, {dtype}): "
                                 f"{bad} beyond twice the eager steps' own "
                                 f"spread {spread}")
        verdict = dict(limit="2x_eager_spread",
                       adam_count=int(card.state.count),
                       loss_sum=f"{metrics['card'][0]:.6f}")
    card.close()
    say("check", rung=rung, dtype=dtype, what=what, **verdict,
        **{f"captured_rel_{n}": f"{v:.3e}" for n, v in got.items()},
        **{f"eager_rel_{n}": f"{v:.3e}" for n, v in spread.items()})
    if f32:
        say_worst(rung, worst, dtype=dtype)


def full_batches(batches):
    """The batches of BATCH real graphs: an epoch's short last batch is not
    the step that sets throughput."""
    return [b for b in batches
            if int(np.asarray(b.graph_mask).sum()) == BATCH]


def phase_check_dropout(setup, batches, dev):
    """Dropout 0.15 and jitter 0.1 on (the trainer's defaults), eproj rung,
    f32: the captured step (one eager warm-up, then 8 replays) and 9 eager
    steps over the same batches from one generator seed agree step by step
    at phase_check's metric limits, or within twice the gap of a second
    eager run from that seed where that is wider (float atomics make two
    eager 9-step trajectories drift apart, by up to half the limits on an
    H100), and the generators end in the same state; 9 eager steps
    from another seed must be ten times that far off (the masks do move
    the metrics). A graph replaying its capture-time masks would fail the
    first check."""
    import torch
    from gnnep_tpu_torch.models.alignn import init_alignn
    from gnnep_tpu_torch.train.loop import (TrainHyper, TrainStep,
                                            make_train_step)
    from gnnep_tpu_torch.utils.synth import flagship_config
    store, t = setup.store, setup.transformer
    cfg = flagship_config(node_dim=store.node_dim, edge_dim=store.edge_dim,
                          angle_dim=store.angle_dim,
                          global_dim=store.global_scalar_dim + 230,
                          dropout=0.15)
    hyper = TrainHyper(feature_jitter_std=0.1)
    full = full_batches(batches)
    seq = [full[i % len(full)] for i in range(9)]
    rows, gens = {}, {}
    for kind, seed in (("captured", SEED), ("eager", SEED),
                       ("eager2", SEED), ("other_seed", SEED + 1)):
        model = init_alignn(np.random.default_rng(SEED + 97), cfg)
        step = (make_train_step(model, hyper, t.means, t.stds, dev)
                if kind == "captured" else
                TrainStep(model.to(dev), hyper, t.means, t.stds))
        gens[kind] = torch.Generator(device=dev).manual_seed(seed)
        reset_counts()
        ms = step.run(seq, gens[kind], 1e-4, 1e-4)
        rows[kind] = torch.stack(list(ms), 1).double().cpu().numpy()
        if kind == "captured":
            if read_replays()["train"] != 8:
                raise AssertionError(f"dropout check: {read_replays()} "
                                     "replays, expected 8")
            step.close()
    rtol, atol = 5e-3, 1e-4

    def gap(a, b):
        """Largest |a − b| over the limit, over every step and metric."""
        return float((np.abs(a - b) / (atol + rtol * np.abs(b))).max())

    same, drift, other = (gap(rows[k], rows["eager"])
                          for k in ("captured", "eager2", "other_seed"))
    limit = max(1.0, 2.0 * drift)
    states_equal = torch.equal(gens["captured"].get_state(),
                               gens["eager"].get_state())
    say("check", what="captured_vs_eager_dropout_jitter", dropout=0.15,
        jitter=0.1, steps=9, replays=8,
        worst_share_of_limit=f"{same:.3f}",
        eager_vs_eager_share_of_limit=f"{drift:.3f}",
        limit=f"{limit:.3f}",
        other_seed_worst_share_of_limit=f"{other:.3f}",
        generator_states_equal=states_equal,
        loss_sum_captured=",".join(f"{x:.4f}" for x in rows["captured"][:, 0]),
        loss_sum_eager=",".join(f"{x:.4f}" for x in rows["eager"][:, 0]))
    if same > limit or not states_equal:
        raise AssertionError("dropout check: the captured step's metrics or "
                             "generator state differ from the eager step's "
                             f"(worst {same:.3f} of the limit, allowed "
                             f"{limit:.3f}, states equal {states_equal})")
    if other <= 10.0 * limit:
        raise AssertionError("dropout check: another seed's steps agree "
                             "with this seed's; the check cannot see the "
                             "masks")


def phase_sync(setup, batches, dev):
    """One K = 8 chunk of the captured step and 8 captured forwards, from
    host batches, under `torch.cuda.set_sync_debug_mode('error')`: nothing
    in them makes the host wait on the card (the readbacks come after)."""
    import torch
    from gnnep_tpu_torch.models.alignn import init_alignn
    from gnnep_tpu_torch.train.loop import (TrainHyper, make_forward,
                                            make_train_step)
    from gnnep_tpu_torch.utils.synth import flagship_config
    store, t = setup.store, setup.transformer
    cfg = flagship_config(node_dim=store.node_dim, edge_dim=store.edge_dim,
                          angle_dim=store.angle_dim,
                          global_dim=store.global_scalar_dim + 230)
    step = make_train_step(init_alignn(np.random.default_rng(SEED + 96),
                                       cfg), TrainHyper(), t.means, t.stds,
                           dev)
    full = full_batches(batches)
    seq = [full[i % len(full)] for i in range(TIMING_K)]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    forward = make_forward()
    step.run(seq, gen, 1e-4, 1e-4)           # warm-up and capture
    for b in full[:2]:
        forward(step.model, b)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ms = step.run(seq, gen)
        outs = [forward(step.model, b) for b in seq]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    loss = ms.loss_sum.cpu().numpy()
    finite = bool(np.isfinite(loss).all()
                  and all(torch.isfinite(o[0]).all() for o in outs))
    step.close()
    forward.close()
    if not finite:
        raise AssertionError("sync check: non-finite outputs")
    say("check", what="no_host_sync", mode="error", train_steps=len(seq),
        forwards=len(outs), loss_sum_mean=f"{loss.mean():.4f}")


# --------------------------------------------------------------- phase 7
def eproj_bound_ms(case):
    """Least time for kernel 5's work on this card → (ms, 'bytes' or
    'operations'), `_fwd_bound_ms`. Bytes count what this run's data
    needs: the edge rows of kv, ea and scale_t are read once for each
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
    return _fwd_bound_ms(nbytes, 2 * live * fe * hidden, item)


def _fwd_bound_ms(nbytes: float, proj_ops: float, item: int):
    """Kernels 5 and 8 → (ms, 'bytes' or 'operations'): the larger of the
    bytes over the memory rate and the projection's operations at the rate
    of the units that run it, the tensor cores: in bf16 one product at the
    bf16 rate, in f32 three TF32 products (3xTF32) at the TF32 rate. (q·k,
    α·v and the softmax, a few operations per edge and channel on the CUDA
    cores, add under 1 % to either.)"""
    t_ops = (proj_ops / PEAK_FLOPS["bfloat16"] if item == 2
             else 3 * proj_ops / PEAK_TF32)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def phase_times(flagship, batches, ens, dev, kve_ens):
    """Kernel 5 at the flagship shapes; then member 0's eval forward, f32
    and bf16, eager and captured side by side over TIMING_BATCHES served
    batches from the host, read back once (the serving path's loop): wall
    ms per batch, graphs/s, and one pass's profile (device ms per batch,
    busy share; the captured pass's kernel calls held to the launch
    counts). The captured forward's first two calls (eager warm-up, then
    capture and replay) are timed apart: what a request pays once per
    member. Then the same captured forward of the kv+e rung's member 0
    (`kve_ens`, kernel 3 in every conv)."""
    import torch
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
    seq = [batches[i % len(batches)] for i in range(TIMING_BATCHES)]
    real = float(np.mean([np.asarray(b.graph_mask).sum() for b in seq]))
    forwards = {}
    for dtype in ("float32", "bfloat16"):
        run = cast_model(model, dtype)
        fwd = make_forward(compute_dtype=dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in seq[:2]:
            fwd(run, b)[0].cpu()
        first_two = (time.perf_counter() - t0) * 1e3
        passes = {
            "eager": lambda: torch.stack([torch.stack(fwd.eager(
                run, DeviceBatch.from_batch(b, dev))) for b in seq]).cpu(),
            "captured": lambda: torch.stack([torch.stack(fwd(run, b))
                                             for b in seq]).cpu()}
        forwards[dtype] = {}
        for kind, one_pass in passes.items():
            ms = chunk_ms(one_pass)[0] / len(seq)
            busy, dev_ms = profile_run(one_pass, f"forward_{kind}", dtype,
                                       len(seq), counted=kind == "captured")
            forwards[dtype][kind] = dict(ms_per_batch=ms,
                                         graphs_per_s=real / ms * 1e3,
                                         device_ms_per_batch=dev_ms,
                                         busy_share=busy)
        fwd.close()
        e, c = forwards[dtype]["eager"], forwards[dtype]["captured"]
        forwards[dtype]["captured"]["first_two_calls_ms"] = first_two
        say("times", forward=dtype, batches=len(seq),
            graphs_per_batch=f"{real:.1f}", side_by_side="eager|captured",
            ms_per_batch=f"{e['ms_per_batch']:.3f}|{c['ms_per_batch']:.3f}",
            graphs_per_s=f"{e['graphs_per_s']:.0f}|{c['graphs_per_s']:.0f}",
            device_ms_per_batch=f"{e['device_ms_per_batch']:.3f}|"
                                f"{c['device_ms_per_batch']:.3f}",
            busy_share=f"{e['busy_share']:.3f}|{c['busy_share']:.3f}",
            captured_first_two_calls_ms=f"{first_two:.1f}")
    model = load_member(kve_ens / "model_0.npz", dev)
    for dtype in ("float32", "bfloat16"):
        run = cast_model(model, dtype)
        fwd = make_forward(compute_dtype=dtype)
        for b in seq[:2]:
            fwd(run, b)[0].cpu()

        def one_pass():
            return torch.stack([torch.stack(fwd(run, b)) for b in seq]).cpu()

        ms = chunk_ms(one_pass)[0] / len(seq)
        busy, dev_ms = profile_run(one_pass, "forward_kv+e_captured", dtype,
                                   len(seq), counted=True)
        fwd.close()
        forwards[f"kv+e_{dtype}"] = {"captured": dict(
            ms_per_batch=ms, graphs_per_s=real / ms * 1e3,
            device_ms_per_batch=dev_ms, busy_share=busy)}
        say("times", forward=dtype, rung="kv+e", kind="captured",
            batches=len(seq), ms_per_batch=f"{ms:.3f}",
            graphs_per_s=f"{real / ms * 1e3:.0f}",
            device_ms_per_batch=f"{dev_ms:.3f}", busy_share=f"{busy:.3f}")
    return cases, forwards


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
    """Least time for kernel 7's work as the kv-gather backward calls it:
    every row the result needs (those before the dummy row's last segment,
    whose sum is unspecified) and its order entry (none for the identity
    order) read once, the starts read once, the output written once in the
    values' type; one f32 add per element read."""
    v = case["values"]
    width = v.shape[1]
    n = case["starts"].shape[0]
    rows = int(case["starts"][-1].item())
    orders = rows if case["order"] is not None else 0
    nbytes = (v.element_size() * (rows + n) * width + 4 * (orders + n))
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
    v and the scale, and row_ptr read once; out and the stats written once.
    Operations: α·v per live edge and channel, the softmax's few per (edge,
    head)."""
    e_total, heads = c["logits"].shape
    n, hidden, item = c["n"], c["v"].shape[1], c["v"].element_size()
    live = int((c["mask2"] > 0).sum().item())
    nbytes = (item * live * hidden
              + 4 * (heads * e_total + live * heads + n + 1)
              + 4 * (n * hidden + 2 * n * heads))
    return _bound_ms(nbytes, 2 * live * hidden + 6 * live * heads, item)


def agg_bwd_bound_ms(c):
    """Kernel 2: every logit, the live edges' rows of v and the scale, g,
    the stats and row_ptr read once; every row of dl and dv written once.
    Operations: g·v and dv per live edge and channel, the softmax
    gradient's few per (edge, head)."""
    e_total, heads = c["logits"].shape
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
        attn_bound_ms,
        floor=lambda c: at.attention_empty_cuda(c["q"], c["k"], c["v"],
                                                heads=c["heads"]))
    out["softmax_aggregate_fwd"] = kernel_times(
        "softmax_aggregate_fwd", rung_flag["softmax_aggregate_fwd"],
        lambda c: ag.aggregate_cuda(*agg_fwd_args(c), heads=c["heads"]),
        lambda c: ag.aggregate_plain(*agg_fwd_args(c), c["dst"],
                                     heads=c["heads"]),
        agg_bound_ms,
        floor=lambda c: ag.aggregate_empty_cuda(c["v"], c["n"],
                                                heads=c["heads"]))
    for kernel, bound in (("attn_bwd", attn_bwd_bound_ms),
                          ("softmax_aggregate_bwd", agg_bwd_bound_ms)):
        args = {id(c): rung_bwd_inputs(kernel, c)
                for c, _ in rung_flag[kernel].values()}
        cuda = (at.attention_bwd_cuda if kernel == "attn_bwd"
                else ag.aggregate_bwd_cuda)
        floor = ((lambda c: at.attention_empty_cuda(
            c["q"], c["k"], c["v"], heads=c["heads"], backward=True))
            if kernel == "attn_bwd" else
            (lambda c: ag.aggregate_empty_cuda(c["v"], c["n"],
                                               heads=c["heads"],
                                               backward=True)))
        out[kernel] = kernel_times(
            kernel, rung_flag[kernel],
            lambda c, cuda=cuda: cuda(*args[id(c)], heads=c["heads"]),
            lambda c, kernel=kernel: run_bwd_plain(kernel, c, args[id(c)]),
            bound, floor=floor)
    return out


def _unique_rows(idx) -> int:
    import torch
    return int(torch.unique(idx).numel())


def span_bound_ms(c):
    """Kernel 8: kernel 5's count (`eproj_bound_ms`) with the node table's
    rows that live edges source, each read once, in place of the edge
    arena's kv rows, and each live edge's src (8 bytes)."""
    q, ea, w = c["q"], c["ea"], c["w_edge"]
    n, hidden = q.shape
    fe, heads, item = ea.shape[1], c["heads"], q.element_size()
    live_e = c["mask2"] > 0
    live = int(live_e.sum().item())
    rows = _unique_rows(c["src"][live_e])
    nbytes = (item * (q.numel() + rows * 2 * hidden + live * fe + w.numel())
              + 8 * live
              + 4 * (live * heads + c["mask2"].numel() + c["row_ptr"].numel())
              + 4 * (n * hidden + 2 * n * heads))
    return _fwd_bound_ms(nbytes, 2 * live * fe * hidden, item)


def span_bwd_bound_ms(c):
    """Kernel 9: kernel 6's count (`eproj_bwd_bound_ms`) with the node
    table's rows that live edges source read once in place of the edge
    arena's kv rows, each live edge's src read, and dkvn [N_src, 2H] written
    once in place of dkv [E, 2H]."""
    q, ea, w = c["q"], c["ea"], c["w_edge"]
    n, hidden = q.shape
    fe, heads, item = ea.shape[1], c["heads"], q.element_size()
    e_total, n_src = ea.shape[0], c["kvn"].shape[0]
    live_e = (c["mask2"] > 0) & (c["dst"] != n - 1)
    live = int(live_e.sum().item())
    rows = _unique_rows(c["src"][live_e])
    nbytes = (item * (q.numel() + rows * 2 * hidden + live * fe + w.numel())
              + 8 * live
              + 4 * (live * heads + c["mask2"].numel() + c["row_ptr"].numel())
              + 4 * (n * hidden + 2 * n * heads)
              + item * (n * hidden + n_src * 2 * hidden + e_total * fe)
              + 4 * fe * hidden)
    ops = 6 * live * fe * hidden + 12 * live * hidden + 10 * live * heads
    return _bound_ms(nbytes, ops, item)


def gather_bound_ms(c):
    """Kernel 11: the output written once, each table row it needs read
    once, the indices read once; no arithmetic."""
    tab, idx = c["tab"], c["idx"]
    row = tab.shape[1] * tab.element_size()
    nbytes = (idx.numel() * row + _unique_rows(idx) * row
              + idx.numel() * idx.element_size())
    return _bound_ms(nbytes, 0, 4)


def phase_span_times(span_flag):
    """Kernels 8 and 9 at the flagship conv shapes → {kernel: cases}."""
    from gnnep_tpu_torch.ops.cuda import attention_span as sp
    fwd = kernel_times(
        "attn_span_fwd", span_flag["attn_span_fwd"],
        lambda c: sp.attention_span_cuda(*span_fwd_args(c), c["row_ptr"],
                                         c["src"], c["dst"],
                                         heads=c["heads"]),
        lambda c: sp.attention_span_plain(*span_fwd_args(c), c["src_plain"],
                                          c["dst"], heads=c["heads"]),
        span_bound_ms)
    args = {id(c): span_bwd_inputs(c)
            for c, _ in span_flag["attn_span_bwd"].values()}
    bwd = kernel_times(
        "attn_span_bwd", span_flag["attn_span_bwd"],
        lambda c: sp.attention_span_bwd_cuda(
            *span_fwd_args(c), c["row_ptr"], c["src"], c["dst"],
            *args[id(c)], heads=c["heads"]),
        lambda c: sp.attention_span_bwd_plain(
            *span_fwd_args(c), c["row_ptr"], c["src_plain"], c["dst"],
            *args[id(c)], heads=c["heads"]),
        span_bwd_bound_ms, split=True)
    return {"attn_span_fwd": fwd, "attn_span_bwd": bwd}


def phase_probes(dev, batch):
    """The two dev probes as timing phases. Checks first, counted: the
    gather kernel bitwise on every case of the JAX probe (S 256, 640, 768
    × 512; f32, int32, bf16); each ladder stage launched at the line-graph
    conv's flagship shapes in bf16 (the JAX ladder's type) and f32, `full`
    bitwise kernel 5 on the same inputs. Then times: the gather's bench
    cases (640 × 512) and the span kernels' own gather (the line-graph
    conv's kvn [N, 2H] by src) beside `torch.index_select`; the ladder's
    device ms per stage, its `full` stage as kernel 5's row → {kernel:
    (cases, launches, extra)}."""
    import torch
    from gnnep_tpu_torch.dev import gather_probe as gp
    from gnnep_tpu_torch.dev import kernel_ladder as kl
    from gnnep_tpu_torch.ops.cuda import attention_eproj as ep
    reset_counts()
    for dtype in gp.DTYPES:
        for rows in gp.PROBE_ROWS:
            if not gp.check_bitwise(gp.probe_case(rows, gp.WIDTH, dtype, dev)):
                raise AssertionError(f"row_gather S={rows} {dtype}: not "
                                     "bitwise tab[idx]")
        # a contiguous table one element off a 16-byte boundary: the plan
        # takes the element's own word
        c = gp.probe_case(641, gp.WIDTH, dtype, dev)
        c["tab"] = c["tab"].view(-1)[gp.WIDTH - 1:-1].view(640, gp.WIDTH)
        c["idx"] = c["idx"][:640] % 640
        if c["tab"].data_ptr() % 16 == 0 or not gp.check_bitwise(c):
            raise AssertionError(f"row_gather misaligned {dtype}: not "
                                 "bitwise tab[idx]")
    ladder_flag = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = "float32" if dtype == torch.float32 else "bfloat16"
        c = kl.lg_case(batch, dtype=dtype, device=dev)
        args = kl.case_args(c)
        outs = {stage: kl.ladder_cuda(*args, heads=c["heads"], stage=stage)
                for stage in kl.STAGES}
        k5 = ep.attention_eproj_cuda(*args, heads=c["heads"])
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(outs["full"], k5)):
            raise AssertionError(f"ladder full {tag}: not bitwise kernel 5")
        for stage, (out, _, _) in outs.items():
            if not torch.isfinite(out[:-1]).all():
                raise AssertionError(f"ladder {stage} {tag}: non-finite out")
        plain = ep.attention_eproj_plain(*args[:6], c["dst"],
                                         heads=c["heads"])
        err = (outs["full"][0][:-1] - plain[0][:-1]).abs().max().item()
        ladder_flag[("lg", tag)] = (c, err)
    counts = read_counts()
    _only(counts, {"row_gather": len(gp.DTYPES) * (len(gp.PROBE_ROWS) + 1),
                   "attn_eproj_ladder": 2 * len(kl.STAGES),
                   "attn_eproj_fwd": 2}, "probe checks")
    say("probe", gather_cases_bitwise=counts["row_gather"],
        gather_misaligned_bitwise=",".join(str(d).split(".")[-1]
                                           for d in gp.DTYPES),
        ladder_full_bitwise_kernel5="float32,bfloat16",
        ladder_launches=counts["attn_eproj_ladder"])

    stages = {}
    for (which, tag), (c, _) in ladder_flag.items():
        n_blocks = kl.blocks(c)
        stages[tag] = kl.time_stages(c, timer=device_ms)
        for stage, ms in stages[tag].items():
            say("times", kernel="attn_eproj_ladder", conv=which, dtype=tag,
                stage=stage, ms=f"{ms:.4f}",
                us_per_block=f"{ms * 1e3 / n_blocks:.4f}", blocks=n_blocks)
    ladder = kernel_times(
        "attn_eproj_ladder", ladder_flag,
        lambda c: kl.ladder_cuda(*kl.case_args(c), heads=c["heads"],
                                 stage="full"),
        lambda c: ep.attention_eproj_plain(*kl.case_args(c)[:6], c["dst"],
                                           heads=c["heads"]),
        eproj_bound_ms)
    gather_flag = {("probe640", "float32"): (gp.probe_case(
                       640, gp.WIDTH, torch.float32, dev), 0.0),
                   ("probe640", "bfloat16"): (gp.probe_case(
                       640, gp.WIDTH, torch.bfloat16, dev), 0.0)}
    for dtype, tag in ((torch.float32, "float32"),
                       (torch.bfloat16, "bfloat16")):
        c = gp.span_case(batch, dtype=dtype, device=dev)
        if not gp.check_bitwise(c):
            raise AssertionError(f"row_gather span {tag}: not bitwise")
        gather_flag[("lg", tag)] = (c, 0.0)
    gather = kernel_times(
        "row_gather", gather_flag,
        lambda c: gp.row_gather_cuda(c["tab"], c["idx"]),
        lambda c: gp.row_gather_plain(c["tab"], c["idx"]), gather_bound_ms,
        library=lambda c: torch.index_select(c["tab"], 0, c["idx"]),
        floor=lambda c: gp.empty_launch_cuda(c["tab"], c["idx"]))
    return {"attn_eproj_ladder": (ladder, counts["attn_eproj_ladder"],
                                  {"stages_ms": stages}),
            "row_gather": (gather, counts["row_gather"], {})}


def kernel_times(name, flagship, run_kernel, run_plain, bound_fn,
                 library=None, split=False, floor=None, library2=None):
    """Device ms per launch, wall ms per call with host work, plain ms and
    bound of one kernel at each flagship case; `library(case)`, where given,
    is one PyTorch call computing the same function, timed beside it, and
    `library2 = (name, fn)` a second such call where `fn(case)` does not
    return None. `floor(case)` launches an empty kernel on the kernel's own
    grid and block, timed the same way: the launch latency under a chain
    (kernels 1-4, 7 and 11). With `split` (kernels 6 and 9), also each CUDA
    kernel's device ms (from torch.profiler) and the three products' time
    as `torch.matmul` calls, a diagnostic floor that the port never
    calls."""
    from gnnep_tpu_torch.dev.bwd_bench import gemm_floor_ms, kernel_split_ms
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
        extra = {}
        if floor:
            cases[-1]["empty_launch_ms"] = device_ms(lambda: floor(case))
            extra["empty_launch_ms"] = f"{cases[-1]['empty_launch_ms']:.4f}"
        if library2 and library2[1](case) is not None:
            ms2 = device_ms(lambda: library2[1](case))
            cases[-1][f"{library2[0]}_ms"] = ms2
            extra[f"{library2[0]}_ms"] = f"{ms2:.4f}"
        say("times", kernel=name, conv=which, dtype=dtype,
            ms=f"{kern_ms:.4f}", call_ms_with_host=f"{call_ms:.4f}",
            bound_ms=f"{bound:.4f}", bound_by=bound_by,
            share_of_bound=f"{bound / kern_ms:.2f}",
            plain_ms_no_yardstick=f"{plain_ms:.4f}",
            library_ms=("none (no single PyTorch call computes this "
                        "function)" if lib_ms is None else f"{lib_ms:.4f}"),
            **extra)
        if split:
            parts = kernel_split_ms(lambda: run_kernel(case))
            floor_ms = gemm_floor_ms(case, device_ms)
            cases[-1].update(split_ms=parts, gemm_floor_ms=floor_ms)
            say("times", kernel=name, conv=which, dtype=dtype,
                **{f"{k.replace('attn_eproj_bwd_', '')}_ms": f"{v:.4f}"
                   for k, v in parts.items() if k.endswith("kernel")},
                gemm_floor_ms_diagnostic=f"{floor_ms:.4f}")
    return cases


def phase_train_times(bwd_flag, seg_flag, setup, batches, dev):
    """Kernels 6 and 7 at the flagship shapes, then on each rung, f32 and
    bf16, the eager step and the captured step side by side: the wall time
    per step of a K-step chunk from host batches (the member loop's),
    graphs/s, and one chunk's profile (device ms per step, busy share; the
    captured chunk's kernel calls held to the launch counts). The span
    rung's beside the default's is the counterpart of
    `scripts_dev/exp_span.py`'s A/B."""
    import torch
    from gnnep_tpu_torch.models.alignn import DeviceBatch, init_alignn
    from gnnep_tpu_torch.ops.cuda import attention_eproj as ep
    from gnnep_tpu_torch.ops.cuda import segment_sum as ss
    from gnnep_tpu_torch.train.loop import (TrainHyper, TrainStep,
                                            make_train_step)
    from gnnep_tpu_torch.utils.synth import flagship_config

    bwd_args = {id(case): bwd_inputs(case) for case, _ in bwd_flag.values()}
    bwd = kernel_times(
        "attn_eproj_bwd", bwd_flag,
        lambda c: ep.attention_eproj_bwd_cuda(*bwd_args[id(c)],
                                              heads=c["heads"]),
        lambda c: ep.attention_eproj_bwd_plain(*bwd_args[id(c)],
                                               heads=c["heads"]),
        eproj_bwd_bound_ms, split=True)

    def seg_args(c):
        return c["values"], c["order"], c["starts"], c["values"].dtype

    def index_add(c):
        # the whole kv-gather backward as one library call: scatter-add of
        # the cotangent rows by source index
        v = c["values"]
        return torch.zeros((c["starts"].shape[0], v.shape[1]), dtype=v.dtype,
                           device=v.device).index_add_(0, c["src"], v)

    def segment_reduce(c):
        # the identity order's sum in one library call: the CSR rows
        # summed by offsets, the dummy row's segment cut to empty
        if c["order"] is not None:
            return None
        starts = c["starts"].long()
        return torch.segment_reduce(c["values"], "sum", offsets=torch.cat(
            [starts, starts[-1:]]), axis=0)

    # kernel 7 as the kv-gather backward calls it: its output in the
    # cotangent's type
    seg = kernel_times(
        "csr_segment_sum", seg_flag,
        lambda c: ss.csr_segment_sum_cuda(*seg_args(c)),
        lambda c: ss.csr_segment_sum_plain(*seg_args(c)), segsum_bound_ms,
        library=index_add, floor=lambda c: ss.empty_launch_cuda(*seg_args(c)),
        library2=("segment_reduce", segment_reduce))

    store = setup.store
    full = full_batches(batches)
    seq = [full[i % len(full)] for i in range(TIMING_K)]
    steps = {}
    nsp, bsp = span_bounds(full)
    for rung in ("eproj", *RUNGS, "span"):
        rung_cfg = (dict(attn_span=True, edge_span64=nsp, lg_span64=bsp)
                    if rung == "span" else RUNGS.get(rung, {"cfg": {}})["cfg"])
        cfg = flagship_config(node_dim=store.node_dim,
                              edge_dim=store.edge_dim,
                              angle_dim=store.angle_dim,
                              global_dim=store.global_scalar_dim + 230,
                              **rung_cfg)
        steps[rung] = {}
        for dtype in ("float32", "bfloat16"):
            steps[rung][dtype] = {}
            for kind in ("eager", "captured"):
                model = init_alignn(np.random.default_rng(SEED + 7), cfg)
                hyper = TrainHyper(compute_dtype=dtype)
                step = (TrainStep(model.to(dev), hyper,
                                  setup.transformer.means,
                                  setup.transformer.stds)
                        if kind == "eager" else
                        make_train_step(model, hyper, setup.transformer.means,
                                        setup.transformer.stds, dev))
                gen = torch.Generator(device=dev)
                gen.manual_seed(SEED)

                def chunk():
                    # the member loop's chunk: K steps from host batches,
                    # the metrics read back once
                    return step.run(seq, gen, 1e-4, 1e-4).loss_sum.cpu()

                torch.cuda.reset_peak_memory_stats(dev)
                ms, first = chunk_ms(chunk)
                ms /= TIMING_K
                rec = {"ms_per_step": ms, "first_chunk_ms": first,
                       "graphs_per_s": float(BATCH / ms * 1e3)}
                rec["busy_share"], rec["device_ms_per_step"] = profile_run(
                    chunk, f"train_step_{rung}_{kind}", dtype, TIMING_K,
                    counted=kind == "captured")
                say("times", rung=rung, train_step=dtype, kind=kind,
                    k=TIMING_K, ms_per_step=f"{ms:.3f}",
                    first_chunk_ms=f"{first:.1f}",
                    graphs_per_step=BATCH,
                    graphs_per_s=f"{rec['graphs_per_s']:.0f}",
                    device_ms_per_step=f"{rec['device_ms_per_step']:.3f}",
                    busy_share=f"{rec['busy_share']:.3f}",
                    peak_mem_gb=f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f}")
                step.close()
                steps[rung][dtype][kind] = rec
            e, c = steps[rung][dtype]["eager"], steps[rung][dtype]["captured"]
            say("times", rung=rung, train_step=dtype,
                side_by_side="eager|captured",
                ms_per_step=f"{e['ms_per_step']:.3f}|{c['ms_per_step']:.3f}",
                graphs_per_s=f"{e['graphs_per_s']:.0f}|"
                             f"{c['graphs_per_s']:.0f}",
                device_ms_per_step=f"{e['device_ms_per_step']:.3f}|"
                                   f"{c['device_ms_per_step']:.3f}",
                busy_share=f"{e['busy_share']:.3f}|{c['busy_share']:.3f}")
    return bwd, seg, steps


def chunk_ms(fn, reps: int = 5):
    """(median wall ms of `fn`, which ends in a readback, on the host's
    clock over `reps` calls; the ms of the first call before them, which
    warms up, and on a captured path also captures)."""
    import torch
    torch.cuda.synchronize()
    times = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:])), times[0]


# each wrapper's launch count against the calls of the CUDA kernel that
# each of its launches runs once (kernels 8 and 9 are kernels 5 and 6's
# kernels with a flag, so their calls add up)
PROFILED = {r"attn_eproj_fwd_kernel": ("attn_eproj_fwd", "attn_span_fwd"),
            r"attn_eproj_bwd_attn_kernel": ("attn_eproj_bwd",
                                            "attn_span_bwd"),
            r"csr_segment_sum_kernel": ("csr_segment_sum",),
            r"attn_fwd_kernel": ("attn_fwd",),
            r"attn_bwd_kernel": ("attn_bwd",),
            r"softmax_aggregate_fwd_kernel": ("softmax_aggregate_fwd",),
            r"softmax_aggregate_bwd_kernel": ("softmax_aggregate_bwd",)}


def profile_run(run_all, label: str, dtype: str, n_calls: int,
                counted: bool = False):
    """Device time by kernel over one pass of `run_all` (n_calls forwards
    or train steps), from torch.profiler: the device's busy share of the
    traced wall time (the tracer's own host cost inflates the wall time, so
    this share is a lower bound) and the kernels that take the most of it.
    With `counted`, the launch counts are set to 0 just before the traced
    pass and read just after, and each wrapper's count must equal the
    profiler's calls of its kernel (`PROFILED`). Returns (busy share,
    device ms per call)."""
    import torch
    run_all()
    torch.cuda.synchronize()
    reset_counts()
    with traced() as prof:
        t0 = time.perf_counter()
        run_all()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    counts = read_counts()

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
    if counted:
        seen = {}
        for pattern, names in PROFILED.items():
            calls = sum(e.count for e in events
                        if re.search(rf"\b{pattern}\b", e.key))
            launched = sum(counts[n] for n in names)
            seen[pattern] = (calls, launched)
            if calls != launched:
                raise AssertionError(
                    f"{label} {dtype}: the profiler saw {calls} calls of "
                    f"{pattern}, the launch counts say {launched} "
                    f"({counts})")
        if not any(launched for _, launched in seen.values()):
            raise AssertionError(f"{label} {dtype}: no kernel launched")
        say("profile", run=label, dtype=dtype,
            profiler_calls_equal_launch_counts=",".join(
                f"{'+'.join(PROFILED[p])}={n}" for p, (_, n) in seen.items()
                if n))
    return busy_us / wall_us, busy_us / 1e3 / n_calls


# --------------------------------------------------------- parallel/ group
# Two gloo ranks on the one card (a multi-card mesh's slots, each a process
# bound to cuda:0), started once and shared by [mesh], [member_parallel]
# and [giant]; one-slot paths run in this process.
MESH_STEPS = 2        # aligned steps checked per dtype, 2 sub-batches each
MESH_TIMED = 5        # timed passes over them, after a warm-up pass
VMAP_MEMBERS, VMAP_EPOCHS = 2, 2
GIANT_ID, SYNTH_GIANT = "example-MgO", "synth-giant"
GIANT_TIMED = 3
MESH_LR = 1e-3
# a gradient leaf compared across layouts on the card: within this share
# of the leaf's largest magnitude plus 1e-5 (the step check's 5e-3 in f32;
# bf16 at the bf16 forward's 5e-2), and StepMetrics at rtol / atol
STEP_TOL = {"float32": 5e-3, "bfloat16": 5e-2}
METRIC_ATOL = 1e-4


def pair_mesh(dev):
    """The two-slot mesh on `dev`'s card: gloo (NCCL refuses a card used
    twice)."""
    from gnnep_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(1, 2, devices=[f"{dev.type}:{dev.index or 0}"] * 2,
                     backend="gloo")


def synced(fn):
    """`fn` followed by a synchronization of the card."""
    import torch

    def run():
        fn()
        torch.cuda.synchronize()
    return run


def _rank_reset(rank):
    """The rank process's launch counts and exchange bytes to 0."""
    from gnnep_tpu_torch.parallel import mesh
    reset_counts()
    mesh.sent_bytes = 0


def _rank_counts(rank):
    return read_counts()


def expect_counts(what: str, counts: dict, want: dict) -> None:
    """Each kernel named in `want` launched exactly that often; a kernel of
    another rung never."""
    others = {k: v for k, v in counts.items()
              if k not in want and k not in ("attn_eproj_ladder",
                                             "row_gather") and v}
    wrong = {k: (counts[k], n) for k, n in want.items() if counts[k] != n}
    if wrong or others:
        raise AssertionError(f"{what}: launches (got, want) {wrong}, other "
                             f"kernels {others}")


def expect_replays(what: str, replays: dict, train: int) -> None:
    """`train` captured train steps replayed, and some eval forwards."""
    if replays["train"] != train or replays["eval"] <= 0:
        raise AssertionError(f"{what}: {replays} replays, expected {train} "
                             "train steps and some eval forwards")


# a bf16 result of one layout against the same of another that rounds the
# same weights and sums the same way (`direct`): within this share of the
# reference's distance from the f32 result. On the 2,040-atom giant the
# S = 2 boundary path lies from the S = 1 one at about a hundredth of the
# S = 1 path's distance from f32 (bf16's rounding of the weights and
# states, which both layouts share, is most of it), and each fault
# `dev/limit_probe.py` plants at a third of it or more (PERF.md §6)
BF16_LAYOUT_SHARE = 0.1


def near_limit(got, ref, f32, floor: float, direct: bool = False):
    """(‖got − f32‖, its limit) of `near_as_ref`; `direct`: (‖got − ref‖,
    BF16_LAYOUT_SHARE of ‖ref − f32‖ + 1e-6), `floor` unused."""
    got, ref, f32 = (np.asarray(x, np.float64).ravel() for x in
                     (got, ref, f32))
    err = float(np.linalg.norm(got - (ref if direct else f32))) \
        if np.isfinite(got).all() else float("inf")
    noise = float(np.linalg.norm(ref - f32))
    if direct:
        return err, BF16_LAYOUT_SHARE * noise + 1e-6
    return err, NOISE_FACTOR * noise + floor * float(np.linalg.norm(f32)) \
        + 1e-6


def near_as_ref(what: str, got, ref, f32, floor: float,
                direct: bool = False) -> float:
    """A bf16 result of one layout against the same of another, where bf16
    rounds in each layout's own order: `got` may lie from the f32 result
    `f32` at most NOISE_FACTOR times as far as `ref` lies from it (L2 over
    every element: two layouts' rounding errors are alike in size, not in
    value, and a per-leaf maximum over 70 leaves read 3.8× on one leaf in
    a card run), plus `floor` of f32's norm (+1e-6) → the share of that
    limit. `direct` (layouts that round alike): `got` within
    BF16_LAYOUT_SHARE of that distance from `ref` itself."""
    err, lim = near_limit(got, ref, f32, floor, direct)
    if err > lim:
        raise AssertionError(f"{what}: {err:.3e} from the f32 result, limit "
                             f"{lim:.3e}")
    return err / lim


METRIC_NAMES = ("loss_sum", "n_graphs", "abs_err_sum", "sq_err_sum",
                "n_elements", "logvar_sum")
COUNTS = ("n_graphs", "n_elements")


def layout_limits(dtype: str, metrics, ref_metrics, grads, ref_grads,
                  f32=None, direct: bool = False) -> list:
    """[(what, err, limit)] of `compare_layouts`' comparisons; err is inf
    where the result is not finite."""
    tol = STEP_TOL[dtype]
    rows = []
    for k, (name, a, b) in enumerate(zip(METRIC_NAMES, metrics,
                                         ref_metrics)):
        if f32 is None:
            err, lim = abs(a - b), METRIC_ATOL + tol * abs(b)
        elif name in COUNTS:
            # counts of real graphs and cells: exact in any layout
            err, lim = abs(a - float(f32[0][k])), 0.0
        else:
            # a sum over (graph, target) cells: as near the f32 step's as
            # the reference layout's, plus the bf16 forward's 5e-2 of the
            # f32 value and 1e-2 a cell (logvar_sum's terms cancel)
            f = float(f32[0][k])
            err = abs(a - f)
            lim = NOISE_FACTOR * abs(b - f) + tol * abs(f) \
                + 1e-2 * float(ref_metrics[4]) + 1e-6
        rows.append((name, err if np.isfinite(a) else float("inf"), lim))
    if f32 is not None and grads:
        names = sorted(grads)
        rows.append(("all leaves", *near_limit(
            np.concatenate([grads[n].ravel() for n in names]),
            np.concatenate([ref_grads[n].ravel() for n in names]),
            np.concatenate([f32[1][n].ravel() for n in names]), 1e-3,
            direct)))
    for name, g in (grads.items() if f32 is None else ()):
        r = ref_grads[name]
        rows.append((name, float(np.abs(g - r).max())
                     if np.isfinite(g).all() else float("inf"),
                     tol * np.abs(r).max() + 1e-5))
    return rows


def compare_layouts(what: str, dtype: str, metrics, ref_metrics, grads,
                    ref_grads, f32=None, direct: bool = False) -> dict:
    """A step of one layout against the reference layout's step from the
    same state. f32: StepMetrics at rtol STEP_TOL / atol METRIC_ATOL, each
    gradient leaf within STEP_TOL of its largest magnitude (+1e-5). bf16
    (`f32`: the reference layout's f32 step, (metrics, grads)): the counts
    of real graphs and cells equal; each other metric, and all gradients
    together in L2, as near the f32 step as the reference layout's bf16
    step (`near_as_ref`), plus for a metric STEP_TOL of its f32 value and
    1e-2 a (graph, target) cell, for the gradients 1e-3 of the norm
    (`layout_limits`); `direct`: the gradients as `near_as_ref`'s. → the
    worst shares of those limits."""
    worst_m, worst_g, leaf = 0.0, 0.0, ""
    for name, err, lim in layout_limits(dtype, metrics, ref_metrics, grads,
                                        ref_grads, f32, direct):
        if err > lim:
            raise AssertionError(f"{what} {dtype} {name}: differs by "
                                 f"{err:.3e}, limit {lim:.3e}")
        share = err / lim if lim > 0 else 0.0
        if name in METRIC_NAMES:
            worst_m = max(worst_m, share)
        elif share >= worst_g:
            worst_g, leaf = share, name
    return dict(metrics_share_of_limit=f"{worst_m:.3f}",
                grad_share_of_limit=f"{worst_g:.3f}", nearest_leaf=leaf)


def _state(model) -> dict:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def _card_model(cfg, state, dev):
    import torch
    from gnnep_tpu_torch.models.alignn import Alignn
    model = Alignn(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model.to(dev)


def _rank_aligned_wall(rank, state, cfg, hyper, means, stds, slots, reps):
    """Host ms per aligned step on this rank over `reps` passes of `slots`,
    after a warm-up pass (its eager step and its two captures)."""
    import torch
    from gnnep_tpu_torch.parallel.train_step import make_aligned_train_step
    step = make_aligned_train_step(rank, _card_model(cfg, state,
                                                     rank.device),
                                   hyper, means, stds)

    def run():
        for group in slots:
            step(group[rank.rank], None, MESH_LR, MESH_LR)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    wall = (time.perf_counter() - t0) * 1e3 / (reps * len(slots))
    step.close()
    return wall


def phase_mesh(pair, root: Path, data: Path, setup, batches, dev,
               layers: int):
    """The graph-aligned step over the gloo pair, f32 and bf16: two steps
    of two 64-graph sub-batches each against the card's single-device step
    over each step's 128-graph union batch (StepMetrics and the reduced
    gradients at `compare_layouts`' limits), the parameters bitwise equal
    on both ranks, each rank's kernels 5, 6 and 7 2·layers times a step;
    its wall per step beside the card's captured single-device step on the
    same sub-batches (bf16 at `compare_layouts`' bf16 rule against the
    f32 union step). Then `cli.train --data-shards 1 --edge-shards 1` on
    the card: the single-device path, unchanged."""
    import torch
    from gnnep_tpu_torch.cli import train as cli_train
    from gnnep_tpu_torch.data.batching import BatchBudget, epoch_batches
    from gnnep_tpu_torch.models.alignn import init_alignn
    from gnnep_tpu_torch.parallel.train_step import (aligned_steps_rank,
                                                     stack_for_mesh)
    from gnnep_tpu_torch.train.loop import (TrainHyper, TrainStep,
                                            make_train_step)
    cfg, _ = check_config(setup, batches, "eproj")
    t = setup.transformer
    state = _state(init_alignn(np.random.default_rng(SEED + 60), cfg))
    slots = [stack_for_mesh(batches[2 * k:2 * k + 2], 2)
             for k in range(MESH_STEPS)]
    unions = []
    for group in slots:
        ids = [int(i) for b in group for i in np.asarray(b.sample_index)
               if i >= 0]
        ub = epoch_batches(setup.store, ids, BatchBudget.plan(
            setup.store, ids, len(ids), cover_all=True), shuffle=False)
        if len(ub) != 1:
            raise AssertionError(f"the union of {len(ids)} graphs packed "
                                 f"{len(ub)} batches")
        unions.append(ub[0])
    lrs = [(MESH_LR, MESH_LR)] * MESH_STEPS
    out, f32_ref = {}, None
    for dtype in ("float32", "bfloat16"):
        hyper = TrainHyper(feature_jitter_std=0.0, compute_dtype=dtype)
        pair.run(_rank_reset)
        t0 = time.perf_counter()
        ranks = pair.run(aligned_steps_rank, state, cfg, hyper, t.means,
                         t.stds, slots, lrs, every_rank=True)
        secs = time.perf_counter() - t0
        counts = pair.run(_rank_counts, every_rank=True)
        want = 2 * layers * MESH_STEPS
        for r, c in enumerate(counts):
            expect_counts(f"mesh {dtype} rank {r}", c, {
                "attn_eproj_fwd": want, "attn_eproj_bwd": want,
                "csr_segment_sum": want})
        for name, v in ranks[0]["params"].items():
            if not np.array_equal(v, ranks[1]["params"][name]):
                raise AssertionError(f"mesh {dtype}: {name} differs across "
                                     "the ranks")
        ref = TrainStep(_card_model(cfg, state, dev), hyper, t.means,
                        t.stds)
        ref_ms = [[float(x) for x in ref(u, None, *lr)]
                  for u, lr in zip(unions, lrs)]
        ref_grads = {n: p.grad.detach().float().cpu().numpy()
                     for n, p in zip(ref.names, ref.params)}
        for k in range(MESH_STEPS - 1):
            compare_layouts("mesh", dtype, ranks[0]["metrics"][k],
                            ref_ms[k], {}, {},
                            f32_ref and (f32_ref[0][k], {}))
        worst = compare_layouts("mesh", dtype, ranks[0]["metrics"][-1],
                                ref_ms[-1], ranks[0]["grads"], ref_grads,
                                f32_ref and (f32_ref[0][-1], f32_ref[1]))
        f32_ref = f32_ref or (ref_ms, ref_grads)
        wall = pair.run(_rank_aligned_wall, state, cfg, hyper, t.means,
                        t.stds, slots, MESH_TIMED)
        single = make_train_step(_card_model(cfg, state, dev), hyper,
                                 t.means, t.stds, dev)
        flat = [b for group in slots for b in group]
        single_ms, _ = chunk_ms(synced(lambda: [single(b, None, MESH_LR,
                                                       MESH_LR)
                                                for b in flat]),
                                reps=MESH_TIMED)
        single.close()
        out[dtype] = dict(counts=counts[0], ranks=2, steps=MESH_STEPS,
                          run_seconds=secs, aligned_wall_ms=wall,
                          single_captured_wall_ms=single_ms / len(flat),
                          **worst)
        say("mesh", dtype=dtype, ranks=2, backend="gloo",
            steps=MESH_STEPS, graphs_per_step=int(sum(
                float(np.sum(b.graph_mask)) for b in slots[0])),
            params_bitwise_across_ranks=True,
            kernel_launches_rank0=json.dumps(counts[0]),
            aligned_wall_ms_per_step=f"{wall:.2f}",
            single_card_captured_wall_ms_per_subbatch=(
                f"{single_ms / len(flat):.2f}"), **worst)
    # one slot: the single-device path in this process, as before
    t0 = time.perf_counter()
    with open(root / "train_1x1.txt", "w") as log, \
            contextlib.redirect_stdout(log):
        summary, counts, losses, _, replays = run_counted(
            lambda: cli_train.main(train_argv(
                data, root / "trained_1x1", "float32", 1, 1)
                + ["--data-shards", "1", "--edge-shards", "1"]))
    steps = summary["optimizer_steps"]
    check_replays("mesh 1x1", replays, steps, 1)
    want = 2 * layers * steps
    if counts["attn_eproj_bwd"] != want or counts["csr_segment_sum"] != want:
        raise AssertionError(f"mesh 1x1: {counts} for {steps} steps")
    say("mesh", slots="1x1", optimizer_steps=steps,
        step_replays=replays["train"], kernel_launches=json.dumps(counts),
        cli_seconds=f"{time.perf_counter() - t0:.2f}")
    out["one_slot"] = dict(counts=counts, steps=steps)
    return out


def phase_member_parallel(pair, root: Path, data: Path, setup, batches,
                          dev, layers: int):
    """`cli.train --member-parallel vmap` (2 members × 2 epochs, f32): one
    captured graph a step for both members (replays = lock-step steps − the
    warm-up), kernels 5, 6 and 7 2·layers times a member a step; the
    stacked step's device time and busy share from a profiled chunk (its
    kernel calls equal the launch counts). `--member-parallel shard
    --ensemble-size 1` on the card (one slot: this process). Then shard
    mode's rank body over the gloo pair, 2 members × 1 epoch, one a rank:
    each rank's kernels 2·layers times a step of its member, and each
    rank's checkpoint written."""
    import torch
    from gnnep_tpu_torch.cli import train as cli_train
    from gnnep_tpu_torch.models.alignn import init_alignn
    from gnnep_tpu_torch.parallel.ensemble_vmap import (StackedTrainStep,
                                                        _shard_rank)
    from gnnep_tpu_torch.train.ensemble import prepare
    from gnnep_tpu_torch.train.loop import WARMUP_STEPS, TrainHyper
    out = {}
    t0 = time.perf_counter()
    with open(root / "train_vmap.txt", "w") as log, \
            contextlib.redirect_stdout(log):
        summary, counts, _, _, replays = run_counted(
            lambda: cli_train.main(train_argv(
                data, root / "trained_vmap", "float32", VMAP_MEMBERS,
                VMAP_EPOCHS) + ["--member-parallel", "vmap"]))
    secs = time.perf_counter() - t0
    member_steps = summary["member_optimizer_steps"]
    if len(set(member_steps)) != 1 or member_steps[0] <= 0:
        raise AssertionError(f"vmap: member steps {member_steps}")
    lock = member_steps[0]
    # one graph a step for both members
    expect_replays("vmap", replays, lock - WARMUP_STEPS)
    want = 2 * layers * VMAP_MEMBERS * lock
    if counts["attn_eproj_bwd"] != want or counts["csr_segment_sum"] != want \
            or counts["attn_eproj_fwd"] < want:
        raise AssertionError(f"vmap: {counts}, expected {want} of kernels "
                             "6 and 7 and at least as many of 5")
    for i in range(VMAP_MEMBERS):
        if not (root / "trained_vmap" / f"model_{i}.npz").exists():
            raise AssertionError(f"vmap: model_{i}.npz not written")
    # the stacked step's device time, in this process
    cfg, _ = check_config(setup, batches, "eproj")
    t = setup.transformer
    step = StackedTrainStep(
        [init_alignn(np.random.default_rng(SEED + 80 + i), cfg)
         for i in range(VMAP_MEMBERS)], TrainHyper(), t.means, t.stds, dev)
    step.set_lrs(np.full((VMAP_MEMBERS, 2), 1e-4))
    gens = [torch.Generator(device=dev) for _ in range(VMAP_MEMBERS)]
    chunk = batches[:TIMING_K]

    @synced
    def run_all():
        for k in range(len(chunk)):
            step([chunk[(k + i) % len(chunk)] for i in range(VMAP_MEMBERS)],
                 gens)

    wall, _ = chunk_ms(run_all)
    share, dev_ms = profile_run(run_all, "vmap_step", "float32", len(chunk),
                                counted=True)
    step.close()
    out["vmap"] = dict(counts=counts, member_steps=member_steps,
                       cli_seconds=secs, step_replays=replays["train"],
                       stacked_wall_ms=wall / len(chunk),
                       stacked_device_ms=dev_ms, busy_share=share)
    say("member_parallel", mode="vmap", members=VMAP_MEMBERS,
        lock_steps=lock, step_replays=replays["train"],
        forward_replays=replays["eval"], kernel_launches=json.dumps(counts),
        stacked_wall_ms_per_step=f"{wall / len(chunk):.2f}",
        stacked_device_ms_per_step=f"{dev_ms:.3f}",
        device_busy_share=f"{share:.3f}", cli_seconds=f"{secs:.2f}")
    # shard, one member: one slot, this process
    with open(root / "train_shard1.txt", "w") as log, \
            contextlib.redirect_stdout(log):
        summary, counts, _, _, replays = run_counted(
            lambda: cli_train.main(train_argv(
                data, root / "trained_shard1", "float32", 1, 1)
                + ["--member-parallel", "shard"]))
    steps = summary["optimizer_steps"]
    check_replays("shard 1", replays, steps, 1)
    want = 2 * layers * steps
    if counts["attn_eproj_bwd"] != want or counts["csr_segment_sum"] != want:
        raise AssertionError(f"shard 1: {counts} for {steps} steps")
    out["shard_one"] = dict(counts=counts, steps=steps)
    say("member_parallel", mode="shard", members=1, slots="this process",
        optimizer_steps=steps, kernel_launches=json.dumps(counts))
    # shard, two members over the gloo pair
    args = cli_train.build_parser().parse_args(
        train_argv(data, root / "trained_shard2", "float32", 2, 1)
        + ["--member-parallel", "shard"])
    scfg = cli_train.config_from_args(args)
    Path(scfg.save_dir).mkdir(parents=True, exist_ok=True)
    ssetup = prepare(scfg)
    pair.run(_rank_reset)
    t0 = time.perf_counter()
    ranks = pair.run(_shard_rank, ssetup, scfg, None, every_rank=True)
    secs = time.perf_counter() - t0
    counts = pair.run(_rank_counts, every_rank=True)
    for r, ((n_steps, _), c) in enumerate(zip(ranks, counts)):
        want = 2 * layers * n_steps
        if c["attn_eproj_bwd"] != want or c["csr_segment_sum"] != want:
            raise AssertionError(f"shard rank {r}: {c} for {n_steps} steps")
        if not (Path(scfg.save_dir) / f"model_{r}.npz").exists():
            raise AssertionError(f"shard rank {r}: no model_{r}.npz")
    out["shard_pair"] = dict(counts=counts[0], steps=[n for n, _ in ranks],
                             seconds=secs)
    say("member_parallel", mode="shard", members=2, slots="gloo pair",
        optimizer_steps=json.dumps([n for n, _ in ranks]),
        kernel_launches_rank0=json.dumps(counts[0]),
        kernel_launches_rank1=json.dumps(counts[1]),
        seconds=f"{secs:.2f}")
    return out


def giant_store(root: Path, data: Path) -> Path:
    """The fixture's graphs, `GIANT_ID` from `[featurize]`'s fetch (the
    7.5 Å cutoff: 8 atoms, 1,424 bonds, 252,048 line-graph edges) and
    `SYNTH_GIANT`, a synthetic crystal of about 2,000 atoms (about 24k
    bonds, 290k line-graph edges) whose rows straddle two ranks' windows,
    in one store."""
    from gnnep_tpu_torch.data.store import GraphStore, save_sample, write_index
    from gnnep_tpu_torch.utils.synth import synthetic_graph
    fetched = GraphStore.load_dir(root / "fetched", require_target=False,
                                  use_cache=False)
    base = GraphStore.load_dir(data)
    samples = [base.sample(g) for g in range(base.n_graphs)]
    samples.append(fetched.sample(fetched.material_ids.index(GIANT_ID)))
    samples.append(synthetic_graph(np.random.default_rng(SEED + 50),
                                   SYNTH_GIANT, mean_atoms=2000, degree=12))
    out = root / "giant_data"
    for s in samples:
        save_sample(out, s)
    write_index(out, GraphStore.from_samples(samples))
    return out


def _rank_boundary_wall(rank, state, cfg, hyper, means, stds, plan, bb, tb,
                        reps):
    """Host ms per boundary step of `bb` on this rank after one warm-up."""
    import torch
    from gnnep_tpu_torch.parallel.boundary_shard import RankBoundaryBatch
    from gnnep_tpu_torch.parallel.train_step import BoundaryTrainStep
    from gnnep_tpu_torch.train.loop import TrainStep
    base = TrainStep(_card_model(cfg, state, rank.device), hyper, means,
                     stds)
    base.set_lr(MESH_LR, MESH_LR)
    step = BoundaryTrainStep(base, rank, plan)
    rb = RankBoundaryBatch.from_boundary(bb, tb, rank.edge, rank.device)
    step(rb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step(rb)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def boundary_s1(setup, g: int, cfg, state, hyper, lrs, dev):
    """Graph `g` on the boundary path at S = 1 in this process, from
    `state` in `hyper`'s compute type: (its eval forward [2, G, T], one
    step's StepMetrics, `boundary_grads`' gradients by name)."""
    from gnnep_tpu_torch.parallel.boundary_shard import RankBoundaryBatch
    from gnnep_tpu_torch.parallel.giant import build_giant_set
    from gnnep_tpu_torch.parallel.mesh import Rank, make_mesh
    from gnnep_tpu_torch.parallel.train_step import (boundary_grads,
                                                     boundary_steps_rank)
    from gnnep_tpu_torch.train.loop import MIN_LOGVAR_FLOOR
    t = setup.transformer
    one = Rank(make_mesh(1, 1, devices=[str(dev)]), 0)
    gset = build_giant_set(setup.store, [g], 1)
    plan, bb, tb = gset.plan, gset.bbs[g], gset.tables[g]
    res = boundary_steps_rank(one, state, cfg, hyper, t.means, t.stds, plan,
                              [[bb]], [[tb]], lrs, MIN_LOGVAR_FLOOR)
    _, grads = boundary_grads(
        one, _card_model(cfg, state, dev),
        RankBoundaryBatch.from_boundary(bb, tb, 0, dev), plan, hyper,
        t.means, t.stds)
    return (np.stack(res["forward"]), [float(x) for x in res["metrics"][0]],
            {n: v.detach().float().cpu().numpy() for n, v in grads.items()})


def phase_giant(pair, root: Path, data: Path, dev, layers: int):
    """A giant beside the fixture's graphs: `GIANT_ID` holds more
    line-graph edges (252,048) than a 64-graph batch's arena (74,880).
    `cli.train --giant-graphs boundary --edge-shards 1` (1 member × 1
    epoch, no bootstrap, the first seed that puts the giant in the train
    split): its boundary step runs in this process beside the captured
    packed steps, kernels 6 and 7 2·layers times a step of either kind;
    `cli.predict` and `cli.evaluate --no-plots --giant-shards 1` route it
    (its row finite; kernel 5 2·layers a forward). Then the S = 2 boundary
    forward and step over the gloo pair, f32 and bf16: in f32 against the
    card's unpartitioned forward (SERVE_RTOL / SERVE_ATOL) and step
    (`compare_layouts`); in bf16 against the S = 1 boundary path in bf16
    (`boundary_s1`: its forward, step metrics and `boundary_grads`, which
    round the same weights and pool in f32 as S = 2 does): the forward and
    the gradients within BF16_LAYOUT_SHARE of its distance from the
    unpartitioned f32 step (`near_as_ref(direct=True)`), the metrics as
    near that step as it (`compare_layouts`), each rank's kernels 5 (eval
    and train forward), 6 and 7 2·layers times, the bytes each rank sent
    through the exchange against `BoundaryPlan.comm_bytes_per_conv`; the
    boundary step's wall at S = 2 and S = 1 beside the unpartitioned
    step's, and the S = 1 step's device time."""
    import torch
    from gnnep_tpu_torch.cli import evaluate as cli_evaluate
    from gnnep_tpu_torch.cli import predict as cli_predict
    from gnnep_tpu_torch.cli import train as cli_train
    from gnnep_tpu_torch.data.batching import epoch_batches
    from gnnep_tpu_torch.models.alignn import DeviceBatch, init_alignn
    from gnnep_tpu_torch.parallel.giant import build_giant_set
    from gnnep_tpu_torch.parallel.mesh import Rank, make_mesh
    from gnnep_tpu_torch.parallel.train_step import boundary_steps_rank
    from gnnep_tpu_torch.train.ensemble import prepare
    from gnnep_tpu_torch.train.loop import (MIN_LOGVAR_FLOOR, WARMUP_STEPS,
                                            Forward, TrainHyper, TrainStep,
                                            cast_model, make_train_step)
    gdata = giant_store(root, data)
    flags = ["--giant-graphs", "boundary", "--edge-shards", "1",
             "--no-bootstrap-train"]

    def argv(seed):
        a = train_argv(gdata, root / "trained_giant", "float32", 1, 1)
        a[a.index("--seed") + 1] = str(seed)
        return a + flags

    for seed in range(SEED, SEED + 50):
        setup = prepare(cli_train.config_from_args(
            cli_train.build_parser().parse_args(argv(seed))))
        if setup.giant and set(setup.giant.indices) & set(setup.train_idx):
            break
    else:
        raise AssertionError("no seed put the giant in the train split")
    ids = setup.store.material_ids
    if sorted(ids[g] for g in setup.giant.indices) != sorted(
            [GIANT_ID, SYNTH_GIANT]):
        raise AssertionError(f"giants {[ids[g] for g in setup.giant.indices]}")
    out = dict(seed=seed, batch_lg_arena=setup.budget.n_lg_edges)
    for g in setup.giant.indices:
        n, e, l = setup.store.counts(g)
        out[ids[g]] = dict(atoms=n, bonds=e, lg_edges=l,
                           in_train=g in setup.train_idx)
        say("giant", material=ids[g], atoms=n, bonds=e, lg_edges=l,
            batch_lg_arena=setup.budget.n_lg_edges,
            in_train=g in setup.train_idx, seed=seed)
    n_giant_steps = len(set(setup.giant.indices) & set(setup.train_idx))
    t0 = time.perf_counter()
    with open(root / "train_giant.txt", "w") as log, \
            contextlib.redirect_stdout(log):
        summary, counts, losses, _, replays = run_counted(
            lambda: cli_train.main(argv(seed)))
    secs = time.perf_counter() - t0
    steps = summary["optimizer_steps"]
    # one step a giant in the train split: no bootstrap, one epoch
    packed = steps - n_giant_steps
    loss = torch.cat(losses).cpu().numpy() if losses else np.zeros(0)
    if len(loss) != steps or not np.isfinite(loss).all():
        raise AssertionError(f"giant train: {len(loss)} losses for {steps} "
                             f"steps, finite {np.isfinite(loss).all()}")
    # the giant's step runs eagerly, the packed steps replay
    expect_replays("giant train", replays, packed - WARMUP_STEPS)
    want = 2 * layers * steps
    if counts["attn_eproj_bwd"] != want or counts["csr_segment_sum"] != want:
        raise AssertionError(f"giant train: {counts}, expected {want} of "
                             "kernels 6 and 7")
    out["train"] = dict(counts=counts, steps=steps, cli_seconds=secs)
    say("giant", run="cli.train", edge_shards=1, optimizer_steps=steps,
        giant_steps=n_giant_steps, step_replays=replays["train"],
        kernel_launches=json.dumps(counts), cli_seconds=f"{secs:.2f}")
    ens = root / "trained_giant"
    pred = root / "pred_giant.json"
    # the whole store: a budget planned over it leaves the giant out
    mids = [GIANT_ID, *[m for m in setup.store.material_ids
                        if m != GIANT_ID]]
    with open(root / "predict_giant.txt", "w") as log, \
            contextlib.redirect_stdout(log):
        reset_counts()
        cli_predict.main(["--mode", "materials", "--materials",
                          ",".join(mids), "--batch-size", str(BATCH),
                          "--data-dir", str(gdata), "--ensemble-dir",
                          str(ens), "--giant-shards", "1", "--output-json",
                          str(pred)])
        pcounts = read_counts()
    preds = json.loads(pred.read_text())["predictions"]
    mu = np.asarray([p["mu"] for p in preds], np.float64)
    # the packed rows first, the giants' boundary rows last
    tail = sorted(p["material_id"] for p in preds[-2:])
    if (tail != sorted([GIANT_ID, SYNTH_GIANT]) or len(preds) != len(mids)
            or not np.isfinite(mu).all()):
        raise AssertionError(f"giant predict: {len(preds)} rows, last two "
                             f"{tail}, finite {np.isfinite(mu).all()}")
    fwd = pcounts["attn_eproj_fwd"]
    expect_counts("giant predict", pcounts, {"attn_eproj_fwd": fwd})
    n_batches = -(-(len(mids) - 2) // BATCH)
    if fwd % (2 * layers) or fwd < 2 * layers * (n_batches + 2):
        raise AssertionError(f"giant predict: kernel 5 launched {fwd} "
                             "times, not 2·layers a forward of the packed "
                             "batches and the giant")
    ev = root / "eval_giant"
    with open(root / "evaluate_giant.txt", "w") as log, \
            contextlib.redirect_stdout(log):
        reset_counts()
        res = cli_evaluate.main(
            ["--ensemble-dir", str(ens), "--data-dir", str(gdata),
             "--output-dir", str(ev), "--no-plots", "--batch-size",
             str(BATCH), "--seed", str(seed), "--ensemble-size", "1",
             "--eval-split", "train", "--giant-shards", "1"])
        ecounts = read_counts()
    if not np.isfinite(res["overall"]["mae"]) or \
            ecounts["attn_eproj_fwd"] <= 0:
        raise AssertionError(f"giant evaluate: {res['overall']}, {ecounts}")
    giant_mu = {p["material_id"]: p["mu"] for p in preds[-2:]}
    out["predict"] = dict(counts=pcounts, giant_mu=giant_mu)
    out["evaluate"] = dict(counts=ecounts, mae=res["overall"]["mae"])
    say("giant", run="cli.predict", giant_shards=1, rows=len(preds),
        giant_mu=json.dumps({k: np.round(v, 3).tolist()
                             for k, v in giant_mu.items()}),
        kernel_launches=json.dumps(pcounts))
    say("giant", run="cli.evaluate", giant_shards=1, split="train",
        mae=f"{res['overall']['mae']:.4f}",
        kernel_launches=json.dumps(ecounts))

    # S = 2 over the pair against the unpartitioned graph on the card
    t = setup.transformer
    lrs = [(MESH_LR, MESH_LR)]
    graphs = {}
    for g in setup.giant.indices:
        mid = ids[g]
        gset = build_giant_set(setup.store, [g], 2)
        plan, bb, tb = gset.plan, gset.bbs[g], gset.tables[g]
        single = epoch_batches(setup.store, [g], gset.budget,
                               shuffle=False)[0]
        cfg, _ = check_config(setup, [single], "eproj")
        state = _state(init_alignn(np.random.default_rng(SEED + 70), cfg))
        graphs[mid] = (g, single, cfg, state)
        f32_ref = None
        for dtype in ("float32", "bfloat16"):
            hyper = TrainHyper(feature_jitter_std=0.0, compute_dtype=dtype)
            pair.run(_rank_reset)
            ranks = pair.run(boundary_steps_rank, state, cfg, hyper,
                             t.means, t.stds, plan, [[bb]], [[tb]], lrs,
                             MIN_LOGVAR_FLOOR, every_rank=True)
            counts = pair.run(_rank_counts, every_rank=True)
            want = 2 * layers
            for r, c_r in enumerate(counts):
                expect_counts(f"boundary {mid} {dtype} rank {r}", c_r, {
                    "attn_eproj_fwd": 2 * want, "attn_eproj_bwd": want,
                    "csr_segment_sum": want})
            item = 4 if dtype == "float32" else 2
            per_conv = plan.comm_bytes_per_conv(cfg.hidden, item,
                                                projected=False)
            # the eval forward, the train forward and its backward
            wire = 3 * layers * sum(per_conv.values())
            for r, res_r in enumerate(ranks):
                if res_r["sent_bytes"] != wire:
                    raise AssertionError(
                        f"boundary {mid} {dtype} rank {r}: sent "
                        f"{res_r['sent_bytes']} bytes, plan {wire}")
            if f32_ref is None:
                # the unpartitioned graph's forward and step
                model = _card_model(cfg, state, dev)
                db = DeviceBatch.from_batch(single, dev)
                fwd = np.stack([o.cpu().numpy() for o in Forward(
                    MIN_LOGVAR_FLOOR, dtype).eager(cast_model(model, dtype),
                                                    db)])
                ref = TrainStep(model, hyper, t.means, t.stds)
                ref_m = [float(x) for x in ref(single, None, *lrs[0])]
                ref_grads = {nm: p.grad.detach().float().cpu().numpy()
                             for nm, p in zip(ref.names, ref.params)}
            else:
                # bf16: the S = 1 boundary path, which pools in f32 as S = 2
                # does (the unpartitioned bf16 step pools in bf16 and lies
                # far from f32 on the 2,040-atom giant: PERF.md) and rounds
                # the same weights and states as S = 2
                fwd, ref_m, ref_grads = boundary_s1(setup, g, cfg, state,
                                                    hyper, lrs, dev)
            got = np.stack(ranks[0]["forward"])
            if f32_ref is None:
                if not np.allclose(got, fwd, rtol=SERVE_RTOL,
                                   atol=SERVE_ATOL):
                    raise AssertionError(f"boundary {mid} {dtype} forward: "
                                         f"{got} vs {fwd}")
                fwd_share = float(np.abs(got - fwd).max() / (
                    SERVE_ATOL + SERVE_RTOL * np.abs(fwd).max()))
            else:
                fwd_share = near_as_ref(f"boundary {mid} {dtype} forward",
                                        got, fwd, f32_ref[0], 0.0,
                                        direct=True)
            worst = compare_layouts(f"boundary {mid}", dtype,
                                    ranks[0]["metrics"][0], ref_m,
                                    ranks[0]["grads"], ref_grads,
                                    f32_ref and f32_ref[1:], direct=True)
            f32_ref = f32_ref or (fwd, ref_m, ref_grads)
            s2 = pair.run(_rank_boundary_wall, state, cfg, hyper, t.means,
                          t.stds, plan, bb, tb, GIANT_TIMED)
            out[f"boundary_{mid}_{dtype}"] = dict(
                counts=counts[0], bn=plan.bn, bl=plan.bl,
                sent_bytes=ranks[0]["sent_bytes"], plan_bytes=wire,
                forward_share_of_limit=fwd_share, s2_wall_ms=s2, **worst)
            say("giant", run="boundary", material=mid, shards=2,
                dtype=dtype, bn=plan.bn, bl=plan.bl,
                comm_bytes_per_conv=json.dumps(per_conv),
                sent_bytes_rank0=ranks[0]["sent_bytes"],
                sent_bytes_rank1=ranks[1]["sent_bytes"],
                forward_share_of_limit=f"{fwd_share:.3f}",
                kernel_launches_rank0=json.dumps(counts[0]),
                s2_step_wall_ms=f"{s2:.2f}", **worst)
    if out[f"boundary_{SYNTH_GIANT}_float32"]["sent_bytes"] <= 0:
        raise AssertionError(f"{SYNTH_GIANT}: the exchange sent nothing")
    # S = 1 in this process: the boundary step's wall and device time
    # beside the unpartitioned step's on the same graph
    g, single, cfg, state = graphs[SYNTH_GIANT]
    one = Rank(make_mesh(1, 1, devices=[str(dev)]), 0)
    gset1 = build_giant_set(setup.store, [g], 1)
    hyper = TrainHyper(feature_jitter_std=0.0)
    s1 = _rank_boundary_wall(one, state, cfg, hyper, t.means, t.stds,
                             gset1.plan, gset1.bbs[g], gset1.tables[g],
                             GIANT_TIMED)
    eager = TrainStep(_card_model(cfg, state, dev), hyper, t.means, t.stds)
    eager_ms, _ = chunk_ms(synced(lambda: eager(single, None, MESH_LR,
                                                MESH_LR)), reps=GIANT_TIMED)
    captured = make_train_step(_card_model(cfg, state, dev), hyper, t.means,
                               t.stds, dev)
    cap_ms, _ = chunk_ms(synced(lambda: captured(single, None, MESH_LR,
                                                 MESH_LR)), reps=GIANT_TIMED)
    captured.close()
    from gnnep_tpu_torch.parallel.boundary_shard import RankBoundaryBatch
    from gnnep_tpu_torch.parallel.train_step import BoundaryTrainStep
    base = TrainStep(_card_model(cfg, state, dev), hyper, t.means, t.stds)
    base.set_lr(MESH_LR, MESH_LR)
    bstep = BoundaryTrainStep(base, one, gset1.plan)
    rb = RankBoundaryBatch.from_boundary(gset1.bbs[g], gset1.tables[g], 0,
                                         dev)
    share, dev_ms = profile_run(synced(lambda: bstep(rb)), "boundary_s1",
                                "float32", 1, counted=True)
    out["walls"] = dict(s1_wall_ms=s1, unpartitioned_eager_wall_ms=eager_ms,
                        unpartitioned_captured_wall_ms=cap_ms,
                        s1_device_ms=dev_ms, s1_busy_share=share)
    say("giant", run="walls", material=SYNTH_GIANT, dtype="float32",
        s1_boundary_step_wall_ms=f"{s1:.2f}",
        s1_boundary_step_device_ms=f"{dev_ms:.3f}",
        unpartitioned_eager_step_wall_ms=f"{eager_ms:.2f}",
        unpartitioned_captured_step_wall_ms=f"{cap_ms:.2f}")
    return out


# ---------------------------------------------------- the edge-sharded path
# The bond and line-graph arenas of one batch cut over the edge axis, the
# states replicated, each conv's partials summed over the ranks
# (`parallel/edge_shard.py`): at S = 1 in this process, at S = 2 on the
# gloo pair of [mesh]. Kernel 7 runs once a conv in an eval forward; a step
# runs it once forward and once backward a conv (the q gather), twice each
# with attention dropout (the denominator and α·v forward; the q and the
# denominator gathers backward).
EDGE_STEPS = 2       # steps of each checked run but S = 1's first
EDGE_TIMED = 3       # timed forwards and steps after the checked ones
EDGE_DROPOUT = 0.15  # the trainer's default


def edge_k7(layers: int, train: bool, dropout: bool) -> int:
    """Kernel 7's launches in a windowed eval forward or train step."""
    per_conv = (2 if dropout else 1) * (2 if train else 1)
    return 2 * layers * per_conv


def edge_bytes(batch, cfg, n_edge: int, n_params: int, train: bool,
               dropout: bool) -> int:
    """Bytes a rank hands to the collectives, D = 1, f32: per conv a
    [rows, heads] max and the sums (Σ exp·v ‖ Σ exp, [rows, H + heads];
    with dropout Σ exp and Σ α·v apart), each sum once more in the
    backward; the bond-state gather ([E/S, H], its backward a [E, H] sum)
    and the two live-edge counts; a step's gradient all-reduce (the
    parameters and 6 metric sums, then max_var)."""
    if n_edge == 1:
        return 0
    h, heads = cfg.hidden, cfg.heads
    n_bonds = batch.edge_src.shape[0]
    conv = 0
    for n in (n_bonds, batch.nodes.shape[0]):
        sums = [n * heads, n * h] if dropout else [n * (h + heads)]
        conv += n * heads + sum(sums) * (2 if train else 1)
    total = cfg.layers * conv + n_bonds // n_edge * h + 2
    if train:
        total += n_bonds * h + n_params + 6 + 1
    return 4 * total


def _rank_edge(rank, state, cfg, hyper, means, stds, group, layout,
               steps, seed, timed, profile=False, restart=False):
    """On this rank from `state`: the edge-sharded eval forward of its
    edge slice of its data slot's batch, then `steps` sharded steps
    (dropout and jitter from this rank's and the slot's shared generator,
    seeded from `seed`; none where None; each step's metrics and reduced
    gradients kept; with `restart` each step after the first starts again
    from `state` with a fresh Adam state, the streams running on), each
    part's kernel launches and collective bytes counted alone; then `timed` more forwards and steps,
    host ms each (the parameters move on); with `profile` (in this
    process) a profiled forward and step (`profile_run`; the profiler's
    kernel 7 calls equal its launches where it runs) → dict."""
    import torch
    from gnnep_tpu_torch.models.alignn import DeviceBatch
    from gnnep_tpu_torch.parallel import mesh
    from gnnep_tpu_torch.parallel.train_step import (edge_slice,
                                                     make_sharded_forward,
                                                     make_sharded_train_step)
    from gnnep_tpu_torch.train.loop import MIN_LOGVAR_FLOOR
    model = _card_model(cfg, state, rank.device)
    db = DeviceBatch.from_batch(edge_slice(group[rank.data], rank.edge,
                                           rank.mesh.n_edge), rank.device)
    fwd = make_sharded_forward(rank, MIN_LOGVAR_FLOOR, **layout)
    step = make_sharded_train_step(rank, model, hyper, means, stds,
                                   **layout)
    gens = (None, None)
    if seed is not None:
        gens = tuple(torch.Generator(device=rank.device) for _ in range(2))
        gens[0].manual_seed(seed + rank.rank)
        gens[1].manual_seed(seed + rank.mesh.size + rank.data)

    def counted(fn):
        torch.cuda.synchronize()
        reset_counts()
        mesh.reduced_bytes = 0
        res = fn()
        torch.cuda.synchronize()
        return res, read_counts(), mesh.reduced_bytes

    forward, f_counts, f_bytes = counted(
        lambda: np.stack([x.cpu().numpy() for x in fwd(model, db)]))
    grads = []
    zeros = {n: np.zeros_like(v) for n, v in state.items()}

    def stepped():
        rows = []
        for k in range(steps):
            if restart and k:
                step.base.load_state(state, zeros, zeros, 0)
            rows.append([float(v) for v in step(db, *gens, MESH_LR,
                                                MESH_LR)])
            grads.append({n: g.detach().cpu().numpy()
                          for n, g in zip(step.base.names,
                                          step.last_grads)})
        return rows

    metrics, s_counts, s_bytes = counted(stepped)
    out = dict(forward=forward, metrics=metrics, params=_state(model),
               grads=grads, counts={"forward": f_counts, "steps": s_counts},
               bytes={"forward": f_bytes, "steps": s_bytes})

    def run_fwd():
        fwd(model, db)

    def run_step():
        step(db, *gens, MESH_LR, MESH_LR)

    for name, fn in (("forward", run_fwd), ("step", run_step)):
        if timed:
            out[f"{name}_wall_ms"], _ = chunk_ms(synced(fn), reps=timed)
        if profile:
            kernel_runs = bool(layout)
            out[f"{name}_busy_share"], out[f"{name}_device_ms"] = \
                profile_run(synced(fn), f"edge_shard_{name}_"
                            f"{'windowed' if kernel_runs else 'coo'}",
                            "float32", 1, counted=kernel_runs)
    return out


def _rank_window_last_row(rank, hidden: int, heads: int):
    """The conv at `hidden` / `heads` on a hand-built arena of 512 rows
    that take 4 edges each, over this rank's slice (S = 2): each slice
    ends on its window's last row (hi = r_lo + R − 1, R = 256), real.
    Windowed (kernel 7) and COO on this rank's card, forward and the
    gradients of Σ out·g → (largest elementwise |Δ| over the limit
    rtol 3e-4 / atol 3e-5 of the outputs; the largest |Δ| of each
    gradient over STEP_TOL of its largest value plus 1e-5 of the largest
    of all, the worst of them and its name; kernel 7's launches). The key
    bias's true gradient is zero (softmax cancels q·b_key): its own is
    rounding noise, held by the absolute term."""
    import torch
    from gnnep_tpu_torch.ops.graph_attention import TransformerConvParams
    from gnnep_tpu_torch.parallel.edge_shard import edge_sharded_conv
    from gnnep_tpu_torch.parallel.train_step import measure_row_windows
    rng = np.random.default_rng(SEED + 82)
    n, deg, s = 512, 4, rank.mesh.n_edge
    e_loc = n * deg // s
    row_ptr = np.arange(n + 1, dtype=np.int32) * deg

    class Arena:
        edge_row_ptr = lg_row_ptr = row_ptr
        edge_src = lg_src = np.zeros(n * deg)
        nodes = np.zeros(n)

    window = measure_row_windows([Arena], s)[0]
    lo = rank.edge * e_loc // deg
    if window != 256 or (lo + window - 1) * deg + deg != (rank.edge + 1) * e_loc:
        raise AssertionError(f"window {window}: the slice does not end on "
                             "its last row")
    dev = rank.device

    def t(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale,
                            dtype=torch.float32, device=dev)

    sl = slice(rank.edge * e_loc, (rank.edge + 1) * e_loc)
    src = torch.tensor(rng.integers(0, n, n * deg), device=dev)[sl]
    dst = torch.arange(n, device=dev).repeat_interleave(deg)[sl]
    x, ea, g = t(n, hidden), t(n * deg, hidden)[sl], t(n, hidden)
    shapes = [(hidden, hidden), (hidden,)] * 3 + [(hidden, hidden)] \
        + [(hidden, hidden), (hidden,), (3 * hidden, 1)]
    params = [t(*sh, scale=hidden ** -0.5) for sh in shapes]
    res = {}
    for impl in ("windowed", "coo"):
        leaves = [p.clone().requires_grad_(True) for p in [x, ea, *params]]
        reset_counts()
        out = edge_sharded_conv(
            TransformerConvParams(*leaves[2:]), leaves[0], src, dst,
            leaves[1], heads=heads, rank=rank,
            row_ptr=torch.from_numpy(row_ptr).to(dev), impl=impl,
            row_window=window)
        (out * g).sum().backward()
        torch.cuda.synchronize()
        res[impl] = (out.detach(), [p.grad for p in leaves],
                     read_counts()["csr_segment_sum"])
    (o_w, g_w, k7), (o_c, g_c, _) = res["windowed"], res["coo"]
    out_share = float(((o_w - o_c).abs() / (3e-5 + 3e-4 * o_c.abs())).max())
    scale = max(float(b.abs().max()) for b in g_c)
    names = ["x", "edge_attr", *TransformerConvParams._fields]
    grad_share, leaf = max(
        (float((a - b).abs().max()) / (STEP_TOL["float32"]
                                       * float(b.abs().max())
                                       + 1e-5 * scale), name)
        for a, b, name in zip(g_w, g_c, names))
    return out_share, grad_share, leaf, k7


def captured_step(cfg, state, hyper, t, batch, dev, steps: int):
    """The card's captured step from `state` on `batch` (its eager warm-up
    on the batch, then the state back in place and `steps` replays, the
    capture's first included) → (each step's StepMetrics as floats, each
    step's gradients by name)."""
    from gnnep_tpu_torch.train.loop import make_train_step
    card = make_train_step(_card_model(cfg, state, dev), hyper, t.means,
                           t.stds, dev)
    card(batch, None, MESH_LR, MESH_LR)
    zeros = {n: np.zeros_like(v) for n, v in state.items()}
    card.load_state(state, zeros, zeros, 0)
    metrics, grads = [], []
    for _ in range(steps):
        metrics.append([float(x) for x in card(batch, None, MESH_LR,
                                               MESH_LR)])
        grads.append({n: p.grad.detach().cpu().numpy()
                      for n, p in zip(card.names, card.params)})
    card.close()
    return metrics, grads


def phase_edge_shard(pair, setup, batches, dev, layers: int):
    """The edge-sharded formulation at the flagship on one 64-graph batch,
    f32. S = 1 in this process, COO and windowed: the eval forward and one
    step (dropout and jitter off) against the card's captured forward and
    step from the same state (the forward at SERVE_RTOL / SERVE_ATOL, the
    step at `compare_layouts`' f32 limits), windowed against COO; kernel 7
    `edge_k7` times on the windowed path and nothing else on either; each
    forward's and step's wall, device ms and busy share (profiled); then
    EDGE_STEPS steps with the trainer's dropout and jitter, each from the
    same state, windowed against COO from the same seeds (the same keep
    masks: each step's metrics and gradients at the f32 limits). S = 2 on
    the gloo pair, widths and row windows measured: the windowed forward
    and EDGE_STEPS steps against the card's forward and captured steps
    (the first step's gradients, every step's metrics), then the dropout
    steps as at S = 1; kernel 7's launches on each rank exactly `edge_k7`'s,
    parameters bitwise equal on both ranks, the bytes each rank hands to
    the collectives exactly `edge_bytes`; walls. Then a conv whose
    window's last row is real (`_rank_window_last_row`), windowed against
    COO on the pair."""
    from gnnep_tpu_torch.models.alignn import init_alignn
    from gnnep_tpu_torch.parallel.mesh import Rank, make_mesh
    from gnnep_tpu_torch.parallel.train_step import (measure_row_windows,
                                                     measure_table_widths)
    from gnnep_tpu_torch.train.loop import (MIN_LOGVAR_FLOOR, Forward,
                                            TrainHyper)
    t0 = time.perf_counter()
    cfg, _ = check_config(setup, batches, "eproj")
    t = setup.transformer
    b = full_batches(batches)[0]
    state = _state(init_alignn(np.random.default_rng(SEED + 80), cfg))
    n_params = sum(v.size for v in state.values())
    off = TrainHyper(feature_jitter_std=0.0)
    fwd = Forward(MIN_LOGVAR_FLOOR)
    model = _card_model(cfg, state, dev)
    fwd(model, b)
    ref_fwd = np.stack([x.cpu().numpy() for x in fwd(model, b)])
    fwd.close()
    ref_m, ref_grads = captured_step(cfg, state, off, t, b, dev, EDGE_STEPS)
    cfg_d = dataclasses.replace(cfg, dropout=EDGE_DROPOUT)

    def layout_for(impl, n_edge):
        if impl == "coo":
            return {}
        return dict(impl=impl, table_widths=measure_table_widths([b]),
                    row_windows=measure_row_windows([b], n_edge))

    def expect(what, r, n_edge, windowed, steps, dropout):
        """Kernel 7's launches and the collectives' bytes of `r`'s forward
        and `steps` steps."""
        for part, train, n in (("forward", False, 1), ("steps", True, steps)):
            drops = dropout and train      # an eval forward drops nothing
            want = n * edge_k7(layers, train, drops) if windowed else 0
            expect_counts(f"{what} {part}", r["counts"][part],
                          {"csr_segment_sum": want})
            nb = n * edge_bytes(b, cfg, n_edge, n_params, train, drops)
            if r["bytes"][part] != nb:
                raise AssertionError(f"{what} {part}: {r['bytes'][part]} "
                                     f"bytes through the collectives, the "
                                     f"formulation's {nb}")

    def steps_vs(what, r, m, grads, grad_steps):
        """Each of `r`'s steps against `m` / `grads`' at the f32 limits,
        the gradients of the first `grad_steps` → the worst shares over
        the steps. (Along a trajectory Adam turns rounding noise in
        gradients of about zero into whole steps, which move the next
        gradients: ROADMAP.md, Hazards; a later step's loss and metric sums
        are held.)"""
        res = [compare_layouts(f"{what} step {k + 1}", "float32",
                               r["metrics"][k], m[k],
                               *((r["grads"][k], grads[k])
                                 if k < grad_steps else ({}, {})))
               for k in range(len(r["metrics"]))]
        return dict(max(res, key=lambda d: float(d["grad_share_of_limit"])),
                    metrics_share_of_limit=max(
                        (d["metrics_share_of_limit"] for d in res),
                        key=float))

    def check(what, r, n_edge, windowed, steps):
        expect(what, r, n_edge, windowed, steps, False)
        got = r["forward"][:, 0]
        if not np.allclose(got, ref_fwd, rtol=SERVE_RTOL, atol=SERVE_ATOL):
            raise AssertionError(f"{what} forward: {got} vs {ref_fwd}")
        share = float(np.abs(got - ref_fwd).max() / (
            SERVE_ATOL + SERVE_RTOL * np.abs(ref_fwd).max()))
        return dict(forward_share_of_limit=f"{share:.3f}",
                    **steps_vs(what, r, ref_m, ref_grads, 1))

    def dropout_vs_coo(what, win, coo, n_edge):
        """The windowed dropout run against the COO one from the same
        seeds: launches, bytes, each step."""
        expect(f"{what} windowed", win, n_edge, True, EDGE_STEPS, True)
        expect(f"{what} coo", coo, n_edge, False, EDGE_STEPS, True)
        if not np.isfinite(win["metrics"]).all():
            raise AssertionError(f"{what}: metrics {win['metrics']}")
        return steps_vs(f"{what} windowed vs coo", win, coo["metrics"],
                        coo["grads"], EDGE_STEPS)

    out = {}
    one = Rank(make_mesh(1, 1, devices=[str(dev)]), 0)
    s1, s1_drop = {}, {}
    for impl in ("coo", "windowed"):
        lay = layout_for(impl, 1)
        s1[impl] = r = _rank_edge(one, state, cfg, off, t.means, t.stds,
                                  [b], lay, 1, None, EDGE_TIMED,
                                  profile=True)
        worst = check(f"edge_shard S=1 {impl}", r, 1, impl == "windowed", 1)
        out[f"s1_{impl}"] = dict(
            counts=r["counts"], **worst,
            **{k: r[k] for k in ("forward_wall_ms", "step_wall_ms",
                                 "forward_device_ms", "step_device_ms",
                                 "forward_busy_share", "step_busy_share")})
        say("edge_shard", shards=1, impl=impl, dtype="float32",
            kernel7_forward=r["counts"]["forward"]["csr_segment_sum"],
            kernel7_step=r["counts"]["steps"]["csr_segment_sum"],
            forward_wall_ms=f"{r['forward_wall_ms']:.2f}",
            forward_device_ms=f"{r['forward_device_ms']:.3f}",
            step_wall_ms=f"{r['step_wall_ms']:.2f}",
            step_device_ms=f"{r['step_device_ms']:.3f}",
            step_busy_share=f"{r['step_busy_share']:.3f}", **worst)
        s1_drop[impl] = _rank_edge(one, state, cfg_d, TrainHyper(), t.means,
                                   t.stds, [b], lay, EDGE_STEPS, SEED + 81,
                                   0, False, True)
    vs = steps_vs("edge_shard S=1 windowed vs coo", s1["windowed"],
                  s1["coo"]["metrics"], s1["coo"]["grads"], 1)
    if not np.allclose(s1["windowed"]["forward"], s1["coo"]["forward"],
                       rtol=SERVE_RTOL, atol=SERVE_ATOL):
        raise AssertionError("edge_shard S=1: windowed forward vs COO")
    out["s1_windowed_vs_coo"] = vs
    say("edge_shard", shards=1, what="windowed_vs_coo", **vs)
    vs = dropout_vs_coo("edge_shard S=1 dropout", s1_drop["windowed"],
                        s1_drop["coo"], 1)
    out["s1_dropout_windowed_vs_coo"] = vs
    say("edge_shard", shards=1, what="dropout_windowed_vs_coo",
        steps=EDGE_STEPS, dropout=EDGE_DROPOUT, **vs)

    lay2 = layout_for("windowed", 2)
    pair.run(_rank_reset)
    ranks = pair.run(_rank_edge, state, cfg, off, t.means, t.stds, [b],
                     lay2, EDGE_STEPS, None, EDGE_TIMED, every_rank=True)
    worst = [check(f"edge_shard S=2 rank {i}", r, 2, True, EDGE_STEPS)
             for i, r in enumerate(ranks)]
    drop = {impl: pair.run(_rank_edge, state, cfg_d, TrainHyper(), t.means,
                           t.stds, [b], layout_for(impl, 2), EDGE_STEPS,
                           SEED + 81, 0, False, True, every_rank=True)
            for impl in ("windowed", "coo")}
    for i, rs in enumerate((ranks, drop["windowed"], drop["coo"])):
        for name, v in rs[0]["params"].items():
            if not np.array_equal(v, rs[1]["params"][name]):
                raise AssertionError(f"edge_shard S=2 run {i}: {name} "
                                     "differs across the ranks")
    drop_vs = [dropout_vs_coo(f"edge_shard S=2 dropout rank {i}", w, c, 2)
               for i, (w, c) in enumerate(zip(drop["windowed"],
                                              drop["coo"]))]
    trap = pair.run(_rank_window_last_row, cfg.hidden, cfg.heads,
                    every_rank=True)
    for i, (o_share, g_share, leaf, k7) in enumerate(trap):
        if o_share > 1.0 or g_share > 1.0 or k7 != 2:
            raise AssertionError(f"edge_shard window's last row, rank {i}: "
                                 f"output {o_share:.3f}, gradients "
                                 f"{g_share:.3f} ({leaf}) of the limit; "
                                 f"kernel 7 {k7} launches (2)")
    r0, d0 = ranks[0], drop["windowed"][0]
    out["s2"] = dict(
        row_windows=lay2["row_windows"], table_widths=lay2["table_widths"],
        counts=r0["counts"], bytes=r0["bytes"], **worst[0],
        forward_wall_ms=r0["forward_wall_ms"],
        step_wall_ms=r0["step_wall_ms"],
        dropout_counts=d0["counts"], dropout_bytes=d0["bytes"],
        dropout_windowed_vs_coo=drop_vs,
        window_last_row=[dict(output_share=o, grad_share=g, leaf=f)
                         for o, g, f, _ in trap])
    out["seconds"] = time.perf_counter() - t0
    say("edge_shard", shards=2, impl="windowed", dtype="float32",
        row_windows=json.dumps(lay2["row_windows"]),
        kernel7_forward=r0["counts"]["forward"]["csr_segment_sum"],
        kernel7_steps=r0["counts"]["steps"]["csr_segment_sum"],
        kernel7_dropout_steps=d0["counts"]["steps"]["csr_segment_sum"],
        bytes_forward=r0["bytes"]["forward"],
        bytes_steps=r0["bytes"]["steps"],
        bytes_dropout_steps=d0["bytes"]["steps"],
        params_bitwise_across_ranks=True,
        forward_wall_ms=f"{r0['forward_wall_ms']:.2f}",
        step_wall_ms=f"{r0['step_wall_ms']:.2f}",
        dropout_vs_coo=json.dumps(drop_vs),
        window_last_row_shares=json.dumps(
            [[round(o, 4), round(g, 4), f] for o, g, f, _ in trap]),
        phase_seconds=f"{out['seconds']:.2f}", **worst[0])
    return out


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
        span_flag = phase_kernel_span(dev, train_batches[0])
        phase_kernel_widths(dev)
        launches = phase_serve(root, data, ens, cfg, batches, dev)
        rung_ens = {rung: write_rung_ensemble(root, ens, cfg, rung)
                    for rung in RUNGS}
        rung_serve = {
            rung: phase_serve(root, data, rung_ens[rung], cfg, batches, dev,
                              members=RUNG_MEMBERS, kernel=spec["fwd"],
                              tag=f"_{rung}")
            for rung, spec in RUNGS.items()}
        runs = phase_train(root, data, cfg.layers)
        evaluated = {
            "eproj": phase_evaluate(root, data, root / "trained_float32",
                                    cfg.layers, TRAIN_MEMBERS,
                                    "attn_eproj_fwd", "eproj"),
            "kv+e": phase_evaluate(root, data, rung_ens["kv+e"], cfg.layers,
                                   RUNG_MEMBERS, RUNGS["kv+e"]["fwd"],
                                   "kv+e")}
        featurized = phase_featurize(root, ens, cfg.layers)
        knn = phase_knn(root, data, cfg.layers, setup, train_batches, dev)
        from gnnep_tpu_torch.parallel.mesh import World
        t0 = time.perf_counter()
        with World(pair_mesh(dev)) as pair:
            say("parallel", ranks=2, backend="gloo",
                world_start_seconds=f"{time.perf_counter() - t0:.2f}")
            meshed = phase_mesh(pair, root, data, setup, train_batches, dev,
                                cfg.layers)
            member_par = phase_member_parallel(pair, root, data, setup,
                                               train_batches, dev,
                                               cfg.layers)
            giant = phase_giant(pair, root, data, dev, cfg.layers)
            edge = phase_edge_shard(pair, setup, train_batches, dev,
                                    cfg.layers)
        say("parallel", phases_seconds=f"{time.perf_counter() - t0:.2f}")
        resumed = phase_resume(root, data, cfg.layers, setup, train_batches,
                               dev)
        isolated = phase_isolation(root, data, cfg.layers, setup)
        profiled = phase_profile(root, data, cfg.layers)
        bundled = phase_bundle(root, data, ens, rung_ens, cfg, batches, dev)
        converted = phase_convert(root, data, ens, cfg, dev)
        rung_train = {rung: phase_train_rung(root, data, cfg.layers, rung)
                      for rung in RUNGS}
        span_cfg, span_forwards = phase_span_forward(ens, batches, dev)
        span_serve = phase_serve(root, data,
                                 write_span_ensemble(root, ens, span_cfg),
                                 cfg, batches, dev, members=1,
                                 kernel="attn_eproj_fwd", tag="_span")
        _, span_train = phase_span_train(setup, train_batches, dev)
        for rung in ("eproj", *RUNGS, "span"):
            phase_check(setup, train_batches, dev, rung)
            for dtype in ("float32", "bfloat16"):
                phase_check_captured(setup, train_batches, dev, rung, dtype)
        # the widths beyond the kernels' old limits, depth cut to 2 layers
        for hidden, heads in WIDTHS[:2]:
            phase_check(setup, train_batches, dev, "eproj", hidden=hidden,
                        heads=heads, layers=2)
        phase_check_dropout(setup, train_batches, dev)
        phase_sync(setup, train_batches, dev)
        cases, forward_times = phase_times(flagship, batches, ens, dev,
                                           rung_ens["kv+e"])
        rung_cases = phase_rung_times(rung_flag)
        span_cases = phase_span_times(span_flag)
        bwd_cases, seg_cases, step_times = phase_train_times(
            bwd_flag, seg_flag, setup, train_batches, dev)
        probes = phase_probes(dev, train_batches[0])

    def head(recs):
        return next(c for c in recs
                    if c["conv"] == "lg" and c["dtype"] == "float32")

    def record(name, recs, launches_f32, launches_bf16, path):
        h = head(recs)
        return {"name": name, "route": "cuda",
                "source": f"gnnep_tpu_torch/csrc/{SOURCES.get(name, name)}.cu",
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
    # the f32 runs of the slice's paths: evaluate (test and calib splits of
    # the trained ensemble), custom structures served, KNN-weighted training
    kernels[0]["launches_evaluate"] = evaluated["eproj"]["launches"]["float32"]
    kernels[0]["launches_custom"] = featurized["launches"]["float32"]
    kernels[0]["launches_knn"] = knn["counts"]["attn_eproj_fwd"]
    for rec in kernels[1:3]:
        rec["launches_knn"] = knn["counts"][rec["name"]]
    # the f32 runs of this slice's paths: the resumed member, the member
    # processes (their own counts), the traced first epoch, the bundles and
    # the converted member served
    for rec in kernels[:3]:
        rec["launches_resume"] = resumed["float32"]["counts"][rec["name"]]
        rec["launches_isolation"] = isolated["launches"][rec["name"]]
        rec["launches_profile"] = profiled["launches"][rec["name"]]
    kernels[0]["launches_bundle"] = bundled["eproj_float32"]["launches"]
    kernels[0]["launches_convert"] = converted["launches"]
    # the f32 runs of the parallel/ group's paths: the aligned step (rank
    # 0 of the gloo pair), vmap members, the shard pair's rank 0, the giant
    # trained through cli.train, the S = 2 boundary step's rank 0
    for rec in kernels[:3]:
        name = rec["name"]
        rec["launches_mesh"] = meshed["float32"]["counts"][name]
        rec["launches_vmap"] = member_par["vmap"]["counts"][name]
        rec["launches_shard"] = member_par["shard_pair"]["counts"][name]
        rec["launches_giant"] = giant["train"]["counts"][name]
        rec["launches_boundary"] = giant[
            f"boundary_{SYNTH_GIANT}_float32"]["counts"][name]
    # the edge-sharded path, rank 0 of the pair: the EDGE_STEPS f32 steps
    # with the trainer's dropout, and the windowed eval forward
    kernels[2]["launches_edge_shard"] = \
        edge["s2"]["dropout_counts"]["steps"]["csr_segment_sum"]
    kernels[2]["launches_edge_shard_forward"] = \
        edge["s2"]["counts"]["forward"]["csr_segment_sum"]
    for rung, spec in RUNGS.items():
        fwd = record(spec["fwd"], rung_cases[spec["fwd"]],
                     rung_serve[rung]["float32"],
                     rung_serve[rung]["bfloat16"], f"serve_{rung}")
        fwd["launches_train"] = rung_train[rung]["counts"][spec["fwd"]]
        if rung in evaluated:
            fwd["launches_evaluate"] = \
                evaluated[rung]["launches"]["float32"]
        fwd["launches_bundle"] = bundled[f"{rung}_float32"]["launches"]
        kernels += [fwd, record(spec["bwd"], rung_cases[spec["bwd"]],
                                rung_train[rung]["counts"][spec["bwd"]], None,
                                f"train_{rung}")]
    for name in ("attn_span_fwd", "attn_span_bwd"):
        rec = record(name, span_cases[name],
                     span_train["float32"]["counts"][name],
                     span_train["bfloat16"]["counts"][name], "train_span")
        if name == "attn_span_fwd":
            rec["launches_forward"] = span_forwards
        kernels.append(rec)
    for name, (recs, n, extra) in probes.items():
        kernels.append({**record(name, recs, n, None, "probe"), **extra})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels, "train": {
        d: {"optimizer_steps": r["steps"], "cli_seconds": r["seconds"],
            "replays": r["replays"], "k": TIMING_K,
            **step_times["eproj"][d]["eager"],
            **{f"captured_{k}": v
               for k, v in step_times["eproj"][d]["captured"].items()}}
        for d, r in runs.items()},
        "train_rungs": {
            rung: {"optimizer_steps": r["steps"], "cli_seconds": r["seconds"],
                   "eval_forwards": r["eval_forwards"],
                   "replays": r["replays"],
                   "step_times": step_times[rung]}
            for rung, r in rung_train.items()},
        "forward": forward_times,
        "evaluate": evaluated, "featurize": featurized,
        "knn": {k: v for k, v in knn.items() if k != "counts"},
        "resume": {d: {k: v for k, v in r.items() if k != "counts"}
                   for d, r in resumed.items()},
        "isolation": isolated, "profile": profiled, "bundle": bundled,
        "convert": converted,
        "parallel": {"mesh": {k: {kk: vv for kk, vv in v.items()
                                  if kk != "counts"}
                              for k, v in meshed.items()},
                     "member_parallel": {
                         k: {kk: vv for kk, vv in v.items()
                             if kk != "counts"}
                         for k, v in member_par.items()},
                     "giant": {k: ({kk: vv for kk, vv in v.items()
                                    if kk != "counts"}
                                   if isinstance(v, dict) else v)
                               for k, v in giant.items()},
                     "edge_shard": {k: ({kk: vv for kk, vv in v.items()
                                         if "counts" not in kk}
                                        if isinstance(v, dict) else v)
                                    for k, v in edge.items()}},
        "span": {"edge_span64": span_cfg.edge_span64,
                 "lg_span64": span_cfg.lg_span64,
                 "serve_launches_attn_eproj_fwd": span_serve,
                 "train": {d: {"optimizer_steps": r["steps"],
                               **step_times["span"][d]}
                           for d, r in span_train.items()}}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
