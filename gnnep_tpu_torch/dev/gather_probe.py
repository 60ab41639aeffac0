"""A row gather inside one kernel, checked bitwise and timed beside
`torch.index_select`:

    python -m gnnep_tpu_torch.dev.gather_probe

Counterpart of `scripts_dev/exp_gather_probe.py`, which asked whether
Mosaic's in-kernel gather compiles on the TPU. Here the kernel is
`csrc/row_gather.cu`, launched on the plan that `gather_plan` chooses from
the shape and the bases' alignment; the probe runs the JAX probe's cases
(S rows of a [S, 512] table gathered by S random indices, S 256, 640 and
768, in f32, int32 and bf16, each bitwise against `tab[idx]`), times its
bench cases (640 × 512 f32 and bf16) and the gather the span kernels do
inside themselves: the line-graph conv's node-space kv [N, 2H] by its src
[E].
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import event_ms
from ..ops.cuda import build
from ..utils.device import resolve_device
from ..utils.synth import flagship_batch

_KERNEL = "row_gather"
DTYPES = (torch.float32, torch.int32, torch.bfloat16)
PROBE_ROWS, WIDTH = (256, 640, 768), 512

# kernel launches since the last reset
launches = 0

# row_gather.cu's block (kThreads / 32 warps) and a warp's slice of a row
# (32 lanes x kWordsPerLane words)
WARPS_PER_BLOCK, SLICE_WORDS = 4, 128
# the H100's L2: a larger output is written with streaming stores
L2_BYTES = 50 * 2 ** 20


@dataclass(frozen=True)
class GatherPlan:
    """How the kernel covers [rows, row_bytes]: warp w of the grid owns row
    w // slices and its slice w % slices; lane l of it copies words
    128 (w % slices) + l + 32 i, i < 4, of `word` bytes each (words past
    the row's end idle)."""
    word: int
    slices: int
    blocks: int
    stream: bool


def gather_plan(rows: int, row_bytes: int, tab_ptr: int,
                out_ptr: int) -> GatherPlan:
    """The launch plan from the shape and the two base addresses alone:
    the widest word (16, 8, 4 or 2 bytes) that divides the row's bytes and
    both bases' alignment; streaming stores for an output larger than L2.
    Raises where not even a 2-byte word fits."""
    word = 16
    while word > 2 and (row_bytes % word or tab_ptr % word
                        or out_ptr % word):
        word //= 2
    if row_bytes % word or tab_ptr % word or out_ptr % word:
        raise ValueError(f"rows of {row_bytes} bytes at addresses "
                         f"{tab_ptr:#x}, {out_ptr:#x} take no 2-byte word")
    slices = -(-(row_bytes // word) // SLICE_WORDS)
    return GatherPlan(word, slices, -(-(rows * slices) // WARPS_PER_BLOCK),
                      rows * row_bytes > L2_BYTES)


def row_gather_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tab[idx], rows of any type."""
    return tab[idx.long()]


def _lib() -> ctypes.CDLL:
    lib = build.load(_KERNEL)
    if lib.row_gather.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.row_gather.argtypes = [p, p, p] + [i] * 5 + [p]
        lib.row_gather.restype = i
        lib.row_gather_empty.argtypes = [i] * 3 + [p]
        lib.row_gather_empty.restype = i
    return lib


def _prepare(tab: torch.Tensor, idx: torch.Tensor):
    """Raise on anything the kernel does not take → (out, row bytes, plan;
    plan None where there is nothing to copy)."""
    build.check_card_tensors({"tab": tab, "idx": idx})
    row_bytes = tab.element_size() * (tab.shape[1] if tab.dim() == 2 else 0)
    if (tab.dim() != 2 or idx.dim() != 1 or row_bytes % 2
            or idx.dtype not in (torch.int32, torch.int64)
            or idx.shape[0] * -(-row_bytes // 64) >= 2 ** 31):
        raise ValueError(f"the gather takes a 2-D table of even row bytes and "
                         f"1-D int32/int64 indices, not {tuple(tab.shape)} "
                         f"{tab.dtype} and {tuple(idx.shape)} {idx.dtype}")
    out = torch.empty((idx.shape[0], tab.shape[1]), dtype=tab.dtype,
                      device=tab.device)
    if idx.shape[0] == 0 or row_bytes == 0:
        return out, row_bytes, None
    return out, row_bytes, gather_plan(idx.shape[0], row_bytes,
                                       tab.data_ptr(), out.data_ptr())


def row_gather_cuda(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the gather on the current stream → tab[idx] [len(idx), W].
    `idx` int32 or int64, each in [0, len(tab)) (not checked on the card).
    Raises on anything the kernel does not take."""
    global launches
    out, row_bytes, plan = _prepare(tab, idx)
    if plan is None:
        return out
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream(tab.device).cuda_stream
        rc = _lib().row_gather(tab.data_ptr(), idx.data_ptr(),
                               out.data_ptr(), idx.shape[0], row_bytes,
                               plan.word, int(plan.stream),
                               int(idx.dtype == torch.int64), stream)
    if rc != 0:
        raise RuntimeError(f"{_KERNEL} launch failed with CUDA error {rc}")
    launches += 1
    return out


def empty_launch_cuda(tab: torch.Tensor, idx: torch.Tensor) -> None:
    """Launch an empty kernel on the grid and block that `row_gather_cuda`
    would launch for these inputs: the floor of launch latency under a
    chain of its launches (timing only; not counted)."""
    _, row_bytes, plan = _prepare(tab, idx)
    if plan is None:
        return
    with torch.cuda.device(tab.device):
        rc = _lib().row_gather_empty(
            idx.shape[0], row_bytes, plan.word,
            torch.cuda.current_stream(tab.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{_KERNEL} empty launch failed with CUDA error "
                           f"{rc}")


def row_gather(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on the CPU."""
    if tab.device.type == "cpu":
        return row_gather_plain(tab, idx)
    return row_gather_cuda(tab, idx)


def probe_case(rows: int, width: int, dtype: torch.dtype, device,
               seed: int = 0) -> Dict[str, torch.Tensor]:
    """The JAX probe's case: a normal table cast to `dtype` (int32 truncates
    toward zero, as numpy's astype) and `rows` indices into it, int32."""
    rng = np.random.default_rng(seed)
    tab = rng.normal(size=(rows, width))
    idx = rng.integers(0, rows, size=(rows,)).astype(np.int32)
    tab = (torch.from_numpy(tab.astype(np.int32)) if dtype == torch.int32
           else torch.from_numpy(tab.astype(np.float32)).to(dtype))
    return dict(tab=tab.to(device), idx=torch.from_numpy(idx).to(device))


def span_case(batch, *, dtype, device, seed: int = 0,
              hidden: int = 256) -> Dict[str, torch.Tensor]:
    """The span kernels' own gather at the line-graph conv of a packed
    batch: the node-space kv [N, 2H] by src [E] (int64, as the conv
    passes it)."""
    rng = np.random.default_rng(seed)
    kvn = rng.normal(size=(batch.edge_src.shape[0], 2 * hidden))
    return dict(tab=torch.from_numpy(kvn.astype(np.float32)).to(device, dtype),
                idx=torch.from_numpy(np.asarray(batch.lg_src, np.int64)).to(
                    device))


def check_bitwise(c) -> bool:
    """The kernel's gather equals tab[idx] bit for bit."""
    return torch.equal(row_gather_cuda(c["tab"], c["idx"]),
                       row_gather_plain(c["tab"], c["idx"]))


def time_case(c, timer: Optional[Callable] = None) -> Dict[str, float]:
    """Device ms of the kernel, of `torch.index_select` and of an empty
    kernel on the gather's grid and block on one case, by `timer` (the JAX
    probe's mean of 200 calls by default)."""
    timer = timer or (lambda fn: event_ms(fn, iters=200))
    return {"ms": timer(lambda: row_gather_cuda(c["tab"], c["idx"])),
            "library_ms": timer(lambda: torch.index_select(
                c["tab"], 0, c["idx"])),
            "empty_launch_ms": timer(lambda: empty_launch_cuda(c["tab"],
                                                               c["idx"]))}


def main() -> int:
    device = resolve_device("cuda")
    build.build([_KERNEL])
    ok = True
    for dtype in DTYPES:
        for rows in PROBE_ROWS:
            good = check_bitwise(probe_case(rows, WIDTH, dtype, device))
            print(f"S={rows} W={WIDTH} {str(dtype).split('.')[-1]}: "
                  f"{'OK' if good else 'WRONG RESULTS'}")
            ok &= good
    if not ok:
        return 1
    cases: List = [(f"bench S=640 W={WIDTH} {str(dt).split('.')[-1]}",
                    probe_case(640, WIDTH, dt, device))
                   for dt in (torch.float32, torch.bfloat16)]
    batch = flagship_batch()
    cases += [(f"span kvn {dt_name}", span_case(batch, dtype=dt,
                                                device=device))
              for dt, dt_name in ((torch.float32, "float32"),
                                  (torch.bfloat16, "bfloat16"))]
    for name, c in cases:
        t = time_case(c)
        nbytes = c["idx"].shape[0] * c["tab"].shape[1] * c["tab"].element_size()
        print(f"  {name}: {t['ms'] * 1e3:.1f} us/call "
              f"({nbytes / t['ms'] / 1e6:.0f} GB/s out); index_select "
              f"{t['library_ms'] * 1e3:.1f} us; empty launch "
              f"{t['empty_launch_ms'] * 1e3:.1f} us")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
