"""The eproj forward kernel (kernel 5) cut short after each of its phases,
timed stage by stage at the line-graph conv's flagship shapes:

    python -m gnnep_tpu_torch.dev.kernel_ladder

Counterpart of `scripts_dev/exp_kernel_ladder.py`, whose Pallas variants
strip the TPU kernel after each of its stages. Here the stages are the CUDA
kernel's own phases (`csrc/attn_eproj_fwd.cuh`, its Stage parameter): `dma`
every load and no math, `eproj` + the projection with k and v formed,
`sddmm` + the logits written, `softmax` + the max, the denominator and α,
`full` + the aggregation over v, which is kernel 5's own instantiation. The
differences between the stages' times attribute kernel 5's time phase by
phase. A stage cut short writes a sum of its work to `out` (so that nvcc
keeps the work); only `full`'s outputs are results, and only `full` has a
plain version (kernel 5's). The ladder has its own launch count and never
runs on the serving or training path.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import event_ms
from ..ops.cuda import build
from ..utils.device import resolve_device
from ..utils.synth import flagship_batch
from ..ops.cuda.attention_eproj import (_KERNEL, _check_inputs, _check_smem,
                                        _lib, attention_eproj_plain,
                                        rows_per_block)

STAGES = ("dma", "eproj", "sddmm", "softmax", "full")

# ladder launches since the last reset
launches = 0


def _ladder_lib() -> ctypes.CDLL:
    lib = _lib(_KERNEL)
    if lib.attn_eproj_ladder.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.attn_eproj_ladder.argtypes = [p] * 13 + [i] * 5 + [
            ctypes.c_float, i, i, i, p]
        lib.attn_eproj_ladder.restype = i
    return lib


def ladder_cuda(q, kv, ea, w_edge, scale_t, mask2, row_ptr, dst, *,
                heads: int, stage: str):
    """Launch kernel 5 cut short after `stage` → (out f32 [N, H], max,
    denom), on kernel 5's inputs (`attention_eproj_cuda`'s). Takes head
    widths 33 to 64 (the flagship's 64) only."""
    global launches
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, not {stage!r}")
    n, hidden, e_total, fe, ch = _check_inputs(
        q, kv, ea, w_edge, scale_t, mask2, row_ptr, dst, heads=heads)
    if not 32 < ch <= 64 or n == 0:
        raise ValueError(f"the ladder takes head widths 33 to 64 and n >= 1, "
                         f"not {ch} and {n}")
    device = q.device
    lib = _ladder_lib()
    _check_smem(lib.attn_eproj_fwd_smem_bytes, fe, ch, device)
    out = torch.empty((n, hidden), dtype=torch.float32, device=device)
    mx = torch.empty((n, heads), dtype=torch.float32, device=device)
    den = torch.empty((n, heads), dtype=torch.float32, device=device)
    logit_s = torch.empty((heads, e_total), dtype=torch.float32,
                          device=device)
    v_s = torch.empty((e_total, hidden), dtype=q.dtype, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.attn_eproj_ladder(
            q.data_ptr(), kv.data_ptr(), ea.data_ptr(), w_edge.data_ptr(),
            scale_t.data_ptr(), mask2.data_ptr(), row_ptr.data_ptr(),
            dst.data_ptr(), out.data_ptr(), mx.data_ptr(), den.data_ptr(),
            logit_s.data_ptr(), v_s.data_ptr(), n, e_total, hidden, fe,
            heads, 1.0 / ch ** 0.5, int(q.dtype == torch.bfloat16),
            rows_per_block(n, e_total, heads, device), STAGES.index(stage),
            stream)
    if rc != 0:
        raise RuntimeError(f"attn_eproj_ladder launch failed with CUDA error "
                           f"{rc}")
    launches += 1
    return out, mx, den


def ladder(q, kv, ea, w_edge, scale_t, mask2, row_ptr, dst, *, heads: int,
           stage: str):
    """`ladder_cuda` on CUDA tensors; on the CPU the plain version, which
    exists for `full` alone (kernel 5's)."""
    if q.device.type != "cpu":
        return ladder_cuda(q, kv, ea, w_edge, scale_t, mask2, row_ptr, dst,
                           heads=heads, stage=stage)
    if stage != "full":
        raise ValueError(f"stage {stage!r} has no plain version: its output "
                         "is a timing aid, not a result")
    return attention_eproj_plain(q, kv, ea, w_edge, scale_t, mask2, dst,
                                 heads=heads)


def lg_case(batch, *, dtype, device, seed: int = 0, hidden: int = 256,
            heads: int = 4) -> Dict[str, object]:
    """Kernel 5's inputs at the line-graph conv of a packed batch, drawn as
    the JAX ladder's `main` draws them: normal q, kv and ea, W_e × 0.05,
    unit scale, the batch's mask and CSR pointers."""
    rng = np.random.default_rng(seed)
    n, e_total = batch.edge_src.shape[0], batch.lg_src.shape[0]

    def t_(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)

    return dict(
        kv=t_(rng.normal(size=(e_total, 2 * hidden))),
        q=t_(rng.normal(size=(n, hidden))),
        ea=t_(rng.normal(size=(e_total, hidden))),
        w_edge=t_(rng.normal(size=(hidden, hidden)) * 0.05),
        scale_t=t_(np.ones((heads, e_total)), torch.float32),
        mask2=t_(batch.lg_mask, torch.float32),
        row_ptr=t_(batch.lg_row_ptr, torch.int32),
        dst=t_(batch.lg_dst, torch.int64), heads=heads)


def case_args(c):
    return (c["q"], c["kv"], c["ea"], c["w_edge"], c["scale_t"], c["mask2"],
            c["row_ptr"], c["dst"])


def blocks(c) -> int:
    """The kernel's grid: target tiles × heads."""
    n, e_total = c["q"].shape[0], c["kv"].shape[0]
    per = rows_per_block(n, e_total, c["heads"], c["q"].device)
    return -(-n // per) * c["heads"]


def time_stages(c, timer: Optional[Callable] = None) -> Dict[str, float]:
    """Device ms per call of each stage on the case `c`, by `timer` (the
    JAX ladder's best of three runs of 30 calls by default)."""
    timer = timer or (lambda fn: event_ms(fn, iters=30, repeats=3))
    return {stage: timer(lambda stage=stage: ladder_cuda(
        *case_args(c), heads=c["heads"], stage=stage)) for stage in STAGES}


def main() -> int:
    device = resolve_device("cuda")
    build.build([_KERNEL])
    batch = flagship_batch()
    for dtype in (torch.bfloat16, torch.float32):
        c = lg_case(batch, dtype=dtype, device=device)
        n_blocks = blocks(c)
        print(f"LG shapes: n={c['q'].shape[0]} E={c['kv'].shape[0]} "
              f"blocks={n_blocks} dtype={str(dtype).split('.')[-1]}")
        for stage, ms in time_stages(c).items():
            print(f"{stage:8s}: {ms:7.3f} ms/call  "
                  f"{ms * 1e3 / n_blocks:6.3f} us/block")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
