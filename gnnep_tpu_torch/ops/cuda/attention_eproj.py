"""CSR attention with the edge projection fused in: the CUDA kernel
`csrc/attn_eproj_fwd.cu`, its ctypes wrapper, its plain PyTorch version and
its launch count.

Counterpart of `fused_attention_eproj` in
`gnnep_tpu/ops/pallas/csr_attention.py` (TPU kernel `_attn_ep_kernel`):

    out_n = Σ_{e→n} softmax_e(q_n·(kv0_e + ea_e·W)/√c) · scale_e · (kv1_e + ea_e·W)

per head over the CSR segments of a dst-sorted edge arena. A tensor on the
CPU takes the plain version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..segment import segment_max, segment_sum
from . import build

_NEG = -1e30
_KERNEL = "attn_eproj_fwd"

# kernel launches since the last reset; the chip smoke run sets it to 0 just
# before it drives the serving path and reads it just after
launches = 0


def attention_eproj_plain(q: torch.Tensor, kv: torch.Tensor, ea: torch.Tensor,
                          w_edge: torch.Tensor, scale_t: torch.Tensor,
                          mask2: torch.Tensor, dst: torch.Tensor, *, heads: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version → (out f32 [N, H], max [N, heads], denom
    [N, heads]), rounding where the TPU kernel rounds: e to the input type
    before the k/v adds, α to v's type before the aggregation, all sums f32."""
    n = q.shape[0]
    e_total, hidden = kv.shape[0], kv.shape[1] // 2
    ch = hidden // heads
    e = (ea.float() @ w_edge.float()).to(kv.dtype)
    k = kv[:, :hidden] + e
    v = kv[:, hidden:] + e
    logits = (q.float().index_select(0, dst) * k.float()).reshape(
        e_total, heads, ch).sum(-1) * (1.0 / ch ** 0.5)          # [E, heads]
    live = (mask2 > 0)[:, None]
    mat = torch.where(live, logits, torch.full_like(logits, _NEG))
    mx = segment_max(mat, dst, n).clamp_min(_NEG)
    ex = torch.where(live, torch.exp(mat - mx.index_select(0, dst)),
                     torch.zeros_like(mat))
    den = segment_sum(ex, dst, n).clamp_min(1e-16)
    alpha = (ex / den.index_select(0, dst)) * scale_t.t()
    alpha = alpha.to(v.dtype).float()
    msg = alpha[:, :, None] * v.float().reshape(e_total, heads, ch)
    return segment_sum(msg.reshape(e_total, hidden), dst, n), mx, den


def _lib() -> ctypes.CDLL:
    lib = build.load(_KERNEL)
    fn = lib.attn_eproj_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 13 + [i] * 5 + [ctypes.c_float, i, i, p]
        fn.restype = i
        lib.attn_eproj_fwd_smem_bytes.argtypes = [i, i]
        lib.attn_eproj_fwd_smem_bytes.restype = ctypes.c_size_t
    return lib


def rows_per_block(n: int, e_total: int, heads: int,
                   device: torch.device) -> int:
    """Targets per block: about 256 edges (four projection chunks) per
    block, but no fewer than two blocks per SM across the (rows, heads)
    grid."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    by_edges = -(-256 * n // max(e_total, 1))
    by_grid = -(-n * heads // (2 * sms))
    return int(max(1, min(by_edges, by_grid)))


def attention_eproj_cuda(q: torch.Tensor, kv: torch.Tensor, ea: torch.Tensor,
                         w_edge: torch.Tensor, scale_t: torch.Tensor,
                         mask2: torch.Tensor, row_ptr: torch.Tensor,
                         dst: torch.Tensor, *, heads: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream → (out, max, denom) as
    `attention_eproj_plain`. Raises on anything the kernel does not take."""
    global launches
    n, hidden = q.shape[0], q.shape[1] if q.dim() == 2 else -1
    e_total = kv.shape[0]
    fe = ea.shape[1] if ea.dim() == 2 else -1
    device = q.device
    tensors = dict(q=q, kv=kv, ea=ea, w_edge=w_edge, scale_t=scale_t,
                   mask2=mask2, row_ptr=row_ptr, dst=dst)
    for name, t in tensors.items():
        if t.device != device or device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; every input must be "
                             f"on the one CUDA device of q ({device})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, not {q.dtype}")
    for name in ("kv", "ea", "w_edge"):
        if tensors[name].dtype != q.dtype:
            raise TypeError(f"{name} is {tensors[name].dtype}; q, kv, ea and "
                            f"w_edge must share one type ({q.dtype})")
    if scale_t.dtype != torch.float32 or mask2.dtype != torch.float32:
        raise TypeError("scale_t and mask2 must be float32")
    if row_ptr.dtype != torch.int32 or dst.dtype != torch.int64:
        raise TypeError(f"row_ptr must be int32 and dst int64, not "
                        f"{row_ptr.dtype} and {dst.dtype}")
    ch = hidden // heads if heads > 0 else 0
    if (q.dim() != 2 or heads <= 0 or hidden % heads or ch > 128
            or tuple(kv.shape) != (e_total, 2 * hidden)
            or ea.dim() != 2 or ea.shape[0] != e_total
            or tuple(w_edge.shape) != (fe, hidden)
            or tuple(scale_t.shape) != (heads, e_total)
            or tuple(mask2.shape) != (e_total,)
            or tuple(dst.shape) != (e_total,)
            or tuple(row_ptr.shape) != (n + 1,) or e_total >= 2 ** 31):
        raise ValueError(
            f"shapes the kernel does not take: q {tuple(q.shape)}, kv "
            f"{tuple(kv.shape)}, ea {tuple(ea.shape)}, w_edge "
            f"{tuple(w_edge.shape)}, scale_t {tuple(scale_t.shape)}, mask2 "
            f"{tuple(mask2.shape)}, row_ptr {tuple(row_ptr.shape)}, dst "
            f"{tuple(dst.shape)}, heads {heads} (needs hidden % heads == 0 "
            "and a head width <= 128)")
    lib = _lib()
    props = torch.cuda.get_device_properties(device)
    smem_cap = getattr(props, "shared_memory_per_block_optin", 232448)
    smem = lib.attn_eproj_fwd_smem_bytes(fe, ch)
    if smem > smem_cap:
        raise ValueError(f"Fe={fe}, head width {ch} need {smem} bytes of "
                         f"shared memory per block; the card allows "
                         f"{smem_cap}")
    out = torch.empty((n, hidden), dtype=torch.float32, device=device)
    mx = torch.empty((n, heads), dtype=torch.float32, device=device)
    den = torch.empty((n, heads), dtype=torch.float32, device=device)
    if n == 0:
        return out, mx, den
    # the kernel's per-edge logits and v, written and read back by the block
    # that owns the edge
    logit_s = torch.empty((heads, e_total), dtype=torch.float32,
                          device=device)
    v_s = torch.empty((e_total, hidden), dtype=q.dtype, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.attn_eproj_fwd(
            q.data_ptr(), kv.data_ptr(), ea.data_ptr(), w_edge.data_ptr(),
            scale_t.data_ptr(), mask2.data_ptr(), row_ptr.data_ptr(),
            dst.data_ptr(), out.data_ptr(), mx.data_ptr(), den.data_ptr(),
            logit_s.data_ptr(), v_s.data_ptr(),
            n, e_total, hidden, fe, heads, 1.0 / ch ** 0.5,
            int(q.dtype == torch.bfloat16),
            rows_per_block(n, e_total, heads, device), stream)
    if rc != 0:
        raise RuntimeError(f"{_KERNEL} launch failed with CUDA error {rc}")
    launches += 1
    return out, mx, den


def fused_attention_eproj(q: torch.Tensor, kv: torch.Tensor, ea: torch.Tensor,
                          w_edge: torch.Tensor, row_ptr: torch.Tensor,
                          dst: torch.Tensor, *, heads: int,
                          scale_t: Optional[torch.Tensor] = None,
                          mask_e: Optional[torch.Tensor] = None,
                          return_stats: bool = False):
    """Fused CSR attention, JAX argument layout: `kv` [E, 2H] is the gathered
    (k‖v)[src] arena, `ea` [E, Fe] the raw per-edge features, `w_edge`
    [Fe, H] the conv's bias-free edge projection, `row_ptr` [N+1] the CSR
    pointers of the sorted `dst` [E]. `scale_t` [heads, E] multiplies α after
    normalisation (dropout; default ones); `mask_e` [E] excludes edges
    (default none). Returns out f32 [N, H], plus (max, denom) [N, heads] with
    `return_stats`. The dummy row's (n−1) output is unspecified."""
    e_total = kv.shape[0]
    if scale_t is None:
        scale_t = torch.ones((heads, e_total), dtype=torch.float32,
                             device=kv.device)
    mask2 = (torch.ones(e_total, dtype=torch.float32, device=kv.device)
             if mask_e is None
             else mask_e.to(torch.float32).reshape(e_total).contiguous())
    if q.device.type == "cpu":
        res = attention_eproj_plain(q, kv, ea, w_edge, scale_t, mask2, dst,
                                    heads=heads)
    else:
        res = attention_eproj_cuda(q, kv, ea, w_edge, scale_t, mask2,
                                   row_ptr, dst, heads=heads)
    return res if return_stats else res[0]
