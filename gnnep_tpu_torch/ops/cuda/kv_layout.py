"""The launch plan of the kernels laid out by `csrc/attn_kv.cuh`: the kv+e
attention (kernels 3 and 4, `attention.py`) and the external-logits
softmax-aggregate (kernels 1 and 2, `aggregate.py`). Each wrapper sets its
own thresholds (the warps a conv needs before its rows are split, the warps
a block holds, whether its per-edge rows are read with evict-first loads)
and asks `kv_plan` for the rest, which follows from the shape, the element
size and the base addresses' alignment alone (never the data, so a captured
CUDA graph replays the planned launch)."""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

# attn_kv.cuh: warps per block and heads a warp holds, at most; slabs
# (spans a lane holds per pass) at most, and G = EDGES_IN_FLIGHT / slabs
# edges to a group (kEdges)
MAX_WARPS, MAX_HEADS, MAX_SLABS, EDGES_IN_FLIGHT = 8, 8, 2, 4
# the SMs, which a plan fills with at least two blocks each where the
# targets allow, and the L2 bytes (per-edge rows larger than it are read
# with evict-first loads): the card's own (`card_shape`), or an H100's where
# the plan is asked without a card
SMS, L2_BYTES = 132, 50 * 2 ** 20


@functools.lru_cache(maxsize=None)
def card_shape(index: int) -> Tuple[int, int]:
    """(SMs, L2 bytes) of CUDA device `index`."""
    p = torch.cuda.get_device_properties(index)
    return p.multi_processor_count, getattr(p, "L2_cache_size", L2_BYTES)


def shape_of(device: Optional[torch.device]) -> Tuple[int, int]:
    """(SMs, L2 bytes) of CUDA `device`; an H100's for None or the CPU."""
    if device is None or device.type != "cuda":
        return SMS, L2_BYTES
    return card_shape(device.index if device.index is not None
                      else torch.cuda.current_device())


@dataclass(frozen=True)
class AttentionPlan:
    """How a kernel on attn_kv.cuh's layout covers the rows. A lane's slot
    is a span of `span` bytes of a head, moved in words of `word` bytes. A
    warp holds `heads_per_warp` heads of one target (all of them: a warp
    per target), `slabs` spans a lane, each head's spans in an aligned
    group of `group` lanes; a head of more than 32 spans takes a warp alone
    (group 32) and walks it in `passes` of 32 x `slabs` spans. `split`
    warps share a target's row, each taking every split-th group of its
    edges. `warps` per block, `blocks` over the targets and groups of
    heads, and `tail_blocks` more, first in a backward's grid, that zero
    the dummy row's per-edge gradient rows. `stream`: the per-edge rows are
    read with evict-first loads (kernel 2 also writes dv with streaming
    stores)."""
    span: int
    word: int
    heads_per_warp: int
    split: int
    slabs: int
    group: int
    passes: int
    warps: int
    blocks: int
    tail_blocks: int
    stream: bool


@functools.lru_cache(maxsize=512)
def kv_plan(n: int, e_total: int, hidden: int, heads: int, itemsize: int,
            offsets: Tuple[int, ...], heads_per_warp: Optional[int],
            split: Optional[int], split_to: int, max_warps: int,
            stream: bool, sms: int, slabs: int = 1,
            pair_mult: int = 1) -> AttentionPlan:
    """The plan from the shape, the element size and the offsets of the
    bases the kernel moves in words (from 16-byte alignment).

    The span, and with it the layout and the order of every sum, follows
    from the shape alone: the widest of 16, 8, 4 or 2 bytes that holds
    whole elements and divides the head's bytes. A warp holds the heads of
    one slab of 32 lanes (at most 8; at the flagship all 4 in bf16, 2 of
    the 4 in f32), or of `slabs` slabs where the conv still has `split_to`
    warps that way; a head of more than 32 spans takes a warp alone, as does
    the one head of a single-head conv, with the widest span that still
    spreads it over 16 lanes; at most as many heads as windows of
    `pair_mult` groups of edges fit a warp's pair lanes (make_layout's
    check). The word is the widest that divides the span
    and every base, so a misaligned tensor changes only the load
    instructions. A conv of fewer warps than `split_to` splits each row over
    2 or 4 warps (one pass only). A block holds `max_warps` warps, fewer
    where the targets would not give every SM two blocks. `heads_per_warp`
    and `split` force a layout (the checks and the benches run others).
    Raises where no word of whole elements fits, or where a warp cannot
    hold the heads asked for."""
    ch = hidden // heads
    head_bytes = ch * itemsize

    def widest(ok):
        return next((b for b in (16, 8, 4, 2) if b >= itemsize and ok(b)),
                    None)

    def grouped(span, hpw):
        """(slabs, group) of `hpw` heads a warp at this span, or None."""
        wph = head_bytes // span
        group = 1 << max(0, (wph - 1).bit_length())
        if group > 32:
            return (2, 32) if hpw == 1 else None
        slabs = -(-hpw // (32 // group))
        if (hpw > min(heads, MAX_HEADS) or slabs > MAX_SLABS
                or hpw * pair_mult * (EDGES_IN_FLIGHT // slabs) > 32):
            return None
        return slabs, group

    span = widest(lambda b: head_bytes % b == 0)
    hpw = heads_per_warp
    if hpw is None:
        group = 1 << max(0, (head_bytes // span - 1).bit_length())
        hpw = min(heads, MAX_HEADS, 32 // group) if group <= 32 else 1
        while hpw > 1 and not grouped(span, hpw):
            hpw -= 1
        more = min(heads, MAX_HEADS, slabs * 32 // group)
        if (group <= 32 and more > hpw and grouped(span, more)
                and n * -(-heads // more) >= split_to):
            hpw = more
    if hpw == 1:
        span = widest(lambda b: head_bytes % b == 0 and (
            head_bytes // b >= 16 or b == itemsize))
    layout = grouped(span, hpw)
    if layout is None:
        raise ValueError(f"a warp cannot hold {hpw} of {heads} heads of "
                         f"{head_bytes} bytes")
    slabs, group = layout
    passes = -(-(head_bytes // span) // (32 * slabs)) if group == 32 and \
        head_bytes // span > 32 else 1
    word = widest(lambda b: b <= span and not any(o % b for o in offsets))
    if word is None:
        raise ValueError(
            f"heads of {head_bytes} bytes at bases "
            f"{', '.join(map(str, offsets))} bytes past 16-byte alignment "
            f"take no word of whole {itemsize}-byte elements (2 bytes at "
            "least)")
    per = -(-heads // hpw)
    if split is None:
        split = next((w for w in (1, 2) if n * per * w >= split_to), 4)
        split = split if passes == 1 else 1
    if split not in (1, 2, 4) or (split > 1 and passes > 1):
        raise ValueError(f"{split} warps cannot share a row of {passes} "
                         "passes")
    warps = max_warps
    while warps > max(2, split) and -(-n // (warps // split)) * per < 2 * sms:
        warps //= 2
    # blocks zeroing the dummy row's gradient rows, one a quarter MiB of
    # the [E, H] arena (the tail's size is the data's)
    tail = max(1, min(sms, -(-e_total * hidden * itemsize // 2 ** 18)))
    return AttentionPlan(span, word, hpw, split, slabs, group, passes, warps,
                         -(-n // (warps // split)) * per, tail, stream)


def plan_args(plan: AttentionPlan) -> tuple:
    """The plan as the C entry points take it, after the shape and type."""
    return (plan.span, plan.word, plan.slabs, plan.heads_per_warp,
            plan.split, plan.warps)


def offsets(ptrs: Sequence[int]) -> Tuple[int, ...]:
    """Each base address's offset from 16-byte alignment."""
    return tuple(p % 16 for p in ptrs)
