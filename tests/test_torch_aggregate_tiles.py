"""The launch plan and the schedule of the external-logits softmax-aggregate
kernels (`csrc/softmax_aggregate_fwd.cu`, kernel 1, and
`csrc/softmax_aggregate_bwd.cu`, kernel 2; layout in `csrc/attn_kv.cuh`,
shared with kernels 3 and 4), checked on the CPU through numpy models of
the kernels' index math and order of operations.

The plan picks its span and layout from the shape alone and its word from
the span and v's base address, the heads a warp holds, and its lanes cover
every channel of every row exactly once. The schedule (a chunk's logits
and scales in shared memory, groups of G edges inside chunks of 32, the
pair lanes' running softmax max and sum merged per group, alpha formed
once the row's statistics are known, g·v summed in the lane and then over
the head's group of lanes, inner summed per pair lane and then over the
head's pairs (kernel 1's pair lanes take windows of 2G edges), split rows
merged in the order of the warps, the bf16 rounding points, the clamp at
−0.5e30) gives what the plain versions give,
on rows of 0 to 100 edges with interior padding, all-masked rows, logits
masked for single heads, a dropout scale and the dummy row's tail, with one
head to a warp and with several, and rows split over 1, 2 or 4 warps."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from gnnep_tpu_torch.ops.cuda import aggregate as ag  # noqa: E402
from gnnep_tpu_torch.ops.cuda import kv_layout as kl  # noqa: E402

from test_torch_attention_tiles import (  # noqa: E402
    BASE, CHUNK, F32, ITEM, NEG, TOL, WIDTHS, bf16, butterfly, close,
    groups_of, lane_channels, lane_dots, lane_rows, layout, scatter,
    slab_heads, spans, widest)

LG, ATOM = (7552, 74880), (768, 7552)  # the flagship convs: (N, E)


def plan_of(n, e_total, hidden, heads, item, offset=0, **kw):
    return ag.aggregate_plan(n, e_total, hidden, heads, item, BASE + offset,
                             **kw)


def fwd_heads(head_bytes, heads, span):
    """The heads a kernel 1 warp holds at a conv of many targets: those of
    `FWD_SLABS` slabs where a lane's slots and the pair lanes (windows of
    two groups of edges a head) allow, else as many of one slab's as the
    pair lanes allow."""
    group = 1 << max(0, (head_bytes // span - 1).bit_length())
    if group > 32:
        return 1

    def fits(hpw):
        slabs = -(-hpw // (32 // group))
        return slabs <= 2 and hpw * 2 * (kl.EDGES_IN_FLIGHT // slabs) <= 32

    one = min(heads, 8, 32 // group)
    while one > 1 and not fits(one):
        one -= 1
    more = min(heads, 8, ag.FWD_SLABS * (32 // group))
    return more if more > one and fits(more) else one


# ----------------------------------------------------------- the plan
@pytest.mark.parametrize("offset", [0, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden,heads", WIDTHS)
def test_plan_word_layout_and_cover(hidden, heads, dtype, offset):
    """Forward and backward: the span (and so the layout) comes from the
    shape alone, as kernels 3 and 4's; the word is the widest of whole
    elements that divides the span and v's base (`offset` bytes off; an
    f32 v 2 bytes off takes none and raises) and changes nothing else of
    the plan. Both stream v (kernel 2 also dv) where two copies of it exceed
    L2; kernel 2's first blocks zero the dummy row's tail. The warps' lanes cover
    every channel of the row exactly once, in whole spans inside one
    head."""
    item = ITEM[dtype]
    n, e_total = LG
    head_bytes = hidden // heads * item
    for backward in (False, True):
        args = (n, e_total, hidden, heads, item)
        if offset % item:
            with pytest.raises(ValueError, match="take no word"):
                plan_of(*args, offset, backward=backward)
            continue
        plan = plan_of(*args, offset, backward=backward)
        assert plan == dataclasses.replace(
            plan_of(*args, backward=backward), word=plan.word)
        span = widest(item, lambda b: head_bytes % b == 0)
        hpw = (slab_heads if backward else fwd_heads)(head_bytes, heads, span)
        assert plan.heads_per_warp == hpw
        if hpw == 1:
            span = widest(item, lambda b: head_bytes % b == 0 and (
                head_bytes // b >= 16 or b == item))
        assert plan.span == span
        assert plan.word == widest(item,
                                   lambda b: b <= span and offset % b == 0)
        groups = -(-heads // hpw)
        assert plan.split == 1 and plan.blocks == -(-n // plan.warps) * groups
        assert plan.warps == ag.BLOCK_WARPS["backward" if backward
                                            else "forward"]
        assert 1 <= plan.tail_blocks <= kl.SMS
        assert plan.stream == (2 * e_total * hidden * item > kl.L2_BYTES)
        vec = span // item
        ch = hidden // heads
        hits = np.zeros(hidden, np.int64)
        for h0 in range(0, heads, plan.heads_per_warp):
            chans, _, _ = lane_channels(plan, hidden, heads, item, h0)
            for c in chans[chans >= 0]:
                assert c % vec == 0 and c // ch == (c + vec - 1) // ch
                hits[c:c + vec] += 1
        assert (hits == 1).all()


def test_plan_flagship_and_forced_layouts():
    """The flagship (hidden 256, 4 heads): 16-byte spans and words; in
    bf16 a warp holds a target's whole row (4 heads of 8-lane groups), in
    f32 half of it (2 heads of 16 lanes), except kernel 1's at the line
    graph, which holds all 4 in two slabs; kernel 1's blocks hold 4 warps,
    kernel 2's 8; both stream the line graph's v
    (77 MB f32, 38 MB bf16: two copies exceed L2) and not the atom conv's;
    the atom conv's 768 targets split their rows
    to reach `SPLIT_TO` warps; the same at any base of the same alignment.
    The heads a warp holds and the warps a row can be forced where they
    fit, and are refused where they do not."""
    for item, hpw, group in ((2, 4, 8), (4, 2, 16)):
        for backward in (False, True):
            lg = plan_of(*LG, 256, 4, item, backward=backward)
            assert lg == plan_of(*LG, 256, 4, item, 4096, backward=backward)
            two = item == 4 and not backward
            assert (lg.span, lg.word, lg.heads_per_warp, lg.slabs, lg.group,
                    lg.split, lg.warps) == (16, 16, 4 if two else hpw,
                                            2 if two else 1, group, 1,
                                            8 if backward else 4)
            assert lg.stream
            atom = plan_of(*ATOM, 256, 4, item, backward=backward)
            want = ag.SPLIT_TO["backward" if backward else "forward"]
            warps = 768 * (4 // hpw)
            split = next((w for w in (1, 2) if warps * w >= want), 4)
            assert atom.split == split and not atom.stream
            assert atom.blocks * atom.warps == warps * split
        one = plan_of(*LG, 256, 4, item, heads_per_warp=1)
        own = plan_of(*LG, 256, 4, item)
        assert (one.heads_per_warp, one.slabs) == (1, 1)
        assert one.blocks == own.blocks * own.heads_per_warp
        forced = plan_of(*ATOM, 256, 4, item, split=4, backward=True)
        assert forced.split == 4 and forced.warps % 4 == 0
    with pytest.raises(ValueError, match="cannot hold"):
        plan_of(*LG, 512, 1, 4, heads_per_warp=2)
    with pytest.raises(ValueError, match="cannot share a row"):
        plan_of(48, 500, 1024, 1, 4, split=4)


# ------------------------------------------------------- the schedule
def warp_stats(l, ok, count, slabs, split, nh):
    """Kernel 1's pass 1 for one warp group of heads: each warp's pair
    lanes keep their head's running max and sum, merged per window of 2G
    edges of a chunk (the window's max over the counted pairs of the
    warp's own groups, then the butterfly sum of its 2G pair lanes); then
    the warps' pairs merged in the order of the warps → (max, sum) [nh]
    before the 1e-16 floor."""
    g = kl.EDGES_IN_FLIGHT // slabs
    pg = 2 * g
    ms = np.full((split, nh), NEG, F32)
    ds = np.zeros((split, nh), F32)
    lg2 = pg.bit_length() - 1
    for w in range(split):
        for c0 in range(0, count, CHUNK):
            cnt = min(CHUNK, count - c0)
            for k0 in range(0, cnt, pg):
                us = np.array([u for u in range(k0, min(k0 + pg, cnt))
                               if (u // g) % split == w], np.int64)
                if not us.size:
                    continue
                e = c0 + us
                mn = np.maximum(ms[w], np.where(ok[e], l[e], NEG).max(0))
                lanes = np.zeros((nh, pg), F32)
                lanes[:, us - k0] = np.where(ok[e], np.exp(
                    np.where(ok[e], l[e] - mn, 0).astype(F32)), 0).T
                ds[w] = (ds[w] * np.exp(ms[w] - mn).astype(F32)
                         + butterfly(lanes, lg2)[:, 0]).astype(F32)
                ms[w] = mn
    if split == 1:
        return ms[0], ds[0]
    m = ms.max(0)
    d = np.zeros(nh, F32)
    for w in range(split):
        d = (d + ds[w] * np.exp(ms[w] - m).astype(F32)).astype(F32)
    return m, d


def emulate(logits, scale, v, row_ptr, heads, plan, item, *, g=None,
            mx=None, den=None):
    """Kernel 1 (g None: → out, max, denom) or kernel 2 (→ dl, dv) in
    numpy, warp by warp in the kernels' order. Inputs f32 arrays, v holding
    values of its type (`item` bytes); rounding to it where the kernels
    round. An edge counts only where its logit is above −0.5e30."""
    rnd = bf16 if item == 2 else (lambda x: np.asarray(x, F32))
    n = row_ptr.shape[0] - 1
    e_total, hidden = v.shape
    vec, _, gl, _, _, wide = layout(plan, hidden, heads, item)
    ge = kl.EDGES_IN_FLIGHT // plan.slabs
    lg2 = ge.bit_length() - 1
    bwd = g is not None
    if bwd:
        dl = np.zeros((e_total, heads), F32)
        dv = np.zeros((e_total, hidden), F32)
    else:
        out = np.zeros((n, hidden), F32)
        stats = np.zeros((2, n, heads), F32)
        stats[0, n - 1], stats[1, n - 1] = NEG, 1e-16
    for h0 in range(0, heads, plan.heads_per_warp):
        chans, hl, nh = lane_channels(plan, hidden, heads, item, h0)
        hl_of = np.where(chans >= 0, np.broadcast_to(hl, chans.shape), 0)
        hsel = slice(h0, h0 + nh)
        for t in range(n - 1):  # the dummy row n-1 is never walked
            lo, hi = int(row_ptr[t]), int(row_ptr[t + 1])
            js = np.arange(lo, hi)
            l = logits[lo:hi, hsel].astype(F32)    # [m, nh]
            sc = scale[lo:hi, hsel].astype(F32)
            ok = l > F32(0.5) * NEG
            split = plan.split
            groups = groups_of(hi - lo, plan.slabs, split)
            # the edges each warp of the target takes, in row order
            mine = [np.concatenate([np.zeros(0, np.int64)] + [
                e for w2, _, e in groups if w2 == w]) for w in range(split)]
            vw = spans(v[js], chans, vec)
            if not bwd:
                m, d = warp_stats(l, ok, hi - lo, plan.slabs, split, nh)
                d = np.maximum(d, F32(1e-16))
                alpha = np.where(ok, rnd((np.exp(np.where(
                    ok, l - m, 0).astype(F32)) / d).astype(F32) * sc),
                    0).astype(F32)
                total = None
                for w in range(split):
                    part = lane_rows(alpha[mine[w]], vw[mine[w]], hl_of)
                    total = part if total is None else (total + part).astype(
                        F32)
                scatter(out[t], chans, total, vec)
                stats[0, t, hsel], stats[1, t, hsel] = m, d
                continue
            gw = spans(rnd(g[t:t + 1]), chans, vec)[0]
            u = np.where(ok, lane_dots(gw, vw, plan, gl, wide, hl, nh),
                         0).astype(F32)
            s = np.where(ok, (np.exp(np.where(
                ok, l - mx[t, hsel], 0).astype(F32)) / den[t, hsel]
            ).astype(F32), 0).astype(F32)
            # each warp's pair lanes add s · scale · u of their counted
            # edges in row order; the butterfly over the head's G pair
            # lanes; then the warps' shares in the order of the warps
            lanes = np.zeros((split, nh, ge), F32)
            for w, u0, e in groups:
                for j in e:
                    add = ((s[j] * sc[j]).astype(F32) * u[j]).astype(F32)
                    lanes[w, :, j - u0] = np.where(
                        ok[j], lanes[w, :, j - u0] + add,
                        lanes[w, :, j - u0]).astype(F32)
            inner = np.zeros(nh, F32)
            for w in range(split):
                inner = (inner + butterfly(lanes[w], lg2)[:, 0]).astype(F32)
            dl[lo:hi, hsel] = np.where(ok, (s * (sc * u - inner)).astype(
                F32), 0)
            al = np.where(ok, rnd((s * sc).astype(F32)), 0).astype(F32)
            for j, e in enumerate(js):
                scatter(dv[e], chans, rnd(
                    (al[j][hl_of][..., None] * gw).astype(F32)), vec)
    if bwd:
        return dl, rnd(dv)
    return out, stats[0], stats[1]


@st.composite
def arenas(draw):
    """A dst-sorted arena: targets with 0 to 30 edges and, in most draws, a
    long one of 33-100 (two to four chunks), interior padding, an
    all-masked row, logits masked for single heads, the dummy row's tail;
    a head width of 8 to 256 over 1, 2 or 4 heads; v's base 0-8 bytes
    off; 1, 2 or 4 heads to a warp and 1, 2 or 4 warps to a row, or the
    plan's choice; an optional dropout scale."""
    heads = draw(st.sampled_from([1, 2, 4]))
    ch = draw(st.sampled_from([8, 16, 24, 64, 96, 128, 256]))
    dtype = draw(st.sampled_from(["float32", "bfloat16"]))
    offs = [0, 4, 8] if dtype == "float32" else [0, 2, 4, 8]
    degs = draw(st.lists(st.integers(0, 30), min_size=1, max_size=5))
    if draw(st.booleans()):
        degs.insert(draw(st.integers(0, len(degs))),
                    draw(st.integers(33, 100)))
    return dict(heads=heads, ch=ch, dtype=dtype, offset=draw(
        st.sampled_from(offs)), hpw=draw(st.sampled_from([None, 1, 2, 4])),
        split=draw(st.sampled_from([None, 1, 2, 4])),
        degs=degs, tail=draw(st.integers(0, 20)),
        pad=draw(st.sampled_from([0.0, 0.2])), dead=draw(st.booleans()),
        head_mask=draw(st.booleans()), drop=draw(st.booleans()),
        seed=draw(st.integers(0, 999)))


def make_case(arena):
    """Tensors of the kernels' argument layout (logits −1e30 where masked,
    as the conv writes them) and the plans of both kernels."""
    rng = np.random.default_rng(arena["seed"])
    heads, dt = arena["heads"], getattr(torch, arena["dtype"])
    hidden = heads * arena["ch"]
    degs = arena["degs"] + [0]  # the dummy row n-1 owns the tail
    n = len(degs)
    dst = np.repeat(np.arange(n), degs)
    e_real = dst.size
    dst = np.concatenate([dst, np.full(arena["tail"], n - 1)])
    e_total = dst.size
    mask = (np.arange(e_total) < e_real).astype(np.float32)
    mask[:e_real] *= rng.random(e_real) >= arena["pad"]
    if arena["dead"]:
        mask[dst == 0] = 0.0
    keep = np.broadcast_to(mask > 0, (heads, e_total))
    if arena["head_mask"]:
        keep = keep & (rng.random((heads, e_total)) >= 0.2)
    logits = np.where(keep, rng.normal(size=(heads, e_total)) * 2.0,
                      NEG).astype(np.float32)
    scale = ((rng.random((heads, e_total)) > 0.25) / 0.75 if arena["drop"]
             else np.ones((heads, e_total))).astype(np.float32)
    c = dict(logits=torch.from_numpy(logits.T.copy()),
             scale=torch.from_numpy(scale.T.copy()),
             v=torch.from_numpy(rng.normal(size=(e_total, hidden)).astype(
                 np.float32)).to(dt),
             row_ptr=torch.from_numpy(np.searchsorted(
                 dst, np.arange(n + 1)).astype(np.int32)),
             dst=torch.from_numpy(dst), heads=heads,
             live=torch.from_numpy(keep.T & (dst != n - 1)[:, None]))
    item = ITEM[arena["dtype"]]
    args = (n, e_total, hidden, heads, item, BASE + arena["offset"])
    for key, backward in (("plan", False), ("plan_bwd", True)):
        try:
            c[key] = ag.aggregate_plan(*args, heads_per_warp=arena["hpw"],
                                       split=arena["split"],
                                       backward=backward)
        except ValueError:  # a layout these heads cannot take
            c[key] = ag.aggregate_plan(*args, backward=backward)
    return c, item


def np_(t):
    return t.float().numpy()


def fwd_args(c):
    return c["logits"], c["scale"], c["v"], c["row_ptr"]


@settings(max_examples=40, deadline=None)
@given(arenas())
def test_forward_schedule_matches_plain(arena):
    """Kernel 1's schedule against `aggregate_plain` on the real rows: out
    and denom within 1e-5 of the largest magnitude in f32 (1e-2 in bf16);
    max so where a row has a counted edge, else exactly −1e30 (and its out
    exactly 0, denom 1e-16)."""
    c, item = make_case(arena)
    got = emulate(*(np_(x) for x in fwd_args(c)[:3]), c["row_ptr"].numpy(),
                  c["heads"], c["plan"], item)
    want = ag.aggregate_plain(*fwd_args(c), c["dst"], heads=c["heads"])
    out, mx, den = (np_(x)[:-1] for x in want)
    close(got[0][:-1], out, TOL[item], "out")
    close(got[2][:-1], den, TOL[item], "denom")
    dead = mx <= 0.5 * NEG
    assert (got[1][:-1][dead] == NEG).all()
    assert (got[2][:-1][dead] == F32(1e-16)).all()
    close(got[1][:-1][~dead], mx[~dead], TOL[item], "max")


@settings(max_examples=40, deadline=None)
@given(arenas())
def test_backward_schedule_matches_plain(arena):
    """Kernel 2's schedule against `aggregate_bwd_plain` from the plain
    forward's stats: dl and dv on the counted pairs within 1e-5 of the
    largest magnitude in f32 (1e-2 in bf16); every pair that does not
    count (masked for its head, or the dummy row's) exact zeros."""
    c, item = make_case(arena)
    heads = c["heads"]
    n = c["row_ptr"].shape[0] - 1
    _, mx, den = ag.aggregate_plain(*fwd_args(c), c["dst"], heads=heads)
    g = torch.from_numpy(np.random.default_rng(arena["seed"] + 1).normal(
        size=(n, c["v"].shape[1])).astype(np.float32))
    want = ag.aggregate_bwd_plain(*fwd_args(c), c["dst"], g, mx, den,
                                  heads=heads)
    got = emulate(*(np_(x) for x in fwd_args(c)[:3]), c["row_ptr"].numpy(),
                  heads, c["plan_bwd"], item, g=g.numpy(), mx=mx.numpy(),
                  den=den.numpy())
    live = c["live"].numpy()                      # [E, heads]
    ch = c["v"].shape[1] // heads
    live_c = np.repeat(live, ch, axis=1)          # [E, H]
    dl, dv = got
    assert not dl[~live].any() and not dv[~live_c].any()
    close(dl[live], np_(want[0])[live], TOL[item], "dl")
    close(dv[live_c], np_(want[1])[live_c], TOL[item], "dv")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden,heads", WIDTHS)
def test_schedule_at_width_with_long_row(hidden, heads, dtype):
    """At each of chip_smoke's widths and the flagship's, with one head to
    a warp and with all of them (where a warp can hold them), one warp to
    a row and four, a 70-edge row (three chunks: the forward reloads its
    logits, the backward keeps u in dl) beside short ones, masked edges,
    logits masked for single heads, an all-masked row, a dropout scale:
    forward and backward schedules against the plain versions."""
    for hpw, split in ((1, 1), (heads, 1), (heads, 4)):
        arena = dict(heads=heads, ch=hidden // heads, dtype=dtype, offset=0,
                     hpw=hpw, split=split, degs=[5, 70, 0, 12], tail=9,
                     pad=0.2, dead=True, head_mask=True, drop=True,
                     seed=hidden + heads)
        test_forward_schedule_matches_plain.hypothesis.inner_test(arena)
        test_backward_schedule_matches_plain.hypothesis.inner_test(arena)


def test_wrappers_need_no_scratch_and_count_launches():
    """The CPU takes the plain versions and counts no launch; the kernels'
    C entry points take no [heads, E] scratch (kernel 2 keeps a long row's
    u in dl), so a call allocates only its outputs; the JAX layout's
    wrapper takes [heads, E] logits and gives their gradient back so."""
    import inspect
    c, _ = make_case(dict(heads=2, ch=8, dtype="float32", offset=0,
                          hpw=None, split=None, degs=[3, 40], tail=2,
                          pad=0.0, dead=False, head_mask=False, drop=True,
                          seed=1))
    before = (ag.launches, ag.bwd_launches)
    logits_t = c["logits"].t().contiguous().requires_grad_()
    out = ag.fused_aggregate_t(logits_t, c["v"], c["row_ptr"],
                               dst=c["dst"], heads=2,
                               scale_t=c["scale"].t().contiguous())
    out.sum().backward()
    assert logits_t.grad.shape == logits_t.shape
    assert out.shape == (3, 16)
    assert (ag.launches, ag.bwd_launches) == before
    src = inspect.getsource(ag.aggregate_bwd_cuda)
    assert "s_s" not in src and "u_s" not in src
