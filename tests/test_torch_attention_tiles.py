"""The launch plan and the schedule of the kv+e attention kernels
(`csrc/attn_fwd.cu`, kernel 3, and `csrc/attn_bwd.cu`, kernel 4; layout in
`csrc/attn_kv.cuh`), checked on the CPU through numpy models of the
kernels' index math and order of operations.

The plan picks its span and layout from the shape alone and its word from
the span and the three base addresses, the heads a warp holds, and its
lanes cover every channel of every row exactly once. The schedule (groups
of G edges inside chunks of 32, the butterfly sums over a head's group of
lanes, the pair lanes' running softmax max and sum merged per group,
inner summed per pair lane and then over the head's pairs, the bf16
rounding points) gives what the plain versions give, on rows of 0 to 100
edges with interior padding, all-masked rows and a dropout scale, at head
widths 8 to 256, with one head to a warp and with several."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from gnnep_tpu_torch.ops.cuda import attention as at  # noqa: E402

# a base address aligned to 256 bytes, as the caching allocator gives
BASE = 0x7F00_0000_0000
WIDTHS = ((16, 2), (256, 4), (192, 2), (512, 4), (256, 1), (384, 2))
ITEM = {"float32": 4, "bfloat16": 2}
F32 = np.float32
CHUNK, NEG = 32, F32(-1e30)


# ----------------------------------------------------------- the plan
def layout(plan, hidden, heads, itemsize):
    """(VEC, spans per head, log2 of the group, heads per slab, spans per
    slab if wide, whether wide) of attn_kv.cuh's `make_layout`."""
    vec = plan.span // itemsize
    wph = hidden // heads // vec
    g = plan.group.bit_length() - 1
    wide = wph > 32
    return vec, wph, g, (0 if wide else 32 >> g), (32 if wide else 0), wide


def lane_channels(plan, hidden, heads, itemsize, h0):
    """`slot_of` and `set_pass` of the kernels for the warp of first head
    `h0` → ([passes, slabs, 32] channel offset of each lane's span in the
    row, -1 where the lane holds none; [slabs, 32] the slot's local head;
    the warp's heads)."""
    vec, wph, g, hps, sw, _ = layout(plan, hidden, heads, itemsize)
    ch = hidden // heads
    nh = min(plan.heads_per_warp, heads - h0)
    lane = np.arange(32)
    hl = np.stack([s * hps + (lane >> g) for s in range(plan.slabs)])
    out = np.full((plan.passes, plan.slabs, 32), -1)
    for p in range(plan.passes):
        for s in range(plan.slabs):
            w = s * sw + (lane & ((1 << g) - 1)) + p * plan.slabs * sw
            out[p, s] = np.where((hl[s] < nh) & (w < wph),
                                 (h0 + hl[s]) * ch + w * vec, -1)
    return out, hl, nh


def widest(item, ok):
    return next((b for b in (16, 8, 4, 2) if b >= item and ok(b)), None)


def slab_heads(head_bytes, heads, span):
    """The heads of one slab of 32 lanes (at most 8), 1 for a head of more
    than 32 spans."""
    group = 1 << max(0, (head_bytes // span - 1).bit_length())
    return min(heads, 8, 32 // group) if group <= 32 else 1


@pytest.mark.parametrize("offset", [0, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden,heads", WIDTHS)
def test_plan_word_layout_and_cover(hidden, heads, dtype, offset):
    """The span (and so the layout) comes from the shape alone: the widest
    of whole elements dividing the head's bytes. A warp holds the heads of
    one slab of 32 lanes (at most 8), a head of more than 32 spans alone;
    a warp of one head takes the widest span that still spreads it over 16
    lanes where it can. The word is the widest of whole elements that
    divides the span and all three bases (q's base `offset` bytes off; an
    f32 tensor 2 bytes off takes none and raises), and changes nothing else
    of the plan. The warps' lanes cover every channel of the row exactly
    once, in whole spans inside one head."""
    item = ITEM[dtype]
    n, e_total = 7552, 74880
    args = (n, e_total, hidden, heads, item, BASE + offset, BASE, BASE)
    head_bytes = hidden // heads * item
    if offset % item:
        with pytest.raises(ValueError, match="take no word"):
            at.attention_plan(*args)
        return
    plan = at.attention_plan(*args)
    aligned = at.attention_plan(n, e_total, hidden, heads, item, BASE, BASE,
                                BASE)
    assert plan == dataclasses.replace(aligned, word=plan.word)
    span = widest(item, lambda b: head_bytes % b == 0)
    hpw = slab_heads(head_bytes, heads, span)
    assert plan.heads_per_warp == hpw
    if hpw == 1:
        span = widest(item, lambda b: head_bytes % b == 0 and (
            head_bytes // b >= 16 or b == item))
    wph = head_bytes // span
    group = 1 << max(0, (wph - 1).bit_length())
    assert (plan.span, plan.group) == (span, min(group, 32))
    assert plan.word == widest(item, lambda b: b <= span and offset % b == 0)
    assert plan.slabs == (2 if wph > 32 else 1)
    assert plan.passes * 32 * plan.slabs >= wph if wph > 32 else (
        plan.passes == 1)
    groups = -(-heads // plan.heads_per_warp)
    assert plan.split == 1 and plan.blocks == -(-n // plan.warps) * groups
    assert 1 <= plan.tail_blocks <= at.SMS
    assert plan.stream == (2 * e_total * hidden * item > at.L2_BYTES)
    assert not at.attention_plan(*args, backward=True).stream
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
    """The flagship (hidden 256, 4 heads) moves 16-byte spans and words;
    in bf16 a warp holds a target's whole row (4 heads of 8-lane groups),
    in f32 half of it (2 heads of 16 lanes), 8 warps a block (4 in the
    backward); at the line graph's 7,552 targets a warp a row and k and v
    streamed past L2, at the atom conv's 768 a row split to reach 3,072
    warps forward and 1,536 backward; the same at any base of the same
    alignment. The heads a warp
    holds can be forced where they fit, and are refused where they do
    not, as is a split row of more than one pass."""
    for item, hpw, group in ((2, 4, 8), (4, 2, 16)):
        lg = at.attention_plan(7552, 74880, 256, 4, item, BASE, BASE, BASE)
        moved = at.attention_plan(7552, 74880, 256, 4, item, BASE + 4096,
                                  BASE + 512, BASE + 256)
        assert lg == moved
        assert (lg.span, lg.word, lg.heads_per_warp, lg.slabs, lg.group,
                lg.warps) == (16, 16, hpw, 1, group, 8)
        atom = at.attention_plan(768, 7552, 256, 4, item, BASE, BASE, BASE)
        back = at.attention_plan(768, 7552, 256, 4, item, BASE, BASE, BASE,
                                 backward=True)
        # 3,072 warps forward, 1,536 backward: bf16 4 and 2 warps a row,
        # f32 (two head groups) 2 and 1
        assert (atom.heads_per_warp, atom.split) == (hpw, hpw)
        assert back.split == hpw // 2
        assert atom.blocks * atom.warps == 3072 and not atom.stream
        assert lg.split == 1 and lg.stream
        lg_back = at.attention_plan(7552, 74880, 256, 4, item, BASE, BASE,
                                    BASE, backward=True)
        assert (lg_back.warps, lg_back.split, lg_back.stream) == (4, 1, False)
        assert lg_back.blocks == -(-7552 // 4) * (4 // hpw)
        one = at.attention_plan(7552, 74880, 256, 4, item, BASE, BASE, BASE,
                                heads_per_warp=1)
        assert (one.heads_per_warp, one.slabs, one.blocks) == (
            1, 1, lg.blocks * hpw)
    four = at.attention_plan(7552, 74880, 256, 4, 4, BASE, BASE, BASE,
                             heads_per_warp=4)
    assert (four.slabs, four.group) == (2, 16)
    with pytest.raises(ValueError, match="cannot hold"):
        at.attention_plan(7552, 74880, 512, 1, 4, BASE, BASE, BASE,
                          heads_per_warp=2)
    with pytest.raises(ValueError, match="cannot hold"):
        at.attention_plan(7552, 74880, 512, 4, 4, BASE, BASE, BASE,
                          heads_per_warp=4)
    with pytest.raises(ValueError, match="cannot share a row"):
        at.attention_plan(48, 500, 1024, 1, 4, BASE, BASE, BASE, split=4)


# ------------------------------------------------------- the schedule
def bf16(x):
    """Round f32 values to bf16 (nearest even) and back."""
    b = np.asarray(x, F32).view(np.uint32).astype(np.uint64)
    b = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16
    return b.astype(np.uint32).view(F32)


def butterfly(x, g):
    """`group_sum` over aligned groups of 2^g lanes of the last axis."""
    n = x.shape[-1]
    lane = np.arange(n)
    for o in (16, 8, 4, 2, 1):
        if o < (1 << g) and o < n:
            x = (x + x[..., lane ^ o]).astype(F32)
    return x


def spans(rows, chans, vec):
    """Each lane's span of each row: rows [m, hidden] → [m, P, S, 32, vec],
    0 where the lane holds none."""
    idx = chans[..., None] + np.arange(vec)
    got = rows[:, np.clip(idx, 0, None)]
    return np.where(chans[..., None] >= 0, got, F32(0)).astype(F32)


def lane_dots(a, b, plan, g, wide, hl, nh):
    """Per edge the dot products of a warp's heads, summed as the kernels
    sum them: over passes, then the span's elements, in the lane; then
    grouped each slab over its head's group, wide the slabs in order and
    the warp. a [P, S, 32, vec] (the target's), b [m, P, S, 32, vec] →
    [m, nh]."""
    m = b.shape[0]
    acc = np.zeros((m, plan.slabs, 32), F32)
    for p in range(plan.passes):
        for i in range(a.shape[-1]):
            acc = (acc + a[p, :, :, i] * b[:, p, :, :, i]).astype(F32)
    if wide:
        d = acc[:, 0]
        for s in range(1, plan.slabs):
            d = (d + acc[:, s]).astype(F32)
        return butterfly(d, 5)[:, :1]
    red = butterfly(acc, g)  # [m, S, 32]
    out = np.zeros((m, nh), F32)
    for s in range(plan.slabs):
        for lane in range(0, 32, 1 << g):
            if hl[s, lane] < nh:
                out[:, hl[s, lane]] = red[:, s, lane]
    return out


def lane_rows(w, x, hl_of):
    """Σ over edges of w[edge, slot's head] · x[edge, slot] per lane, in
    edge order (the kernels' FMA order): w [m, nh], x [m, P, S, 32, vec]
    → [P, S, 32, vec]."""
    acc = np.zeros(x.shape[1:], F32)
    wl = w[:, hl_of]  # [m, P, S, 32]
    for j in range(x.shape[0]):
        acc = (acc + wl[j][..., None] * x[j]).astype(F32)
    return acc


def groups_of(count, slabs, split):
    """Each group of G = EDGES_IN_FLIGHT / S edges of a row, chunk by chunk:
    (the warp of the target's `split` that takes it, its first edge, its
    edges)."""
    g = at.EDGES_IN_FLIGHT // slabs
    return [((u0 // g) % split, c0 + u0,
             np.arange(c0 + u0, min(c0 + u0 + g, c0 + CHUNK, count)))
            for c0 in range(0, count, CHUNK)
            for u0 in range(0, min(CHUNK, count - c0), g)]


def scatter(out_row, chans, vals, vec):
    """Write each lane's span [P, S, 32, vec] into the row."""
    for idx in np.argwhere(chans >= 0):
        c = chans[tuple(idx)]
        out_row[c:c + vec] = vals[tuple(idx)]


def emulate(q, k, v, scale_t, mask2, row_ptr, heads, plan, item, *,
            g=None, mx=None, den=None):
    """Kernel 3 (g None: → out, max, denom) or kernel 4 (→ dq, dk, dv) in
    numpy, warp by warp in the kernels' order. Inputs f32 arrays holding
    values of the input type (`item` bytes); rounding to it where the
    kernels round."""
    rnd = bf16 if item == 2 else (lambda x: np.asarray(x, F32))
    n, hidden = q.shape
    e_total = k.shape[0]
    vec, _, gl, _, _, wide = layout(plan, hidden, heads, item)
    inv = F32(at.inv_sqrt(hidden // heads))
    ge = at.EDGES_IN_FLIGHT // plan.slabs
    lg2 = ge.bit_length() - 1
    bwd = g is not None
    outs = [np.zeros((n, hidden), F32)] + (
        [np.zeros((e_total, hidden), F32) for _ in range(2)] if bwd else [])
    stats = np.zeros((2, n, heads), F32)
    for h0 in range(0, heads, plan.heads_per_warp):
        chans, hl, nh = lane_channels(plan, hidden, heads, item, h0)
        hl_of = np.where(chans >= 0, np.broadcast_to(hl, chans.shape), 0)
        hsel = slice(h0, h0 + nh)
        for t in range(n - 1):  # the dummy row n-1 is never walked
            lo, hi = int(row_ptr[t]), int(row_ptr[t + 1])
            js = np.arange(lo, hi)
            live = mask2[js] > 0
            sc = scale_t[hsel, lo:hi].T.astype(F32)
            qw = spans(q[t:t + 1], chans, vec)[0]
            kw = spans(k[js], chans, vec)
            logit = np.where(live[:, None], lane_dots(
                qw, kw, plan, gl, wide, hl, nh) * inv, 0).astype(F32)
            split = plan.split
            groups = [(w, u0, e[live[e]]) for w, u0, e in groups_of(
                hi - lo, plan.slabs, split)]
            # the edges each warp of the target takes, in row order
            mine = [np.concatenate([np.zeros(0, np.int64)] + [
                e for w2, u0, e in groups_of(hi - lo, plan.slabs, split)
                if w2 == w]) for w in range(split)]
            if not bwd:
                # each warp's pair lanes: the running max and sum of their
                # head, merged per group (the group's max, then the
                # butterfly sum of its G pair lanes); then the warps' pairs
                # merged in the order of the warps
                ms = np.full((split, nh), NEG, F32)
                ds = np.zeros((split, nh), F32)
                for w, u0, e in groups:
                    if not e.size:
                        continue
                    mn = np.maximum(ms[w], logit[e].max(0))
                    lanes = np.zeros((nh, ge), F32)
                    lanes[:, e - u0] = np.exp(logit[e] - mn).T
                    ds[w] = (ds[w] * np.exp(ms[w] - mn)
                             + butterfly(lanes, lg2)[:, 0]).astype(F32)
                    ms[w] = mn
                m, d = ms[0], ds[0]
                if split > 1:
                    m = ms.max(0)
                    d = np.zeros(nh, F32)
                    for w in range(split):
                        d = (d + ds[w] * np.exp(ms[w] - m)).astype(F32)
                d = np.maximum(d, F32(1e-16))
                alpha = np.where(live[:, None], rnd(
                    (np.exp(np.where(live[:, None], logit - m, 0)) / d
                     ).astype(F32) * sc), 0).astype(F32)
                vw = spans(v[js], chans, vec)
                total = None
                for w in range(split):
                    part = lane_rows(alpha[mine[w]], vw[mine[w]], hl_of)
                    total = part if total is None else (total + part).astype(
                        F32)
                scatter(outs[0][t], chans, total, vec)
                stats[0, t, hsel], stats[1, t, hsel] = m, d
                continue
            gw = spans(rnd(g[t:t + 1]), chans, vec)[0]
            vw = spans(v[js], chans, vec)
            u = np.where(live[:, None], lane_dots(
                gw, vw, plan, gl, wide, hl, nh), 0).astype(F32)
            s = np.where(live[:, None], (np.exp(np.where(
                live[:, None], logit - mx[t, hsel], 0)) / den[t, hsel]
            ).astype(F32), 0)
            # each warp's pair lanes add s · scale · u of their edges in
            # row order; the butterfly over the head's G pair lanes; then
            # the warps' shares in the order of the warps
            lanes = np.zeros((split, nh, ge), F32)
            for w, u0, e in groups:
                for j in e:
                    lanes[w, :, j - u0] = (lanes[w, :, j - u0] + (
                        s[j] * sc[j]).astype(F32) * u[j]).astype(F32)
            inner = butterfly(lanes[0], lg2)[:, 0]
            if split > 1:
                inner = np.zeros(nh, F32)
                for w in range(split):
                    inner = (inner + butterfly(lanes[w], lg2)[:, 0]).astype(
                        F32)
            dl = np.where(live[:, None], rnd((s * (sc * u - inner)).astype(
                F32)), 0).astype(F32)
            al = np.where(live[:, None], rnd((s * sc).astype(F32)), 0)
            acc = None
            for w in range(split):
                part = lane_rows(dl[mine[w]], kw[mine[w]], hl_of)
                acc = part if acc is None else (acc + part).astype(F32)
            scatter(outs[0][t], chans, rnd((acc * inv).astype(F32)), vec)
            for j, e in enumerate(js):
                scatter(outs[1][e], chans, rnd(
                    (dl[j][hl_of][..., None] * qw).astype(F32) * inv), vec)
                scatter(outs[2][e], chans, rnd(
                    (al[j][hl_of][..., None] * gw).astype(F32)), vec)
    if not bwd:
        stats[0, n - 1], stats[1, n - 1] = NEG, 1e-16
        return outs[0], stats[0], stats[1]
    return tuple(outs)


@st.composite
def arenas(draw):
    """A dst-sorted arena: targets with 0 to 100 edges (a long one of
    33-100 in most draws), interior padding, an all-masked row, the dummy
    row's tail; a head width of 8 to 256 over 1, 2 or 4 heads; q's base
    0-8 bytes off; 1, 2 or 4 heads to a warp and 1, 2 or 4 warps to a
    row, or the plan's choice; an optional dropout scale."""
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
        drop=draw(st.booleans()), seed=draw(st.integers(0, 999)))


def make_case(arena):
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
    scale = ((rng.random((heads, e_total)) > 0.25) / 0.75 if arena["drop"]
             else np.ones((heads, e_total))).astype(np.float32)

    def t_(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dt)

    c = dict(q=t_((n, hidden)), k=t_((e_total, hidden)),
             v=t_((e_total, hidden)), scale_t=torch.from_numpy(scale),
             mask2=torch.from_numpy(mask),
             row_ptr=torch.from_numpy(np.searchsorted(
                 dst, np.arange(n + 1)).astype(np.int32)),
             dst=torch.from_numpy(dst), heads=heads)
    item = ITEM[arena["dtype"]]
    args = (n, e_total, hidden, heads, item, BASE + arena["offset"], BASE,
            BASE)
    for key, backward in (("plan", False), ("plan_bwd", True)):
        try:
            c[key] = at.attention_plan(*args, heads_per_warp=arena["hpw"],
                                       split=arena["split"],
                                       backward=backward)
        except ValueError:  # a layout these heads cannot take
            c[key] = at.attention_plan(*args, backward=backward)
    return c, item


def np_(t):
    return t.float().numpy()


def close(a, b, tol, what):
    """|a − b| within `tol` of b's largest magnitude, or of 1 (the inputs'
    scale) where b is smaller: a row of one live edge has dl exactly 0 in
    the plain version, while the schedule's logit, summed in another
    order, leaves its s a rounding away from 1."""
    scale = max(np.abs(b).max(), 1.0) if b.size else 1.0
    err = np.abs(a - b).max() if b.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


TOL = {2: 1e-2, 4: 1e-5}


@settings(max_examples=40, deadline=None)
@given(arenas())
def test_forward_schedule_matches_plain(arena):
    """Kernel 3's schedule against `attention_plain` on the real rows: out
    and denom within 1e-5 of the largest magnitude in f32 (1e-2 in bf16);
    max so where a row has a live edge, else exactly −1e30."""
    c, item = make_case(arena)
    args = [np_(c[x]) for x in ("q", "k", "v", "scale_t", "mask2")]
    got = emulate(*args, c["row_ptr"].numpy(), c["heads"], c["plan"], item)
    want = at.attention_plain(c["q"], c["k"], c["v"], c["scale_t"],
                              c["mask2"], c["dst"], heads=c["heads"])
    out, mx, den = (np_(x)[:-1] for x in want)
    close(got[0][:-1], out, TOL[item], "out")
    close(got[2][:-1], den, TOL[item], "denom")
    dead = mx <= 0.5 * NEG
    assert (got[1][:-1][dead] == NEG).all()
    close(got[1][:-1][~dead], mx[~dead], TOL[item], "max")


@settings(max_examples=40, deadline=None)
@given(arenas())
def test_backward_schedule_matches_plain(arena):
    """Kernel 4's schedule against `attention_bwd_plain` from the plain
    forward's stats: dq on the real rows, dk and dv on the live edges
    within 1e-5 of the largest magnitude in f32 (1e-2 in bf16); the dummy
    row's dq and every dead edge's dk and dv rows exact zeros."""
    c, item = make_case(arena)
    n = c["q"].shape[0]
    _, mx, den = at.attention_plain(c["q"], c["k"], c["v"], c["scale_t"],
                                    c["mask2"], c["dst"], heads=c["heads"])
    g = torch.from_numpy(np.random.default_rng(arena["seed"] + 1).normal(
        size=tuple(c["q"].shape)).astype(np.float32))
    want = at.attention_bwd_plain(c["q"], c["k"], c["v"], c["scale_t"],
                                  c["mask2"], c["row_ptr"], c["dst"], g, mx,
                                  den, heads=c["heads"])
    args = [np_(c[x]) for x in ("q", "k", "v", "scale_t", "mask2")]
    got = emulate(*args, c["row_ptr"].numpy(), c["heads"], c["plan_bwd"],
                  item, g=g.numpy(), mx=mx.numpy(), den=den.numpy())
    live = (np_(c["mask2"]) > 0) & (c["dst"].numpy() != n - 1)
    assert not got[0][-1].any()
    close(got[0][:-1], np_(want[0])[:-1], TOL[item], "dq")
    for name, a, b in zip(("dk", "dv"), got[1:], want[1:]):
        assert not a[~live].any(), f"{name} of dead edges must be zero"
        close(a[live], np_(b)[live], TOL[item], name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden,heads", WIDTHS)
def test_schedule_at_width_with_long_row(hidden, heads, dtype):
    """At each of chip_smoke's widths and the flagship's, with one head to
    a warp and with all of them (where a warp can hold them), one warp to
    a row and four, a 70-edge row (three chunks: the scratch path) beside
    short ones, masked edges, an all-masked row, a dropout scale: forward
    and backward schedules against the plain versions."""
    for hpw, split in ((1, 1), (heads, 1), (heads, 4)):
        arena = dict(heads=heads, ch=hidden // heads, dtype=dtype, offset=0,
                     hpw=hpw, split=split, degs=[5, 70, 0, 12], tail=9,
                     pad=0.2, dead=True, drop=True, seed=hidden + heads)
        test_forward_schedule_matches_plain.hypothesis.inner_test(arena)
        test_backward_schedule_matches_plain.hypothesis.inner_test(arena)
