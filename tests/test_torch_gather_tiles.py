"""The launch plans of the row gather (`csrc/row_gather.cu`, kernel 11) and
the CSR segment-sum (`csrc/csr_segment_sum.cu`, kernel 7), checked on the
CPU through Python models of the kernels' index math: each plan covers
every (row, word) exactly once, chooses its word from the shape, the types
and the bases' alignment alone, and the segment-sum's schedule sums in the
order that makes it bitwise the plain version. Then the plain segment-sum's
output type, the kv-gather's gradient against the JAX package's at width
1024, and, on a GPU, both kernels against their plain versions."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from gnnep_tpu.ops.pallas.csr_attention import (  # noqa: E402
    csr_gather_ordered as jax_gather_ordered)
from gnnep_tpu_torch.dev import gather_probe as gp  # noqa: E402
from gnnep_tpu_torch.ops.cuda import segment_sum as ss  # noqa: E402

WIDTHS = (2, 6, 16, 512, 1024)
# a base address aligned to 256 bytes, as the caching allocator gives
BASE = 0x7F00_0000_0000


# --------------------------------------------------- kernel 11's plan
def emulate_gather(tab: np.ndarray, idx: np.ndarray, plan: gp.GatherPlan):
    """`row_gather_kernel`'s index math, every lane of every warp of the
    plan's grid at once: → (out bytes, how often each output word was
    written)."""
    rows, row_bytes = idx.shape[0], tab.shape[1]
    words = row_bytes // plan.word
    warp, lane, i = np.meshgrid(np.arange(plan.blocks * gp.WARPS_PER_BLOCK),
                                np.arange(32), np.arange(4), indexing="ij")
    row = warp // plan.slices
    c = (warp - row * plan.slices) * gp.SLICE_WORDS + lane + 32 * i
    live = (row < rows) & (c < words)
    row, c = row[live], c[live]
    src = tab.reshape(tab.shape[0], words, plan.word)
    out = np.zeros((rows, words, plan.word), np.uint8)
    out[row, c] = src[idx[row], c]
    hits = np.zeros((rows, words), np.int64)
    np.add.at(hits, (row, c), 1)
    return out.reshape(rows, row_bytes), hits


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("dtype", [np.float32, np.int32, "bfloat16"])
@pytest.mark.parametrize("width", WIDTHS)
def test_gather_plan_covers_every_word_once(width, dtype, idx_dtype,
                                            aligned):
    """At 40 rows and at 2,500, the plan's grid writes every word of the
    output once, from row idx[i] of the table; the word is the widest that
    the row's bytes and both bases allow (a base one element off takes the
    element's own size)."""
    item = 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize
    row_bytes = width * item
    rng = np.random.default_rng(width)
    tab = rng.integers(0, 256, (300, row_bytes), dtype=np.uint8)
    for rows in (40, 2500):
        idx = rng.integers(0, 300, rows).astype(idx_dtype)
        tab_ptr = BASE + (0 if aligned else item)
        plan = gp.gather_plan(rows, row_bytes, tab_ptr, BASE)
        widest = max(w for w in (2, 4, 8, 16)
                     if row_bytes % w == 0 and tab_ptr % w == 0)
        assert plan.word == widest
        out, hits = emulate_gather(tab, idx, plan)
        assert (hits == 1).all()
        assert np.array_equal(out, tab[idx])


def test_gather_plan_streams_only_past_l2():
    """The probe's 640 × 512 f32 takes 16-byte words, a warp a row (640
    warps) and cached stores; the span gather's 74,880 rows of 2 KB
    (153 MB) streaming stores; an odd base takes no word at all."""
    probe = gp.gather_plan(640, 2048, BASE, BASE)
    assert (probe.word, probe.slices, probe.blocks, probe.stream) == (
        16, 1, 160, False)
    span = gp.gather_plan(74_880, 2048, BASE, BASE)
    assert (span.word, span.slices, span.stream) == (16, 1, True)
    assert span.blocks * gp.WARPS_PER_BLOCK >= 74_880
    with pytest.raises(ValueError, match="no 2-byte word"):
        gp.gather_plan(8, 64, BASE + 1, BASE)


# --------------------------------------------------- kernel 7's plan
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cover_segsum(n: int, width: int, plan: ss.SegsumPlan) -> np.ndarray:
    """`csr_segment_sum_kernel`'s index math over the plan's grid → how
    often each output element [n, width] is written."""
    words = width // plan.vec
    warp, lane = np.meshgrid(np.arange(plan.blocks * ss.WARPS_PER_BLOCK),
                             np.arange(32), indexing="ij")
    seg = warp // plan.slices
    c = (warp - seg * plan.slices) * 32 + lane
    live = (seg < n) & (c < words)
    seg, c = seg[live], c[live]
    flat = (seg * width + c * plan.vec)[:, None] + np.arange(plan.vec)
    return np.bincount(flat.ravel(), minlength=n * width).reshape(n, width)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("types", [("float32", "float32"),
                                   ("bfloat16", "bfloat16"),
                                   ("bfloat16", "float32")])
@pytest.mark.parametrize("width", WIDTHS)
def test_segsum_plan_covers_every_word_once(width, types, aligned):
    """Every output element written once by one lane's word; 16-byte loads
    (4 f32 or 8 bf16 columns) wherever the width and the bases allow, the
    loads and the stores' chunks aligned to the addresses, narrower words
    for a base one element off."""
    in_dt, out_dt = (DTYPES[t] for t in types)
    item, out_item = in_dt.itemsize, out_dt.itemsize
    values_ptr = BASE + (0 if aligned else item)
    for n in (1, 7, 300, 7552):
        plan = ss.segsum_plan(n, width, in_dt, out_dt, values_ptr, BASE)
        assert (cover_segsum(n, width, plan) == 1).all()
        assert width % plan.vec == 0
        assert values_ptr % (plan.vec * item) == 0
        assert BASE % min(16, plan.vec * out_item) == 0
        widest = 16 // item
        while width % widest:
            widest //= 2
        assert plan.vec == (widest if aligned else 1)


# --------------------------------------------- kernel 7's schedule, bitwise
ROUND, STEP = 32, 8  # csr_segment_sum.cu: indices per round, kRows


def emulate_segsum(values: np.ndarray, order, starts: np.ndarray,
                   plan: ss.SegsumPlan) -> np.ndarray:
    """The kernel's schedule in numpy, f32: for each warp's segment and
    column slice, rounds of 32 order entries, each in steps of 8 rows
    whose loads come before their adds; each lane adds its rows in segment
    order from 0. The last segment ends where it starts (zeros)."""
    n, width = starts.shape[0], values.shape[1]
    out = np.full((n, width), np.nan, np.float32)
    span = 32 * plan.vec
    for warp in range(plan.blocks * ss.WARPS_PER_BLOCK):
        seg, sl = divmod(warp, plan.slices)
        if seg >= n:
            continue
        cols = slice(sl * span, min(width, (sl + 1) * span))
        lo, hi = (int(starts[min(seg + i, n - 1)]) for i in (0, 1))
        acc = np.zeros(cols.stop - cols.start, np.float32)
        for r0 in range(lo, hi, ROUND):
            m = min(hi - r0, ROUND)
            mine = np.arange(r0, r0 + m)
            if order is not None:
                mine = order[mine]
            for s0 in range(0, m, STEP):
                x = [values[row, cols] for row in mine[s0:s0 + STEP]]
                for row in x:
                    acc = acc + row
        out[seg, cols] = acc
    return out


@st.composite
def layouts(draw):
    """Segment lengths (empty ones, a single segment, a 200-row one, or
    none with rows), dead rows before the first segment and the dummy
    segment's tail, a width, and whether the order is permuted."""
    kind = draw(st.sampled_from(["mixed", "single", "long", "all_empty"]))
    if kind == "single":
        lengths = [draw(st.integers(0, 40))]
    elif kind == "all_empty":
        lengths = [0] * draw(st.integers(1, 6))
    else:
        lengths = draw(st.lists(st.integers(0, 20), min_size=1, max_size=9))
        if kind == "long":
            lengths.insert(draw(st.integers(0, len(lengths))), 200)
    return dict(lengths=lengths, head=draw(st.integers(0, 3)),
                tail=draw(st.integers(0, 50)),
                width=draw(st.sampled_from([2, 6, 16, 40])),
                permuted=draw(st.booleans()), seed=draw(st.integers(0, 99)))


@settings(max_examples=40, deadline=None)
@given(layouts())
def test_segsum_schedule_is_bitwise_the_plain_sum(lay):
    """The kernel's order of adds gives bit for bit what the plain version
    gives in f32 (a sequential sum in row order from 0): no reassociation
    anywhere in the schedule. The segments are the real ones plus the
    dummy's, which owns the tail."""
    rng = np.random.default_rng(lay["seed"])
    lengths = lay["lengths"]
    starts = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    starts += lay["head"]
    e_total = int(starts[-1]) + lay["tail"]
    values = rng.normal(size=(e_total, lay["width"])).astype(np.float32)
    order = (rng.permutation(e_total).astype(np.int32) if lay["permuted"]
             else None)
    plan = ss.segsum_plan(starts.shape[0], lay["width"], torch.float32,
                          torch.float32, BASE, BASE)
    want = emulate_segsum(values, order, starts, plan)
    got = ss.csr_segment_sum_plain(
        torch.from_numpy(values),
        None if order is None else torch.from_numpy(order),
        torch.from_numpy(starts)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not got[-1].any()


@pytest.mark.parametrize("permuted", [True, False])
def test_plain_bf16_output_is_the_f32_sum_cast(permuted):
    """A bf16 output is the f32 sum rounded once: the same bits as the f32
    output `.to(bfloat16)`, from bf16 values."""
    rng = np.random.default_rng(5)
    idx = np.sort(rng.integers(0, 40, 600))
    starts = torch.from_numpy(np.searchsorted(idx, np.arange(41))
                              .astype(np.int32))
    values = torch.from_numpy(rng.normal(size=(600, 24))).to(torch.bfloat16)
    order = (torch.from_numpy(rng.permutation(600).astype(np.int32))
             if permuted else None)
    f32 = ss.csr_segment_sum_plain(values, order, starts)
    bf16 = ss.csr_segment_sum_plain(values, order, starts,
                                    out_dtype=torch.bfloat16)
    assert f32.dtype == torch.float32 and bf16.dtype == torch.bfloat16
    assert torch.equal(bf16.view(torch.int16),
                       f32.to(torch.bfloat16).view(torch.int16))
    before = ss.launches
    assert torch.equal(ss.csr_segment_sum(values, order, starts,
                                          torch.bfloat16), bf16)
    assert ss.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_csr_gather_ordered_grads_match_jax_at_width_1024(dtype):
    """`test_csr_gather_ordered_grads_match_jax`'s case at the kv width of
    hidden 512 (2H = 1024), the same tolerances: values 1e-4 / 1e-5 in f32,
    2e-2 in bf16; the gradient in the cotangent's type."""
    rng = np.random.default_rng(1)
    n, h, e_total, e_real = 32, 1024, 256, 100
    x = rng.normal(size=(n, h)).astype(np.float32)
    idx = rng.integers(0, n - 1, e_total).astype(np.int32)
    idx[e_real:] = n - 1
    order = np.argsort(idx, kind="stable").astype(np.int32)
    starts = np.searchsorted(idx[order], np.arange(n)).astype(np.int32)
    w = rng.normal(size=(e_total, h)).astype(np.float32)
    w[e_real:] = 0.0
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = DTYPES[dtype]

    def loss(xx):
        return (jax_gather_ordered(xx, jnp.asarray(idx), jnp.asarray(order),
                                   jnp.asarray(starts), 48, True)
                * jnp.asarray(w).astype(jd)).astype(jnp.float32).sum()

    want = np.asarray(jax.grad(loss)(jnp.asarray(x).astype(jd)), np.float32)
    xt = torch.from_numpy(x).to(td).requires_grad_()
    out = ss.csr_gather_ordered(xt, torch.from_numpy(idx).long(),
                                torch.from_numpy(order),
                                torch.from_numpy(starts))
    (out * torch.from_numpy(w).to(td)).float().sum().backward()
    assert xt.grad.dtype == td
    tol = (dict(rtol=1e-4, atol=1e-5) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    np.testing.assert_allclose(xt.grad.float().numpy()[:-1], want[:-1],
                               **tol)


def test_card_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the kernels' own wrappers raise (only the
    dispatchers take the plain versions there)."""
    values = torch.zeros((8, 4))
    starts = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        ss.csr_segment_sum_cuda(values, None, starts, torch.float32)
    with pytest.raises(ValueError, match="CUDA device"):
        ss.empty_launch_cuda(values, None, starts)
    with pytest.raises(ValueError, match="CUDA device"):
        gp.row_gather_cuda(values, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA device"):
        gp.empty_launch_cuda(values, torch.zeros(3, dtype=torch.int64))


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels have no CPU "
                    "mode (run `python3 chip_smoke.py` or this file on one)")
    from gnnep_tpu_torch.utils.device import resolve_device
    return resolve_device("cuda")


def _layout(kind, rng):
    """(segment ids of the arena's rows, n): a 1,000-row hub among short
    segments; 100 segments (fewer than the card's 132 SMs); a single
    segment (the dummy's alone)."""
    if kind == "hub1000":
        n = 300
        idx = np.concatenate([rng.integers(0, n - 1, 3000),
                              np.full(1000, 17), np.full(200, n - 1)])
    elif kind == "n100":
        n = 100
        idx = np.concatenate([rng.integers(0, n - 1, 900),
                              np.full(60, n - 1)])
    else:
        n = 1
        idx = np.zeros(50, np.int64)
    return rng.permutation(idx), n


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [6, 512, 1024])
@pytest.mark.parametrize("kind", ["hub1000", "n100", "n1"])
def test_segsum_kernel_on_card(cuda, kind, width, dtype):
    """Kernel 7 in f32 out: bitwise the CPU's plain version (a sequential
    sum in row order), and within 1e-5 of the card's plain version, whose
    float atomics add in another order (atol 1e-3 over the 1,000-row
    segment, whose f32 sums reach about 100); deterministic on a rerun;
    its bf16 output bitwise its own f32 output cast; the identity order
    alike; one launch per call."""
    rng = np.random.default_rng(width)
    idx, n = _layout(kind, rng)
    order = np.argsort(idx, kind="stable").astype(np.int32)
    starts = np.searchsorted(idx[order], np.arange(n)).astype(np.int32)
    values = torch.from_numpy(rng.normal(size=(idx.shape[0], width))).to(
        cuda, DTYPES[dtype])
    for o in (torch.from_numpy(order).to(cuda), None):
        args = (values, o, torch.from_numpy(starts).to(cuda))
        before = ss.launches
        got = ss.csr_segment_sum_cuda(*args)
        torch.cuda.synchronize()
        assert ss.launches == before + 1
        cpu = ss.csr_segment_sum_plain(*(None if a is None else a.cpu()
                                         for a in args))
        assert torch.equal(got.cpu(), cpu)
        torch.testing.assert_close(got, ss.csr_segment_sum_plain(*args),
                                   rtol=1e-5,
                                   atol=1e-3 if kind == "hub1000" else 1e-5)
        assert torch.equal(ss.csr_segment_sum_cuda(*args), got)
        if dtype == "bfloat16":
            low = ss.csr_segment_sum_cuda(*args, torch.bfloat16)
            assert low.dtype == torch.bfloat16
            assert torch.equal(low, got.to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segsum_kernel_on_a_misaligned_base(cuda, dtype):
    """Values one element off a 16-byte boundary take one-column loads
    and still sum bitwise as the CPU's plain version."""
    rng = np.random.default_rng(9)
    idx = rng.integers(0, 49, 2000)
    order = np.argsort(idx, kind="stable").astype(np.int32)
    starts = np.searchsorted(idx[order], np.arange(50)).astype(np.int32)
    flat = torch.from_numpy(rng.normal(size=2000 * 512 + 1)).to(
        cuda, DTYPES[dtype])
    values = flat[1:].view(2000, 512)
    assert values.is_contiguous() and values.data_ptr() % 16
    args = (values, torch.from_numpy(order).to(cuda),
            torch.from_numpy(starts).to(cuda))
    got = ss.csr_segment_sum_cuda(*args)
    assert torch.equal(got.cpu(), ss.csr_segment_sum_plain(
        *(a.cpu() for a in args)))


@pytest.mark.gpu
def test_kv_gather_backward_is_one_launch_in_the_cotangent_type(cuda):
    """The bf16 kv gather's backward is the segment-sum kernel alone: its
    gradient comes out bf16, with no separate cast kernel."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 63, 4000)
    idx[-300:] = 63
    order = np.argsort(idx, kind="stable").astype(np.int32)
    starts = np.searchsorted(idx[order], np.arange(64)).astype(np.int32)
    x = torch.from_numpy(rng.normal(size=(64, 512))).to(
        cuda, torch.bfloat16).requires_grad_()
    out = ss.csr_gather_ordered(x, torch.from_numpy(idx).to(cuda),
                                torch.from_numpy(order).to(cuda),
                                torch.from_numpy(starts).to(cuda))
    g = torch.randn_like(out)
    torch.cuda.synchronize()
    before = ss.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        (dx,) = torch.autograd.grad(out, x, g)
        torch.cuda.synchronize()
    assert dx.dtype == torch.bfloat16 and ss.launches == before + 1
    kernels = [e.key for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    assert len(kernels) == 1 and "csr_segment_sum_kernel" in kernels[0], \
        kernels


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32,
                                   torch.bfloat16])
def test_gather_kernel_bitwise_on_card(cuda, dtype):
    """Kernel 11 bitwise tab[idx] on every probe case; on a contiguous
    table one element off a 16-byte boundary (the plan takes the
    element's own word); with int32 and int64 indices; and on 30,000 rows
    (past L2 in f32 and int32: streaming stores)."""
    before = gp.launches
    for rows in gp.PROBE_ROWS:
        assert gp.check_bitwise(gp.probe_case(rows, gp.WIDTH, dtype, cuda))
    flat = torch.arange(300 * 512 + 1, device=cuda).to(dtype)
    tab = flat[1:].view(300, 512)
    assert tab.is_contiguous() and tab.data_ptr() % 16
    for idx_dtype in (torch.int32, torch.int64):
        idx = torch.randint(0, 300, (1000,), device=cuda, dtype=idx_dtype)
        assert torch.equal(gp.row_gather_cuda(tab, idx), tab[idx.long()])
    big = torch.arange(2000 * 512, device=cuda).to(dtype).view(2000, 512)
    idx = torch.randint(0, 2000, (30_000,), device=cuda)
    assert gp.gather_plan(30_000, 512 * big.element_size(), big.data_ptr(),
                          big.data_ptr()).stream == (dtype != torch.bfloat16)
    assert torch.equal(gp.row_gather_cuda(big, idx), big[idx])
    torch.cuda.synchronize()
    assert gp.launches == before + len(gp.PROBE_ROWS) + 3
