"""The port's external-logits softmax-aggregate (plain versions of
`csrc/softmax_aggregate_fwd.cu` and `csrc/softmax_aggregate_bwd.cu`) against
the JAX package's `fused_aggregate_t` (Pallas kernels `_kernel` /
`_bwd_kernel` in interpret mode, forward and `jax.grad`), the port's
`csr_gather` (whose backward is the segment-sum over the identity order)
against the JAX package's, and, on a GPU, the CUDA kernels against their
plain versions."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from gnnep_tpu.ops.pallas import csr_attention as jmod  # noqa: E402
from gnnep_tpu_torch.ops.cuda import aggregate as ag  # noqa: E402
from gnnep_tpu_torch.ops.cuda import segment_sum as ss  # noqa: E402

from test_torch_eproj import _case as _eproj_case  # noqa: E402

NEG = -1e30


def _case(rng, **kw):
    """The serving hazards of `test_torch_eproj._case` (masked interior
    padding rows, an all-masked row 3, an empty row 5, a dropout scale),
    with [heads, E] logits written as −1e30 where the mask is 0, as the
    conv writes them, and per-edge values v."""
    c = _eproj_case(rng, **kw)
    hidden = c["q"].shape[1]
    logits = rng.normal(size=(c["heads"], c["dst"].shape[0])) * 2.0
    c["logits"] = np.where(c["mask"][None, :] > 0, logits,
                           NEG).astype(np.float32)
    c["v"] = c["kv"][:, :hidden].copy()
    return c


def _t(c, key, dtype, device="cpu"):
    return torch.from_numpy(c[key]).to(device, dtype)


def _jax_forward(c, dtype):
    """(out, max, denom) of the Pallas kernel, interpret mode."""
    heads, block_n, max_deg = c["heads"], 8, 8
    logits, v = jnp.asarray(c["logits"]), jnp.asarray(c["v"]).astype(dtype)
    out = jmod.fused_aggregate_t(
        logits, v, jnp.asarray(c["row_ptr"]), dst=jnp.asarray(c["dst"]),
        heads=heads, max_in_degree=max_deg, block_n=block_n, interpret=True,
        scale_t=jnp.asarray(c["scale"]))
    cap = jmod._win_cap(block_n, max_deg, v.shape[0])
    _, stats = jmod._pallas_forward_t(
        logits, jnp.asarray(c["scale"]), v, jnp.asarray(c["row_ptr"]),
        heads=heads, block_n=block_n, cap=cap, interpret=True)
    stats = np.asarray(stats)
    return np.asarray(out), stats[:, :heads], stats[:, 128:128 + heads]


def _port_forward(c, dtype, device="cpu"):
    return ag.fused_aggregate_t(
        _t(c, "logits", torch.float32, device), _t(c, "v", dtype, device),
        _t(c, "row_ptr", torch.int32, device),
        dst=_t(c, "dst", torch.int64, device), heads=c["heads"],
        scale_t=_t(c, "scale", torch.float32, device), return_stats=True)


# f32 at the Pallas kernel tests' tolerance (test_pallas_kernel.py:58-59);
# bf16 at 1e-4: both sides round α to bf16 at the same point from the same
# f32 logits (largest difference measured over eight such cases: 4.8e-7)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-4)])
@pytest.mark.parametrize("heads,hidden", [(2, 16), (4, 32)])
def test_plain_matches_pallas_aggregate(dtype, tol, heads, hidden):
    c = _case(np.random.default_rng(7), heads=heads, hidden=hidden)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = _jax_forward(c, jd)
    got = _port_forward(c, td)
    for name, a, b in zip(("out", "max", "denom"), got, want):
        assert a.dtype == torch.float32, name
        # the dummy row n-1 owns the tail padding: unspecified, not compared
        np.testing.assert_allclose(a.numpy()[:-1], np.asarray(b)[:-1],
                                   rtol=tol, atol=tol, err_msg=name)
    # the clamp: the all-masked row 3 (logits −1e30, max −1e30) and the
    # empty row 5 give out 0 and denom 1e-16, not exp(0) = 1 per edge
    for row in (3, 5):
        assert not got[0][row].any()
        assert (got[1][row] == NEG).all() and (got[2][row] == 1e-16).all()


def _cotangent(c, seed=3):
    return np.random.default_rng(seed).normal(
        size=(c["q"].shape[0], c["v"].shape[1])).astype(np.float32)


def _jax_grads(c, g):
    def loss(logits, v):
        out = jmod.fused_aggregate_t(
            logits, v, jnp.asarray(c["row_ptr"]), dst=jnp.asarray(c["dst"]),
            heads=c["heads"], max_in_degree=8, block_n=8, interpret=True,
            scale_t=jnp.asarray(c["scale"]))
        return (out * jnp.asarray(g)).sum()

    return [np.asarray(x, np.float32) for x in jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(c["logits"]), jnp.asarray(c["v"]))]


def _port_grads(c, g, device="cpu"):
    leaves = [_t(c, "logits", torch.float32, device).requires_grad_(),
              _t(c, "v", torch.float32, device).requires_grad_()]
    out = ag.fused_aggregate_t(
        *leaves, _t(c, "row_ptr", torch.int32, device),
        dst=_t(c, "dst", torch.int64, device), heads=c["heads"],
        scale_t=_t(c, "scale", torch.float32, device))
    (out * torch.from_numpy(g).to(device)).sum().backward()
    return [t.grad for t in leaves]


def _compare(got, want, c):
    """dl_t and dv on the live edges; the rows of edges that do not count
    (masked, or the dummy row's) must be exact zeros."""
    n = c["q"].shape[0]
    live = (c["mask"] > 0) & (c["dst"] != n - 1)
    dl, dv = (t.float().cpu().numpy() for t in got)
    assert not dl[:, ~live].any() and not dv[~live].any()
    yield "dl_t", dl[:, live], want[0][:, live]
    yield "dv", dv[live], want[1][live]


@pytest.mark.parametrize("heads,hidden", [(2, 16), (4, 32)])
def test_plain_bwd_matches_pallas(heads, hidden):
    """f32 at the Pallas aggregate gradient tests' tolerance
    (test_pallas_kernel.py:100-102, 132-134)."""
    c = _case(np.random.default_rng(7), heads=heads, hidden=hidden)
    g = _cotangent(c)
    want = _jax_grads(c, g)
    for name, a, b in _compare(_port_grads(c, g), want, c):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)


def test_all_masked_rows_give_zero_out_and_grads():
    """Every logit −1e30: without the clamp each masked edge would weigh
    exp(0) = 1; with it, out and both gradients are exact zeros."""
    c = _case(np.random.default_rng(4))
    c["logits"][:] = NEG
    out = _port_forward(c, torch.float32)[0]
    assert not out.any()
    for t in _port_grads(c, _cotangent(c)):
        assert torch.isfinite(t).all() and not t.any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_csr_gather_grads_match_jax(dtype):
    """`x[dst]` whose backward sums each CSR segment of the cotangent over
    the identity order (`test_csr_gather_grads`, test_pallas_kernel.py:
    553-568): grads at 1e-4 / 1e-5 in f32, cast to the cotangent's type as
    `_csr_gather_bwd` does. The dummy row's segment is unspecified."""
    c = _case(np.random.default_rng(2), heads=2, hidden=16)
    n = c["q"].shape[0]
    w = np.random.default_rng(5).normal(size=(c["dst"].shape[0], 16))
    w[c["dst"] == n - 1] = 0.0               # the tail's cotangent is zero
    w = w.astype(np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16

    def loss(x):
        return (jmod.csr_gather(x, jnp.asarray(c["dst"]),
                                jnp.asarray(c["row_ptr"][:-1]), 8, True)
                * jnp.asarray(w).astype(jd)).astype(jnp.float32).sum()

    want = np.asarray(jax.grad(loss)(jnp.asarray(c["q"]).astype(jd)),
                      np.float32)
    x = _t(c, "q", td).requires_grad_()
    out = ss.csr_gather(x, _t(c, "dst", torch.int64),
                        _t(c, "row_ptr", torch.int32)[:-1])
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  x.detach().float().numpy()[c["dst"]])
    (out * torch.from_numpy(w).to(td)).float().sum().backward()
    assert x.grad.dtype == td
    tol = (dict(rtol=1e-4, atol=1e-5) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    np.testing.assert_allclose(x.grad.float().numpy()[:-1], want[:-1], **tol)


def test_cpu_tensors_take_the_plain_versions():
    c = _case(np.random.default_rng(1))
    before = (ag.launches, ag.bwd_launches, ss.launches)
    _port_grads(c, _cotangent(c))
    q = _t(c, "q", torch.float32).requires_grad_()
    ss.csr_gather(q, _t(c, "dst", torch.int64),
                  _t(c, "row_ptr", torch.int32)[:-1]).sum().backward()
    assert (ag.launches, ag.bwd_launches, ss.launches) == before


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernel has no CPU "
                    "mode (run `python3 chip_smoke.py` or this file on one)")
    from gnnep_tpu_torch.utils.device import resolve_device
    return resolve_device("cuda")


def _card_args(c, dtype, device):
    """Kernel 1's arguments on `device`: logits and scale in the kernels'
    [E, heads] layout, v in `dtype`, row_ptr."""
    return (_t(c, "logits", torch.float32, device).t().contiguous(),
            _t(c, "scale", torch.float32, device).t().contiguous(),
            _t(c, "v", dtype, device), _t(c, "row_ptr", torch.int32, device))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("heads,hidden", [(4, 256), (2, 16), (2, 192)])
def test_kernels_match_plain_on_card(cuda, dtype, tol, heads, hidden):
    """Head widths 64, 8 and 96; forward on the real rows, backward as
    `_compare`, each within `tol` of the plain tensor's largest value."""
    c = _case(np.random.default_rng(11), heads=heads, hidden=hidden)
    args = _card_args(c, dtype, cuda)
    dst = _t(c, "dst", torch.int64, cuda)
    before = (ag.launches, ag.bwd_launches)
    got = ag.aggregate_cuda(*args, heads=heads)
    want = ag.aggregate_plain(*args, dst, heads=heads)
    for a, b in zip(got, want):
        sc = max(b[:-1].abs().max().item(), 1e-30)
        torch.testing.assert_close(a[:-1] / sc, b[:-1] / sc, rtol=tol,
                                   atol=tol)
    g = torch.from_numpy(_cotangent(c)).to(cuda)
    bwd = ag.aggregate_bwd_cuda(*args, g, got[1], got[2], heads=heads)
    torch.cuda.synchronize()
    assert (ag.launches, ag.bwd_launches) == (before[0] + 1, before[1] + 1)
    ref = ag.aggregate_bwd_plain(*args, dst, g, got[1], got[2], heads=heads)
    # _compare takes dl in the JAX layout [heads, E]
    for name, a, b in _compare((bwd[0].t(), bwd[1]),
                               [r.float().cpu().numpy()
                                for r in (ref[0].t(), ref[1])], c):
        sc = max(np.abs(b).max(), 1e-30)
        np.testing.assert_allclose(a / sc, b / sc, rtol=tol, atol=tol,
                                   err_msg=name)


@pytest.mark.gpu
def test_identity_order_segment_sum_on_card(cuda):
    c = _case(np.random.default_rng(6), heads=4, hidden=256)
    vals = torch.randn((c["dst"].shape[0], 256), device=cuda)
    starts = _t(c, "row_ptr", torch.int32, cuda)[:-1].contiguous()
    before = ss.launches
    got = ss.csr_segment_sum_cuda(vals, None, starts)
    torch.cuda.synchronize()
    assert ss.launches == before + 1
    torch.testing.assert_close(got, ss.csr_segment_sum_plain(vals, None,
                                                             starts),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_kernels_without_scale_on_card(cuda):
    """No scale (no dropout): kernels 1 and 2 read none and equal their
    plain versions with scale None, which equal them with a scale of
    ones."""
    c = _case(np.random.default_rng(12), heads=4, hidden=256)
    logits, _, v, row_ptr = _card_args(c, torch.float32, cuda)
    dst = _t(c, "dst", torch.int64, cuda)
    got = ag.aggregate_cuda(logits, None, v, row_ptr, heads=4)
    want = ag.aggregate_plain(logits, torch.ones_like(logits), v, row_ptr,
                              dst, heads=4)
    g = torch.from_numpy(_cotangent(c)).to(cuda)
    bwd = ag.aggregate_bwd_cuda(logits, None, v, row_ptr, g, got[1], got[2],
                                heads=4)
    ref = ag.aggregate_bwd_plain(logits, None, v, row_ptr, dst, g, got[1],
                                 got[2], heads=4)
    torch.cuda.synchronize()
    for a, b in zip(got + bwd, want + ref):
        _near(a[:-1].float(), b[:-1].float(), 1e-4, "no scale")


def _arena(rng, heads, hidden, degs, tail=37, pad=0.1):
    """A dst-sorted arena with `degs[t]` edges into target t (row 7 all
    live; row 3 all masked), masked interior padding at rate `pad`, the
    dummy row's tail of `tail` edges, [heads, E] logits at −1e30 where
    masked, a dropout scale and f32 values v."""
    degs = list(degs) + [0]
    n = len(degs)
    dst = np.repeat(np.arange(n), degs)
    e_real = dst.size
    dst = np.concatenate([dst, np.full(tail, n - 1)])
    e_total = dst.size
    mask = (np.arange(e_total) < e_real) & (rng.random(e_total) >= pad)
    mask[dst == 7] = np.arange(e_total)[dst == 7] < e_real
    mask[dst == 3] = False
    logits = rng.normal(size=(heads, e_total)) * 2.0
    return dict(
        logits=np.where(mask[None], logits, NEG).astype(np.float32),
        scale=((rng.random((heads, e_total)) > 0.25) / 0.75).astype(
            np.float32),
        v=rng.normal(size=(e_total, hidden)).astype(np.float32),
        row_ptr=np.searchsorted(dst, np.arange(n + 1)).astype(np.int32),
        dst=dst, mask=mask.astype(np.float32), heads=heads, n=n)


def _at_offset(t, offset):
    """`t` copied into a contiguous view `offset` bytes past an aligned
    base (no move where its elements cannot sit there)."""
    if offset % t.element_size():
        return t
    skip = offset // t.element_size()
    flat = torch.empty(t.numel() + skip, dtype=t.dtype, device=t.device)
    return flat[skip:].view(t.shape).copy_(t)


def _near(a, b, tol, what):
    sc = max(b.abs().max().item(), 1e-30) if b.numel() else 1.0
    err = (a - b).abs().max().item() if b.numel() else 0.0
    assert err <= tol * sc, f"{what}: {err:.3e} > {tol} x {sc:.3e}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("heads,hidden", [(2, 16), (4, 256), (2, 192),
                                          (1, 256), (4, 512)])
def test_kernel_layouts_on_card(cuda, dtype, tol, heads, hidden):
    """Kernels 1 and 2 on every layout their plan can take here (1, 2 and
    all heads to a warp; 1, 2 and 4 warps to a row), on rows of 0 to 40
    edges beside a row of 1,000 live edges (kernel 2 keeps its u in dl_t),
    interior padding, an all-masked row, a dropout scale and the dummy
    row's tail: each output within `tol` of the plain tensor's largest
    magnitude, the dead edges' dl and dv exact zeros; and with v (and g) 2
    and 4 bytes off an aligned base (narrower words), bitwise the aligned
    run."""
    rng = np.random.default_rng(hidden + heads)
    degs = rng.integers(0, 40, 24)
    degs[7] = 1000
    c = _arena(rng, heads, hidden, degs)
    n = c["n"]
    args = _card_args(c, dtype, cuda)
    dst = _t(c, "dst", torch.int64, cuda)
    g = torch.from_numpy(np.random.default_rng(5).normal(
        size=(n, hidden)).astype(np.float32)).to(cuda)
    want = ag.aggregate_plain(*args, dst, heads=heads)
    live = torch.from_numpy((c["mask"] > 0) & (c["dst"] != n - 1)).to(cuda)
    e_total = c["dst"].shape[0]
    tried = 0
    for hpw in sorted({1, 2, heads}):
        for split in (1, 2, 4):
            try:
                plans = [ag.aggregate_plan(
                    n, e_total, hidden, heads, args[2].element_size(),
                    args[2].data_ptr(), heads_per_warp=hpw, split=split,
                    backward=b) for b in (False, True)]
            except ValueError:  # a layout these heads cannot take
                continue
            what = f"hpw {hpw} split {split}"
            fwd = ag.aggregate_cuda(*args, heads=heads, plan=plans[0])
            bwd = ag.aggregate_bwd_cuda(*args, g, fwd[1], fwd[2],
                                        heads=heads, plan=plans[1])
            torch.cuda.synchronize()
            for name, a, b in zip(("out", "max", "denom"), fwd, want):
                a, b = a[:-1], b[:-1]
                if name == "max":
                    dead = b <= 0.5 * NEG
                    assert (a[dead] == NEG).all(), what
                    a, b = a[~dead], b[~dead]
                _near(a, b, tol, f"{what} {name}")
            ref = ag.aggregate_bwd_plain(*args, dst, g, fwd[1], fwd[2],
                                         heads=heads)
            for name, a, b in (("dl", bwd[0], ref[0]),
                               ("dv", bwd[1].float(), ref[1].float())):
                assert not a[~live].any(), f"{what} {name}: dead rows"
                _near(a[live], b[live], tol, f"{what} {name}")
            for offset in (2, 4):
                if offset % args[2].element_size():
                    continue  # an f32 v 2 bytes off takes no word
                v2, g2 = _at_offset(args[2], offset), _at_offset(g, offset)
                moved = [ag.aggregate_plan(
                    n, e_total, hidden, heads, v2.element_size(),
                    v2.data_ptr(), heads_per_warp=hpw, split=split,
                    backward=b) for b in (False, True)]
                assert moved[0].word < plans[0].word or plans[0].word <= 4
                a2 = (args[0], args[1], v2, args[3])
                fwd2 = ag.aggregate_cuda(*a2, heads=heads, plan=moved[0])
                bwd2 = ag.aggregate_bwd_cuda(*a2, g2, fwd[1], fwd[2],
                                             heads=heads, plan=moved[1])
                torch.cuda.synchronize()
                for a, b in zip(fwd2 + bwd2, fwd + bwd):
                    assert torch.equal(a, b), f"{what} at offset {offset}"
            tried += 1
    assert tried >= 2
