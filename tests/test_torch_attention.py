"""The port's kv+e attention (plain versions of `csrc/attn_fwd.cu` and
`csrc/attn_bwd.cu`) against the JAX package's `fused_attention` (Pallas
kernels `_attn_kernel` / `_attn_bwd_kernel` in interpret mode, forward and
`jax.grad`), and, on a GPU, the CUDA kernels against their plain versions."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from gnnep_tpu.ops.pallas import csr_attention as jmod  # noqa: E402
from gnnep_tpu_torch.ops.cuda import attention as at  # noqa: E402

from test_torch_eproj import _case as _eproj_case  # noqa: E402

NAMES = ("dq", "dk", "dv")


def _case(rng, **kw):
    """The serving hazards of `test_torch_eproj._case` (masked interior
    padding rows, an all-masked row 3, an empty row 5, a dropout scale), with
    k and v in place of kv and the edge features."""
    c = _eproj_case(rng, **kw)
    hidden = c["q"].shape[1]
    c["k"], c["v"] = c["kv"][:, :hidden].copy(), c["kv"][:, hidden:].copy()
    return c


def _jax_forward(c, dtype):
    """(out, max, denom) of the Pallas kernel, interpret mode."""
    heads, block_n, max_deg = c["heads"], 8, 8
    q, k, v = (jnp.asarray(c[x]).astype(dtype) for x in ("q", "k", "v"))
    out = jmod.fused_attention(
        q, k, v, jnp.asarray(c["row_ptr"]), jnp.asarray(c["dst"]),
        heads=heads, max_in_degree=max_deg, block_n=block_n, interpret=True,
        scale_t=jnp.asarray(c["scale"]), mask_e=jnp.asarray(c["mask"]))
    cap = jmod._win_cap(block_n, max_deg, k.shape[0])
    _, stats = jmod._attn_forward(
        q, k, v, jnp.asarray(c["scale"]), jnp.asarray(c["mask"]).reshape(1, -1),
        jnp.asarray(c["row_ptr"]), heads=heads, block_n=block_n, cap=cap,
        interpret=True)
    stats = np.asarray(stats)
    return np.asarray(out), stats[:, :heads], stats[:, 128:128 + heads]


def _t(c, key, dtype, device="cpu"):
    return torch.from_numpy(c[key]).to(device, dtype)


def _port_forward(c, dtype, device="cpu"):
    return at.fused_attention(
        _t(c, "q", dtype, device), _t(c, "k", dtype, device),
        _t(c, "v", dtype, device), _t(c, "row_ptr", torch.int32, device),
        _t(c, "dst", torch.int64, device), heads=c["heads"],
        scale_t=_t(c, "scale", torch.float32, device),
        mask_e=_t(c, "mask", torch.float32, device), return_stats=True)


# f32 at the Pallas kernel test's tolerance (test_pallas_kernel.py:276);
# bf16 at 1e-4: both sides round α to bf16 at the same point, and the
# largest difference measured over eight such cases was 2.4e-7 (denom; out
# equal). One bf16 step of α flipping would show as ~1e-2.
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-4)])
@pytest.mark.parametrize("heads,hidden", [(2, 16), (4, 32)])
def test_plain_matches_pallas_attention(dtype, tol, heads, hidden):
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
    # all-masked and empty rows: out 0, max -1e30, denom 1e-16
    for row in (3, 5):
        assert not got[0][row].any()
        assert (got[1][row] == -1e30).all() and (got[2][row] == 1e-16).all()


def _cotangent(c, seed=3):
    return np.random.default_rng(seed).normal(
        size=c["q"].shape).astype(np.float32)


def _jax_grads(c, g, dtype):
    def loss(q, k, v):
        out = jmod.fused_attention(
            q, k, v, jnp.asarray(c["row_ptr"]), jnp.asarray(c["dst"]),
            heads=c["heads"], max_in_degree=8, block_n=8, interpret=True,
            scale_t=jnp.asarray(c["scale"]), mask_e=jnp.asarray(c["mask"]))
        return (out * jnp.asarray(g)).sum()

    args = [jnp.asarray(c[x]).astype(dtype) for x in ("q", "k", "v")]
    return [np.asarray(x, np.float32)
            for x in jax.grad(loss, argnums=(0, 1, 2))(*args)]


def _port_grads(c, g, dtype, device="cpu"):
    leaves = [_t(c, x, dtype, device).requires_grad_() for x in ("q", "k", "v")]
    out = at.fused_attention(
        *leaves, _t(c, "row_ptr", torch.int32, device),
        _t(c, "dst", torch.int64, device), heads=c["heads"],
        scale_t=_t(c, "scale", torch.float32, device),
        mask_e=_t(c, "mask", torch.float32, device))
    (out * torch.from_numpy(g).to(device)).sum().backward()
    return [t.grad for t in leaves]


def _compare(got, want, c):
    """dq on the real rows, dk and dv on the live edges; dead edges' rows
    and the dummy row's dq must be exact zeros."""
    n = c["q"].shape[0]
    live = (c["mask"] > 0) & (c["dst"] != n - 1)
    for name, a, b in zip(NAMES, got, want):
        a = a.float().cpu().numpy()
        if name == "dq":
            assert not a[-1].any(), "dq of the dummy row must be zero"
            a, b = a[:-1], b[:-1]
        else:
            assert not a[~live].any(), f"{name} of dead edges must be zero"
            a, b = a[live], b[live]
        yield name, a, b


@pytest.mark.parametrize("heads,hidden", [(2, 16), (4, 32)])
def test_plain_bwd_matches_pallas_f32(heads, hidden):
    """f32 at the Pallas attention gradient test's tolerance
    (test_pallas_kernel.py:314-320)."""
    c = _case(np.random.default_rng(7), heads=heads, hidden=hidden)
    g = _cotangent(c)
    want = _jax_grads(c, g, jnp.float32)
    got = _port_grads(c, g, torch.float32)
    assert [t.dtype for t in got] == [torch.float32] * 3
    for name, a, b in _compare(got, want, c):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)


def test_plain_bwd_matches_pallas_bf16():
    """bf16: both sides round g, dl and α at the same points; scaled atol
    0.08 as the Pallas bf16 round trip (test_pallas_kernel.py:493-504)."""
    c = _case(np.random.default_rng(9), heads=2, hidden=16)
    g = _cotangent(c)
    want = _jax_grads(c, g, jnp.bfloat16)
    got = _port_grads(c, g, torch.bfloat16)
    assert [t.dtype for t in got] == [torch.bfloat16] * 3
    for name, a, b in _compare(got, want, c):
        sc = max(np.abs(b).max(), 1.0)
        np.testing.assert_allclose(a / sc, b / sc, atol=0.08, err_msg=name)


def test_all_masked_rows_give_finite_zero_grads():
    """Every row all-masked keeps max −1e30 from the forward; the backward
    selects before it multiplies, so the grads are zeros, not NaN."""
    c = _case(np.random.default_rng(4))
    c["mask"][:] = 0.0
    got = _port_grads(c, _cotangent(c), torch.float32)
    for name, t in zip(NAMES, got):
        assert torch.isfinite(t).all() and not t.any(), name


def test_cpu_tensors_take_the_plain_versions():
    c = _case(np.random.default_rng(1))
    before = (at.launches, at.bwd_launches)
    _port_grads(c, _cotangent(c), torch.float32)
    assert (at.launches, at.bwd_launches) == before


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernel has no CPU "
                    "mode (run `python3 chip_smoke.py` or this file on one)")
    from gnnep_tpu_torch.utils.device import resolve_device
    return resolve_device("cuda")


def _card_inputs(c, dtype, device):
    return (_t(c, "q", dtype, device), _t(c, "k", dtype, device),
            _t(c, "v", dtype, device), _t(c, "scale", torch.float32, device),
            _t(c, "mask", torch.float32, device),
            _t(c, "row_ptr", torch.int32, device))


def _row1000_case(rng, heads, hidden):
    """`_case`'s hazards (interior padding, an all-masked row 3, an empty
    row 5, a dropout scale) around a row of 1,000 live edges (row 2), the
    kernels' path for rows of more than 32 edges."""
    n = 16
    degs = rng.integers(1, 7, n)
    degs[2], degs[5], degs[-1] = 1000, 0, 0
    dst = np.repeat(np.arange(n, dtype=np.int32), degs)
    e_real = dst.shape[0]
    dst = np.concatenate([dst, np.full(16, n - 1, np.int32)])
    e_total = dst.shape[0]
    mask = ((np.arange(e_total) < e_real)
            & ((rng.random(e_total) > 0.15) | (dst == 2))).astype(np.float32)
    mask[dst == 3] = 0.0
    return dict(q=rng.normal(size=(n, hidden)).astype(np.float32),
                k=rng.normal(size=(e_total, hidden)).astype(np.float32),
                v=rng.normal(size=(e_total, hidden)).astype(np.float32),
                row_ptr=np.searchsorted(dst, np.arange(n + 1)).astype(
                    np.int32), dst=dst, mask=mask, heads=heads,
                scale=((rng.random((heads, e_total)) > 0.25) / 0.75).astype(
                    np.float32))


def _at_offset(t, offset):
    """`t` copied into a contiguous view `offset` bytes past an aligned
    base."""
    skip = offset // t.element_size()
    flat = torch.empty(t.numel() + skip, dtype=t.dtype, device=t.device)
    return flat[skip:].view(t.shape).copy_(t)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", ["serving", "row1000"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("heads,hidden", [(4, 256), (2, 16), (2, 192)])
def test_kernels_match_plain_on_card(cuda, dtype, tol, heads, hidden, rows):
    """Head widths 64, 8 and 96, on the serving hazards or around a row of
    1,000 live edges; with the wrapper's plan and with 1, 2 and all heads
    to a warp (where a warp holds them), one warp to a row and four:
    forward on the real rows,
    backward as `_compare`, each within `tol` of the plain tensor's
    largest value. Then q, k_e and v_e at 2- and 4-byte offsets (the
    plan's narrow words): every output bitwise the aligned run's."""
    rng = np.random.default_rng(11)
    c = (_case(rng, heads=heads, hidden=hidden) if rows == "serving"
         else _row1000_case(rng, heads, hidden))
    args = _card_inputs(c, dtype, cuda)
    dst = _t(c, "dst", torch.int64, cuda)
    g = torch.from_numpy(_cotangent(c)).to(cuda)
    want = at.attention_plain(*args[:5], dst, heads=heads)

    def run(q, k, v, layout):
        plans = [None if layout is None else at.attention_plan(
            q.shape[0], k.shape[0], hidden, heads, q.element_size(),
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            heads_per_warp=layout[0], split=layout[1], backward=backward)
            for backward in (False, True)]
        fwd = at.attention_cuda(q, k, v, *args[3:], heads=heads,
                                plan=plans[0])
        bwd = at.attention_bwd_cuda(q, k, v, *args[3:], g, fwd[1], fwd[2],
                                    heads=heads, plan=plans[1])
        torch.cuda.synchronize()
        return fwd, bwd

    for layout in (None, (1, 1), (2, 1), (heads, 1), (1, 4), (heads, 4)):
        try:
            before = (at.launches, at.bwd_launches)
            got, bwd = run(*args[:3], layout)
        except ValueError:  # a layout these heads cannot take
            continue
        assert (at.launches, at.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
        for a, b in zip(got, want):
            sc = max(b[:-1].abs().max().item(), 1e-30)
            torch.testing.assert_close(a[:-1] / sc, b[:-1] / sc, rtol=tol,
                                       atol=tol)
        ref = at.attention_bwd_plain(*args, dst, g, got[1], got[2],
                                     heads=heads)
        for name, a, b in _compare(bwd, [r.float().cpu().numpy()
                                         for r in ref], c):
            sc = max(np.abs(b).max(), 1e-30)
            np.testing.assert_allclose(a / sc, b / sc, rtol=tol, atol=tol,
                                       err_msg=name)
        for offset in (2, 4):
            if offset % args[0].element_size():
                continue  # an f32 tensor 2 bytes off takes no word
            moved = run(*(_at_offset(x, offset) for x in args[:3]), layout)
            for a, b in zip(moved[0] + moved[1], got + bwd):
                assert torch.equal(a, b), f"{offset} bytes off, {layout}"
