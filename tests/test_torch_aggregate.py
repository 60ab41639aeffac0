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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("heads,hidden", [(4, 256), (2, 16), (2, 192)])
def test_kernels_match_plain_on_card(cuda, dtype, tol, heads, hidden):
    """Head widths 64, 8 and 96; forward on the real rows, backward as
    `_compare`, each within `tol` of the plain tensor's largest value."""
    c = _case(np.random.default_rng(11), heads=heads, hidden=hidden)
    args = (_t(c, "logits", torch.float32, cuda),
            _t(c, "scale", torch.float32, cuda), _t(c, "v", dtype, cuda),
            _t(c, "row_ptr", torch.int32, cuda))
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
    for name, a, b in _compare(bwd, [r.float().cpu().numpy() for r in ref],
                               c):
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
