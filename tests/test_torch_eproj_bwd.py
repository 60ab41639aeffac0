"""The port's eproj backward (plain version of `csrc/attn_eproj_bwd.cu`)
against `jax.grad` through the JAX package's `fused_attention_eproj` (Pallas
kernels `_attn_ep_kernel` / `_attn_ep_bwd_kernel` in interpret mode), and, on
a GPU, the CUDA kernels against their plain versions."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from gnnep_tpu.ops.pallas import csr_attention as jmod  # noqa: E402
from gnnep_tpu_torch.ops.cuda import attention_eproj as ep  # noqa: E402

from test_torch_eproj import _case  # noqa: E402

NAMES = ("dq", "dkv", "dea", "dw")


def _cotangent(c, seed=3):
    hidden = c["q"].shape[1]
    return np.random.default_rng(seed).normal(
        size=(c["q"].shape[0], hidden)).astype(np.float32)


def _jax_grads(c, g, dtype):
    def loss(q, kv, ea, w):
        out = jmod.fused_attention_eproj(
            q, kv, ea, w, jnp.asarray(c["row_ptr"]), jnp.asarray(c["dst"]),
            heads=c["heads"], max_in_degree=8, block_n=8, interpret=True,
            scale_t=jnp.asarray(c["scale"]), mask_e=jnp.asarray(c["mask"]))
        return (out * jnp.asarray(g)).sum()

    args = [jnp.asarray(c[k]).astype(dtype)
            for k in ("q", "kv", "ea", "w_edge")]
    return [np.asarray(x, np.float32)
            for x in jax.grad(loss, argnums=(0, 1, 2, 3))(*args)]


def _port_grads(c, g, dtype, device="cpu"):
    leaves = [torch.from_numpy(c[k]).to(device, dtype).requires_grad_()
              for k in ("q", "kv", "ea", "w_edge")]
    out = ep.fused_attention_eproj(
        *leaves, torch.from_numpy(c["row_ptr"]).to(device),
        torch.from_numpy(c["dst"]).to(device, torch.int64), heads=c["heads"],
        scale_t=torch.from_numpy(c["scale"]).to(device),
        mask_e=torch.from_numpy(c["mask"]).to(device))
    (out * torch.from_numpy(g).to(device)).sum().backward()
    return [t.grad for t in leaves]


def _compare(got, want, mask, **tol):
    """dq on the real rows, dkv/dea on the live edges, dW_e in full; dead
    edges' rows and the dummy row's dq must be exact zeros."""
    live = mask > 0
    for name, a, b in zip(NAMES, got, want):
        a = a.float().cpu().numpy()
        if name == "dq":
            assert not a[-1].any(), "dq of the dummy row must be zero"
            a, b = a[:-1], b[:-1]
        elif name in ("dkv", "dea"):
            assert not a[~live].any(), f"{name} of dead edges must be zero"
            a, b = a[live], b[live]
        yield name, a, b


@pytest.mark.parametrize("heads,hidden,fe", [(2, 16, 16), (4, 32, 8)])
def test_plain_bwd_matches_pallas_f32(heads, hidden, fe):
    """f32 at the Pallas eproj gradient tests' tolerance
    (test_pallas_kernel.py:452)."""
    c = _case(np.random.default_rng(7), heads=heads, hidden=hidden, fe=fe)
    g = _cotangent(c)
    want = _jax_grads(c, g, jnp.float32)
    got = _port_grads(c, g, torch.float32)
    assert [t.dtype for t in got] == [torch.float32] * 4
    for name, a, b in _compare(got, want, c["mask"]):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5, err_msg=name)


def test_plain_bwd_matches_pallas_bf16():
    """bf16: both sides round at the same points; scaled atol 0.08 as the
    Pallas bf16 round trip (test_pallas_kernel.py:493-504)."""
    c = _case(np.random.default_rng(9), heads=2, hidden=16, fe=16)
    g = _cotangent(c)
    want = _jax_grads(c, g, jnp.bfloat16)
    got = _port_grads(c, g, torch.bfloat16)
    assert [t.dtype for t in got] == [torch.bfloat16] * 4
    for name, a, b in _compare(got, want, c["mask"]):
        sc = max(np.abs(b).max(), 1.0)
        np.testing.assert_allclose(a / sc, b / sc, atol=0.08, err_msg=name)


def test_all_masked_row_gives_finite_zero_grads():
    """A row whose edges are all masked keeps max −1e30 from the forward;
    the backward selects before it multiplies, so its grads are zeros, not
    NaN."""
    c = _case(np.random.default_rng(4))
    c["mask"][:] = 0.0
    got = _port_grads(c, _cotangent(c), torch.float32)
    for name, t in zip(NAMES, got):
        assert torch.isfinite(t).all() and not t.any(), name


def test_cpu_backward_launches_no_kernel():
    c = _case(np.random.default_rng(1))
    before = (ep.launches, ep.bwd_launches)
    _port_grads(c, _cotangent(c), torch.float32)
    assert (ep.launches, ep.bwd_launches) == before


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernel has no CPU "
                    "mode (run `python3 chip_smoke.py` or this file on one)")
    from gnnep_tpu_torch.utils.device import resolve_device
    return resolve_device("cuda")


def _card_args(c, g, dtype, device):
    def t(k, dt=dtype):
        return torch.from_numpy(c[k]).to(device, dt)

    fwd = (t("q"), t("kv"), t("ea"), t("w_edge"), t("scale", torch.float32),
           t("mask", torch.float32))
    dst = t("dst", torch.int64)
    _, mx, den = ep.attention_eproj_plain(*fwd, dst, heads=c["heads"])
    return fwd + (t("row_ptr", torch.int32), dst,
                  torch.from_numpy(g).to(device), mx, den)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("heads,hidden,fe", [(4, 256, 256), (2, 16, 16),
                                             (2, 192, 32)])
def test_bwd_kernel_matches_plain_on_card(cuda, dtype, tol, heads, hidden,
                                          fe):
    """Head widths 64, 8 and 96 (padded to 128 inside the kernel)."""
    c = _case(np.random.default_rng(11), heads=heads, hidden=hidden, fe=fe)
    g = _cotangent(c)
    args = _card_args(c, g, dtype, cuda)
    before = ep.bwd_launches
    got = ep.attention_eproj_bwd_cuda(*args, heads=heads)
    torch.cuda.synchronize()
    assert ep.bwd_launches == before + 1
    want = ep.attention_eproj_bwd_plain(*args, heads=heads)
    want = [w.float().cpu().numpy() for w in want]
    for name, a, b in _compare(got, want, c["mask"]):
        sc = max(np.abs(b).max(), 1.0)
        np.testing.assert_allclose(a / sc, b / sc, rtol=tol, atol=tol,
                                   err_msg=name)


@pytest.mark.gpu
def test_autograd_runs_the_bwd_kernel_on_card(cuda):
    """One forward and one backward kernel launch, and gradients as close
    to float64 as the CPU's own. The kernel's f32 products run as 3xTF32
    on the tensor cores, summed in another order than the CPU's, so on this
    ill-conditioned case (e = ea·W_e of std ~5 feeding u − inner) the two
    f32 results differ elementwise by their own rounding; against the
    float64 gradients of the same forward (`bwd_bench.eproj_bwd_f64`), each
    leaf's largest error over its largest value stays within 2× the
    CPU's."""
    from gnnep_tpu_torch.dev.bwd_bench import eproj_bwd_f64, f64_errors
    c = _case(np.random.default_rng(5), heads=4, hidden=256, fe=256)
    g = _cotangent(c)
    before = (ep.launches, ep.bwd_launches)
    got = _port_grads(c, g, torch.float32, cuda)
    assert (ep.launches, ep.bwd_launches) == (before[0] + 1, before[1] + 1)
    want = _port_grads(c, g, torch.float32)
    ref = eproj_bwd_f64(*_card_args(c, g, torch.float32, "cpu"),
                        heads=c["heads"])
    card = f64_errors([t.cpu() for t in got], ref, NAMES)
    cpu = f64_errors(want, ref, NAMES)
    for name in NAMES:
        assert card[name] <= 2 * cpu[name], (name, card, cpu)


def _odd_case(rng, heads, hidden, fe, n=120):
    """The shapes the Hopper tiling must take: a hub target with 1,200
    in-edges (across 64-edge chunks, 32-edge slices and tile boundaries), a
    run of 20 targets whose edges are all masked (longer than a tile's share
    of edges, so some tile holds only dead edges), empty rows, E not a
    multiple of 64, and the dummy row's tail."""
    degs = rng.integers(0, 12, n)
    degs[n // 3] = 1200
    degs[n // 2:n // 2 + 20] = 10
    degs[-1] = 0
    e_real = int(degs.sum())
    e_total = e_real + 37 + (1 if (e_real + 37) % 64 == 0 else 0)
    dst = np.concatenate([np.repeat(np.arange(n), degs),
                          np.full(e_total - e_real, n - 1)]).astype(np.int64)
    mask = ((np.arange(e_total) < e_real)
            & (rng.random(e_total) > 0.1)).astype(np.float32)
    mask[(dst >= n // 2) & (dst < n // 2 + 20)] = 0.0
    return dict(
        q=rng.normal(size=(n, hidden)).astype(np.float32),
        kv=rng.normal(size=(e_total, 2 * hidden)).astype(np.float32),
        ea=rng.normal(size=(e_total, fe)).astype(np.float32),
        w_edge=(rng.normal(size=(fe, hidden)) / np.sqrt(fe)).astype(
            np.float32),
        row_ptr=np.searchsorted(dst, np.arange(n + 1)).astype(np.int32),
        dst=dst, mask=mask, heads=heads,
        scale=((rng.random((heads, e_total)) > 0.25) / 0.75).astype(
            np.float32))


def _has_dead_tile(c, device):
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n = c["q"].shape[0]
    ptr = ep.bwd_tile_ptr(torch.from_numpy(c["row_ptr"]),
                          ep.bwd_tiles(n, c["heads"], sms)).numpy()
    rp = c["row_ptr"]
    return any(rp[b] > rp[a] and not c["mask"][rp[a]:rp[b]].any()
               for a, b in zip(ptr, ptr[1:]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("heads,hidden,fe", [(4, 256, 36), (2, 16, 16),
                                             (2, 192, 36)])
def test_bwd_kernel_odd_shapes_on_card(cuda, dtype, tol, heads, hidden, fe):
    """`_odd_case` at head widths 64, 8 and 96 and Fe 36 (not a multiple of
    16): each output within `tol` of the plain tensor's largest magnitude,
    dead edges' rows and the dummy row's dq exact zeros."""
    c = _odd_case(np.random.default_rng(21), heads, hidden, fe)
    assert c["kv"].shape[0] % 64 and _has_dead_tile(c, cuda)
    args = _card_args(c, _cotangent(c), dtype, cuda)
    got = ep.attention_eproj_bwd_cuda(*args, heads=heads)
    torch.cuda.synchronize()
    want = [w.float().cpu().numpy()
            for w in ep.attention_eproj_bwd_plain(*args, heads=heads)]
    for name, a, b in _compare(got, want, c["mask"]):
        assert np.abs(a - b).max() <= tol * np.abs(b).max(), name
