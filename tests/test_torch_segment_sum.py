"""The port's CSR segment-sum (plain version of `csrc/csr_segment_sum.cu`)
against the JAX package's `windowed_segment_sum` (Pallas kernel `_sum_kernel`
in interpret mode), the port's `csr_gather_ordered` grads against the JAX
package's, and, on a GPU, the CUDA kernel against its plain version."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from gnnep_tpu.ops.pallas.csr_attention import (  # noqa: E402
    csr_gather_ordered as jax_gather_ordered, windowed_segment_sum)
from gnnep_tpu_torch.ops.cuda import segment_sum as ss  # noqa: E402


def _segments(rng, n=32, h=16):
    """`TestWindowedSegmentSum.test_matches_numpy`'s arena: contiguous
    segments (some empty), zero-filled tail padding."""
    degs = rng.integers(0, 6, n)
    seg = np.repeat(np.arange(n), degs)
    e_real = seg.shape[0]
    e_total = max(-(-(e_real + 8) // 128) * 128, 256)
    vals = rng.normal(size=(e_total, h)).astype(np.float32)
    vals[e_real:] = 0.0
    starts = np.searchsorted(seg, np.arange(n)).astype(np.int32)
    return vals, starts, e_total


@pytest.mark.parametrize("h", [16, 6])
def test_plain_matches_windowed_segment_sum(h):
    """1e-5 as the Pallas test (test_pallas_kernel.py:525); the dummy/tail
    row is unspecified there and not compared."""
    vals, starts, e_total = _segments(np.random.default_rng(0), h=h)
    want = np.asarray(windowed_segment_sum(
        jnp.asarray(vals), jnp.asarray(starts), e_total, max_deg=8,
        block_n=8, interpret=True))
    got = ss.csr_segment_sum_plain(torch.from_numpy(vals), None,
                                   torch.from_numpy(starts))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy()[:-1], want[:-1], rtol=1e-5,
                               atol=1e-5)


def test_plain_permuted_sum_matches_numpy():
    rng = np.random.default_rng(2)
    vals = rng.normal(size=(50, 8)).astype(np.float32)
    idx = rng.integers(0, 7, 50)
    order = np.argsort(idx, kind="stable").astype(np.int32)
    starts = np.searchsorted(idx[order], np.arange(7)).astype(np.int32)
    got = ss.csr_segment_sum_plain(torch.from_numpy(vals),
                                   torch.from_numpy(order),
                                   torch.from_numpy(starts))
    want = np.zeros((7, 8), np.float32)
    np.add.at(want, idx, vals)
    # the last segment is the dummy row's: unspecified, written as zeros
    np.testing.assert_allclose(got.numpy()[:-1], want[:-1], rtol=1e-5,
                               atol=1e-5)
    assert not got[-1].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_csr_gather_ordered_grads_match_jax(dtype):
    """The unsorted-index case of `test_csr_gather_grads`
    (test_pallas_kernel.py:553-568): values at 1e-5 / 1e-4 in f32, grads
    cast to the cotangent's type as `_csr_gather_ordered_bwd` does."""
    rng = np.random.default_rng(0)
    n, h, e_total = 32, 16, 256
    e_real = 100
    x = rng.normal(size=(n, h)).astype(np.float32)
    idx = rng.integers(0, n - 1, e_total).astype(np.int32)
    idx[e_real:] = n - 1
    order = np.argsort(idx, kind="stable").astype(np.int32)
    starts = np.searchsorted(idx[order], np.arange(n)).astype(np.int32)
    w = rng.normal(size=(e_total, h)).astype(np.float32)
    w[e_real:] = 0.0
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16

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


def test_cpu_gather_launches_no_kernel():
    vals, starts, _ = _segments(np.random.default_rng(1))
    before = ss.launches
    ss.csr_segment_sum(torch.from_numpy(vals),
                       torch.arange(vals.shape[0], dtype=torch.int32),
                       torch.from_numpy(starts))
    assert ss.launches == before


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernel has no CPU "
                    "mode (run `python3 chip_smoke.py` or this file on one)")
    from gnnep_tpu_torch.utils.device import resolve_device
    return resolve_device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("width", [512, 16, 6])
def test_kernel_matches_plain_on_card(cuda, dtype, tol, width):
    rng = np.random.default_rng(3)
    n, e_total = 300, 4096
    idx = rng.integers(0, n - 1, e_total)
    idx[-200:] = n - 1
    order = np.argsort(idx, kind="stable").astype(np.int32)
    starts = np.searchsorted(idx[order], np.arange(n)).astype(np.int32)
    vals = torch.from_numpy(rng.normal(size=(e_total, width))
                            .astype(np.float32)).to(cuda, dtype)
    args = (vals, torch.from_numpy(order).to(cuda),
            torch.from_numpy(starts).to(cuda))
    before = ss.launches
    got = ss.csr_segment_sum_cuda(*args)
    torch.cuda.synchronize()
    assert ss.launches == before + 1
    want = ss.csr_segment_sum_plain(*args)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    # deterministic: no atomics
    assert torch.equal(ss.csr_segment_sum_cuda(*args), got)
