"""The port's two dev probes against the JAX package's: the row gather
(`gnnep_tpu_torch.dev.gather_probe`, CUDA kernel `csrc/row_gather.cu`)
against `scripts_dev/exp_gather_probe.py`'s Pallas `_kernel`, and the
kernel ladder (`gnnep_tpu_torch.dev.kernel_ladder`, kernel 5 cut short
after each phase) against `scripts_dev/exp_kernel_ladder.py`'s
`make_kernel`, both in interpret mode on the CPU; on a GPU, the gather
kernel bitwise and the ladder's `full` stage bitwise kernel 5."""
import ast
import importlib.util
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from gnnep_tpu.data.batching import measure_win64  # noqa: E402
from gnnep_tpu.ops.pallas import csr_attention as jmod  # noqa: E402
from gnnep_tpu.utils.synth import synthetic_batch  # noqa: E402
from gnnep_tpu_torch.dev import gather_probe as gp  # noqa: E402
from gnnep_tpu_torch.dev import kernel_ladder as kl  # noqa: E402
from gnnep_tpu_torch.ops.cuda import attention_eproj as ep  # noqa: E402

SCRIPTS = pathlib.Path(__file__).resolve().parents[1] / "scripts_dev"


def _script(name):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32,
                                   torch.bfloat16])
def test_gather_plain_matches_pallas_probe(dtype):
    """The JAX probe's first case, 256 × 512: the port's plain gather is
    bitwise the Pallas kernel's output (interpret mode) on the same table
    and indices."""
    probe = _script("exp_gather_probe")
    c = gp.probe_case(256, gp.WIDTH, dtype, "cpu")
    tab = (c["tab"].float().numpy().astype(jnp.bfloat16)
           if dtype == torch.bfloat16 else c["tab"].numpy())
    fn = pl.pallas_call(
        probe._kernel, out_shape=jax.ShapeDtypeStruct(tab.shape, tab.dtype),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)
    want = np.asarray(fn(jnp.asarray(c["idx"].numpy()), jnp.asarray(tab)))
    got = gp.row_gather(c["tab"], c["idx"])
    got = (got.float().numpy().astype(jnp.bfloat16)
           if dtype == torch.bfloat16 else got.numpy())
    assert got.dtype == want.dtype
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


def test_gather_probe_cases_follow_the_jax_probe():
    """The JAX probe's table and indices: the same numpy draws, int32
    truncated toward zero as numpy's astype does."""
    rng = np.random.default_rng(0)
    tab = rng.normal(size=(640, 512))
    idx = rng.integers(0, 640, size=(640,)).astype(np.int32)
    c = gp.probe_case(640, 512, torch.int32, "cpu")
    assert np.array_equal(c["tab"].numpy(), tab.astype(np.int32))
    assert np.array_equal(c["idx"].numpy(), idx)
    assert gp.PROBE_ROWS == (256, 640, 768) and gp.WIDTH == 512


def test_ladder_stages_are_the_jax_ladders():
    """`main`'s stage tuple in the JAX ladder, read from its source."""
    tree = ast.parse((SCRIPTS / "exp_kernel_ladder.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    loop = next(n for n in ast.walk(main) if isinstance(n, ast.For))
    assert tuple(ast.literal_eval(loop.iter)) == kl.STAGES


@pytest.fixture(scope="module")
def span_batch():
    """`tests/test_span_attention.py`'s fixture: 8 graphs."""
    return synthetic_batch(np.random.default_rng(7), n_graphs=8,
                           mean_atoms=6, degree=6)


def _ladder_case(batch, hidden=64, heads=2, seed=0):
    """Kernel 5's inputs at the fixture's line-graph conv, as the JAX
    ladder's `main` draws them (scaled to the fixture's widths), with a
    dropout scale."""
    rng = np.random.default_rng(seed)
    n, e_total = batch.edge_src.shape[0], batch.lg_src.shape[0]
    return dict(kv=rng.normal(size=(e_total, 2 * hidden)).astype(np.float32),
                q=rng.normal(size=(n, hidden)).astype(np.float32),
                ea=rng.normal(size=(e_total, hidden)).astype(np.float32),
                w_edge=(rng.normal(size=(hidden, hidden)) * 0.05).astype(
                    np.float32),
                scale=((rng.random((heads, e_total)) > 0.25) / 0.75).astype(
                    np.float32),
                mask=np.asarray(batch.lg_mask, np.float32),
                row_ptr=np.asarray(batch.lg_row_ptr, np.int32),
                dst=np.asarray(batch.lg_dst, np.int64), heads=heads)


def _jax_ladder_full(c, batch):
    """`make_kernel('full', …)` under `run_variant`'s grid spec, interpret
    mode → (out, max, denom)."""
    ladder = _script("exp_kernel_ladder")
    n, e_total = c["q"].shape[0], c["kv"].shape[0]
    hidden, heads = c["q"].shape[1], c["heads"]
    fe = c["ea"].shape[1]
    bn = 64
    win64 = ((measure_win64(c["dst"], n) + 31) // 32) * 32
    cap = jmod._win_cap(bn, batch.lg_in_edges.shape[1], e_total, win64)
    n_blocks = n // bn
    row_ptr = jnp.asarray(c["row_ptr"])
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(n_blocks,),
        in_specs=[pl.BlockSpec((n_blocks, bn), lambda i, s: (0, 0)),
                  pl.BlockSpec((n_blocks, bn), lambda i, s: (0, 0)),
                  pl.BlockSpec(memory_space=pltpu.ANY),
                  pl.BlockSpec(memory_space=pltpu.ANY),
                  pl.BlockSpec(memory_space=pltpu.ANY),
                  pl.BlockSpec(memory_space=pltpu.ANY),
                  pl.BlockSpec((fe, hidden), lambda i, s: (0, 0)),
                  pl.BlockSpec((bn, hidden), lambda i, s: (i, 0))],
        out_specs=(pl.BlockSpec((bn, hidden), lambda i, s: (i, 0)),
                   pl.BlockSpec((bn, 256), lambda i, s: (i, 0))),
        scratch_shapes=[pltpu.VMEM((2, cap, 2 * hidden), jnp.float32),
                        pltpu.VMEM((2, cap, fe), jnp.float32),
                        pltpu.VMEM((2, heads, cap), jnp.float32),
                        pltpu.VMEM((2, 1, cap), jnp.float32),
                        pltpu.SemaphoreType.DMA((2, 4))])
    out, stats = pl.pallas_call(
        ladder.make_kernel("full", bn, cap, heads, hidden // heads),
        grid_spec=grid_spec,
        out_shape=(jax.ShapeDtypeStruct((n, hidden), jnp.float32),
                   jax.ShapeDtypeStruct((n, 256), jnp.float32)),
        interpret=True,
    )(jmod._window_starts(row_ptr, bn, cap, e_total),
      row_ptr[:-1].reshape(n_blocks, bn), row_ptr[1:].reshape(n_blocks, bn),
      jnp.asarray(c["kv"]), jnp.asarray(c["ea"]), jnp.asarray(c["scale"]),
      jnp.asarray(c["mask"]).reshape(1, -1), jnp.asarray(c["w_edge"]),
      jnp.asarray(c["q"]))
    stats = np.asarray(stats)
    return np.asarray(out), stats[:, :heads], stats[:, 128:128 + heads]


def _port_args(c, dtype=torch.float32, device="cpu"):
    def t(k, dt=dtype):
        return torch.from_numpy(c[k]).to(device, dt)

    return (t("q"), t("kv"), t("ea"), t("w_edge"), t("scale", torch.float32),
            t("mask", torch.float32), t("row_ptr", torch.int32),
            t("dst", torch.int64))


def test_ladder_full_plain_matches_pallas_full(span_batch):
    """The ladder's `full` stage (kernel 5's plain version) against the JAX
    ladder's `full` kernel, interpret mode, at the span fixture's
    line-graph conv, f32 at the Pallas kernel tests' 1e-5 on the real
    rows; the cut-short stages have no plain version."""
    c = _ladder_case(span_batch)
    want = _jax_ladder_full(c, span_batch)
    got = kl.ladder(*_port_args(c), heads=c["heads"], stage="full")
    for name, a, b in zip(("out", "max", "denom"), got, want):
        np.testing.assert_allclose(a.numpy()[:-1], b[:-1], rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    with pytest.raises(ValueError, match="no plain version"):
        kl.ladder(*_port_args(c), heads=c["heads"], stage="softmax")


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernel has no CPU "
                    "mode (run `python3 chip_smoke.py` or this file on one)")
    from gnnep_tpu_torch.utils.device import resolve_device
    return resolve_device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32,
                                   torch.bfloat16])
def test_gather_kernel_is_bitwise_on_card(cuda, dtype):
    before = gp.launches
    for rows in gp.PROBE_ROWS:
        assert gp.check_bitwise(gp.probe_case(rows, gp.WIDTH, dtype, cuda))
    # int64 indices, and rows of 20 or 10 bytes (4- and 2-byte words)
    tab = torch.arange(300 * 5, device=cuda).to(dtype).reshape(300, 5)
    idx = torch.randint(0, 300, (1000,), device=cuda)
    assert torch.equal(gp.row_gather_cuda(tab, idx), tab[idx])
    assert gp.launches == before + len(gp.PROBE_ROWS) + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ladder_full_is_kernel_5_on_card(span_batch, cuda, dtype):
    """`full` is kernel 5's own instantiation: bitwise its output; every
    stage launches and counts on the ladder's counter, not kernel 5's."""
    c = _ladder_case(span_batch, hidden=256, heads=4)
    args = _port_args(c, dtype, cuda)
    before = (kl.launches, ep.launches)
    full = kl.ladder_cuda(*args, heads=4, stage="full")
    k5 = ep.attention_eproj_cuda(*args, heads=4)
    for a, b in zip(full, k5):
        assert torch.equal(a, b)
    for stage in kl.STAGES[:-1]:
        out, _, _ = kl.ladder_cuda(*args, heads=4, stage=stage)
        assert torch.isfinite(out[:-1]).all(), stage
    torch.cuda.synchronize()
    assert (kl.launches, ep.launches) == (before[0] + len(kl.STAGES),
                                          before[1] + 1)
