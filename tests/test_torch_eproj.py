"""The port's eproj attention against the JAX package's `fused_attention_eproj`
(Pallas kernel `_attn_ep_kernel` in interpret mode), and, on a GPU, the CUDA
kernel against its plain version."""
import numpy as np
import pytest

import jax.numpy as jnp

torch = pytest.importorskip("torch")

from gnnep_tpu.ops.pallas import csr_attention as jmod  # noqa: E402
from gnnep_tpu_torch.ops.cuda import attention_eproj as ep  # noqa: E402


def _case(rng, n=32, heads=2, hidden=16, fe=16, cap_d=8):
    """`TestFusedAttentionEproj._case` plus the serving hazards: masked
    interior padding rows inside real rows' ranges, an all-masked row (3), an
    empty row (5), and a dropout scale."""
    degs = rng.integers(1, cap_d - 1, n)
    degs[-1] = 0
    degs[5] = 0
    dst = np.repeat(np.arange(n, dtype=np.int32), degs)
    e_real = dst.shape[0]
    cap_needed = ((8 * cap_d + 128 + 127) // 128) * 128
    e_total = max((-(-(e_real + 16) // 128)) * 128, cap_needed)
    dst = np.concatenate([dst, np.full(e_total - e_real, n - 1, np.int32)])
    mask = ((np.arange(e_total) < e_real)
            & (rng.random(e_total) > 0.15)).astype(np.float32)
    mask[dst == 3] = 0.0
    q = rng.normal(size=(n, hidden)).astype(np.float32)
    kv = rng.normal(size=(e_total, 2 * hidden)).astype(np.float32)
    ea = rng.normal(size=(e_total, fe)).astype(np.float32)
    w_edge = rng.normal(size=(fe, hidden)).astype(np.float32) * 0.3
    row_ptr = np.searchsorted(dst, np.arange(n + 1)).astype(np.int32)
    scale = ((rng.random((heads, e_total)) > 0.25) / 0.75).astype(np.float32)
    return dict(q=q, kv=kv, ea=ea, w_edge=w_edge, row_ptr=row_ptr, dst=dst,
                mask=mask, scale=scale, heads=heads)


def _jax_forward(c, dtype):
    """(out, max, denom) of the Pallas kernel, interpret mode."""
    heads, block_n, max_deg = c["heads"], 8, 8
    args = [jnp.asarray(c[k]).astype(dtype)
            for k in ("q", "kv", "ea", "w_edge")]
    e_total = c["kv"].shape[0]
    out = jmod.fused_attention_eproj(
        *args, jnp.asarray(c["row_ptr"]), jnp.asarray(c["dst"]),
        heads=heads, max_in_degree=max_deg, block_n=block_n, interpret=True,
        scale_t=jnp.asarray(c["scale"]), mask_e=jnp.asarray(c["mask"]))
    cap = jmod._win_cap(block_n, max_deg, e_total)
    _, stats = jmod._attn_ep_forward(
        *args, jnp.asarray(c["scale"]), jnp.asarray(c["mask"]).reshape(1, -1),
        jnp.asarray(c["row_ptr"]), heads=heads, block_n=block_n, cap=cap,
        interpret=True)
    stats = np.asarray(stats)
    return (np.asarray(out), stats[:, :heads],
            stats[:, 128:128 + heads])


def _port_forward(c, dtype, device="cpu"):
    def t(k, dt=dtype):
        return torch.from_numpy(c[k]).to(device, dt)

    return ep.fused_attention_eproj(
        t("q"), t("kv"), t("ea"), t("w_edge"),
        t("row_ptr", torch.int32), t("dst", torch.int64), heads=c["heads"],
        scale_t=t("scale", torch.float32), mask_e=t("mask", torch.float32),
        return_stats=True)


# f32 at the Pallas kernel tests' own tolerance (test_pallas_kernel.py:59);
# bf16 with both sides rounding at the same points, up to one bf16 step of
# the f32-accumulated projection flipping (summation order differs)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("heads,hidden,fe", [(2, 16, 16), (4, 32, 8)])
def test_plain_matches_pallas_eproj(dtype, tol, heads, hidden, fe):
    c = _case(np.random.default_rng(7), heads=heads, hidden=hidden, fe=fe)
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


def test_cpu_tensors_take_the_plain_version():
    c = _case(np.random.default_rng(1))
    before = ep.launches
    _port_forward(c, torch.float32)
    assert ep.launches == before


@pytest.mark.parametrize("fused,eproj", [(False, True), (True, False)])
def test_rungs_match_jax_on_cpu(tmp_path, monkeypatch, fused, eproj):
    """On the CPU, a config that selects another ladder rung gives the
    activations of the JAX package's model on that rung: the external-logits
    kernel `_kernel` (attn_fused=False) or the kv+e kernel `_attn_kernel`
    (attn_eproj=False), both in interpret mode, and the port reaches that
    rung's own plain version, not the eproj one. f32 at the model tests'
    tolerance (test_pallas_kernel.py:228)."""
    import dataclasses
    import pathlib
    import sys

    import jax

    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    from synthetic import make_store

    from gnnep_tpu.data.batching import BatchBudget, BatchPacker
    from gnnep_tpu.models import alignn as jm
    from gnnep_tpu.train import artifacts as ja
    from gnnep_tpu_torch.models import alignn as pm
    from gnnep_tpu_torch.ops.cuda import aggregate, attention
    from gnnep_tpu_torch.train import artifacts as pa

    store = make_store(6, seed=5)
    budget = BatchBudget.plan(store, range(6), batch_size=6)
    # 128-divisible arenas, so that the JAX model takes its Pallas rungs
    budget = dataclasses.replace(budget, n_nodes=128, n_edges=256,
                                 n_lg_edges=1024)
    batch = next(iter(BatchPacker(store, budget).pack(range(6))))
    cfg = jm.AlignnConfig(
        node_dim=store.node_dim, edge_dim=store.edge_dim,
        angle_dim=store.angle_dim, global_dim=store.global_scalar_dim + 230,
        target_dim=2, hidden=16, layers=1, heads=2, dropout=0.0,
        conv_impl="fused", force_fused=True, attn_fused=fused,
        attn_eproj=eproj)
    params = jm.init_alignn(jax.random.PRNGKey(3), cfg)
    ja.save_member(tmp_path / "model_0.npz", params, cfg)
    # the JAX forward really reaches that rung's kernel entry point
    rung = "fused_aggregate_t" if not fused else "fused_attention"
    calls = []
    real = getattr(jmod, rung)
    monkeypatch.setattr(jmod, rung,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    want = jm.alignn_activations(params, cfg, batch)
    assert calls, f"the JAX forward did not reach {rung}"
    model = pa.load_member(tmp_path / "model_0.npz", "cpu")
    assert (model.cfg.attn_fused, model.cfg.attn_eproj) == (fused, eproj)
    plain = {"aggregate": (aggregate, "aggregate_plain"),
             "attention": (attention, "attention_plain"),
             "eproj": (ep, "attention_eproj_plain")}
    reached = {name: 0 for name in plain}
    for name, (mod, fn) in plain.items():
        def counted(*a, _name=name, _real=getattr(mod, fn), **k):
            reached[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, fn, counted)
    with torch.inference_mode():
        got = pm.alignn_activations(model,
                                    pm.DeviceBatch.from_batch(batch, "cpu"))
    own = "aggregate" if not fused else "attention"
    assert reached == {**dict.fromkeys(plain, 0), own: 2 * cfg.layers}
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(value),
                                   rtol=1e-3, atol=1e-4, err_msg=name)


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
                                       (torch.bfloat16, 5e-2)])
def test_kernel_matches_plain_on_card(cuda, dtype, tol):
    c = _case(np.random.default_rng(11), heads=4, hidden=256, fe=256)
    before = ep.launches
    got = _port_forward(c, dtype, cuda)
    assert ep.launches == before + 1
    args = [torch.from_numpy(c[k]).to(cuda, dtype)
            for k in ("q", "kv", "ea", "w_edge")]
    want = ep.attention_eproj_plain(
        *args, torch.from_numpy(c["scale"]).to(cuda),
        torch.from_numpy(c["mask"]).to(cuda),
        torch.from_numpy(c["dst"]).to(cuda, torch.int64), heads=4)
    for a, b in zip(got, want):
        torch.testing.assert_close(a[:-1], b[:-1], rtol=tol, atol=tol)


@pytest.mark.gpu
def test_card_refuses_what_the_kernel_does_not_take(cuda):
    from gnnep_tpu_torch.ops.dense_attention import transformer_conv_table
    from gnnep_tpu_torch.ops.graph_attention import TransformerConv

    c = _case(np.random.default_rng(2))
    q = torch.from_numpy(c["q"]).to(cuda)
    with pytest.raises(TypeError):
        _port_forward({**c, "q": c["q"].astype(np.float64)}, torch.float64,
                      cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ep.attention_eproj_cuda(
            q.t().contiguous().t(), *[torch.from_numpy(c[k]).to(cuda)
                                      for k in ("kv", "ea", "w_edge",
                                                "scale", "mask")],
            torch.from_numpy(c["row_ptr"]).to(cuda),
            torch.from_numpy(c["dst"]).to(cuda, torch.int64), heads=2)
    # each other rung runs its own kernel on the card: the span rung (its
    # bounds measured and the batch's span_lo given) too
    from gnnep_tpu_torch.ops.cuda import aggregate, attention
    from gnnep_tpu_torch.ops.cuda import attention_span
    conv = TransformerConv(16, 16, edge_dim=16).to(cuda)
    n_e = len(c["dst"])
    src_starts = torch.zeros(len(c["row_ptr"]) - 1, dtype=torch.int32,
                             device=cuda)

    def run(**rung):
        return transformer_conv_table(
            conv.params(), q, torch.zeros(n_e, dtype=torch.long, device=cuda),
            torch.from_numpy(c["dst"]).to(cuda, torch.long),
            torch.from_numpy(c["ea"]).to(cuda),
            torch.from_numpy(c["row_ptr"]).to(cuda),
            torch.arange(n_e, dtype=torch.int32, device=cuda), src_starts,
            heads=2, fused=True, **rung)

    span_lo = torch.zeros(len(c["row_ptr"]) - 1, dtype=torch.int32,
                          device=cuda)
    for rung, mod in (({"attn_fused": False}, aggregate),
                      ({"attn_eproj": False}, attention),
                      ({"attn_span": True, "span_lo": span_lo},
                       attention_span)):
        before = mod.launches
        assert torch.isfinite(run(**rung)).all()
        assert mod.launches == before + 1
