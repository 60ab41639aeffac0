"""The port's span attention (plain versions of `csrc/attn_span_fwd.cu` and
`csrc/attn_span_bwd.cu`) against the JAX package's `fused_attention_span`
(Pallas kernels `_attn_sp_kernel` / `_attn_sp_bwd_kernel` in interpret
mode, forward and `jax.grad`), the span rung of the model against the JAX
model's, a JAX-saved span member in the port, and, on a GPU, the CUDA
kernels against their plain versions."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from gnnep_tpu.data.batching import measure_span64, measure_win64  # noqa: E402
from gnnep_tpu.models import alignn as jm  # noqa: E402
from gnnep_tpu.ops.pallas import csr_attention as jmod  # noqa: E402
from gnnep_tpu.train import artifacts as ja  # noqa: E402
from gnnep_tpu.utils.synth import synthetic_batch  # noqa: E402
from gnnep_tpu_torch.models import alignn as pm  # noqa: E402
from gnnep_tpu_torch.ops import dense_attention as pda  # noqa: E402
from gnnep_tpu_torch.ops.cuda import attention_eproj as ep  # noqa: E402
from gnnep_tpu_torch.ops.cuda import attention_span as sp  # noqa: E402
from gnnep_tpu_torch.ops.cuda import segment_sum as ss  # noqa: E402
from gnnep_tpu_torch.train import artifacts as pa  # noqa: E402

NAMES = ("dq", "dkvn", "dea", "dw")


@pytest.fixture(scope="module")
def batch():
    """`tests/test_span_attention.py`'s fixture: 8 graphs."""
    return synthetic_batch(np.random.default_rng(7), n_graphs=8,
                           mean_atoms=6, degree=6)


def _spans(batch):
    return measure_span64(np.asarray(batch.node_graph),
                          np.asarray(batch.edge_dst),
                          np.asarray(batch.edge_mask), batch.y.shape[0])


def _case(batch, seed=0, hidden=64, heads=2):
    """Kernel inputs at the fixture's line-graph conv (hidden 64, 2 heads)
    with the hazards: an all-masked row, masked interior edges inside real
    rows, empty rows (the arena's padding targets), the dummy row's masked
    tail, padding src values on dead edges, and a dropout scale."""
    rng = np.random.default_rng(seed)
    n, e_total = batch.edge_src.shape[0], batch.lg_src.shape[0]
    dst = np.asarray(batch.lg_dst, np.int64)
    mask = np.asarray(batch.lg_mask, np.float32).copy()
    dead_row = int(dst[np.nonzero(mask)[0][3]])
    mask[dst == dead_row] = 0.0
    live = np.nonzero(mask)[0]
    mask[rng.choice(live, size=live.size // 10, replace=False)] = 0.0
    row_ptr = np.asarray(batch.lg_row_ptr, np.int32)
    deg = np.diff(row_ptr)
    assert (deg[:-1] == 0).any() and deg[-1] > 0, "no empty row or tail"
    _, bsp = _spans(batch)

    def normal(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    return dict(q=normal(n, hidden), kvn=normal(n, 2 * hidden),
                ea=normal(e_total, hidden),
                w_edge=normal(hidden, hidden, s=0.1), mask=mask,
                scale=((rng.random((heads, e_total)) > 0.25) / 0.75
                       ).astype(np.float32),
                row_ptr=row_ptr, src=np.asarray(batch.lg_src, np.int64),
                dst=dst, span_lo=np.asarray(batch.bond_span_lo),
                span=min(bsp, n), heads=heads, dead_row=dead_row,
                deg=int(batch.lg_in_edges.shape[1]),
                win64=((measure_win64(dst, n) + 31) // 32) * 32)


def _jax_args(c, dtype):
    return [jnp.asarray(c[k]).astype(dtype)
            for k in ("q", "kvn", "ea", "w_edge")]


def _jax_kw(c):
    return dict(heads=c["heads"], max_in_degree=c["deg"], span=c["span"],
                win64=c["win64"], scale_t=jnp.asarray(c["scale"]),
                mask_e=jnp.asarray(c["mask"]))


def _jax_forward(c, dtype):
    """(out, max, denom) of the Pallas kernel, interpret mode, at the block
    size and window `fused_attention_span` picks."""
    n, e_total = c["q"].shape[0], c["ea"].shape[0]
    hidden = c["q"].shape[1]
    bn = jmod.pick_block_n_attn_sp(
        n, n, e_total, c["deg"], hidden, c["ea"].shape[1], c["span"],
        win64=c["win64"], itemsize=jnp.dtype(dtype).itemsize)
    assert bn is not None, "the fixture misses the span preconditions"
    cap = jmod._win_cap(bn, c["deg"], e_total, c["win64"])
    out, stats = jmod._attn_sp_forward(
        *_jax_args(c, dtype), jnp.asarray(c["scale"]),
        jnp.asarray(c["mask"]).reshape(1, -1),
        jnp.asarray(c["src"], jnp.int32).reshape(1, -1),
        jnp.asarray(c["span_lo"], jnp.int32), jnp.asarray(c["row_ptr"]),
        heads=c["heads"], block_n=bn, cap=cap, span=c["span"],
        interpret=True)
    stats = np.asarray(stats)
    h = c["heads"]
    return np.asarray(out), stats[:, :h], stats[:, 128:128 + h]


def _t(c, key, dtype, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(c[key])).to(device, dtype)


def _port_inputs(c, dtype, device="cpu"):
    """(q, kvn, ea, w_edge) in `dtype` and the rest of the kernels' inputs
    (scale_t, mask2, row_ptr, src, dst)."""
    floats = [_t(c, k, dtype, device) for k in ("q", "kvn", "ea", "w_edge")]
    rest = (_t(c, "scale", torch.float32, device),
            _t(c, "mask", torch.float32, device),
            _t(c, "row_ptr", torch.int32, device),
            _t(c, "src", torch.int64, device),
            _t(c, "dst", torch.int64, device))
    return floats, rest


def _port_forward(c, dtype, device="cpu"):
    (q, kvn, ea, we), (scale, mask, row_ptr, src, dst) = _port_inputs(
        c, dtype, device)
    return sp.fused_attention_span(q, kvn, ea, we, row_ptr, src, dst,
                                   heads=c["heads"], scale_t=scale,
                                   mask_e=mask, return_stats=True)


# f32 at the Pallas kernel tests' tolerance (test_pallas_kernel.py:59). bf16
# at 1e-4: both sides round e, k, v and α at the same points; the largest
# difference measured here was 4.8e-7 (denom; out 1.2e-7, of values up to
# ~6). One bf16 step of e or α flipping would show as ~1e-2.
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-4)])
def test_plain_matches_pallas_span(batch, dtype, tol):
    c = _case(batch)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = _jax_forward(c, jd)
    got = _port_forward(c, td)
    for name, a, b in zip(("out", "max", "denom"), got, want):
        assert a.dtype == torch.float32, name
        # the dummy row n-1 owns the tail padding: unspecified, not compared
        np.testing.assert_allclose(a.numpy()[:-1], np.asarray(b)[:-1],
                                   rtol=tol, atol=tol, err_msg=name)
    # the all-masked row and the empty rows: out 0, max -1e30, denom 1e-16
    empty = np.nonzero(np.diff(c["row_ptr"])[:-1] == 0)[0][:3]
    for row in (c["dead_row"], *empty):
        assert not got[0][row].any()
        assert (got[1][row] == -1e30).all() and (got[2][row] == 1e-16).all()


def _cotangent(c, seed=3, scale=1.0):
    return (np.random.default_rng(seed).normal(size=c["q"].shape)
            * scale).astype(np.float32)


def _jax_grads(c, g, dtype):
    src, row_ptr = jnp.asarray(c["src"]), jnp.asarray(c["row_ptr"])
    span_lo = jnp.asarray(c["span_lo"])

    def loss(q, kvn, ea, we):
        out = jmod.fused_attention_span(q, kvn, ea, we, row_ptr, src,
                                        span_lo, interpret=True, **_jax_kw(c))
        return (out * jnp.asarray(g)).sum()

    return [np.asarray(x, np.float32) for x in
            jax.grad(loss, argnums=(0, 1, 2, 3))(*_jax_args(c, dtype))]


def _port_grads(c, g, dtype, device="cpu"):
    (q, kvn, ea, we), (scale, mask, row_ptr, src, dst) = _port_inputs(
        c, dtype, device)
    leaves = [t.requires_grad_() for t in (q, kvn, ea, we)]
    out = sp.fused_attention_span(*leaves, row_ptr, src, dst,
                                  heads=c["heads"], scale_t=scale,
                                  mask_e=mask)
    (out * torch.from_numpy(g).to(device)).sum().backward()
    return [t.grad for t in leaves]


def _compare(got, want, c):
    """dq on the real rows, dkvn on every node row, dea on the live edges
    and dW_e in full; dead edges' dea rows and the dummy row's dq must be
    exact zeros."""
    n = c["q"].shape[0]
    live = (c["mask"] > 0) & (c["dst"] != n - 1)
    for name, a, b in zip(NAMES, got, want):
        a = a.float().cpu().numpy()
        if name == "dq":
            assert not a[-1].any(), "dq of the dummy row must be zero"
            a, b = a[:-1], b[:-1]
        elif name == "dea":
            assert not a[~live].any(), "dea of dead edges must be zero"
            a, b = a[live], b[live]
        yield name, a, b


def test_plain_bwd_matches_pallas_f32(batch):
    """f32 at the Pallas attention gradient test's tolerance
    (test_pallas_kernel.py:314-320): the node-space sum of the port (f32,
    in another order) and of the TPU kernel (f32 per block) agree there.
    The cotangent is scaled by 1/4: dW_e sums some 1,000 edges' products,
    and at a unit cotangent its entries reach 60, where the f32 summation
    order alone moves them by 3.4e-5, above the 1e-5 floor; scaled, the
    largest difference uses 0.34 of the limit (dW_e), the others 0.02."""
    c = _case(batch)
    g = _cotangent(c, scale=0.25)
    want = _jax_grads(c, g, jnp.float32)
    got = _port_grads(c, g, torch.float32)
    assert [t.dtype for t in got] == [torch.float32] * 4
    for name, a, b in _compare(got, want, c):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)


def test_plain_bwd_matches_pallas_bf16(batch):
    """bf16: both sides round g, dl, α and each edge's dk and dv at the same
    points, but the TPU kernel keeps its node-space dkvn in bf16 and rounds
    it after every block, while the port sums in f32 and rounds once: dkvn
    differs by a bf16 step of its larger partial sums. The largest
    difference measured here was 2.6e-3 of the largest magnitude (dkvn; the
    others below 1e-5), so the scaled atol is 1e-2."""
    c = _case(batch)
    g = _cotangent(c)
    want = _jax_grads(c, g, jnp.bfloat16)
    got = _port_grads(c, g, torch.bfloat16)
    assert [t.dtype for t in got] == [torch.bfloat16] * 4
    for name, a, b in _compare(got, want, c):
        sc = max(np.abs(b).max(), 1.0)
        np.testing.assert_allclose(a / sc, b / sc, atol=1e-2, err_msg=name)


def test_plain_equals_eproj_on_gathered_kv(batch):
    """The counterpart of `test_span_attention.py:62-101`: the span plain
    versions equal the eproj ones on kvn[src], and dkvn is the eproj dkv
    folded into node space by the kv gather's own backward (the CSR
    segment-sum over the source-sorted order)."""
    c = _case(batch)
    (q, kvn, ea, we), (scale, mask, row_ptr, src, dst) = _port_inputs(
        c, torch.float32)
    heads = c["heads"]
    fwd = sp.attention_span_plain(q, kvn, ea, we, scale, mask, src, dst,
                                  heads=heads)
    ref = ep.attention_eproj_plain(q, kvn[src], ea, we, scale, mask, dst,
                                   heads=heads)
    for a, b in zip(fwd, ref):
        assert torch.equal(a, b)
    g = torch.from_numpy(_cotangent(c))
    dq, dkvn, dea, dw = sp.attention_span_bwd_plain(
        q, kvn, ea, we, scale, mask, row_ptr, src, dst, g, fwd[1], fwd[2],
        heads=heads)
    edq, dkv, edea, edw = ep.attention_eproj_bwd_plain(
        q, kvn[src], ea, we, scale, mask, row_ptr, dst, g, fwd[1], fwd[2],
        heads=heads)
    order = torch.from_numpy(np.argsort(c["src"], kind="stable").astype(
        np.int32))
    starts = torch.searchsorted(src[order.long()],
                                torch.arange(kvn.shape[0])).to(torch.int32)
    folded = ss.csr_segment_sum_plain(dkv, order, starts)
    for a, b in ((dq, edq), (dea, edea), (dw, edw)):
        assert torch.equal(a, b)
    torch.testing.assert_close(dkvn, folded, rtol=1e-6, atol=1e-6)


def test_all_masked_rows_give_finite_zero_grads(batch):
    c = _case(batch)
    c["mask"][:] = 0.0
    got = _port_grads(c, _cotangent(c), torch.float32)
    for name, t in zip(NAMES, got):
        assert torch.isfinite(t).all() and not t.any(), name


def test_cpu_tensors_take_the_plain_versions(batch):
    c = _case(batch)
    before = (sp.launches, sp.bwd_launches)
    _port_grads(c, _cotangent(c), torch.float32)
    assert (sp.launches, sp.bwd_launches) == before


# ------------------------------------------------- the rung in the model
def _model_cfg(batch, **kw):
    nsp, bsp = _spans(batch)
    return jm.AlignnConfig(
        node_dim=batch.nodes.shape[1], edge_dim=batch.edge_attr.shape[1],
        angle_dim=batch.lg_attr.shape[1],
        global_dim=batch.globals_.shape[1] + 230, hidden=32, layers=2,
        heads=2, dropout=0.0, conv_impl="fused", force_fused=True,
        attn_span=True, edge_span64=nsp, lg_span64=bsp, **kw)


def _count(monkeypatch, mod, name, calls):
    real = getattr(mod, name)

    def counted(*a, **k):
        calls[name] = calls.get(name, 0) + 1
        return real(*a, **k)

    monkeypatch.setattr(mod, name, counted)


def _forbid_kv_gather(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the span rung gathered an edge-space kv")

    monkeypatch.setattr(pda, "csr_gather_ordered", refuse)


def test_forward_matches_jax_on_span_rung(batch, tmp_path, monkeypatch):
    """`alignn_apply` with a span config: the JAX model really runs
    `fused_attention_span` (its preconditions hold at this size), the port
    runs the span plain version in both convs of each layer and no kv
    gather, and the means and log-variances agree at the model tests'
    tolerance (test_torch_eproj.py:106-107)."""
    cfg = _model_cfg(batch)
    params = jm.init_alignn(jax.random.PRNGKey(3), cfg)
    ja.save_member(tmp_path / "model_0.npz", params, cfg)
    j_calls, p_calls = {}, {}
    _count(monkeypatch, jmod, "fused_attention_span", j_calls)
    want = jm.alignn_apply(params, cfg, batch)
    assert j_calls == {"fused_attention_span": 2 * cfg.layers}
    model = pa.load_member(tmp_path / "model_0.npz", "cpu")
    _count(monkeypatch, sp, "attention_span_plain", p_calls)
    _count(monkeypatch, ep, "attention_eproj_plain", p_calls)
    _forbid_kv_gather(monkeypatch)
    with torch.inference_mode():
        got = pm.alignn_apply(model, pm.DeviceBatch.from_batch(batch, "cpu"))
    assert p_calls == {"attention_span_plain": 2 * cfg.layers}
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-3,
                                   atol=1e-4)


def test_jax_span_member_loads_and_serves_on_eproj(batch, tmp_path,
                                                   monkeypatch):
    """A member the JAX package saved with `conv_impl='fused'`,
    `attn_span=True` and measured bounds loads in the port with those
    fields intact and runs the span rung through `alignn_apply`; served
    through the port's ensemble (`infer/predict.py`), whose eval repack
    clears the bounds (`reconcile_win64`) as the JAX package's does, the
    same member runs the eproj rung."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    from synthetic import make_samples

    from gnnep_tpu.data.store import GraphStore as JStore
    from gnnep_tpu.data.transforms import FeatureScaler, LogTransformer
    from gnnep_tpu_torch.data.featurize import GraphSample as PSample
    from gnnep_tpu_torch.data.store import GraphStore as PStore
    from gnnep_tpu_torch.infer import predict as pp

    samples = make_samples(6, seed=4)
    store = JStore.from_samples(samples)
    nsp, bsp = _spans(batch)
    cfg = jm.AlignnConfig(
        node_dim=store.node_dim, edge_dim=store.edge_dim,
        angle_dim=store.angle_dim, global_dim=store.global_scalar_dim + 230,
        target_dim=2, hidden=16, layers=1, heads=2, dropout=0.0,
        conv_impl="fused", attn_span=True, edge_span64=nsp, lg_span64=bsp)
    ens = tmp_path / "ensemble"
    ens.mkdir()
    ja.save_member(ens / "model_0.npz",
                   jm.init_alignn(jax.random.PRNGKey(7), cfg), cfg)
    ja.save_scaler_state(ens / "scaler_state.npz",
                         FeatureScaler.fit(store, range(6)),
                         LogTransformer.fit(store.y),
                         dims={"global_scalar_dim": store.global_scalar_dim})
    member = pa.load_member(ens / "model_0.npz", "cpu")
    assert (member.cfg.conv_impl, member.cfg.attn_span,
            member.cfg.edge_span64, member.cfg.lg_span64) == (
                "fused", True, nsp, bsp)
    calls = {}
    _count(monkeypatch, sp, "attention_span_plain", calls)
    _count(monkeypatch, ep, "attention_eproj_plain", calls)
    pstore = PStore.from_samples([
        PSample(**{f.name: getattr(s, f.name)
                   for f in dataclasses.fields(PSample)}) for s in samples])
    _, batches = pp.pack_batches(pstore, range(6), 6)
    with torch.inference_mode():
        pm.alignn_apply(member, pm.DeviceBatch.from_batch(batches[0], "cpu"))
    assert calls == {"attention_span_plain": 2}
    calls.clear()
    p_ens = pp.Ensemble.load(ens, device="cpu")
    got = p_ens.predict(p_ens.scaler.apply(pstore), range(6), batch_size=3)
    assert calls == {"attention_eproj_plain": 2 * 2}      # 2 batches
    assert len(got) == 6 and all(np.isfinite(r["mu"]).all() for r in got)


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
@pytest.mark.parametrize("hidden,heads", [(64, 2), (256, 4)])
def test_kernels_match_plain_on_card(batch, cuda, dtype, tol, hidden, heads):
    """Kernels 8 and 9 against their plain versions, each output within
    `tol` of the plain tensor's largest magnitude (forward on the real rows,
    backward as `_compare`); the dead edges' src set out of range, which the
    kernels must never read, and the plain versions given an in-range
    copy."""
    c = _case(batch, seed=11, hidden=hidden, heads=heads)
    (q, kvn, ea, we), (scale, mask, row_ptr, src, dst) = _port_inputs(
        c, dtype, cuda)
    bad_src = torch.where(mask > 0, src, src + 10 ** 9)
    before = (sp.launches, sp.bwd_launches)
    got = sp.attention_span_cuda(q, kvn, ea, we, scale, mask, row_ptr,
                                 bad_src, dst, heads=heads)
    want = sp.attention_span_plain(q, kvn, ea, we, scale, mask, src, dst,
                                   heads=heads)
    for a, b in zip(got, want):
        sc = max(b[:-1].abs().max().item(), 1e-30)
        torch.testing.assert_close(a[:-1] / sc, b[:-1] / sc, rtol=tol,
                                   atol=tol)
    g = torch.from_numpy(_cotangent(c)).to(cuda)
    bwd = sp.attention_span_bwd_cuda(q, kvn, ea, we, scale, mask, row_ptr,
                                     bad_src, dst, g, got[1], got[2],
                                     heads=heads)
    torch.cuda.synchronize()
    assert (sp.launches, sp.bwd_launches) == (before[0] + 1, before[1] + 1)
    ref = sp.attention_span_bwd_plain(q, kvn, ea, we, scale, mask, row_ptr,
                                      src, dst, g, got[1], got[2],
                                      heads=heads)
    for name, a, b in _compare(bwd, [r.float().cpu().numpy() for r in ref],
                               c):
        sc = max(np.abs(b).max(), 1e-30)
        np.testing.assert_allclose(a / sc, b / sc, rtol=tol, atol=tol,
                                   err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("heads,hidden,fe", [(4, 256, 36), (2, 16, 16),
                                             (2, 192, 36)])
def test_bwd_kernel_odd_shapes_on_card(cuda, dtype, tol, heads, hidden, fe):
    """Kernel 9 on the eproj tests' odd shapes (`_odd_case`: a 1,200-edge
    hub, a tile of dead edges, Fe 36, E not a multiple of 64, head widths
    64, 8 and 96) over a node table of n + 7 rows, dead edges' src out of
    range: each output within `tol` of the plain tensor's largest
    magnitude, dead edges' dea rows and the dummy row's dq exact zeros."""
    from test_torch_eproj_bwd import _card_args, _has_dead_tile, _odd_case
    rng = np.random.default_rng(23)
    c = _odd_case(rng, heads, hidden, fe)
    assert c["kv"].shape[0] % 64 and _has_dead_tile(c, cuda)
    n, e_total = c["q"].shape[0], c["kv"].shape[0]
    live = c["mask"] > 0
    src = rng.integers(0, n + 6, e_total)
    kvn = torch.from_numpy(rng.normal(size=(n + 7, 2 * hidden))).to(
        cuda, dtype)
    q, _, ea, we, scale, mask, row_ptr, dst, g, _, _ = _card_args(
        c, _cotangent(c), dtype, cuda)
    fwd = (q, kvn, ea, we, scale, mask)
    src_plain = torch.from_numpy(np.where(live, src, 0)).to(cuda)
    _, mx, den = sp.attention_span_plain(*fwd, src_plain, dst, heads=heads)
    got = sp.attention_span_bwd_cuda(
        *fwd, row_ptr, torch.from_numpy(np.where(live, src, 10 ** 9)).to(cuda),
        dst, g, mx, den, heads=heads)
    torch.cuda.synchronize()
    want = sp.attention_span_bwd_plain(*fwd, row_ptr, src_plain, dst, g, mx,
                                       den, heads=heads)
    for name, a, b in zip(NAMES, got, want):
        a, b = a.float().cpu().numpy(), b.float().cpu().numpy()
        if name == "dq":
            assert not a[-1].any(), "dq of the dummy row must be zero"
            a, b = a[:-1], b[:-1]
        elif name == "dea":
            assert not a[~live].any(), "dea of dead edges must be zero"
            a, b = a[live], b[live]
        assert np.abs(a - b).max() <= tol * np.abs(b).max(), name
