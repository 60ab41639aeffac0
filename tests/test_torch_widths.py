"""Widths the JAX package trains and the card used to refuse: Fe = hidden
above 256 and a head width above 128, at (hidden 512, heads 4), (hidden
256, heads 1) and (hidden 384, heads 2) (a head width of 192, not a power
of two).

On the CPU: the trainer's option check, the model constructor and every
kernel wrapper's input check refuse none of them, and the port's forward
and one train step equal the JAX package's on the same numpy-seeded batch
and parameters (the JAX side on its fused rungs, Pallas kernels in
interpret mode), on the eproj, kv+e and external-logits rungs. On a GPU:
each of kernels 1-6, 8 and 9 against its plain version at these widths."""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from synthetic import make_store  # noqa: E402

from gnnep_tpu.data.batching import BatchBudget, BatchPacker  # noqa: E402
from gnnep_tpu.models import alignn as jm  # noqa: E402
from gnnep_tpu.train import artifacts as ja  # noqa: E402
from gnnep_tpu_torch.models import alignn as pm  # noqa: E402
from gnnep_tpu_torch.ops.cuda import aggregate as ag  # noqa: E402
from gnnep_tpu_torch.ops.cuda import attention as at  # noqa: E402
from gnnep_tpu_torch.ops.cuda import attention_eproj as ep  # noqa: E402
from gnnep_tpu_torch.ops.cuda import attention_span as sp  # noqa: E402
from gnnep_tpu_torch.ops.cuda import build  # noqa: E402
from gnnep_tpu_torch.train import artifacts as pa  # noqa: E402
from gnnep_tpu_torch.train.config import TrainConfig  # noqa: E402
from gnnep_tpu_torch.train.ensemble import check_supported  # noqa: E402

from test_torch_eproj import _case  # noqa: E402
from test_torch_train import _step_parity  # noqa: E402

# (hidden, heads): head widths 128, 256 and 192, Fe = hidden
WIDTHS = [(512, 4), (256, 1), (384, 2)]
IDS = [f"h{h}x{k}" for h, k in WIDTHS]
# the rungs under conv_impl='fused': the config field each turns off
RUNGS = {"eproj": {}, "kv+e": {"attn_eproj": False},
         "logits": {"attn_fused": False}}
# f32 forward: the JAX package's fused-vs-table model tolerance
# (test_torch_model.py)
RTOL, ATOL = 1e-3, 1e-4


@pytest.mark.parametrize("hidden,heads", WIDTHS, ids=IDS)
def test_trainer_and_model_take_the_width(hidden, heads):
    check_supported(TrainConfig(hidden=hidden, heads=heads))
    check_supported(TrainConfig(hidden=256, member_hiddens=[hidden],
                                heads=heads))
    cfg = pm.AlignnConfig(node_dim=8, edge_dim=4, angle_dim=3, global_dim=5,
                          target_dim=2, hidden=hidden, layers=1, heads=heads)
    model = pm.init_alignn(np.random.default_rng(0), cfg)
    names = dict(model.named_parameters())
    # Fe = hidden: the conv's edge projection is [hidden, hidden]
    w_edge = [p for n, p in names.items() if n.endswith("w_edge")]
    assert w_edge and all(tuple(p.shape) == (hidden, hidden)
                          for p in w_edge)


@pytest.mark.parametrize("hidden,heads", WIDTHS, ids=IDS)
def test_every_wrapper_check_takes_the_width(monkeypatch, hidden, heads):
    """The kernel wrappers' shape and type checks (the device check aside,
    which needs a card) accept every (hidden, heads) that passes
    `hidden % heads`, at Fe = hidden: kernels 1-6, 8 and 9."""
    monkeypatch.setattr(build, "check_card_tensors", lambda tensors: None)
    c = _case(np.random.default_rng(1), n=8, heads=heads, hidden=hidden,
              fe=hidden)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in c.items()
         if k != "heads"}
    q, kv, ea, w = t["q"], t["kv"], t["ea"], t["w_edge"]
    scale, mask = t["scale"], t["mask"]
    row_ptr, dst = t["row_ptr"], t["dst"].long()
    n, e_total = q.shape[0], kv.shape[0]
    g = torch.zeros((n, hidden))
    st = torch.zeros((n, heads))
    stats = (("g", g, torch.float32, (n, hidden)),
             ("max", st, torch.float32, (n, heads)),
             ("denom", st, torch.float32, (n, heads)))
    want = (n, hidden, e_total, hidden, hidden // heads)
    # kernels 5 and 6
    assert ep._check_inputs(q, kv, ea, w, scale, mask, row_ptr, dst,
                            heads=heads) == want
    assert ep._check_inputs(q, kv, ea, w, scale, mask, row_ptr, dst,
                            heads=heads, extra=stats) == want
    # kernels 8 and 9: kv is a node table
    kvn = torch.zeros((n + 3, 2 * hidden))
    src = (("src", dst, torch.int64, (e_total,)),)
    assert ep._check_inputs(q, kvn, ea, w, scale, mask, row_ptr, dst,
                            heads=heads, extra=src + stats,
                            node_kv=True) == want
    # kernels 3 and 4
    k, v = kv[:, :hidden].contiguous(), kv[:, hidden:].contiguous()
    assert at._check_inputs(q, k, v, scale, mask, row_ptr,
                            heads=heads) == (n, hidden, e_total)
    assert at._check_inputs(
        q, k, v, scale, mask, row_ptr, heads=heads,
        extra=tuple((name, x, shape) for name, x, _, shape in stats)) == (
            n, hidden, e_total)
    # kernels 1 and 2, whose logits and scale are [E, heads]
    scale_e = scale.t().contiguous()
    assert ag._check_inputs(scale_e, scale_e, v, row_ptr, heads=heads) == (
        n, hidden, e_total)
    assert ag._check_inputs(
        scale_e, scale_e, v, row_ptr, heads=heads,
        extra=(("g", g, lambda n_, h_: (n_, h_)),
               ("max", st, lambda n_, h_: (n_, heads)))) == (
            n, hidden, e_total)


@pytest.fixture(scope="module")
def batch():
    store = make_store(2, seed=21)
    budget = BatchBudget.plan(store, range(2), batch_size=2)
    # 128-divisible arenas, so that the JAX fused path takes its Pallas
    # rungs (as test_torch_model.py does)
    budget = dataclasses.replace(budget, n_nodes=128, n_edges=256,
                                 n_lg_edges=512)
    b = next(iter(BatchPacker(store, budget).pack(range(2))))
    return store, b


def _jax_cfg(store, hidden, heads, rung):
    return jm.AlignnConfig(
        node_dim=store.node_dim, edge_dim=store.edge_dim,
        angle_dim=store.angle_dim, global_dim=store.global_scalar_dim + 230,
        target_dim=2, hidden=hidden, layers=1, heads=heads, dropout=0.0,
        conv_impl="fused", force_fused=True, **RUNGS[rung])


@pytest.mark.parametrize("rung", list(RUNGS))
@pytest.mark.parametrize("hidden,heads", WIDTHS, ids=IDS)
def test_forward_matches_jax_at_width(batch, tmp_path, hidden, heads, rung):
    """The eval forward from one `model_0.npz` written by the JAX package,
    every activation at the f32 model tolerance."""
    store, b = batch
    cfg = _jax_cfg(store, hidden, heads, rung)
    params = jm.init_alignn(jax.random.PRNGKey(hidden + heads), cfg)
    path = tmp_path / "model_0.npz"
    ja.save_member(path, params, cfg)
    want = jm.alignn_activations(params, cfg, b)
    model = pa.load_member(path, "cpu")
    assert (model.cfg.hidden, model.cfg.heads) == (hidden, heads)
    with torch.inference_mode():
        got = pm.alignn_activations(model, pm.DeviceBatch.from_batch(b, "cpu"))
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(value),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("rung", list(RUNGS))
@pytest.mark.parametrize("hidden,heads", WIDTHS, ids=IDS)
def test_train_step_matches_jax_at_width(batch, hidden, heads, rung):
    """One train step (loss, metrics, every gradient and updated parameter
    at rtol 5e-3 / atol 1e-4) through `test_torch_train._step_parity`. At
    these widths a few of a leaf's 10^5 elements have a gradient near
    Adam's eps (1e-8), where the first step g / (|g| + eps) is not
    conditioned: they are held to that step's bound only (elements below
    1e-6, `tiny_grad`), as chip_smoke's card-vs-CPU step check leaves them
    out."""
    store, b = batch
    cfg = _jax_cfg(store, hidden, heads, rung)
    ys = np.asarray(b.y)[np.asarray(b.graph_mask) > 0]
    fx = dict(batch=b, cfg=cfg,
              params=jm.init_alignn(jax.random.PRNGKey(7), cfg),
              means=np.log(ys).mean(0).astype(np.float32),
              stds=np.log(ys).std(0).astype(np.float32) + 0.1)
    _step_parity(fx, cfg, "adamw", tiny_grad=1e-6)


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels have no CPU "
                    "mode (run `python3 chip_smoke.py` or this file on one)")
    from gnnep_tpu_torch.utils.device import resolve_device
    return resolve_device("cuda")


def _card_case(hidden, heads, dtype, device, seed=5):
    c = _case(np.random.default_rng(seed), n=40, heads=heads, hidden=hidden,
              fe=hidden)
    rng = np.random.default_rng(seed + 1)

    def t(x, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device, dt)

    # W_e scaled by sqrt(16 / Fe), as chip_smoke's `eproj_case` draws it:
    # e keeps unit scale at every Fe (at Fe 512, W_e x 0.3 gives e of
    # scale 7 and a softmax so peaked that bf16's rounding of e decides it)
    c["w_edge"] = c["w_edge"] * np.float32(np.sqrt(16 / hidden))
    n, e_total = c["q"].shape[0], c["kv"].shape[0]
    live = c["mask"] > 0
    src = rng.integers(0, n + 2, e_total)
    logits = np.where(live[None], rng.normal(size=(heads, e_total)) * 2,
                      -1e30).astype(np.float32)
    return dict(
        q=t(c["q"]), kv=t(c["kv"]), ea=t(c["ea"]), w=t(c["w_edge"]),
        scale=t(c["scale"], torch.float32), mask=t(c["mask"], torch.float32),
        row_ptr=t(c["row_ptr"], torch.int32), dst=t(c["dst"], torch.int64),
        kvn=t(rng.normal(size=(n + 3, 2 * hidden))),
        src=t(np.where(live, src, n + 10 ** 6), torch.int64),
        src_plain=t(np.where(live, src, 0), torch.int64),
        logits=t(logits, torch.float32),
        g=torch.from_numpy(rng.normal(size=(n, hidden)).astype(
            np.float32)).to(device),
        live=t(live & (c["dst"] != n - 1), torch.bool), heads=heads)


def _near(got, want, tol, what):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all(), what
    sc = max(want.abs().max().item(), 1.0)
    err = (got - want).abs().max().item() if got.numel() else 0.0
    assert err <= tol * sc, f"{what}: {err:.3e} > {tol} x {sc:.3e}"


def _run(kernel, c):
    """(kernel outputs, plain outputs, {name: rows that must be exact
    zeros}) of one kernel on the case."""
    h = c["heads"]
    fwd = (c["q"], c["kv"], c["ea"], c["w"], c["scale"], c["mask"])
    span = (c["q"], c["kvn"], c["ea"], c["w"], c["scale"], c["mask"])
    k_e = c["kv"][:, :c["q"].shape[1]].contiguous()
    v_e = c["kv"][:, c["q"].shape[1]:].contiguous()
    att = (c["q"], k_e, v_e, c["scale"], c["mask"])
    # kernels 1 and 2 take [E, heads] logits and scale
    agg = (c["logits"].t().contiguous(), c["scale"].t().contiguous(), v_e,
           c["row_ptr"])
    dead = ~c["live"]
    if kernel == "attn_eproj_fwd":
        return (ep.attention_eproj_cuda(*fwd, c["row_ptr"], c["dst"], heads=h),
                ep.attention_eproj_plain(*fwd, c["dst"], heads=h), {})
    if kernel == "attn_span_fwd":
        return (sp.attention_span_cuda(*span, c["row_ptr"], c["src"],
                                       c["dst"], heads=h),
                sp.attention_span_plain(*span, c["src_plain"], c["dst"],
                                        heads=h), {})
    if kernel == "attn_fwd":
        return (at.attention_cuda(*att, c["row_ptr"], heads=h),
                at.attention_plain(*att, c["dst"], heads=h), {})
    if kernel == "softmax_aggregate_fwd":
        return (ag.aggregate_cuda(*agg, heads=h),
                ag.aggregate_plain(*agg, c["dst"], heads=h), {})
    if kernel == "attn_eproj_bwd":
        _, mx, den = ep.attention_eproj_plain(*fwd, c["dst"], heads=h)
        args = fwd + (c["row_ptr"], c["dst"], c["g"], mx, den)
        return (ep.attention_eproj_bwd_cuda(*args, heads=h),
                ep.attention_eproj_bwd_plain(*args, heads=h),
                {1: dead, 2: dead})
    if kernel == "attn_span_bwd":
        _, mx, den = sp.attention_span_plain(*span, c["src_plain"], c["dst"],
                                             heads=h)
        tail = (c["dst"], c["g"], mx, den)
        return (sp.attention_span_bwd_cuda(*span, c["row_ptr"], c["src"],
                                           *tail, heads=h),
                sp.attention_span_bwd_plain(*span, c["row_ptr"],
                                            c["src_plain"], *tail, heads=h),
                {2: dead})
    if kernel == "attn_bwd":
        _, mx, den = at.attention_plain(*att, c["dst"], heads=h)
        args = att + (c["row_ptr"], c["g"], mx, den)
        return (at.attention_bwd_cuda(*args, heads=h),
                at.attention_bwd_plain(*att, c["row_ptr"], c["dst"], c["g"],
                                       mx, den, heads=h),
                {1: dead, 2: dead})
    _, mx, den = ag.aggregate_plain(*agg, c["dst"], heads=h)
    args = agg + (c["g"], mx, den)
    got = ag.aggregate_bwd_cuda(*args, heads=h)
    want = ag.aggregate_bwd_plain(*agg[:4], c["dst"], c["g"], mx, den,
                                  heads=h)
    return got, want, {0: dead, 1: dead}


KERNELS = ("softmax_aggregate_fwd", "softmax_aggregate_bwd", "attn_fwd",
           "attn_bwd", "attn_eproj_fwd", "attn_eproj_bwd", "attn_span_fwd",
           "attn_span_bwd")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("hidden,heads", WIDTHS, ids=IDS)
def test_kernel_matches_plain_at_width_on_card(cuda, hidden, heads, kernel,
                                               dtype, tol):
    """Each output within `tol` of the plain tensor's largest magnitude
    (kernels 5 and 8's out also elementwise); forward outputs on the real
    rows; the dead edges' gradient rows and the dummy row's dq exact
    zeros."""
    c = _card_case(hidden, heads, dtype, cuda)
    got, want, zeros = _run(kernel, c)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        what = f"{kernel} output {i}"
        if kernel.endswith("_fwd") or (kernel != "softmax_aggregate_bwd"
                                       and i == 0):
            assert not (kernel.endswith("_bwd") and a[-1].any()), \
                f"{what}: dq of the dummy row is not zero"
            a, b = a[:-1], b[:-1]
        if i in zeros:
            assert not a[zeros[i]].any(), f"{what}: dead rows are not zero"
            a, b = a[~zeros[i]], b[~zeros[i]]
        if kernel in ("attn_eproj_fwd", "attn_span_fwd") and i == 0:
            # elementwise, at chip_smoke's `check_case` tolerances
            rtol, atol = (1e-4, 1e-5) if dtype == torch.float32 else (
                0.05, 0.05)
            assert torch.allclose(a.float(), b.float(), rtol=rtol,
                                  atol=atol), f"{what}: elementwise"
        if kernel.endswith("_fwd") and i == 1:
            # the max: exactly -1e30 where a row has no live edge
            empty = b <= -0.5e30
            assert (a[empty] == -1e30).all(), f"{what}: all-masked rows"
            a, b = a[~empty], b[~empty]
        _near(a, b, tol, what)
