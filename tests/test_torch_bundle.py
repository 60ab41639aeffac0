"""The port's AOT serving bundles (`gnnep_tpu_torch.infer.bundle`,
`cli.bundle`) and the three forward custom ops they export through:
`opcheck` of each op; each rung's exported program calls its op; export →
load → predict equal to `Ensemble.predict` to the bit on the CPU, and to the
JAX package's `Ensemble.predict` on the same checkpoints at the serving
tolerance; a self-contained bundle that refuses oversize input and another
platform; the CLI's export then predict."""
import dataclasses
import json
import pathlib
import shutil
import sys

import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from synthetic import make_samples  # noqa: E402

from gnnep_tpu.data.store import GraphStore as JStore  # noqa: E402
from gnnep_tpu.infer import predict as jp  # noqa: E402
from gnnep_tpu.models import alignn as jm  # noqa: E402
from gnnep_tpu.train import artifacts as ja  # noqa: E402
from gnnep_tpu_torch.cli import bundle as cli  # noqa: E402
from gnnep_tpu_torch.data.store import GraphStore as PStore  # noqa: E402
from gnnep_tpu_torch.data.store import save_sample, write_index  # noqa: E402
from gnnep_tpu_torch.data.transforms import (FeatureScaler,  # noqa: E402
                                             LogTransformer)
from gnnep_tpu_torch.infer import bundle as pb  # noqa: E402
from gnnep_tpu_torch.infer.predict import Ensemble  # noqa: E402
from gnnep_tpu_torch.models.alignn import AlignnConfig, init_alignn  # noqa: E402
from gnnep_tpu_torch.ops.cuda import aggregate as ag  # noqa: E402
from gnnep_tpu_torch.ops.cuda import attention as at  # noqa: E402
from gnnep_tpu_torch.ops.cuda import attention_eproj as ep  # noqa: E402
from gnnep_tpu_torch.train.artifacts import (save_member,  # noqa: E402
                                             save_scaler_state)

N_GRAPHS, BATCH = 20, 8
# the rungs: the member config fields and the op their convs export
RUNGS = {"eproj": ({}, "attn_eproj_fwd"),
         "kv+e": (dict(conv_impl="fused", attn_eproj=False), "attn_fwd"),
         "logits": (dict(conv_impl="fused", attn_fused=False),
                    "softmax_aggregate_fwd")}
SERVE_RTOL, SERVE_ATOL = 1e-3, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's default of a thread a core would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Data dir, and a 2-member ensemble (hidden 32, 2 layers) per rung."""
    root = tmp_path_factory.mktemp("bundle")
    samples = make_samples(N_GRAPHS, seed=3)
    store = PStore.from_samples(samples)
    for s in samples:
        save_sample(root / "data", s)
    write_index(root / "data", store)
    for rung, (kw, _) in RUNGS.items():
        ens = root / f"ens_{rung}"
        ens.mkdir()
        cfg = AlignnConfig(node_dim=store.node_dim, edge_dim=store.edge_dim,
                           angle_dim=store.angle_dim,
                           global_dim=store.global_scalar_dim + 230,
                           hidden=32, layers=2, heads=2, **kw)
        for i in range(2):
            save_member(ens / f"model_{i}.npz",
                        init_alignn(np.random.default_rng(i), cfg))
        save_scaler_state(ens / "scaler_state.npz",
                          FeatureScaler.fit(store, range(N_GRAPHS)),
                          LogTransformer.fit(store.y),
                          dims={"global_scalar_dim": 59})
        (ens / "conformal.json").write_text(json.dumps(
            {"q": [1.0, 1.2], "method": "scaled", "alpha": 0.1,
             "affine_a": [1.0, 1.0], "affine_b": [0.0, 0.0]}))
    return root


def _store(root):
    return PStore.load_dir(root / "data", use_cache=False)


def _export(root, rung, name=None, dtype="float32"):
    out = root / (name or f"bundle_{rung}_{dtype}")
    if not (out / "meta.json").exists():
        pb.export_bundle(root / f"ens_{rung}", _store(root), out,
                         batch_size=BATCH, compute_dtype=dtype, device="cpu")
    return out


def _assert_bitwise(got, want):
    assert [r["material_id"] for r in got] == \
        [r["material_id"] for r in want]
    for g, w in zip(got, want):
        assert g["mu"] == w["mu"] and g["sigma"] == w["sigma"]
        assert g["ci90"] == w["ci90"]


# ------------------------------------------------------------------ ops
def _conv_inputs(seed=0, n=7, heads=2, hidden=16, fe=16):
    rng = np.random.default_rng(seed)
    degs = rng.integers(0, 5, n - 1)
    dst = np.repeat(np.arange(n - 1), degs)
    e = dst.size
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    row_ptr = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(np.bincount(dst, minlength=n))]).astype(np.int32))
    mask2 = torch.from_numpy((rng.random(e) > 0.2).astype(np.float32))
    scale_t = torch.from_numpy(rng.uniform(0.5, 1.5, (heads, e))
                               .astype(np.float32))
    return dict(q=t(n, hidden), kv=t(e, 2 * hidden), ea=t(e, fe),
                w_edge=t(fe, hidden), k=t(e, hidden), v=t(e, hidden),
                logits=t(e, heads), scale=scale_t.t().contiguous(),
                scale_t=scale_t, mask2=mask2, row_ptr=row_ptr,
                dst=torch.from_numpy(dst.astype(np.int64)), heads=heads)


def _op_args(name, c):
    if name == "attn_eproj_fwd":
        return (c["q"], c["kv"], c["ea"], c["w_edge"], c["scale_t"],
                c["mask2"], c["row_ptr"], c["dst"], c["heads"])
    if name == "attn_fwd":
        return (c["q"], c["k"], c["v"], c["scale_t"], c["mask2"],
                c["row_ptr"], c["dst"], c["heads"])
    return (c["logits"], c["scale"], c["v"], c["row_ptr"], c["dst"],
            c["heads"])


OPS = {"attn_eproj_fwd": (ep, "attention_eproj_plain"),
       "attn_fwd": (at, "attention_plain"),
       "softmax_aggregate_fwd": (ag, "aggregate_plain")}


@pytest.mark.parametrize("name", sorted(OPS))
def test_opcheck(name):
    """Schema, fake (shape) function and dispatch of each forward op, on
    CPU tensors; the op's CPU kernel is the plain version."""
    c = _conv_inputs()
    op = getattr(torch.ops.gnnep_torch, name).default
    torch.library.opcheck(op, _op_args(name, c))
    mod, plain = OPS[name]
    args = _op_args(name, c)
    *tensors, heads = args
    if name == "attn_eproj_fwd":
        want = getattr(mod, plain)(*tensors[:6], tensors[7], heads=heads)
    elif name == "attn_fwd":
        want = getattr(mod, plain)(*tensors[:5], tensors[6], heads=heads)
    else:
        want = getattr(mod, plain)(*tensors, heads=heads)
    for a, b in zip(op(*args), want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(OPS))
def test_differentiable_wrapper_uses_the_op(name, monkeypatch):
    """With a gradient to take, the autograd Function's forward calls the
    op (whose backward kernels are unchanged); without one the op alone
    runs. Both equal."""
    c = _conv_inputs(seed=1)
    calls = []
    op = getattr(torch.ops.gnnep_torch, name)
    mod, plain = OPS[name]
    real = getattr(mod, plain)

    def counted(*a, **k):
        calls.append(torch.is_grad_enabled())
        return real(*a, **k)

    monkeypatch.setattr(mod, plain, counted)
    if name == "attn_eproj_fwd":
        run = lambda q: ep.fused_attention_eproj(
            q, c["kv"], c["ea"], c["w_edge"], c["row_ptr"], c["dst"],
            heads=2, scale_t=c["scale_t"], mask_e=c["mask2"])
    elif name == "attn_fwd":
        run = lambda q: at.fused_attention(
            q, c["k"], c["v"], c["row_ptr"], c["dst"], heads=2,
            scale_t=c["scale_t"], mask_e=c["mask2"])
    else:
        run = lambda q: ag.fused_aggregate(
            q[c["dst"]][:, :2] + c["logits"], c["v"], c["row_ptr"],
            dst=c["dst"], heads=2, scale=c["scale"])
    q = c["q"].clone().requires_grad_(True)
    out = run(q)
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    with torch.inference_mode():
        again = run(c["q"])
    assert torch.equal(out.detach(), again)
    assert calls == [False, False]
    assert op.default is not None


@pytest.mark.parametrize("rung", sorted(RUNGS))
def test_exported_program_calls_its_op(root, rung):
    """The rung's program calls its op once per conv (2·layers), and no
    other of the three."""
    out = _export(root, rung)
    prog = torch.export.load(out / "forward_0.pt2")
    called = [str(n.target) for n in prog.graph.nodes
              if "gnnep_torch" in str(n.target)]
    want = RUNGS[rung][1]
    assert called == [f"gnnep_torch.{want}.default"] * 4
    # the program holds no weights: they come from the members' npz
    assert len(prog.state_dict) == 0


# -------------------------------------------------------------- bundles
@pytest.mark.parametrize("rung", sorted(RUNGS))
def test_bundle_equals_ensemble_predict_bitwise(root, rung):
    out = _export(root, rung)
    meta = json.loads((out / "meta.json").read_text())
    assert meta["member_programs"] == [0, 0]
    assert meta["platform"] == "cpu" and meta["torch_version"]
    bundle = pb.ServingBundle.load(out, device="cpu")
    ens = Ensemble.load(root / f"ens_{rung}", device="cpu")
    std = ens.scaler.apply(_store(root))
    idx = list(range(N_GRAPHS))
    _assert_bitwise(bundle.predict(std, idx),
                    ens.predict(std, idx, batch_size=BATCH))


def test_bundle_bf16_equals_ensemble_predict_bitwise(root):
    out = _export(root, "eproj", dtype="bfloat16")
    assert json.loads((out / "meta.json").read_text())["compute_dtype"] \
        == "bfloat16"
    bundle = pb.ServingBundle.load(out, device="cpu")
    ens = Ensemble.load(root / "ens_eproj", device="cpu")
    std = ens.scaler.apply(_store(root))
    idx = list(range(N_GRAPHS))
    _assert_bitwise(bundle.predict(std, idx),
                    ens.predict(std, idx, batch_size=BATCH,
                                compute_dtype="bfloat16"))


def test_bundle_serves_a_subset_in_request_order(root):
    out = _export(root, "eproj")
    bundle = pb.ServingBundle.load(out, device="cpu")
    ens = Ensemble.load(root / "ens_eproj", device="cpu")
    std = ens.scaler.apply(_store(root))
    idx = [7, 2, 15, 0]
    got = bundle.predict(std, idx)
    want = ens.predict(std, idx, batch_size=BATCH)
    assert [r["material_id"] for r in got] == \
        [std.material_ids[i] for i in idx]
    np.testing.assert_allclose([r["mu"] for r in got],
                               [r["mu"] for r in want], rtol=1e-5)


def test_bundle_matches_jax_ensemble(root, tmp_path):
    """A JAX-written ensemble exported and served by the port equals the
    JAX package's `Ensemble.predict` on the same checkpoints at the serving
    tolerance."""
    js = JStore.load_dir(root / "data", use_cache=False)
    cfg = jm.AlignnConfig(node_dim=js.node_dim, edge_dim=js.edge_dim,
                          angle_dim=js.angle_dim,
                          global_dim=js.global_scalar_dim + 230,
                          hidden=32, layers=2, heads=2, dropout=0.0)
    ens = tmp_path / "jens"
    ens.mkdir()
    for i in range(2):
        ja.save_member(ens / f"model_{i}.npz",
                       jm.init_alignn(jax.random.PRNGKey(20 + i), cfg), cfg)
    shutil.copy(root / "ens_eproj" / "scaler_state.npz", ens)
    pb.export_bundle(ens, _store(root), tmp_path / "b", batch_size=BATCH,
                     device="cpu")
    bundle = pb.ServingBundle.load(tmp_path / "b", device="cpu")
    j_ens = jp.Ensemble.load(ens)
    idx = list(range(0, N_GRAPHS, 2))
    want = j_ens.predict(j_ens.scaler.apply(js), idx, batch_size=BATCH)
    got = bundle.predict(bundle.ensemble.scaler.apply(_store(root)), idx)
    assert [r["material_id"] for r in got] == \
        [r["material_id"] for r in want]
    for key in ("mu", "sigma"):
        np.testing.assert_allclose([r[key] for r in got],
                                   [r[key] for r in want],
                                   rtol=SERVE_RTOL, atol=SERVE_ATOL)


def test_members_of_two_configs_get_two_programs(root, tmp_path):
    store = _store(root)
    ens = tmp_path / "mixed"
    shutil.copytree(root / "ens_eproj", ens)
    cfg = Ensemble.load(ens, device="cpu").cfgs[0]
    wide = dataclasses.replace(cfg, hidden=16)
    save_member(ens / "model_2.npz",
                init_alignn(np.random.default_rng(9), wide))
    meta = pb.export_bundle(ens, store, tmp_path / "b", batch_size=BATCH,
                            device="cpu")
    assert meta["member_programs"] == [0, 0, 1]
    assert sorted(p.name for p in (tmp_path / "b").glob("forward_*.pt2")) \
        == ["forward_0.pt2", "forward_1.pt2"]
    bundle = pb.ServingBundle.load(tmp_path / "b", device="cpu")
    e = Ensemble.load(ens, device="cpu")
    std = e.scaler.apply(store)
    idx = list(range(N_GRAPHS))
    _assert_bitwise(bundle.predict(std, idx),
                    e.predict(std, idx, batch_size=BATCH))


def test_bundle_is_self_contained_and_rejects_oversize(root, tmp_path):
    src = _export(root, "eproj")
    moved = tmp_path / "moved"
    shutil.copytree(src, moved)
    for name in ("model_0.npz", "model_1.npz", "scaler_state.npz",
                 "conformal.json", "meta.json", "forward_0.pt2"):
        assert (moved / name).exists()
    bundle = pb.ServingBundle.load(moved, device="cpu")
    assert bundle.budget.n_graphs >= BATCH
    std = bundle.ensemble.scaler.apply(_store(root))
    assert len(bundle.predict(std, [1, 2])) == 2
    # a graph bigger than the recorded arenas is a loud packer error
    bundle.budget = dataclasses.replace(bundle.budget, n_edges=9, n_nodes=9)
    with pytest.raises(ValueError):
        bundle.predict(std, list(range(10)))


def test_platform_mismatch_raises(root, tmp_path):
    out = tmp_path / "b"
    shutil.copytree(_export(root, "eproj"), out)
    meta = json.loads((out / "meta.json").read_text())
    meta["platform"] = "cuda"
    (out / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(RuntimeError, match="platform 'cuda'"):
        pb.ServingBundle.load(out, device="cpu")


def test_cli_export_then_predict(root, tmp_path, capsys):
    out = tmp_path / "serving"
    cli.main(["export", "--ensemble-dir", str(root / "ens_eproj"),
              "--data-dir", str(root / "data"), "--out", str(out),
              "--batch-size", str(BATCH), "--device", "cpu"])
    assert "1 program(s) for platform 'cpu'" in capsys.readouterr().out
    pred = tmp_path / "pred.json"
    got = cli.main(["predict", "--bundle-dir", str(out), "--data-dir",
                    str(root / "data"), "--num-samples", str(N_GRAPHS),
                    "--output-json", str(pred), "--device", "cpu"])
    assert json.loads(pred.read_text())["predictions"] == \
        json.loads(json.dumps(got))
    # the same request through cli.predict, to the bit
    from gnnep_tpu_torch.cli import predict as pcli
    want = pcli.main(["--mode", "random", "--num-samples", str(N_GRAPHS),
                      "--batch-size", str(BATCH), "--data-dir",
                      str(root / "data"), "--ensemble-dir",
                      str(root / "ens_eproj"), "--device", "cpu"])
    _assert_bitwise(got, want)


@pytest.mark.parametrize("argv", [
    ["export", "--ensemble-dir", "e", "--data-dir", "d", "--out", "o"],
    ["predict", "--bundle-dir", "b"]])
def test_cli_defaults_to_the_card(argv, monkeypatch, tmp_path):
    """Without `--device cpu` the CLI asks for CUDA, and without a GPU it
    raises instead of drifting to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
