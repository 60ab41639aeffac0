"""The port's eval forward against `gnnep_tpu.models.alignn`, from one
checkpoint written by the JAX package."""
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
from gnnep_tpu.train.loop import make_forward as j_make_forward  # noqa: E402
from gnnep_tpu_torch.models import alignn as pm  # noqa: E402
from gnnep_tpu_torch.train import artifacts as pa  # noqa: E402
from gnnep_tpu_torch.train import loop as pl  # noqa: E402

# f32: the tolerance of the JAX package's own fused-vs-table model test
# (test_pallas_kernel.py:228)
RTOL, ATOL = 1e-3, 1e-4


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    store = make_store(10, seed=12)
    budget = BatchBudget.plan(store, range(10), batch_size=10)
    # 128-divisible arenas, so that the JAX fused path takes the eproj rung
    # (as test_pallas_kernel.py:211-214 forces them)
    budget = dataclasses.replace(budget, n_nodes=128, n_edges=256,
                                 n_lg_edges=1024)
    batch = next(iter(BatchPacker(store, budget).pack(range(10))))
    cfg = jm.AlignnConfig(
        node_dim=store.node_dim, edge_dim=store.edge_dim,
        angle_dim=store.angle_dim, global_dim=store.global_scalar_dim + 230,
        target_dim=2, hidden=16, layers=2, heads=2, dropout=0.0)
    params = jm.init_alignn(jax.random.PRNGKey(0), cfg)
    path = tmp_path_factory.mktemp("ckpt") / "model_0.npz"
    ja.save_member(path, params, cfg)
    return dict(batch=batch, cfg=cfg, params=params, path=path)


def _jax_cfg(cfg, impl):
    if impl == "fused":
        return dataclasses.replace(cfg, conv_impl="fused", force_fused=True)
    return dataclasses.replace(cfg, conv_impl=impl)


@pytest.mark.parametrize("impl", ["coo", "table", "fused"])
@pytest.mark.parametrize("sg_zero", [False, True])
def test_forward_matches_jax(fixture, impl, sg_zero):
    batch = fixture["batch"]
    if sg_zero:     # unknown space group: a zero one-hot row in both
        sg = np.asarray(batch.sg_num).copy()
        sg[0] = 0
        batch = batch._replace(sg_num=sg)
    want = jm.alignn_activations(fixture["params"],
                                 _jax_cfg(fixture["cfg"], impl), batch)
    model = pa.load_member(fixture["path"], "cpu")
    model.cfg = dataclasses.replace(model.cfg, conv_impl=impl)
    with torch.inference_mode():
        got = pm.alignn_activations(
            model, pm.DeviceBatch.from_batch(batch, "cpu"))
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(value),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_bf16_forward_matches_jax(fixture):
    """bf16 trunks round at different points in the two frameworks (XLA's
    and torch's CPU matmuls and reductions), so this holds the outputs at
    5e-2: a few bf16 steps (2^-8 relative) through two layers."""
    cfg = fixture["cfg"]
    want = j_make_forward(cfg, pl.MIN_LOGVAR_FLOOR, "bfloat16")(
        fixture["params"], fixture["batch"])
    model = pl.cast_model(pa.load_member(fixture["path"], "cpu"), "bfloat16")
    got = pl.make_forward(compute_dtype="bfloat16")(
        model, pm.DeviceBatch.from_batch(fixture["batch"], "cpu"))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-2,
                                   atol=5e-2)


def _path_name(path) -> str:
    parts = []
    for k in path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
    return ".".join(parts)


def test_leaf_order_pinned_to_jax_tree_leaves(fixture):
    cfg = dataclasses.replace(fixture["cfg"], layers=3)
    params = jm.init_alignn(jax.random.PRNGKey(1), cfg)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [_path_name(p) for p, _ in flat] == pm.leaf_names(cfg)
    model = pa.params_from_leaves([np.asarray(x) for _, x in flat], cfg)
    named = dict(model.named_parameters())
    for p, leaf in flat:
        assert np.array_equal(named[_path_name(p)].detach().numpy(),
                              np.asarray(leaf))
    assert len(named) == len(flat)


def test_config_json_round_trip(fixture):
    cfg = fixture["cfg"]
    assert dataclasses.asdict(pm.AlignnConfig(**dataclasses.asdict(cfg))) \
        == dataclasses.asdict(cfg)
    assert [f.name for f in dataclasses.fields(pm.AlignnConfig)] \
        == [f.name for f in dataclasses.fields(jm.AlignnConfig)]
