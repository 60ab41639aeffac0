"""The boundary path's K-step and gradient surfaces in the port
(`BoundaryTrainStep.run`, `parallel.train_step.boundary_grads`) against
the JAX package's `make_boundary_scan_step` and `make_boundary_grads` on the
fake CPU devices, against K single steps and the step's own gradients, over
gloo rank processes."""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).parent))

from gnnep_tpu.models import alignn as jm  # noqa: E402
from gnnep_tpu.parallel import train_step as jts  # noqa: E402
from gnnep_tpu.parallel.mesh import make_mesh as j_make_mesh  # noqa: E402
from gnnep_tpu.train import loop as jl  # noqa: E402
from gnnep_tpu.utils.synth import synthetic_batch  # noqa: E402
from gnnep_tpu_torch.models import alignn as pm  # noqa: E402
from gnnep_tpu_torch.parallel import boundary_shard as pb  # noqa: E402
from gnnep_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from gnnep_tpu_torch.parallel import train_step as pts  # noqa: E402
from gnnep_tpu_torch.train import artifacts as pa  # noqa: E402
from gnnep_tpu_torch.train import loop as pl  # noqa: E402

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

# the JAX package's model tolerance (test_pallas_kernel.py)
RTOL, ATOL = 5e-3, 1e-4
FLOOR, LR = -2.9, 1e-3
MU, SD = np.array([4.32, 3.56], np.float32), np.array([0.91, 0.94],
                                                      np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds():
    with pmesh.WorldPool() as pool:
        yield lambda d, e: pool.get(pmesh.make_mesh(d, e,
                                                    devices=["cpu"] * (d * e)))


def _batch(seed):
    """Graphs larger than a rank's row window (the JAX package's giant)."""
    return synthetic_batch(np.random.default_rng(seed), n_graphs=2,
                           mean_atoms=40, degree=8, node_dim=16, edge_dim=12,
                           angle_dim=7, global_dim=59, table_cap=24,
                           lg_table_cap=40)


@pytest.fixture(scope="module")
def fx():
    cfg = jm.AlignnConfig(node_dim=16, edge_dim=12, angle_dim=7,
                          global_dim=289, target_dim=2, hidden=32, layers=1,
                          heads=2, dropout=0.0, conv_impl="coo")
    params = jm.init_alignn(jax.random.PRNGKey(8), cfg)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]
    pcfg = pm.AlignnConfig(**dataclasses.asdict(cfg))
    model = pa.params_from_leaves(leaves, pcfg)
    b = _batch(21)
    return dict(cfg=cfg, pcfg=pcfg, params=params,
                state={k: v.detach().numpy().copy()
                       for k, v in model.state_dict().items()},
                # a second data slot: the same graphs, other targets
                batches=[b, b._replace(y=np.asarray(b.y) * 1.7)])


def _plan(fx, n_shards, n_batches=1):
    bbs, plan = pb.plan_boundary_batches(fx["batches"][:n_batches], n_shards)
    return bbs, plan, pb.build_boundary_tables(bbs, plan)


def _run_rank(rank, state, cfg, hyper, plan, groups, tables, seed):
    """K boundary steps through `run` (one metrics readback), data slot d
    taking each group's batch d → {'metrics' [K, 7], 'params', 'grads'
    (the last step's reduced gradients)}."""
    model = pts._model_on(rank, cfg, state)
    step = pts.BoundaryTrainStep(pl.TrainStep(model, hyper, MU, SD), rank,
                                 plan)
    gens = [torch.Generator().manual_seed(seed + rank.rank),
            torch.Generator().manual_seed(seed + rank.mesh.size + rank.data)]
    rbs = [pb.RankBoundaryBatch.from_boundary(g[rank.data], t[rank.data],
                                              rank.edge, rank.device)
           for g, t in zip(groups, tables)]
    m = step.run(rbs, *gens, LR, LR)
    return {"metrics": torch.stack(list(m), dim=1).numpy(),
            "params": pts._host_state(model),
            "grads": {n: g.numpy() for n, g in zip(step.base.names,
                                                   step.last_grads)}}


@pytest.mark.parametrize("d,e", [(1, 1), (1, 2), (2, 2)],
                         ids=["1x1", "1x2", "2x2"])
def test_run_equals_k_single_steps(worlds, fx, d, e):
    """`run` over K = 2 batches equals 2 calls, with dropout and jitter on
    (both streams continue from step to step): bitwise."""
    cfg = dataclasses.replace(fx["pcfg"], dropout=0.2)
    hyper = pl.TrainHyper(feature_jitter_std=0.1)
    bbs, plan, tabs = _plan(fx, e, d)
    groups, tables = [bbs] * 2, [tabs] * 2
    ran = worlds(d, e).run(_run_rank, fx["state"], cfg, hyper, plan, groups,
                           tables, 4, every_rank=True)
    single = worlds(d, e).run(pts.boundary_steps_rank, fx["state"], cfg,
                              hyper, MU, SD, plan, groups, tables,
                              [(LR, LR)] * 2, FLOOR, 4, every_rank=True)
    for a, b in zip(ran, single):
        np.testing.assert_array_equal(a["metrics"], b["metrics"])
        for name, v in b["params"].items():
            np.testing.assert_array_equal(a["params"][name], v,
                                          err_msg=name)
    assert np.isfinite(ran[0]["metrics"]).all()


def test_run_matches_jax_scan_step(worlds, fx):
    """K = 2 boundary steps at S = 2 against JAX's scan-over-steps program:
    each step's loss and the parameters after both."""
    bbs, plan, tabs = _plan(fx, 2)
    hyper = pl.TrainHyper(feature_jitter_std=0.0)
    outs = worlds(1, 2).run(_run_rank, fx["state"], fx["pcfg"], hyper, plan,
                            [bbs] * 2, [tabs] * 2, 0, every_rank=True)
    mesh = j_make_mesh(1, 2, devices=jax.devices()[:2])
    multi, init_opt = jts.make_boundary_scan_step(
        mesh, fx["cfg"], jl.TrainHyper(feature_jitter_std=0.0), MU, SD, plan)
    one = jts.stack_boundary_for_mesh(bbs, 1)
    stacked = type(one)(*[np.stack([f, f]) for f in one])
    params = jax.tree.map(jnp.array, fx["params"])
    new, _, losses, ns = multi(params, init_opt(params), stacked,
                               jax.random.PRNGKey(0), LR, LR,
                               jl.sigma_mask(params))
    m = outs[0]["metrics"]
    np.testing.assert_array_equal(m[:, 1], np.asarray(ns))
    np.testing.assert_allclose(m[:, 0] / m[:, 1], np.asarray(losses),
                               rtol=RTOL, atol=ATOL)
    for name, w in zip(pm.leaf_names(fx["pcfg"]),
                       jax.tree_util.tree_leaves(new)):
        got, w = outs[0]["params"][name], np.asarray(w)
        # Adam moves a parameter by about the LR along its gradient's
        # sign; where the gradient is tiny the sign is noise
        tiny = np.abs(outs[0]["grads"][name]) < 10 * ATOL
        np.testing.assert_allclose(got[~tiny], w[~tiny], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        assert np.all(np.abs(got - w) <= 4 * LR + 1e-6), name
        np.testing.assert_array_equal(outs[1]["params"][name], got)


def _grads_rank(rank, state, cfg, hyper, plan, bbs, tabs):
    model = pts._model_on(rank, cfg, state)
    rb = pb.RankBoundaryBatch.from_boundary(bbs[rank.data], tabs[rank.data],
                                            rank.edge, rank.device)
    loss, grads = pts.boundary_grads(rank, model, rb, plan, hyper, MU, SD)
    return float(loss), {n: g.numpy() for n, g in grads.items()}


@pytest.mark.parametrize("d,e", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_boundary_grads_match_jax(worlds, fx, d, e):
    bbs, plan, tabs = _plan(fx, e, d)
    hyper = pl.TrainHyper(feature_jitter_std=0.0)
    outs = worlds(d, e).run(_grads_rank, fx["state"], fx["pcfg"], hyper,
                            plan, bbs, tabs, every_rank=True)
    mesh = j_make_mesh(d, e, devices=jax.devices()[:d * e])
    fn = jts.make_boundary_grads(mesh, fx["cfg"],
                                 jl.TrainHyper(feature_jitter_std=0.0), MU,
                                 SD, plan)
    loss, grads = fn(fx["params"], jts.stack_boundary_for_mesh(bbs, d),
                     jax.random.PRNGKey(0))
    for out in outs:                    # the same on every rank
        np.testing.assert_allclose(out[0], float(loss), rtol=RTOL,
                                   atol=ATOL)
        for name, w in zip(pm.leaf_names(fx["pcfg"]),
                           jax.tree_util.tree_leaves(grads)):
            np.testing.assert_allclose(out[1][name], np.asarray(w),
                                       rtol=RTOL, atol=ATOL, err_msg=name)


def test_boundary_grads_equal_the_steps(worlds, fx):
    """Dropout and jitter off, the gradients `boundary_grads` reduces are
    the ones the step clips and applies."""
    bbs, plan, tabs = _plan(fx, 2)
    hyper = pl.TrainHyper(feature_jitter_std=0.0)
    got = worlds(1, 2).run(_grads_rank, fx["state"], fx["pcfg"], hyper,
                           plan, bbs, tabs)
    step = worlds(1, 2).run(pts.boundary_steps_rank, fx["state"],
                            fx["pcfg"], hyper, MU, SD, plan, [bbs], [tabs],
                            [(LR, LR)], FLOOR)
    for name, g in step["grads"].items():
        np.testing.assert_allclose(got[1][name], g, rtol=1e-5, atol=1e-7,
                                   err_msg=name)


def test_boundary_grads_bf16_pool_in_f32(worlds, fx):
    """In bf16 the S = 2 gradients lie as near the f32 ones as S = 1's:
    both pool in f32, so a layout's rounding, not the pooling, sets the
    distance."""
    f32 = pl.TrainHyper(feature_jitter_std=0.0)
    bf16 = dataclasses.replace(f32, compute_dtype="bfloat16")
    res = {}
    for e, hyper in ((1, f32), (1, bf16), (2, bf16)):
        bbs, plan, tabs = _plan(fx, e)
        res[(e, hyper.compute_dtype)] = worlds(1, e).run(
            _grads_rank, fx["state"], fx["pcfg"], hyper, plan, bbs, tabs)
    names = sorted(res[(1, "float32")][1])

    def flat(r):
        return np.concatenate([r[1][n].ravel() for n in names])

    ref = flat(res[(1, "float32")])
    d1 = np.linalg.norm(flat(res[(1, "bfloat16")]) - ref)
    d2 = np.linalg.norm(flat(res[(2, "bfloat16")]) - ref)
    assert 0 < d2 <= 4.0 * d1 + 1e-3 * np.linalg.norm(ref)
    assert np.isfinite(res[(2, "bfloat16")][0])
