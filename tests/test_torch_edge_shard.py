"""The port's edge-sharded formulation (`gnnep_tpu_torch.parallel.
edge_shard`, and the sharded step and forward of `parallel.train_step`)
against the JAX package: the conv over gloo rank processes (S = 2 and 4;
COO, windowed and table; with and without a row window and a mask) against
JAX's `edge_sharded_conv` and the single-device conv and its gradients; a
row window whose last row is real; the windowed conv and step with
attention dropout against COO from the same streams; the row window's NaN
poison and its misaligned-arena rule; the collectives' transposes; the
new autograd functions under `gradcheck`; the host measures and the edge
slice; and the sharded forward and step against JAX's
`make_sharded_forward` / `make_sharded_train_step` at (D, E) = (1, 2) and
(2, 2), pad slots, and the two random streams."""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from synthetic import make_store  # noqa: E402

from gnnep_tpu.data.batching import BatchBudget, epoch_batches  # noqa: E402
from gnnep_tpu.models import alignn as jm  # noqa: E402
from gnnep_tpu.ops import graph_attention as jga  # noqa: E402
from gnnep_tpu.parallel import edge_shard as jes  # noqa: E402
from gnnep_tpu.parallel import train_step as jts  # noqa: E402
from gnnep_tpu.parallel.mesh import make_mesh as j_make_mesh  # noqa: E402
from gnnep_tpu.parallel.mesh import shard_map  # noqa: E402
from gnnep_tpu.train import loop as jl  # noqa: E402
from gnnep_tpu_torch.models import alignn as pm  # noqa: E402
from gnnep_tpu_torch.ops.cuda import segment_sum as pss  # noqa: E402
from gnnep_tpu_torch.ops.graph_attention import \
    TransformerConvParams  # noqa: E402
from gnnep_tpu_torch.parallel import edge_shard as pes  # noqa: E402
from gnnep_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from gnnep_tpu_torch.parallel import train_step as pts  # noqa: E402
from gnnep_tpu_torch.train import artifacts as pa  # noqa: E402
from gnnep_tpu_torch.train import loop as pl  # noqa: E402

P = jax.sharding.PartitionSpec

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

# the JAX package's sharded-conv tolerance (test_edge_shard_properties.py)
# and its model tolerance (test_pallas_kernel.py)
CONV_RTOL, CONV_ATOL = 3e-4, 3e-5
RTOL, ATOL = 5e-3, 1e-4
HIDDEN, FE, HEADS = 16, 8, 2
FLOOR, LR = -2.9, 1e-3


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


def _case(seed, n=512, avg_deg=3, n_shards=2, uniform=False):
    """A CSR-sorted arena (the JAX property test's): random in-degrees, the
    last row's own edges none, tail padding onto the last row, masked, to
    a multiple of 128·S edges; `uniform`: `avg_deg` edges into every row
    and no padding, so each rank's slice ends on a real row. Conv
    parameters from the JAX package's init."""
    rng = np.random.default_rng(seed)
    if uniform:
        degs = np.full(n, avg_deg)
    else:
        degs = rng.integers(0, 2 * avg_deg + 1, n)
        degs[-1] = 0
    dst = np.repeat(np.arange(n, dtype=np.int32), degs)
    e_real = dst.shape[0]
    align = 128 * n_shards
    e_total = e_real if uniform else -(-(e_real + 1) // align) * align
    pad = e_total - e_real
    dst = np.concatenate([dst, np.full(pad, n - 1, np.int32)])
    params = jga.init_transformer_conv(jax.random.PRNGKey(seed % 97), HIDDEN,
                                       HIDDEN, edge_dim=FE)
    return dict(
        x=rng.standard_normal((n, HIDDEN)).astype(np.float32),
        src=rng.integers(0, n, size=e_total).astype(np.int32), dst=dst,
        ea=rng.standard_normal((e_total, FE)).astype(np.float32),
        mask=np.concatenate([np.ones(e_real, np.float32),
                             np.zeros(pad, np.float32)]),
        row_ptr=np.searchsorted(dst, np.arange(n + 1)).astype(np.int32),
        params={f: np.asarray(getattr(params, f))
                for f in TransformerConvParams._fields},
        g=rng.standard_normal((n, HIDDEN)).astype(np.float32))


def _row_window(case, n_shards):
    """The measured window of the case's arena (`measure_row_windows` on
    a batch-like of the one arena)."""
    class _B:
        edge_row_ptr = case["row_ptr"]
        lg_row_ptr = case["row_ptr"]
        edge_src = lg_src = case["src"]
        nodes = case["x"]
    return pts.measure_row_windows([_B], n_shards)[0]


def _conv_rank(rank, case, impl, row_window, masked, dtype=torch.float32,
               dropout=0.0):
    """This rank's conv output and the gradients of Σ out·g: the edge
    axis' average of the replicated inputs' (x, the parameters), and the
    local edge features' over S (each rank's holds S times its share).
    Attention dropout at `dropout` draws from a generator seeded from the
    rank alone, so every `impl` draws the same masks."""
    s, e = rank.mesh.n_edge, rank.edge
    n_e = case["src"].shape[0] // s
    sl = slice(e * n_e, (e + 1) * n_e)

    def t(a, grad=False):
        a = np.asarray(a)
        if a.dtype == np.float32:
            return torch.tensor(a, dtype=dtype).requires_grad_(grad)
        return torch.tensor(a, dtype=torch.int64)

    params = TransformerConvParams(*[t(case["params"][f], True)
                                     for f in TransformerConvParams._fields])
    x, ea = t(case["x"], True), t(case["ea"][sl], True)
    out = pes.edge_sharded_conv(
        params, x, t(case["src"][sl]), t(case["dst"][sl]), ea, heads=HEADS,
        rank=rank, edge_mask=t(case["mask"][sl]) if masked else None,
        dropout_rate=dropout,
        generator=torch.Generator().manual_seed(17 + rank.rank),
        row_ptr=torch.from_numpy(case["row_ptr"]), impl=impl,
        row_window=row_window)
    (out * t(case["g"])).sum().backward()
    grads = [x.grad, *(p.grad for p in params)]
    for g in grads:
        pmesh.all_reduce_sum(rank, g, pmesh.EDGE_AXIS).div_(s)
    return {"out": out.detach().numpy(),
            "grads": [g.numpy() for g in grads],
            "ea_grad": ea.grad.numpy() / s}


def _jax_single(case, masked):
    """The single-device JAX conv and its gradients (x, parameters, edge
    features) of Σ out·g."""
    params = jga.TransformerConvParams(
        **{f: jnp.asarray(v) for f, v in case["params"].items()})

    def f(xx, p, aa):
        out = jga.transformer_conv(p, xx, case["src"], case["dst"], aa,
                                   heads=HEADS,
                                   edge_mask=case["mask"] if masked else None)
        return jnp.sum(out * case["g"]), out

    (_, out), (gx, gp, ga) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(case["x"], params, case["ea"])
    return np.asarray(out), [np.asarray(gx), *(np.asarray(getattr(gp, f))
                                               for f in gp._fields)], \
        np.asarray(ga)


_JAX_SHARDED = {}


def _jax_sharded(case_key, case, n_shards, masked, impl="coo",
                 row_window=0):
    """JAX's `edge_sharded_conv` under `shard_map` over S fake devices."""
    key = (case_key, n_shards, masked, impl, row_window)
    if key not in _JAX_SHARDED:
        mesh = j_make_mesh(1, n_shards, devices=jax.devices()[:n_shards])
        span = int(np.diff(case["row_ptr"]).max())
        params = jga.TransformerConvParams(
            **{f: jnp.asarray(v) for f, v in case["params"].items()})

        def device_fn(p, xx, ss, dd, aa, mm, rr):
            return jes.edge_sharded_conv(
                p, xx, ss, dd, aa, heads=HEADS, axis_name="edge",
                edge_mask=mm if masked else None, impl=impl, row_ptr=rr,
                table_width=span + 1, row_window=row_window)

        _JAX_SHARDED[key] = np.asarray(jax.jit(shard_map(
            device_fn, mesh=mesh,
            in_specs=(P(), P(), P("edge"), P("edge"), P("edge"), P("edge"),
                      P()),
            out_specs=P(), check=False))(
                params, case["x"], case["src"], case["dst"], case["ea"],
                case["mask"], case["row_ptr"]))
    return _JAX_SHARDED[key]


CONV_CASES = ([("coo", s, False, m) for s in (2, 4) for m in (True, False)]
              + [("windowed", s, w, m) for s in (2, 4) for w in (False, True)
                 for m in (True, False)]
              + [("table", 2, True, True)])


@pytest.mark.parametrize(
    "impl,n_shards,windowed_rows,masked", CONV_CASES,
    ids=[f"{i}-S{s}-{'window' if w else 'full'}-{'mask' if m else 'nomask'}"
         for i, s, w, m in CONV_CASES])
def test_conv_matches_jax(worlds, impl, n_shards, windowed_rows, masked):
    """Every row, the last (the dummy's, which takes live padding edges
    without the mask) included, against JAX's sharded COO conv; the
    gradients against `jax.grad` of the single-device conv."""
    case = _case(3, n_shards=n_shards)
    rw = _row_window(case, n_shards) if windowed_rows else 0
    if windowed_rows:
        assert rw < case["x"].shape[0]       # the window really engages
    outs = worlds(1, n_shards).run(_conv_rank, case, impl, rw, masked,
                                   every_rank=True)
    want = _jax_sharded("c3", case, n_shards, masked)
    _, grads, ga = _jax_single(case, masked)
    for out in outs:
        np.testing.assert_allclose(out["out"], want, rtol=CONV_RTOL,
                                   atol=CONV_ATOL)
        for a, w, name in zip(out["grads"], grads,
                              ["x", *TransformerConvParams._fields]):
            np.testing.assert_allclose(a, w, rtol=CONV_RTOL, atol=CONV_ATOL,
                                       err_msg=name)
    np.testing.assert_allclose(np.concatenate([o["ea_grad"] for o in outs]),
                               ga, rtol=CONV_RTOL, atol=CONV_ATOL)


def test_window_whose_last_row_is_real(worlds):
    """Each rank's slice ends on a real row that is its window's last
    (`hi = r_lo + R − 1`): the window's R + 1 bounds sum it. With the
    bounds the plain kernel contract takes (R starts, the last segment the
    dummy's) that row would come out zero."""
    case = _case(5, n=512, avg_deg=4, uniform=True)
    rw = _row_window(case, 2)
    assert rw == 256 and int(case["row_ptr"][256]) == 1024   # rows 0-255
    outs = worlds(1, 2).run(_conv_rank, case, "windowed", rw, True,
                            every_rank=True)
    want, grads, ga = _jax_single(case, True)
    for out in outs:
        np.testing.assert_allclose(out["out"], want, rtol=CONV_RTOL,
                                   atol=CONV_ATOL)
        for a, w in zip(out["grads"], grads):
            np.testing.assert_allclose(a, w, rtol=CONV_RTOL, atol=CONV_ATOL)
    np.testing.assert_allclose(np.concatenate([o["ea_grad"] for o in outs]),
                               ga, rtol=CONV_RTOL, atol=CONV_ATOL)
    # rank 0's window, rows 0-255, through the kernel's two contracts
    vals = torch.ones(1024, 3)
    bounds = torch.from_numpy(case["row_ptr"][:257])
    closed = pss.csr_window_sum(vals, bounds, torch.arange(1024) // 4)
    assert closed[-1].tolist() == [4.0] * 3 and closed.shape == (256, 3)
    assert pss.csr_segment_sum(vals, None, bounds[:-1])[-1].abs().sum() == 0


def test_windowed_matches_jax_windowed_interpret(worlds):
    """One small case against JAX's own windowed formulation (its Pallas
    segment-sum in interpret mode), row window on."""
    case = _case(7, n=512, avg_deg=2)
    rw = _row_window(case, 2)
    assert rw < 512
    want = _jax_sharded("c7", case, 2, True, impl="windowed", row_window=rw)
    outs = worlds(1, 2).run(_conv_rank, case, "windowed", rw, True,
                            every_rank=True)
    # the dummy row's sum is unspecified by JAX's windowed contract
    for out in outs:
        np.testing.assert_allclose(out["out"][:-1], want[:-1],
                                   rtol=CONV_RTOL, atol=CONV_ATOL)


DROPOUT_CASES = [(s, w, m) for s in (2, 4) for w in (False, True)
                 for m in (True, False)]


@pytest.mark.parametrize(
    "n_shards,windowed_rows,masked", DROPOUT_CASES,
    ids=[f"S{s}-{'window' if w else 'full'}-{'mask' if m else 'nomask'}"
         for s, w, m in DROPOUT_CASES])
def test_windowed_dropout_matches_coo(worlds, n_shards, windowed_rows,
                                      masked):
    """Attention dropout at the trainer's rate: the windowed conv (Σ exp
    and α·v in two window sums, the denominator's closed gather) against
    the COO conv, which draws the same keep masks from the same streams;
    outputs and gradients at the conv tolerance."""
    case = _case(11, n_shards=n_shards)
    rw = _row_window(case, n_shards) if windowed_rows else 0
    world = worlds(1, n_shards)
    got, want = (world.run(_conv_rank, case, impl, rw, masked,
                           torch.float32, 0.15, every_rank=True)
                 for impl in ("windowed", "coo"))
    assert not np.allclose(want[0]["out"], _jax_single(case, masked)[0],
                           rtol=CONV_RTOL, atol=CONV_ATOL)  # it drops
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["out"], w["out"], rtol=CONV_RTOL,
                                   atol=CONV_ATOL)
        for a, b in zip(g["grads"], w["grads"]):
            np.testing.assert_allclose(a, b, rtol=CONV_RTOL, atol=CONV_ATOL)
        np.testing.assert_allclose(g["ea_grad"], w["ea_grad"],
                                   rtol=CONV_RTOL, atol=CONV_ATOL)


def test_windowed_dropout_last_row_real_matches_coo(worlds):
    """The same on the arena whose slices end on their window's last row."""
    case = _case(5, n=512, avg_deg=4, uniform=True)
    rw = _row_window(case, 2)
    got, want = (worlds(1, 2).run(_conv_rank, case, impl, rw, True,
                                  torch.float32, 0.15, every_rank=True)
                 for impl in ("windowed", "coo"))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["out"], w["out"], rtol=CONV_RTOL,
                                   atol=CONV_ATOL)
        for a, b in zip(g["grads"], w["grads"]):
            np.testing.assert_allclose(a, b, rtol=CONV_RTOL, atol=CONV_ATOL)


def test_undercovering_row_window_is_nan(worlds):
    """A window smaller than a rank's rows poisons the whole output."""
    case = _case(0, n=256, avg_deg=2)
    assert _row_window(case, 2) > 128
    outs = worlds(1, 2).run(_conv_rank, case, "windowed", 128, True,
                            every_rank=True)
    assert all(np.isnan(o["out"]).all() for o in outs)


def test_misaligned_arena_disables_row_window(worlds):
    """An arena of 192 rows (not a multiple of 128) turns the window off:
    every row exact, the last a real row with 8 edges."""
    n, deg = 192, 8
    case = _case(2, n=n, avg_deg=deg, n_shards=4, uniform=True)
    outs = worlds(1, 4).run(_conv_rank, case, "windowed", 128, False,
                            every_rank=True)
    want, grads, _ = _jax_single(case, False)
    for out in outs:
        np.testing.assert_allclose(out["out"], want, rtol=CONV_RTOL,
                                   atol=CONV_ATOL)
        for a, w in zip(out["grads"], grads):
            np.testing.assert_allclose(a, w, rtol=CONV_RTOL, atol=CONV_ATOL)


def test_windowed_needs_row_ptr_and_a_known_impl():
    one = pmesh.Rank(pmesh.make_mesh(1, 1, devices=["cpu"]), 0)
    case = _case(1, n=64)
    params = TransformerConvParams(*[torch.tensor(case["params"][f])
                                     for f in TransformerConvParams._fields])
    args = (params, torch.tensor(case["x"]), torch.tensor(case["src"]).long(),
            torch.tensor(case["dst"]).long(), torch.tensor(case["ea"]))
    with pytest.raises(ValueError, match="needs the global row_ptr"):
        pes.edge_sharded_conv(*args, heads=HEADS, rank=one, impl="windowed")
    with pytest.raises(ValueError, match="impl must be one of"):
        pes.edge_sharded_conv(*args, heads=HEADS, rank=one, impl="dense")


# ---------------------------------------------------------------------------
# gradients: the autograd functions and the collectives' transposes
# ---------------------------------------------------------------------------

def _small_window(seed=0, rows=5, width=3):
    """values [E, width] f64 sorted by row, the R + 1 bounds (the last row
    real), each value's row."""
    rng = np.random.default_rng(seed)
    degs = rng.integers(1, 4, rows)
    dst = torch.from_numpy(np.repeat(np.arange(rows), degs))
    bounds = torch.from_numpy(np.concatenate([[0], np.cumsum(degs)])
                              .astype(np.int32))
    vals = torch.from_numpy(rng.standard_normal((len(dst), width)))
    return vals, bounds, dst


def test_gradcheck_window_sum():
    vals, bounds, dst = _small_window()
    assert torch.autograd.gradcheck(
        lambda v: pss.csr_window_sum(v, bounds, dst),
        (vals.requires_grad_(True),))


def test_gradcheck_closed_gather():
    vals, bounds, dst = _small_window(1)
    x = torch.randn(len(bounds) - 1, 4, dtype=torch.float64,
                    requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda t: pss.csr_gather(t, dst, bounds, closed=True), (x,))


@pytest.mark.parametrize("impl", ["coo", "windowed"])
def test_gradcheck_conv_one_rank(impl):
    """The whole conv on a one-slot mesh in float64, its last row real,
    with respect to the states and the edge features."""
    one = pmesh.Rank(pmesh.make_mesh(1, 1, devices=["cpu"]), 0)
    case = _case(4, n=12, avg_deg=2, uniform=True)
    params = TransformerConvParams(*[
        torch.tensor(case["params"][f], dtype=torch.float64)
        for f in TransformerConvParams._fields])

    def conv(x, ea):
        return pes.edge_sharded_conv(
            params, x, torch.tensor(case["src"]).long(),
            torch.tensor(case["dst"]).long(), ea, heads=HEADS, rank=one,
            row_ptr=torch.from_numpy(case["row_ptr"]), impl=impl)

    x = torch.tensor(case["x"], dtype=torch.float64, requires_grad=True)
    ea = torch.tensor(case["ea"], dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(conv, (x, ea))


def _adjoint_rank(rank):
    """<F(x), g> and <x, Fᵀ(g)> on this rank, float64, for `psum` and
    `all_gather_rows` (summed over the ranks they must agree: Fᵀ is the
    transpose of the global map); and whether `pmax` is gradient-free."""
    gen = torch.Generator().manual_seed(rank.rank)
    out = {}
    for name, fn, rows_out in (
            ("psum", pmesh.psum, 6),
            ("all_gather_rows", pmesh.all_gather_rows,
             6 * rank.mesh.n_edge)):
        x = torch.randn(6, 3, dtype=torch.float64, generator=gen,
                        requires_grad=True)
        g = torch.randn(rows_out, 3, dtype=torch.float64, generator=gen)
        y = fn(rank, x)
        (y * g).sum().backward()
        out[name] = (float((y.detach() * g).sum()), float((x * x.grad).sum()))
    m = pmesh.pmax(rank, torch.randn(4, requires_grad=True))
    out["pmax_no_grad"] = not m.requires_grad
    return out


@pytest.mark.parametrize("n_shards", [2, 4])
def test_collectives_transpose(worlds, n_shards):
    outs = worlds(1, n_shards).run(_adjoint_rank, every_rank=True)
    for name in ("psum", "all_gather_rows"):
        fwd = sum(o[name][0] for o in outs)
        bwd = sum(o[name][1] for o in outs)
        assert abs(fwd - bwd) <= 1e-9 * max(1.0, abs(fwd)), name
    assert all(o["pmax_no_grad"] for o in outs)


# ---------------------------------------------------------------------------
# host: the measures and the edge slice
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fx():
    """Sub-batches of 4 graphs, a member from JAX's init (dropout off) and
    its port twin, and the target statistics."""
    store = make_store(16, seed=21)
    idx = list(range(16))
    sub = epoch_batches(store, idx, BatchBudget.plan(store, idx, 4,
                                                     cover_all=True),
                        shuffle=False)
    union = epoch_batches(store, idx, BatchBudget.plan(store, idx, 16,
                                                       cover_all=True),
                          shuffle=False)
    cfg = jm.AlignnConfig(
        node_dim=store.node_dim, edge_dim=store.edge_dim,
        angle_dim=store.angle_dim, global_dim=store.global_scalar_dim + 230,
        target_dim=2, hidden=32, layers=1, heads=2, dropout=0.0,
        conv_impl="coo")
    params = jm.init_alignn(jax.random.PRNGKey(5), cfg)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]
    pcfg = pm.AlignnConfig(**dataclasses.asdict(cfg))
    model = pa.params_from_leaves(leaves, pcfg)
    ys = np.log(np.asarray(store.y))
    return dict(sub=sub, union=union[0], cfg=cfg, pcfg=pcfg, params=params,
                state={k: v.detach().numpy().copy()
                       for k, v in model.state_dict().items()},
                means=ys.mean(0).astype(np.float32),
                stds=(ys.std(0) + 0.1).astype(np.float32))


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_measures_match_jax(fx, n_shards):
    batches = [*fx["sub"], fx["union"]]
    assert pts.measure_table_widths(batches) == \
        jts.measure_table_widths(batches)
    for b in (fx["sub"][:1], batches):
        assert pts.measure_row_windows(b, n_shards) == \
            jts.measure_row_windows(b, n_shards)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_edge_slice_cuts_jax_edge_fields(fx, n_shards):
    """The JAX package's edge fields cut in S row blocks, every other field
    whole; the slices rebuild the batch."""
    assert pts.EDGE_FIELDS == jts._EDGE_FIELDS
    b = fx["union"]
    parts = [pts.edge_slice(b, e, n_shards) for e in range(n_shards)]
    for f in b._fields:
        whole = getattr(b, f)
        if whole is None:
            continue
        got = [np.asarray(getattr(p, f)) for p in parts]
        if f in pts.EDGE_FIELDS:
            np.testing.assert_array_equal(np.concatenate(got), whole,
                                          err_msg=f)
            assert got[0].shape[0] == whole.shape[0] // n_shards
        else:
            for g in got:
                np.testing.assert_array_equal(g, whole, err_msg=f)
    pm.DeviceBatch.from_batch(parts[-1], "cpu")


def test_edge_slice_refuses_an_uneven_arena(fx):
    with pytest.raises(ValueError, match="does not split over 3 edge ranks"):
        pts.edge_slice(fx["union"], 0, 3)


# ---------------------------------------------------------------------------
# the sharded forward and step
# ---------------------------------------------------------------------------

MESHES = [(1, 2), (2, 2)]
_JAX_MODEL = {}


def _layout(fx, impl, n_edge):
    if impl == "coo":
        return {}
    return dict(impl=impl, table_widths=pts.measure_table_widths(fx["sub"]),
                row_windows=pts.measure_row_windows(fx["sub"], n_edge))


def _jax_model(fx, d, e):
    """JAX's sharded forward and one sharded step (COO) from the fixture's
    parameters on the first D sub-batches."""
    if (d, e) not in _JAX_MODEL:
        mesh = j_make_mesh(d, e, devices=jax.devices()[:d * e])
        stacked = jts.stack_for_mesh(fx["sub"][:d], d)
        fwd = jts.make_sharded_forward(mesh, fx["cfg"], FLOOR)
        mean, logvar = fwd(fx["params"], stacked)
        step, init_opt = jts.make_sharded_train_step(
            mesh, fx["cfg"], jl.TrainHyper(feature_jitter_std=0.0),
            fx["means"], fx["stds"])
        params = jax.tree.map(jnp.array, fx["params"])
        new, _, loss, n = step(params, init_opt(params), stacked,
                               jax.random.PRNGKey(0), LR, LR,
                               jl.sigma_mask(params))
        _JAX_MODEL[(d, e)] = dict(
            forward=(np.asarray(mean), np.asarray(logvar)),
            params=[np.asarray(p) for p in jax.tree_util.tree_leaves(new)],
            loss=float(loss), n=float(n))
    return _JAX_MODEL[(d, e)]


def _port(worlds, fx, d, e, layout, n_steps=1, hyper=None, seed=None,
          cfg=None, groups=None):
    groups = groups or [pts.stack_for_mesh(fx["sub"][:d], d)] * max(n_steps, 1)
    return worlds(d, e).run(
        sharded_steps_rank, fx["state"], cfg or fx["pcfg"],
        hyper or pl.TrainHyper(feature_jitter_std=0.0), fx["means"],
        fx["stds"], groups, [(LR, LR)] * n_steps, FLOOR, seed, layout,
        every_rank=True)


def sharded_steps_rank(rank, state, cfg, hyper, log_means, log_stds,
                       groups, lrs, floor, seed=None, layout=None):
    """The edge-sharded forward of `groups[0]`, then one sharded step per
    group from `state` (data slot d takes each group's batch d, edge rank e
    its `edge_slice`), dropout and jitter from two generators seeded from
    `seed` (none where None): this rank's, `seed + rank`, and its data
    slot's shared one, `seed + mesh size + data slot`. `layout`: keywords
    of `make_sharded_train_step` (none: COO) → this rank's {'forward':
    (mean, logvar) [D, G, T], 'params', 'metrics' [steps, 7], 'grads' (the
    first step's reduced gradients), 'reduced_bytes' {'forward', 'steps'}
    (what this rank handed to the collectives)}."""
    layout = layout or {}
    model = pts._model_on(rank, cfg, state)
    step = pts.make_sharded_train_step(rank, model, hyper, log_means,
                                       log_stds, **layout)
    gens = [None, None]
    if seed is not None:
        gens = [torch.Generator().manual_seed(seed + rank.rank),
                torch.Generator().manual_seed(seed + rank.mesh.size
                                              + rank.data)]

    def mine(k):
        return pts.edge_slice(groups[k][rank.data], rank.edge,
                              rank.mesh.n_edge)

    fwd = pts.make_sharded_forward(rank, floor, **layout)
    at = pmesh.reduced_bytes
    forward = tuple(t.numpy() for t in fwd(model, mine(0)))
    fwd_bytes, at = pmesh.reduced_bytes - at, pmesh.reduced_bytes
    rows, grads = [], None
    for k, (lr_mean, lr_sigma) in enumerate(lrs):
        rows.append(torch.stack(list(step(mine(k), *gens, lr_mean,
                                          lr_sigma))))
        if grads is None:
            grads = {n: g.detach().numpy()
                     for n, g in zip(step.base.names, step.last_grads)}
    return {"forward": forward, "params": pts._host_state(model),
            "metrics": torch.stack(rows).numpy() if rows else None,
            "grads": grads,
            "reduced_bytes": {"forward": fwd_bytes,
                              "steps": pmesh.reduced_bytes - at}}

IMPL_MESHES = [(i, d, e) for i in ("coo", "windowed") for d, e in MESHES]
IMPL_IDS = [f"{i}-{d}x{e}" for i, d, e in IMPL_MESHES]


@pytest.mark.parametrize("impl,d,e", IMPL_MESHES, ids=IMPL_IDS)
def test_sharded_forward_matches_jax(worlds, fx, impl, d, e):
    outs = _port(worlds, fx, d, e, _layout(fx, impl, e), n_steps=0)
    want = _jax_model(fx, d, e)["forward"]
    for out in outs:                       # [D, G, T] on every rank
        for got, w in zip(out["forward"], want):
            np.testing.assert_allclose(got, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("impl,d,e", IMPL_MESHES, ids=IMPL_IDS)
def test_sharded_step_matches_jax(worlds, fx, impl, d, e):
    """One step: the loss and graph count against JAX's sharded step, the
    reduced gradients against `jax.grad` of the loss sums over the global
    graph count, the parameters against JAX's updated ones; bitwise equal
    on every rank."""
    outs = _port(worlds, fx, d, e, _layout(fx, impl, e))
    want = _jax_model(fx, d, e)
    m = outs[0]["metrics"][0]
    assert m[1] == want["n"]
    np.testing.assert_allclose(m[0] / m[1], want["loss"], rtol=RTOL,
                               atol=ATOL)
    mu, sd = jnp.asarray(fx["means"]), jnp.asarray(fx["stds"])
    jhyper = jl.TrainHyper(feature_jitter_std=0.0)

    def loss_sum(p, b):
        mean, logvar = jm.alignn_apply(p, fx["cfg"], b)
        return jl.nll_loss_sums(mean, logvar, b, mu, sd, jhyper)[0]

    grads = [jax.grad(loss_sum)(fx["params"], b) for b in fx["sub"][:d]]
    names = pm.leaf_names(fx["pcfg"])
    for k, name in enumerate(names):
        g = sum(np.asarray(jax.tree_util.tree_leaves(gr)[k])
                for gr in grads) / want["n"]
        np.testing.assert_allclose(outs[0]["grads"][name], g, rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        # Adam's first step moves a parameter by about the LR along its
        # gradient's sign; where the gradient is tiny the sign is noise
        tiny = np.abs(g) < 10 * ATOL
        np.testing.assert_allclose(outs[0]["params"][name][~tiny],
                                   want["params"][k][~tiny], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        for other in outs[1:]:
            np.testing.assert_array_equal(other["params"][name],
                                          outs[0]["params"][name])


def test_pad_data_slot_contributes_nothing(worlds, fx):
    """D = 2 with an inert second slot = D = 1 on the real batch alone."""
    lay = _layout(fx, "windowed", 2)
    padded = _port(worlds, fx, 2, 2, lay,
                   groups=[pts.stack_for_mesh(fx["sub"][:1], 2)] * 2,
                   n_steps=2)
    alone = _port(worlds, fx, 1, 2, lay,
                  groups=[pts.stack_for_mesh(fx["sub"][:1], 1)] * 2,
                  n_steps=2)
    np.testing.assert_array_equal(padded[0]["metrics"], alone[0]["metrics"])
    for name, v in alone[0]["params"].items():
        np.testing.assert_allclose(padded[0]["params"][name], v, rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def _streams_rank(rank, fx, shared):
    """The train forward of this rank's slice with dropout and jitter,
    the tail's stream shared by the edge ranks or each rank's own."""
    cfg = dataclasses.replace(fx["pcfg"], dropout=0.3)
    model = pa.params_from_leaves(
        [fx["state"][n] for n in pm.leaf_names(cfg)], cfg)
    gen = torch.Generator().manual_seed(3 + rank.rank)
    sgen = torch.Generator().manual_seed(50 + rank.data) if shared else None
    b = pts.edge_slice(fx["sub"][rank.data], rank.edge, rank.mesh.n_edge)
    mean, logvar = pes.sharded_apply(
        model, pm.DeviceBatch.from_batch(b, "cpu"), rank, train=True,
        generator=gen, shared_generator=sgen,
        **_layout(fx, "windowed", rank.mesh.n_edge))
    return mean.detach().numpy(), logvar.detach().numpy()


@pytest.mark.parametrize("d,e", MESHES, ids=["1x2", "2x2"])
def test_two_streams_keep_states_replicated(worlds, fx, d, e):
    """Attention dropout from each rank's stream, residual, pooled and
    embedding dropout from the data slot's shared one: the edge ranks'
    outputs are bitwise equal; drawn from each rank's own stream, they
    drift apart."""
    outs = worlds(d, e).run(_streams_rank, fx, True, every_rank=True)
    for r in range(1, e):
        for a, b in zip(outs[r], outs[0]):
            np.testing.assert_array_equal(a, b)
    drift = worlds(d, e).run(_streams_rank, fx, False, every_rank=True)
    assert not np.array_equal(drift[0][0], drift[1][0])


@pytest.mark.parametrize("d,e", MESHES, ids=["1x2", "2x2"])
def test_dropout_steps_bitwise_across_ranks(worlds, fx, d, e):
    """Two steps with the trainer's dropout and jitter: parameters and
    metrics bitwise equal on every rank, finite."""
    cfg = dataclasses.replace(fx["pcfg"], dropout=0.15)
    outs = _port(worlds, fx, d, e, _layout(fx, "windowed", e), n_steps=2,
                 hyper=pl.TrainHyper(feature_jitter_std=0.1), seed=7,
                 cfg=cfg)
    for out in outs[1:]:
        np.testing.assert_array_equal(out["metrics"], outs[0]["metrics"])
        for name, v in out["params"].items():
            np.testing.assert_array_equal(v, outs[0]["params"][name])
    assert np.isfinite(outs[0]["metrics"]).all()


@pytest.mark.parametrize("d,e", MESHES, ids=["1x2", "2x2"])
def test_dropout_steps_windowed_match_coo(worlds, fx, d, e):
    """Two steps with the trainer's dropout and jitter, windowed against
    COO from the same seeds (the same keep masks and jitter): each step's
    metrics, the first step's reduced gradients and the parameters after
    both at the model tolerance."""
    cfg = dataclasses.replace(fx["pcfg"], dropout=0.15)
    got, want = (_port(worlds, fx, d, e, _layout(fx, impl, e), n_steps=2,
                       hyper=pl.TrainHyper(feature_jitter_std=0.1), seed=7,
                       cfg=cfg)[0] for impl in ("windowed", "coo"))
    np.testing.assert_allclose(got["metrics"], want["metrics"], rtol=RTOL,
                               atol=ATOL)
    for name, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][name], g, rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        tiny = np.abs(g) < 10 * ATOL
        np.testing.assert_allclose(got["params"][name][~tiny],
                                   want["params"][name][~tiny], rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def expected_bytes(n_atoms, n_bonds, e_loc, hidden, heads, layers, n_data,
                   n_graphs, targets, n_params, train, dropout):
    """What one rank hands to the collectives in the windowed formulation:
    a forward (`train`: a train forward, its backward and the step's
    gradient all-reduce), f32."""
    conv = 0
    for n in (n_bonds, n_atoms):
        sums = [n * heads, n * hidden] if dropout else [n * (hidden + heads)]
        conv += n * heads + sum(sums) * (2 if train else 1)
    total = layers * conv + e_loc * hidden + 2
    if train:
        total += n_bonds * hidden + n_params + 6 + 1
    elif n_data > 1:
        total += 2 * n_graphs * targets     # the [D, G, T] gathers
    return 4 * total


@pytest.mark.parametrize("d,dropout", [(1, 0.0), (2, 0.2)])
def test_collective_bytes_follow_the_formulation(worlds, fx, d, dropout):
    cfg = dataclasses.replace(fx["pcfg"], dropout=dropout)
    out = _port(worlds, fx, d, 2, _layout(fx, "windowed", 2), seed=1,
                cfg=cfg)[0]
    b = fx["sub"][0]
    dims = dict(n_atoms=b.nodes.shape[0], n_bonds=b.edge_src.shape[0],
                e_loc=b.edge_src.shape[0] // 2, hidden=cfg.hidden,
                heads=cfg.heads, layers=cfg.layers, n_data=d,
                n_graphs=b.y.shape[0], targets=b.y.shape[1],
                n_params=sum(v.size for v in fx["state"].values()))
    assert out["reduced_bytes"] == {
        "forward": expected_bytes(**dims, train=False, dropout=False),
        "steps": expected_bytes(**dims, train=True, dropout=dropout > 0)}


def test_sharded_step_refuses_bf16(fx):
    one = pmesh.Rank(pmesh.make_mesh(1, 1, devices=["cpu"]), 0)
    model = pa.params_from_leaves(
        [fx["state"][n] for n in pm.leaf_names(fx["pcfg"])], fx["pcfg"])
    with pytest.raises(ValueError, match="float32 only"):
        pts.make_sharded_train_step(
            one, model, pl.TrainHyper(compute_dtype="bfloat16"),
            fx["means"], fx["stds"])


def test_one_slot_windowed_step_equals_single_device(fx):
    """S = 1 in this process (the JAX bench's Mesh(1, 1)): the windowed
    sharded step equals the single-device step on the same batch."""
    one = pmesh.Rank(pmesh.make_mesh(1, 1, devices=["cpu"]), 0)
    hyper = pl.TrainHyper(feature_jitter_std=0.0)
    models = [pa.params_from_leaves(
        [fx["state"][n] for n in pm.leaf_names(fx["pcfg"])], fx["pcfg"])
        for _ in range(2)]
    sharded = pts.make_sharded_train_step(one, models[0], hyper, fx["means"],
                                          fx["stds"],
                                          **_layout(fx, "windowed", 1))
    single = pl.TrainStep(models[1], hyper, fx["means"], fx["stds"])
    a = sharded(fx["sub"][1], None, None, LR, LR)
    b = single(fx["sub"][1], None, LR, LR)
    np.testing.assert_allclose([float(x) for x in a][:6],
                               [float(x) for x in b][:6], rtol=1e-5,
                               atol=1e-6)
    for name, g, p, q in zip(single.names, sharded.last_grads, single.params,
                             sharded.base.params):
        np.testing.assert_allclose(g.numpy(), p.grad.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
        # Adam moves a parameter by about the LR along its gradient's
        # sign; where the gradient is tiny the sign is noise
        tiny = np.abs(p.grad.numpy()) < 10 * ATOL
        np.testing.assert_allclose(q.detach().numpy()[~tiny],
                                   p.detach().numpy()[~tiny], rtol=1e-4,
                                   atol=1e-6, err_msg=name)
