"""The plain reference held to the port's CPU path at a tiny size: initial
weights, the trainer's batch layout, the forward, one member's first steps
(loss, gradients, the AdamW update); and the control, the reference in
TF32, reading above every sound reading."""
import numpy as np
import pytest
import torch

from bench_port.reference import model as R
from bench_port.reference import packing as P
from bench_port.reference.train import INT_KEYS, to_device

from conftest import run_tiny, tiny_cell

CELLS = ["flagship-train-unbounded", "cutoff5-train-unbounded"]

SMALL = dict(node_dim=206, edge_dim=36, angle_dim=11, global_dim=289,
             target_dim=2, hidden=16, layers=2, heads=2, dropout=0.15,
             conv_impl="fused", compute_dtype="float32")


def _port_model(seed, m):
    from gnnep_tpu_torch.models.alignn import AlignnConfig, init_alignn
    cfg = AlignnConfig(**{k: v for k, v in m.items() if k != "compute_dtype"})
    return init_alignn(np.random.default_rng(seed), cfg)


@pytest.mark.parametrize("seed", [0, 2147483700])
def test_initial_weights_equal_the_port(seed):
    port = _port_model(seed, SMALL)
    ref = R.init_params(seed, SMALL, "cpu")
    assert [n for n, _ in port.named_parameters()] == list(ref)
    for n, p in port.named_parameters():
        assert torch.equal(p.detach(), ref[n]), n


@pytest.mark.parametrize("name", CELLS)
def test_first_batches_equal_the_port(name):
    """Bootstrap, epoch permutation, greedy grouping and arenas, on the
    trainer's budget with its window bounds cleared: array-equal to the
    trainer's first batches."""
    from gnnep_tpu_torch.data.batching import epoch_batches
    from gnnep_tpu_torch.train.config import TrainConfig
    from gnnep_tpu_torch.train.member import bootstrap_indices
    from bench_port.drivers import train as T
    cell = tiny_cell(name)
    inputs = T.make_inputs(cell, 11)
    store = T.program_store(inputs["graphs"])
    bs = cell.traffic["trainer"]["batch_size"]
    budget = T.plan_budget(store, cell.traffic["trainer"])
    assert (budget.edge_win64, budget.lg_win64, budget.edge_src_win64,
            budget.lg_src_win64) == (0, 0, 0, 0)
    eff = bootstrap_indices(inputs["train"],
                            TrainConfig(bootstrap_ratio=1.3, verbose=False), 11)
    order = np.asarray(eff)[np.random.default_rng(28).permutation(len(eff))]
    port = epoch_batches(store, order, budget, shuffle=False, workers=4)[:3]
    rb = P.plan_budget(inputs["graphs"], range(store.n_graphs), bs)
    assert (rb["n_graphs"], rb["n_nodes"], rb["n_edges"], rb["n_lg_edges"]) \
        == (budget.n_graphs, budget.n_nodes, budget.n_edges,
            budget.n_lg_edges)
    ref = P.first_batches(inputs["graphs"], inputs["train"], rb, 11, 1.3, 3)
    for a, b in zip(ref, port):
        for k, v in a.items():
            np.testing.assert_array_equal(v, np.asarray(getattr(b, k)),
                                          err_msg=k)


def test_eval_forward_matches_the_port():
    from gnnep_tpu_torch.data.batching import BatchBudget, epoch_batches
    from gnnep_tpu_torch.models.alignn import DeviceBatch, alignn_apply
    from bench_port.drivers import train as T
    cell = tiny_cell("flagship-train-unbounded")
    inputs = T.make_inputs(cell, 5)
    store = T.program_store(inputs["graphs"])
    budget = BatchBudget.plan(store, range(store.n_graphs), 8)
    batch = epoch_batches(store, list(range(8)), budget, shuffle=False)[0]
    port = _port_model(5, SMALL)
    with torch.no_grad():
        mean, logvar = alignn_apply(port, DeviceBatch.from_batch(batch, "cpu"))
    arena = {k: np.asarray(getattr(batch, k)) for k in
             ("nodes", "node_graph", "edge_src", "edge_dst", "edge_attr",
              "edge_mask", "lg_src", "lg_dst", "lg_attr", "lg_mask",
              "globals_", "sg_num")}
    a = to_device(arena, "cpu")
    assert all(a[k].dtype == torch.int64 for k in INT_KEYS)
    with torch.no_grad():
        rm, rl = R.forward(R.init_params(5, SMALL, "cpu"), a, SMALL,
                           R.Numerics())
    np.testing.assert_allclose(rm.numpy(), mean.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rl.numpy(), logvar.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", CELLS)
def test_member_steps_match_the_port(name):
    """Three steps of `train_member` (jitter, dropout, loss, gradients,
    clip, AdamW) against the reference's, at rounding level."""
    _, _, numbers = run_tiny(tiny_cell(name))
    assert numbers["init_gap"] == 0.0 and numbers["batch_ids"] == 0.0
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-5
    assert numbers["replay_loss_gap"] < 1e-5
    assert numbers["replay_grad_gap"] < 1e-5
    assert numbers["change_gap"] < 1e-3


def test_replay_gradient_is_taken_at_the_judged_weights():
    """Step 2's gradient follows the weights handed in: at the reference's
    own weights after step 1 it is its own step 2, and elsewhere it moves
    while the trajectory (losses, final weights) stays the same."""
    from bench_port.reference.train import reference_steps
    from bench_port.drivers import train as T
    cell = tiny_cell("flagship-train-unbounded")
    inputs = T.make_inputs(cell, 7)
    args = (inputs["graphs"], inputs["train"], cell.model,
            cell.traffic["trainer"], 7, 5, 3, "cpu", R.Numerics())
    own = reference_steps(*args)
    same = reference_steps(*args, judged_p1=own["p1"])
    moved = reference_steps(*args, judged_p1={
        n: 1.01 * v for n, v in own["p1"].items()})
    assert same["loss2"] == own["loss2"] == own["losses"][1]
    assert moved["loss2"] != own["loss2"]
    for n in own["g2"]:
        assert torch.equal(own["g2"][n], same["g2"][n]), n
        assert torch.equal(own["pn"][n], moved["pn"][n]), n
    assert own["losses"] == moved["losses"]
    assert any(not torch.equal(own["g2"][n], moved["g2"][n])
               for n in own["g2"])


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_above_the_limits(name):
    """The control: the reference put in the program's place with its
    GEMMs in TF32 reads above the cell's limits in at least one number,
    where the program's own run reads under all of them."""
    from bench_port import harness
    cell = tiny_cell(name, hidden=64, layers=2, heads=4)
    drv, state, sound = run_tiny(cell)
    assert harness.judge(sound, cell.limits), sound
    side = drv.reference(state, R.Numerics(tf32=True))
    control = drv.numbers(side, drv.reference(state, R.Numerics(tf32=False),
                                              side["p1"]))
    assert not harness.judge(control, cell.limits), control


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -3.0,
                      1.0 + 2.0 ** -10], dtype=torch.float32)
    got = R.round_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2.0 ** -9, -3.0, 1.0 + 2.0 ** -10]
