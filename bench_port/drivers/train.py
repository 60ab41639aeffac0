"""Traffic kind `train`: one ensemble member through the port's
`train.member.train_member`, the trainer's own loop (packing an epoch ahead
on a thread, K-step chunks, val forwards, best-state selection).

Set-up makes the store, the splits and the log-target statistics, plans the
batch budget as the trainer's set-up does, and runs the member for
`warmup_epochs_run` epochs: every kernel builds and loads, the step and the
val forward capture once. The window is one more `train_member` call whose
epochs fill `--seconds` at the rate of the warm-up's last epoch; its rate is
every graph stepped over the call's whole wall time.

The budget is the one the trainer plans, with its window bounds cleared
(`BatchBudget`'s 0, unenforced): the CUDA kernels read whole CSR ranges and
no kernel reads the bounds, but the packer raises on graphs that cannot meet
them (PERF.md, Open questions), so the cells stand in on this path.

The check follows the window's own member: the harness's wrapper around the
step keeps its initial weights, the metrics of its first `checked_steps`
steps, Adam's first moment after steps 1 and 2 (from which the clipped
gradients the optimizer got are worked out), the weights after step 1 and
after the last checked step, as device copies in stream order. Step 1 runs
eagerly, step 2 is the first replay of the captured step. The plain
reference repeats those steps from the raw graphs and the seed, and takes
step 2's gradient at the program's weights after step 1.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bench_port.harness import Cell, Obs, Patches, live_counts
from bench_port.reference.model import Numerics
from bench_port.reference.packing import first_batches
from bench_port.reference.packing import plan_budget as ref_plan_budget
from bench_port.reference.train import ADAM_B1, reference_steps
from bench_port.synth import Graphs, make_graphs
from bench_port.work import alignn as work



def make_inputs(cell: Cell, seed: int) -> Dict:
    """The raw graphs and the member's splits, from the seed alone."""
    g, m, t = cell.config["graphs"], cell.model, cell.traffic
    n = int(t["store_graphs"])
    graphs = make_graphs(seed, n, mean_atoms=g["mean_atoms"],
                         degree=g["degree"], node_dim=m["node_dim"],
                         edge_dim=m["edge_dim"], angle_dim=m["angle_dim"],
                         global_scalar_dim=g["global_scalar_dim"],
                         target_dim=m["target_dim"])
    perm = np.random.default_rng([seed, 3]).permutation(n)
    cut = np.cumsum([int(round(n * t["splits"][k]))
                     for k in ("val", "calib", "test")])
    return dict(graphs=graphs, val=sorted(perm[:cut[0]].tolist()),
                train=sorted(perm[cut[2]:].tolist()))


def program_store(graphs: Graphs):
    """The raw graphs handed to the program as its `GraphStore`."""
    from gnnep_tpu_torch.data.store import GraphStore
    n = graphs.n_graphs
    return GraphStore(
        node_feats=graphs.node_feats, edge_src=graphs.edge_src,
        edge_dst=graphs.edge_dst, edge_attr=graphs.edge_attr,
        lg_src=graphs.lg_src, lg_dst=graphs.lg_dst, lg_attr=graphs.lg_attr,
        node_off=graphs.node_off, edge_off=graphs.edge_off,
        lg_off=graphs.lg_off, global_scalars=graphs.global_scalars,
        sg_num=graphs.sg_num, y=graphs.y,
        material_ids=list(graphs.material_ids), formulas=[""] * n,
        reduced_formulas=[""] * n, prototypes=[""] * n)


def plan_budget(store, t: Dict):
    """The trainer's budget over the store (`train/ensemble.py`), its
    window bounds cleared."""
    from gnnep_tpu_torch.data.batching import BatchBudget
    budget = BatchBudget.plan(store, range(store.n_graphs), t["batch_size"],
                              slack=t["batch_slack"],
                              quantile=t["batch_quantile"], cover_all=True)
    return dataclasses.replace(budget, edge_win64=0, lg_win64=0,
                               edge_src_win64=0, lg_src_win64=0)


def model_config(cell: Cell, budget):
    from gnnep_tpu_torch.models.alignn import AlignnConfig
    m = {k: v for k, v in cell.model.items() if k != "compute_dtype"}
    return AlignnConfig(**m, edge_win64=budget.edge_win64,
                        lg_win64=budget.lg_win64,
                        edge_src_win64=budget.edge_src_win64,
                        lg_src_win64=budget.lg_src_win64)


class Watch:
    """Device copies of the checked steps' readings."""

    def __init__(self, n: int):
        self.n = n
        self.seen = 0
        self.p0 = self.mu1 = self.p1 = self.mu2 = self.pn = None
        self.rows: List[torch.Tensor] = []
        self.ids: List[List[int]] = []


@dataclasses.dataclass
class State:
    cell: Cell
    seed: int
    device: torch.device
    obs: Obs
    inputs: Dict
    store: object
    budget: object
    transformer: object
    model_cfg: object
    save_dir: str
    marks: List[float] = dataclasses.field(default_factory=list)
    watch: Optional[Watch] = None
    graphs: float = 0.0
    epochs: int = 0
    peaks: tuple = (0.0, 0.0)
    flops: float = 0.0
    last_epoch_s: float = 0.0
    patches: Optional[Patches] = None

    def trainer(self, epochs: int):
        from gnnep_tpu_torch.train.config import TrainConfig
        t, m = self.cell.traffic["trainer"], self.cell.model
        return TrainConfig(
            save_dir=self.save_dir, batch_size=t["batch_size"], epochs=epochs,
            hidden=m["hidden"], layers=m["layers"], heads=m["heads"],
            dropout=m["dropout"], lr=t["lr"], lr_min=t["lr_min"],
            weight_decay=t["weight_decay"], warmup_epochs=t["warmup_epochs"],
            sigma_warmup_epochs=t["sigma_warmup_epochs"],
            sigma_lr_max=t["sigma_lr_max"], optimizer=t["optimizer"],
            min_logvar_floor=t["min_logvar_floor"],
            log_sigma_l2=t["log_sigma_l2"],
            feature_jitter_std=t["feature_jitter_std"],
            early_stop=epochs + 1, bootstrap=True,
            bootstrap_ratio=t["bootstrap_ratio"], conv_impl=m["conv_impl"],
            pack_workers=t["pack_workers"], compute_dtype=m["compute_dtype"],
            scan_steps=t["scan_steps"], batch_quantile=t["batch_quantile"],
            batch_slack=t["batch_slack"], verbose=False)

    def run_member(self, epochs: int):
        from gnnep_tpu_torch.train.member import train_member
        return train_member(self.store, self.trainer(epochs), self.model_cfg,
                            self.transformer, self.budget, self.seed,
                            self.inputs["train"], self.inputs["val"],
                            device=self.device)


def instrument(state: State) -> Patches:
    """Wrap the program's step and eval forward (class attributes, so the
    objects `train_member` builds are seen): spans around each step call
    and val forward, epoch starts, graphs stepped, the checked steps'
    readings and, in a traced run, each batch's work."""
    from gnnep_tpu_torch.train import loop
    obs, m = state.obs, state.cell.model
    TS = loop.TrainStep
    run0, call0, lr0, fwd0 = TS.run, TS.__call__, TS.set_lr, \
        loop.Forward.__call__

    def run(self, batches, generator, *a, **k):
        with obs.span("step"):
            return run0(self, batches, generator, *a, **k)

    def call(self, batch, generator=None, *a, **k):
        with obs.span("step"):
            return call0(self, batch, generator, *a, **k)

    def set_lr(self, lr_mean, lr_sigma):
        state.marks.append(time.perf_counter())
        return lr0(self, lr_mean, lr_sigma)

    def wrap_one(one0):
        def one(self, batch, generator):
            w = state.watch
            if w is not None and w.seen == 0:
                w.p0 = {n: p.detach().clone()
                        for n, p in zip(self.names, self.params)}
            out = one0(self, batch, generator)
            if obs.recording:
                state.graphs += float(np.asarray(batch.graph_mask).sum())
                if obs.trace:
                    c = live_counts(batch)
                    state.flops += work.model_flops(c, m, True)
                    obs.add_work(work.op_bounds(c, m, True, *state.peaks))
            if w is not None and w.seen < w.n:
                w.seen += 1
                w.rows.append(out.detach().clone())
                idx = np.asarray(batch.sample_index)
                w.ids.append(idx[idx >= 0].tolist())
                if w.seen == 1:
                    w.mu1 = {n: v.detach().clone()
                             for n, v in zip(self.names, self.state.mu)}
                    w.p1 = {n: p.detach().clone()
                            for n, p in zip(self.names, self.params)}
                if w.seen == 2:
                    w.mu2 = {n: v.detach().clone()
                             for n, v in zip(self.names, self.state.mu)}
                if w.seen == w.n:
                    w.pn = {n: p.detach().clone()
                            for n, p in zip(self.names, self.params)}
            return out
        return one

    def fwd(self, model, batch):
        with obs.span("val_forward"):
            out = fwd0(self, model, batch)
        if obs.recording and obs.trace:
            obs.add_work(work.op_bounds(live_counts(batch), m, False,
                                        *state.peaks))
        return out

    patches = Patches()
    patches.set(TS, "run", run)
    patches.set(TS, "__call__", call)
    patches.set(TS, "set_lr", set_lr)
    for cls in (loop.TrainStep, loop.GraphTrainStep):
        patches.set(cls, "_one", wrap_one(cls.__dict__["_one"]))
    patches.set(loop.Forward, "__call__", fwd)
    return patches


def build(cell: Cell, seed: int, device, obs: Obs) -> State:
    """Inputs, the program's store and budget, instrumentation."""
    from gnnep_tpu_torch.data.transforms import LogTransformer
    inputs = make_inputs(cell, seed)
    store = program_store(inputs["graphs"])
    budget = plan_budget(store, cell.traffic["trainer"])
    transformer = LogTransformer.fit(store.y[np.asarray(inputs["train"])])
    save_dir = tempfile.mkdtemp(prefix="bench_port_member_",
                                dir=os.environ.get("TMPDIR"))
    state = State(cell, seed, torch.device(device), obs, inputs, store,
                  budget, transformer, model_config(cell, budget), save_dir)
    state.patches = instrument(state)
    return state


def warm(state: State) -> None:
    state.marks.clear()
    state.run_member(int(state.cell.traffic["warmup_epochs_run"]))
    _sync(state)
    state.last_epoch_s = time.perf_counter() - state.marks[-1]


def _sync(state: State) -> None:
    if state.device.type == "cuda":
        torch.cuda.synchronize()


def window(state: State, seconds: float) -> Dict:
    obs, t = state.obs, state.cell.traffic
    state.epochs = max(int(t["min_epochs"]),
                       int(round(seconds / state.last_epoch_s)))
    if obs.trace:
        state.peaks = work.peaks(torch.cuda.get_device_name(0),
                                 state.cell.model["compute_dtype"])
    state.watch = Watch(int(t["checked_steps"]))
    state.graphs = 0.0
    state.marks.clear()
    obs.recording = True
    with obs.span("window"):
        t0 = time.perf_counter()
        _, _, n_steps = state.run_member(state.epochs)
        _sync(state)
        t1 = time.perf_counter()
    obs.recording = False
    wall = t1 - t0
    starts = [t0] + state.marks[1:] + [t1]
    return dict(wall_s=wall, attempted=int(n_steps),
                metrics={"train_graphs_per_s": (state.graphs / wall,
                                                "graphs/s")},
                model_flops=state.flops,
                detail={"epoch_s": [round(b - a, 4) for a, b in
                                    zip(starts, starts[1:])]})


def program_readings(state: State) -> Dict:
    w = state.watch
    rows = [r.double().cpu().numpy() for r in w.rows]
    return dict(p0=w.p0, losses=[r[0] / r[1] for r in rows],
                g1={n: v.double() / (1.0 - ADAM_B1) for n, v in w.mu1.items()},
                p1=w.p1,
                g2={n: (w.mu2[n].double() - ADAM_B1 * v.double())
                    / (1.0 - ADAM_B1) for n, v in w.mu1.items()},
                pn=w.pn, ids=w.ids)


def release(state: State) -> None:
    """The program's state goes before the reference runs; the watch's
    device copies stay."""
    import gc
    import shutil
    shutil.rmtree(state.save_dir, ignore_errors=True)
    gc.collect()
    if state.device.type == "cuda":
        torch.cuda.empty_cache()


def reference(state: State, num: Numerics,
              judged_p1: Optional[Dict] = None) -> Dict:
    """The reference's readings; step 2's gradient at `judged_p1`, the
    judged side's weights after step 1, where given."""
    return reference_steps(state.inputs["graphs"], state.inputs["train"],
                           state.cell.model, state.cell.traffic["trainer"],
                           state.seed, state.epochs, state.watch.n,
                           state.device, num, judged_p1)


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(v.double())) for n, v in
            d.items()}


def _leaf_gaps(prog: Dict, ref: Dict):
    """Per leaf, |‖program‖ − ‖reference‖| of the clipped gradients of
    steps 1 and 2 and of the weights' change over the checked steps, over
    the larger of that leaf's reference norm and the median leaf's; and the
    leaves left out of the change: those whose reference gradient is under
    a thousandth of the median leaf's (Adam moves them by round-off)."""
    def gaps(key):
        p, r = _norms(prog[key]), _norms(ref[key])
        med = float(np.median(list(r.values())))
        return {n: abs(p[n] - r[n]) / max(r[n], med) for n in r}, r, med

    grad, gr, gmed = gaps("g1")
    grad2, _, _ = gaps("g2")
    moved = [n for n in gr if gr[n] >= 1e-3 * gmed]
    dp = _norms({n: prog["pn"][n] - prog["p0"][n] for n in moved})
    dr = _norms({n: ref["pn"][n] - ref["p0"][n] for n in moved})
    dmed = float(np.median(list(dr.values())))
    change = {n: abs(dp[n] - dr[n]) / max(dr[n], dmed) for n in moved}
    return grad, grad2, change, sorted(set(gr) - set(moved))


def _relative(a: float, b: float) -> float:
    return float(abs(a - b) / abs(b))


def numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The compared numbers: the initial weights (exact), each step's
    graphs (exact), each step's mean NLL (relative, worst step), the
    worst leaf of `_leaf_gaps`' change, and for each of the first two
    steps (step 1 eager, step 2 the first replay of the captured step,
    taken at the same weights on both sides) the median leaf of its
    gradient; for step 2 also its NLL. A gradient's worst leaf is always
    a β gate, whose gradient sums every row with heavy cancellation: it
    reads as high on sound runs as the control does (PERF.md §2)."""
    init = max(float((prog["p0"][n].double() - v.double()).abs().max())
               for n, v in ref["p0"].items())
    loss = max(_relative(a, b) for a, b in zip(prog["losses"],
                                               ref["losses"]))
    grad, grad2, change, _ = _leaf_gaps(prog, ref)
    batches = sum(a != b for a, b in zip(prog["ids"], ref["ids"]))
    return dict(init_gap=init, batch_ids=float(batches), loss_gap=loss,
                grad_gap=float(np.median(list(grad.values()))),
                replay_loss_gap=_relative(prog["losses"][1], ref["loss2"]),
                replay_grad_gap=float(np.median(list(grad2.values()))),
                change_gap=max(change.values()))


def detail(prog: Dict, ref: Dict) -> Dict:
    """Where the numbers come from: each step's loss gap, the leaves that
    read worst for the gradients and the change, and every leaf's gaps."""
    grad, grad2, change, left_out = _leaf_gaps(prog, ref)

    def worst(d):
        return sorted(d.items(), key=lambda kv: -kv[1])[:3]

    def signed(key):
        p, r = _norms(prog[key]), _norms(ref[key])
        return {n: [p[n], r[n]] for n in r}

    return dict(step_loss_gaps=[_relative(a, b) for a, b in
                                zip(prog["losses"], ref["losses"])],
                norms=dict(g1=signed("g1"), g2=signed("g2")),
                grad_worst=worst(grad), replay_grad_worst=worst(grad2),
                change_worst=worst(change),
                change_median_leaf=float(np.median(list(change.values()))),
                left_out=left_out, leaves=dict(grad=grad, replay_grad=grad2,
                                               change=change))


def check(state: State, num: Numerics) -> Dict[str, float]:
    prog = program_readings(state)
    return numbers(prog, reference(state, num, prog["p1"]))


def dry(cell: Cell, seed: int, graphs_in_store: int) -> Dict:
    """The cell's inputs at a tiny store size, the program's budget and the
    reference's first arenas, with no model run and no timing."""
    cell = dataclasses.replace(cell, traffic=dict(
        cell.traffic, store_graphs=graphs_in_store))
    inputs = make_inputs(cell, seed)
    store = program_store(inputs["graphs"])
    t = cell.traffic["trainer"]
    budget = plan_budget(store, t)
    ref_budget = ref_plan_budget(inputs["graphs"], range(store.n_graphs),
                                 t["batch_size"], slack=t["batch_slack"])
    arenas = first_batches(inputs["graphs"], inputs["train"], ref_budget,
                           seed, t["bootstrap_ratio"], 1)
    return dict(store_graphs=store.n_graphs, train=len(inputs["train"]),
                val=len(inputs["val"]),
                budget=[budget.n_nodes, budget.n_edges, budget.n_lg_edges],
                reference_budget=[ref_budget["n_nodes"], ref_budget["n_edges"],
                                  ref_budget["n_lg_edges"]],
                first_batch_graphs=int(arenas[0]["graph_mask"].sum()))
