"""The member trainer's first optimizer steps, in plain PyTorch.

From the raw graphs, the member's train split and its seed, the reference
works out again the log-target statistics, the first batches' arenas
(`packing`), the initial weights, the epoch-0 learning rates of the two
parameter groups, and then steps: jitter and dropout drawn from a generator
seeded with the member's seed, the heteroscedastic loss, autograd, the global
norm clip at 5, Adam's moments (β 0.9 / 0.999, ε 1e-8) and the decoupled
weight decay, the log-variance head at its own rate.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .model import Numerics, forward, hetero_loss, init_params
from .packing import first_batches, plan_budget

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
INT_KEYS = ("node_graph", "edge_src", "edge_dst", "lg_src", "lg_dst",
            "sg_num")


def cosine_lr(total: int, warmup: int, max_lr: float, min_lr: float):
    """Per-epoch rate: linear warmup, then cosine down to `min_lr`."""
    warmup, total = max(int(warmup), 0), max(int(total), 1)
    if warmup >= total:
        warmup = max(total - 1, 0)
    floor = min(max(min_lr / max_lr, 0.0), 1.0)

    def at(epoch: int) -> float:
        if warmup > 0 and epoch < warmup:
            return max_lr * float(epoch + 1) / warmup
        prog = float(epoch - warmup) / float(max(total - warmup, 1))
        return max_lr * (floor + (1.0 - floor) * 0.5 * (1.0 + math.cos(
            math.pi * prog)))

    return at


def log_stats(y: np.ndarray):
    """Mean and population std of log targets (std 1 where degenerate)."""
    logged = np.log(np.asarray(y, dtype=np.float64))
    std = logged.std(axis=0, ddof=0)
    return logged.mean(axis=0), np.where(np.isfinite(std) & (std > 1e-12),
                                         std, 1.0)


def to_device(a: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        device, torch.int64 if k in INT_KEYS else None)
        for k, v in a.items() if k != "sample_index"}


def _clipped_grads(params: Dict[str, torch.Tensor], a: Dict, m: Dict, t: Dict,
                   num: Numerics, gen, log_means, log_stds):
    """One step's mean per-graph NLL and its gradient, clipped at the
    global norm as the trainer clips it."""
    mean, logvar = forward(params, a, m, num, gen=gen,
                           jitter=t["feature_jitter_std"])
    loss, nll_sum = hetero_loss(mean, logvar, a, log_means, log_stds,
                                t["min_logvar_floor"], t["log_sigma_l2"])
    nll = float(nll_sum.detach()) / float(a["graph_mask"].sum())
    grads = torch.autograd.grad(loss, list(params.values()))
    del mean, logvar, loss
    with torch.no_grad():
        gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        clip = min(1.0, t["grad_clip"] / max(float(gnorm), 1e-12))
        return nll, [g * clip for g in grads]


def reference_steps(graphs, train_idx: Sequence[int], m: Dict, t: Dict,
                    member_seed: int, epochs: int, n_steps: int, device,
                    num: Numerics,
                    judged_p1: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Dict:
    """Readings of the member's first `n_steps` (at least 2) steps: its
    initial weights `p0`, each step's mean per-graph NLL `losses`, the
    clipped gradient of the first step `g1`, the weights after it `p1`,
    the second step's mean NLL `loss2` and clipped gradient `g2`, the
    weights after the last step `pn`, with each step's batch `ids` (global
    graph ids).

    `loss2` and `g2` are taken at `judged_p1`, the weights after step 1 of
    the side being judged, where given: the second step (the trainer's
    first replay of its captured step) is then checked by itself, with the
    same jitter and dropout draws, and the reference's own trajectory goes
    on unchanged."""
    budget = plan_budget(graphs, range(graphs.n_graphs), t["batch_size"],
                         slack=t["batch_slack"])
    arenas = first_batches(graphs, train_idx, budget, member_seed,
                           t["bootstrap_ratio"], n_steps)
    mu_np, sd_np = log_stats(graphs.y[np.asarray(train_idx, np.int64)])
    log_means = torch.as_tensor(mu_np.astype(np.float32), device=device)
    log_stds = torch.as_tensor(sd_np.astype(np.float32), device=device)
    params = init_params(member_seed, m, device)
    names = list(params)
    p0 = {n: v.clone() for n, v in params.items()}
    for v in params.values():
        v.requires_grad_(True)
    mu = [torch.zeros_like(v) for v in params.values()]
    nu = [torch.zeros_like(v) for v in params.values()]
    sigma = ["logvar_head" in n for n in names]
    lr_mean = cosine_lr(epochs, t["warmup_epochs"], t["lr"], t["lr_min"])(0)
    lr_sigma = cosine_lr(epochs, t["sigma_warmup_epochs"], t["sigma_lr_max"],
                         t["lr_min"])(0)
    gen = torch.Generator(device=device)
    gen.manual_seed(member_seed)
    losses: List[float] = []
    g1 = p1 = g2 = loss2 = None
    for step, arena in enumerate(arenas, start=1):
        a = to_device(arena, device)
        if step == 2 and judged_p1 is not None:
            drawn = gen.get_state()
            at = {n: judged_p1[n].detach().clone().requires_grad_(True)
                  for n in names}
            loss2, side = _clipped_grads(at, a, m, t, num, gen, log_means,
                                         log_stds)
            g2 = dict(zip(names, side))
            del at, side
            gen.set_state(drawn)
        nll, grads = _clipped_grads(params, a, m, t, num, gen, log_means,
                                    log_stds)
        losses.append(nll)
        del a
        with torch.no_grad():
            if step == 1:
                g1 = {n: g.clone() for n, g in zip(names, grads)}
            elif step == 2 and g2 is None:
                g2 = {n: g.clone() for n, g in zip(names, grads)}
                loss2 = nll
            for i, (p, g) in enumerate(zip(params.values(), grads)):
                mu[i].mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
                nu[i].mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
                upd = (mu[i] / (1.0 - ADAM_B1 ** step)) / (
                    torch.sqrt(nu[i] / (1.0 - ADAM_B2 ** step)) + ADAM_EPS)
                upd = upd + t["weight_decay"] * p
                p.sub_((lr_sigma if sigma[i] else lr_mean) * upd)
            if step == 1:
                p1 = {n: v.detach().clone() for n, v in params.items()}
        del grads
    pn = {n: v.detach().clone() for n, v in params.items()}
    return dict(p0=p0, losses=losses, g1=g1, p1=p1, loss2=loss2, g2=g2,
                pn=pn,
                ids=[a["sample_index"][a["sample_index"] >= 0].tolist()
                     for a in arenas])
