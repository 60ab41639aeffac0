"""Train step, eval forward and prediction collection: the counterpart of
`gnnep_tpu.train.loop`.

- loss = mean over real graphs of mean-over-valid-targets of
  ½(logvar + diff²/var), logvar clamped at the floor (−2.9 default),
  per-sample weights, plus λ·mean((½logvar)²) log-σ L2;
- Gaussian feature jitter on node and global features;
- global-norm gradient clip at 5.0: `min(1, clip / max(gnorm, 1e-12))`;
- Adam moments as optax's `scale_by_adam(0.9, 0.999, 1e-8)`, then per leaf
  `p − lr·(u + wd·p)` with the logvar head ("sigma" group) at its own LR;
  `optimizer='adam'` couples the decay into the gradient after the clip.

Under bf16 the f32 parameters are cast inside the autograd graph each step
(the JAX package's `_cast_for_compute`), so gradients and Adam state stay
f32. Every dropout and jitter draw comes from one `torch.Generator` on the
device.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from ..models.alignn import Alignn, AlignnConfig, DeviceBatch, alignn_apply
from ..utils.device import resolve_device

MIN_LOGVAR_FLOOR = -2.9  # reference train.py:39
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# The JAX package's `_cast_for_compute` in two halves: the member is cast once
# per prediction run, the batch once per batch.
def cast_model(model: Alignn, compute_dtype: str) -> Alignn:
    """The member with every f32 parameter in `compute_dtype` (a copy,
    unless that is float32)."""
    dtype = _DTYPES[compute_dtype]
    if dtype == torch.float32:
        return model
    return copy.deepcopy(model).to(dtype)


def cast_batch(batch: DeviceBatch, dtype: torch.dtype) -> DeviceBatch:
    """The batch with its four feature arrays in `dtype` (masks stay f32)."""
    if dtype == torch.float32:
        return batch
    return dataclasses.replace(
        batch, nodes=batch.nodes.to(dtype), edge_attr=batch.edge_attr.to(dtype),
        lg_attr=batch.lg_attr.to(dtype), globals_=batch.globals_.to(dtype))


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    """Loss and optimizer hyperparameters, the JAX package's fields but
    `flat_opt` (a TPU parameter-layout choice; the port's tail always runs
    per leaf)."""

    weight_decay: float = 1e-4
    log_sigma_l2: float = 0.1
    feature_jitter_std: float = 0.1
    min_logvar_floor: float = MIN_LOGVAR_FLOOR
    grad_clip: float = 5.0
    optimizer: str = "adamw"     # 'adamw' (decoupled decay) or 'adam'
    compute_dtype: str = "float32"


class StepMetrics(NamedTuple):
    loss_sum: torch.Tensor       # Σ per-sample weighted NLL (real graphs)
    n_graphs: torch.Tensor
    abs_err_sum: torch.Tensor    # Σ |pred − y| linear space, real elements
    sq_err_sum: torch.Tensor
    n_elements: torch.Tensor
    logvar_sum: torch.Tensor
    max_var: torch.Tensor


def cosine_lr(total_epochs: int, warmup_epochs: int, max_lr: float,
              min_lr: float) -> Callable[[int], float]:
    """Per-epoch LR: linear warmup then cosine to min_lr (train.py:1215-1232)."""
    warmup = max(int(warmup_epochs), 0)
    total = max(int(total_epochs), 1)
    if warmup >= total:
        warmup = max(total - 1, 0)
    if max_lr <= 0:
        raise ValueError("max_lr must be positive for cosine scheduling")
    min_factor = min(max(min_lr / max_lr, 0.0), 1.0)

    def lr_at(epoch_idx: int) -> float:
        if warmup > 0 and epoch_idx < warmup:
            factor = float(epoch_idx + 1) / warmup
        else:
            progress = float(epoch_idx - warmup) / float(max(total - warmup, 1))
            factor = min_factor + (1.0 - min_factor) * 0.5 * (
                1.0 + math.cos(math.pi * progress))
        return max_lr * factor

    return lr_at


def sigma_mask(model: Alignn) -> Dict[str, bool]:
    """Parameter name → True for the sigma (logvar head) group."""
    return {name: "logvar_head" in name for name, _ in
            model.named_parameters()}


def masked_sample_nll(nll: torch.Tensor, y_mask: torch.Tensor,
                      graph_mask: torch.Tensor) -> torch.Tensor:
    """Per-sample mean NLL over valid targets only (`y_mask` [G, T] is the
    authority on target validity), zero for padding graphs."""
    valid = torch.clamp_min(y_mask.sum(dim=1), 1.0)
    return (nll * y_mask).sum(dim=1) / valid * graph_mask


def target_z(batch: DeviceBatch, mu: torch.Tensor,
             sd: torch.Tensor) -> torch.Tensor:
    """Log-standardized targets [G, T]."""
    return (torch.log(torch.clamp_min(batch.y, 1e-12)) - mu) / sd


def _compute_forward(model: Alignn, batch: DeviceBatch, dtype: torch.dtype,
                     *, train: bool, generator: Optional[torch.Generator]):
    """alignn_apply with the parameters and features in `dtype`; the f32
    parameters are cast inside the autograd graph."""
    if dtype == torch.float32:
        return alignn_apply(model, batch, train=train, generator=generator)
    params = {n: (p.to(dtype) if p.dtype == torch.float32 else p)
              for n, p in model.named_parameters()}
    return torch.func.functional_call(
        model, params, (cast_batch(batch, dtype),),
        {"train": train, "generator": generator})


def hetero_nll(model: Alignn, hyper: TrainHyper, batch: DeviceBatch,
               y_z: torch.Tensor, generator: Optional[torch.Generator],
               train: bool):
    """Loss + (mean, logvar, per-sample loss) of one batch; `y_z` are the
    log-standardized targets [G, T]. With `train` and a generator, feature
    jitter and dropout are drawn from it."""
    if train and hyper.feature_jitter_std > 0.0 and generator is not None:
        std = hyper.feature_jitter_std
        batch = dataclasses.replace(
            batch,
            nodes=batch.nodes + std * torch.randn(
                batch.nodes.shape, generator=generator,
                device=batch.nodes.device),
            globals_=batch.globals_ + std * torch.randn(
                batch.globals_.shape, generator=generator,
                device=batch.globals_.device))
    mean, logvar = _compute_forward(model, batch, _DTYPES[hyper.compute_dtype],
                                    train=train, generator=generator)
    mean = mean.float()
    logvar = torch.clamp_min(logvar.float(), hyper.min_logvar_floor)
    nll = 0.5 * (logvar + (mean - y_z) ** 2 / torch.exp(logvar))
    nll = nll * batch.weight[:, None]
    sample_loss = masked_sample_nll(nll, batch.y_mask, batch.graph_mask)
    n_real = torch.clamp_min(batch.graph_mask.sum(), 1.0)
    loss = sample_loss.sum() / n_real
    if hyper.log_sigma_l2 > 0.0:
        log_sigma_sq = (0.5 * logvar) ** 2 * batch.graph_mask[:, None]
        loss = loss + hyper.log_sigma_l2 * log_sigma_sq.sum() / (
            n_real * y_z.shape[1])
    return loss, (mean, logvar, sample_loss)


@dataclasses.dataclass
class AdamState:
    """optax `ScaleByAdamState` per parameter, f32."""

    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: int = 0


def init_adam(params: Sequence[torch.Tensor]) -> AdamState:
    return AdamState([torch.zeros_like(p) for p in params],
                     [torch.zeros_like(p) for p in params])


def _f32_bias_correction(decay: float, count: int) -> float:
    """1 − decayᶜᵒᵘⁿᵗ in f32, as optax forms it from an int32 count."""
    return float(np.float32(1.0) - np.power(np.float32(decay), count))


@torch.no_grad()
def apply_update(params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], state: AdamState,
                 is_sigma: Sequence[bool], lr_mean: float, lr_sigma: float,
                 hyper: TrainHyper) -> torch.Tensor:
    """The optimizer tail, in place on `params` and `state`: global-norm
    clip, optional coupled decay, Adam moments, then `p − lr·(u + wd·p)` per
    leaf with `lr_sigma` for the sigma group. Returns the gradient norm."""
    grads = [g.float() for g in grads]
    gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.clamp(hyper.grad_clip / torch.clamp_min(gnorm, 1e-12),
                        max=1.0)
    grads = torch._foreach_mul(grads, scale)
    wd = hyper.weight_decay
    if hyper.optimizer == "adam":       # coupled L2: decay enters the moments
        torch._foreach_add_(grads, list(params), alpha=wd)
        wd = 0.0
    torch._foreach_mul_(state.mu, ADAM_B1)
    torch._foreach_add_(state.mu, grads, alpha=1.0 - ADAM_B1)
    torch._foreach_mul_(state.nu, ADAM_B2)
    torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - ADAM_B2)
    state.count += 1
    mu_hat = torch._foreach_div(state.mu,
                                _f32_bias_correction(ADAM_B1, state.count))
    nu_hat = torch._foreach_div(state.nu,
                                _f32_bias_correction(ADAM_B2, state.count))
    denom = torch._foreach_sqrt(nu_hat)
    torch._foreach_add_(denom, ADAM_EPS)
    updates = torch._foreach_div(mu_hat, denom)
    if wd:
        torch._foreach_add_(updates, list(params), alpha=wd)
    for sigma, lr in ((False, lr_mean), (True, lr_sigma)):
        pick = [i for i, s in enumerate(is_sigma) if s == sigma]
        if pick:
            torch._foreach_add_([params[i] for i in pick],
                                [updates[i] for i in pick], alpha=-lr)
    return gnorm


class TrainStep:
    """One optimizer step of a member, the JAX package's `make_train_step`:
    `step(batch, generator, lr_mean, lr_sigma)` → StepMetrics (0-d device
    tensors). The model's parameters and this object's Adam state update in
    place; after a step each parameter's `.grad` holds its raw gradient."""

    def __init__(self, model: Alignn, hyper: TrainHyper,
                 log_means: np.ndarray, log_stds: np.ndarray):
        self.model = model
        self.hyper = hyper
        names, params = zip(*model.named_parameters())
        self.params = list(params)
        smask = sigma_mask(model)
        self.is_sigma = [smask[n] for n in names]
        self.state = init_adam(self.params)
        device = self.params[0].device
        self.mu = torch.as_tensor(np.asarray(log_means, np.float32),
                                  device=device)
        self.sd = torch.as_tensor(np.asarray(log_stds, np.float32),
                                  device=device)

    def __call__(self, batch: DeviceBatch, generator: Optional[torch.Generator],
                 lr_mean: float, lr_sigma: float) -> StepMetrics:
        for p in self.params:
            p.grad = None
        y_z = target_z(batch, self.mu, self.sd)
        loss, (mean, logvar, sample_loss) = hetero_nll(
            self.model, self.hyper, batch, y_z, generator, train=True)
        loss.backward()
        apply_update(self.params, [p.grad for p in self.params], self.state,
                     self.is_sigma, lr_mean, lr_sigma, self.hyper)
        with torch.no_grad():
            pred = torch.exp(mean * self.sd + self.mu)
            el_mask = batch.graph_mask[:, None] * batch.y_mask
            err = (pred - batch.y) * el_mask
            return StepMetrics(
                loss_sum=sample_loss.sum(), n_graphs=batch.graph_mask.sum(),
                abs_err_sum=err.abs().sum(), sq_err_sum=(err ** 2).sum(),
                n_elements=el_mask.sum(),
                logvar_sum=(logvar * el_mask).sum(),
                max_var=(torch.exp(logvar)
                         * batch.graph_mask[:, None]).max())

    def run(self, batches: Sequence[DeviceBatch],
            generator: Optional[torch.Generator], lr_mean: float,
            lr_sigma: float) -> StepMetrics:
        """K sequential steps over `batches` (the JAX package's
        `make_scan_train_step`) → StepMetrics of [K] tensors, read back
        once."""
        ms = [self(b, generator, lr_mean, lr_sigma) for b in batches]
        return StepMetrics(*(torch.stack(x) for x in zip(*ms)))


def make_train_step(model: Alignn, hyper: TrainHyper, log_means: np.ndarray,
                    log_stds: np.ndarray, device=None) -> TrainStep:
    """The member's train step on `device` (the model moves there). `device`
    None means CUDA, which must then be available."""
    return TrainStep(model.to(resolve_device(device)), hyper, log_means,
                     log_stds)


def make_forward(floor: float = MIN_LOGVAR_FLOOR,
                 compute_dtype: str = "float32"
                 ) -> Callable[[Alignn, DeviceBatch],
                               Tuple[torch.Tensor, torch.Tensor]]:
    """Eval forward → (mean_z f32, logvar f32 floored at `floor`).

    `compute_dtype='bfloat16'` expects a member already cast with
    `cast_model` (cast once per member, not per batch) and casts the batch's
    features; the heads' outputs return as f32."""
    dtype = _DTYPES[compute_dtype]

    def forward(model: Alignn, batch: DeviceBatch):
        with torch.inference_mode():
            mean, logvar = alignn_apply(model, cast_batch(batch, dtype))
            return (mean.float(),
                    torch.clamp_min(logvar.float(), floor))

    return forward


def collect_predictions(forward, model: Alignn, batches: Sequence, device
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
    """Run `forward` over the packed batches → per-real-graph host arrays
    (mean_z [N,T], sigma_z [N,T], y_linear [N,T], sample_index [N])."""
    means, sigmas, ys, idxs = [], [], [], []
    for b in batches:
        mean, logvar = forward(model, DeviceBatch.from_batch(b, device))
        mask = np.asarray(b.graph_mask) > 0
        means.append(mean.cpu().numpy()[mask])
        sigmas.append(np.sqrt(np.exp(logvar.cpu().numpy()))[mask])
        # invalid targets (y_mask 0) surface as NaN, never as y's inert fill
        yv = np.where(np.asarray(b.y_mask) > 0, np.asarray(b.y), np.nan)
        ys.append(yv[mask])
        idxs.append(np.asarray(b.sample_index)[mask])
    return (np.concatenate(means), np.concatenate(sigmas),
            np.concatenate(ys), np.concatenate(idxs))


def with_config(model: Alignn, cfg: AlignnConfig) -> Alignn:
    """The member's forward under `cfg`: a shallow copy sharing its
    parameters (the member itself where `cfg` is its own), as the JAX
    package runs a member's parameters under a reconciled config."""
    if cfg == model.cfg:
        return model
    run = copy.copy(model)
    run.cfg = cfg
    return run


def reconcile_win64(cfg: AlignnConfig, budget) -> AlignnConfig:
    """The checkpoint config with its packer window bounds replaced by the
    active batch budget's, and the span bounds cleared, as the JAX package
    does before every eval forward (the window bounds size the TPU kernels'
    windows, which the CUDA kernels do not have; clearing the span bounds
    turns the span rung into the eproj rung on an eval-time repack)."""
    return dataclasses.replace(
        cfg,
        edge_win64=int(budget.edge_win64), lg_win64=int(budget.lg_win64),
        edge_src_win64=int(budget.edge_src_win64),
        lg_src_win64=int(budget.lg_src_win64),
        edge_span64=0, lg_span64=0)
