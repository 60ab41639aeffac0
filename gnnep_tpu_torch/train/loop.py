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

On the card the step and the eval forward are captured CUDA graphs, the
counterpart of the JAX package's jitted and scanned programs
(`GraphTrainStep`, `Forward`): each batch is copied into static buffers and
the capture replayed; the optimizer's count and LRs are device tensors, so a
replay reads their current values. The CPU runs the same code eagerly.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from ..models.alignn import Alignn, AlignnConfig, DeviceBatch, alignn_apply
from ..ops.cuda.graphs import CountedGraph
from ..utils.device import resolve_device
from ..utils.profiling import span

MIN_LOGVAR_FLOOR = -2.9  # reference train.py:39
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# real steps a captured train step takes eagerly (on a side stream) before
# its capture: the first launch of each kernel builds and loads it
WARMUP_STEPS = 1


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


def train_outputs(model: Alignn, hyper: TrainHyper, batch: DeviceBatch,
                  generator: Optional[torch.Generator], train: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, logvar) of one batch as f32, the logvar not yet floored. With
    `train` and a generator, feature jitter and dropout are drawn from
    it."""
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
    return mean.float(), logvar.float()


def hetero_nll(model: Alignn, hyper: TrainHyper, batch: DeviceBatch,
               y_z: torch.Tensor, generator: Optional[torch.Generator],
               train: bool):
    """Loss + (mean, logvar, per-sample loss) of one batch; `y_z` are the
    log-standardized targets [G, T]. With `train` and a generator, feature
    jitter and dropout are drawn from it."""
    mean, logvar = train_outputs(model, hyper, batch, generator, train)
    logvar = torch.clamp_min(logvar, hyper.min_logvar_floor)
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


def nll_loss_sums(mean: torch.Tensor, logvar: torch.Tensor, batch,
                  y_z: torch.Tensor, hyper: TrainHyper):
    """The sum-form loss of the multi-device steps (the JAX package's
    `nll_loss_sums`): floor clamp, per-sample weights, y_mask-valid target
    averaging and the log-σ L2, summed over real graphs, not averaged →
    (loss_sum, per-sample loss). The caller divides the summed gradients
    by the global real-graph count."""
    logvar = torch.clamp_min(logvar, hyper.min_logvar_floor)
    nll = 0.5 * (logvar + (mean - y_z) ** 2 / torch.exp(logvar)) \
        * batch.weight[:, None]
    sample_loss = masked_sample_nll(nll, batch.y_mask, batch.graph_mask)
    loss_sum = sample_loss.sum()
    if hyper.log_sigma_l2 > 0.0:
        ls2 = ((0.5 * logvar) ** 2 * batch.graph_mask[:, None]).sum() \
            / y_z.shape[1]
        loss_sum = loss_sum + hyper.log_sigma_l2 * ls2
    return loss_sum, sample_loss


@torch.no_grad()
def step_metrics(mean: torch.Tensor, logvar: torch.Tensor,
                 sample_loss: torch.Tensor, batch, mu: torch.Tensor,
                 sd: torch.Tensor) -> torch.Tensor:
    """A step's `StepMetrics` stacked, f32 [7]: the error diagnostics over
    y_mask-valid (graph, target) cells of the linear-space prediction."""
    pred = torch.exp(mean * sd + mu)
    el_mask = batch.graph_mask[:, None] * batch.y_mask
    err = (pred - batch.y) * el_mask
    return torch.stack([
        sample_loss.sum(), batch.graph_mask.sum(), err.abs().sum(),
        (err ** 2).sum(), el_mask.sum(), (logvar * el_mask).sum(),
        (torch.exp(logvar) * batch.graph_mask[:, None]).max()])


@dataclasses.dataclass
class AdamState:
    """optax `ScaleByAdamState` per parameter, f32, with its int32 count a
    0-d tensor on the parameters' device."""

    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: torch.Tensor


def init_adam(params: Sequence[torch.Tensor]) -> AdamState:
    return AdamState([torch.zeros_like(p) for p in params],
                     [torch.zeros_like(p) for p in params],
                     torch.zeros((), dtype=torch.int32,
                                 device=params[0].device))


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """1 − decayᶜᵒᵘⁿᵗ in f32 from the int32 count, as optax forms it."""
    return 1.0 - torch.pow(decay, count)


@torch.no_grad()
def apply_update(params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], state: AdamState,
                 is_sigma: Sequence[bool],
                 lr_mean: Union[float, torch.Tensor],
                 lr_sigma: Union[float, torch.Tensor],
                 hyper: TrainHyper) -> torch.Tensor:
    """The optimizer tail, in place on `params` and `state`: global-norm
    clip, optional coupled decay, Adam moments, then `p − lr·(u + wd·p)` per
    leaf with `lr_sigma` for the sigma group (each LR a float or a 0-d f32
    tensor on the parameters' device). Returns the gradient norm."""
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
    state.count.add_(1)
    mu_hat = torch._foreach_div(state.mu,
                                _bias_correction(ADAM_B1, state.count))
    nu_hat = torch._foreach_div(state.nu,
                                _bias_correction(ADAM_B2, state.count))
    denom = torch._foreach_sqrt(nu_hat)
    torch._foreach_add_(denom, ADAM_EPS)
    updates = torch._foreach_div(mu_hat, denom)
    if wd:
        torch._foreach_add_(updates, list(params), alpha=wd)
    for sigma, lr in ((False, lr_mean), (True, lr_sigma)):
        pick = [i for i, s in enumerate(is_sigma) if s == sigma]
        if pick:
            torch._foreach_sub_([params[i] for i in pick], torch._foreach_mul(
                [updates[i] for i in pick], lr))
    return gnorm


def _on_device(batch, device: torch.device) -> DeviceBatch:
    """`batch` as a DeviceBatch on `device` (a GraphBatch is moved)."""
    if isinstance(batch, DeviceBatch):
        return batch
    return DeviceBatch.from_batch(batch, device)


class TrainStep:
    """One optimizer step of a member, run eagerly (the CPU's step; on the
    card `GraphTrainStep` replays its capture): `step(batch, generator)` →
    StepMetrics (0-d device tensors), `batch` a DeviceBatch or a host
    GraphBatch. The model's parameters and this object's Adam state update
    in place; after a step each parameter's `.grad` holds its raw gradient.
    The two LR groups' rates are device tensors, written by `set_lr` (or
    by passing `lr_mean` and `lr_sigma`)."""

    def __init__(self, model: Alignn, hyper: TrainHyper,
                 log_means: np.ndarray, log_stds: np.ndarray):
        self.model = model
        self.hyper = hyper
        names, params = zip(*model.named_parameters())
        self.names = list(names)
        self.params = list(params)
        smask = sigma_mask(model)
        self.is_sigma = [smask[n] for n in names]
        self.state = init_adam(self.params)
        self.device = self.params[0].device
        self.mu = torch.as_tensor(np.asarray(log_means, np.float32),
                                  device=self.device)
        self.sd = torch.as_tensor(np.asarray(log_stds, np.float32),
                                  device=self.device)
        self.lr_mean = torch.zeros((), dtype=torch.float32, device=self.device)
        self.lr_sigma = torch.zeros_like(self.lr_mean)

    def set_lr(self, lr_mean: float, lr_sigma: float) -> None:
        """Write the two groups' LRs into their device tensors, outside any
        captured program (a replay reads them where they are)."""
        self.lr_mean.fill_(lr_mean)
        self.lr_sigma.fill_(lr_sigma)

    def read_state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The step's own tensors by parameter name, not copies:
        {'params', 'mu', 'nu'} name → tensor, and 'count' {'count': 0-d}."""
        return {"params": dict(zip(self.names, self.params)),
                "mu": dict(zip(self.names, self.state.mu)),
                "nu": dict(zip(self.names, self.state.nu)),
                "count": {"count": self.state.count}}

    @torch.no_grad()
    def load_state(self, params: Dict[str, object], mu: Dict[str, object],
                   nu: Dict[str, object], count: int) -> None:
        """Write parameters, Adam moments (each by parameter name, arrays or
        tensors) and Adam's count into the step's own tensors with `copy_`:
        a captured step reads them where they are, so nothing is rebound."""
        for group, values in ((self.params, params), (self.state.mu, mu),
                              (self.state.nu, nu)):
            for name, t in zip(self.names, group):
                t.copy_(torch.as_tensor(values[name]))
        self.state.count.fill_(int(count))

    def _step(self, batch: DeviceBatch,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        """The step's work → its StepMetrics stacked, f32 [7]."""
        for p in self.params:
            p.grad = None
        y_z = target_z(batch, self.mu, self.sd)
        loss, (mean, logvar, sample_loss) = hetero_nll(
            self.model, self.hyper, batch, y_z, generator, train=True)
        loss.backward()
        apply_update(self.params, [p.grad for p in self.params], self.state,
                     self.is_sigma, self.lr_mean, self.lr_sigma, self.hyper)
        return step_metrics(mean, logvar, sample_loss, batch, self.mu,
                            self.sd)

    def _one(self, batch, generator: Optional[torch.Generator]
             ) -> torch.Tensor:
        return self._step(_on_device(batch, self.device), generator)

    def __call__(self, batch, generator: Optional[torch.Generator] = None,
                 lr_mean: Optional[float] = None,
                 lr_sigma: Optional[float] = None) -> StepMetrics:
        if lr_mean is not None:
            self.set_lr(lr_mean, lr_sigma)
        return StepMetrics(*self._one(batch, generator).clone())

    def run(self, batches: Sequence, generator: Optional[torch.Generator],
            lr_mean: Optional[float] = None,
            lr_sigma: Optional[float] = None) -> StepMetrics:
        """K sequential steps over `batches` (the JAX package's
        `make_scan_train_step`) → StepMetrics of [K] tensors, filled on the
        device and read back once by the caller."""
        if lr_mean is not None:
            self.set_lr(lr_mean, lr_sigma)
        rows = torch.empty((len(batches), len(StepMetrics._fields)),
                           dtype=torch.float32, device=self.device)
        for i, b in enumerate(batches):
            rows[i].copy_(self._one(b, generator))
        return StepMetrics(*rows.unbind(1))

    def close(self) -> None:
        """Drop what the step holds beyond the model and its state."""


class GraphTrainStep(TrainStep):
    """The train step on the card as a captured CUDA graph, the JAX
    package's jitted step with the parameters and Adam state donated.

    Each batch is copied into static buffers (`DeviceBatch.copy_from`).
    The first `WARMUP_STEPS` steps run eagerly on a side stream (PyTorch's
    whole-network capture recipe; they are real steps of the epoch). The
    next step captures loss → backward → optimizer tail → metrics once, with
    `generator` registered so each replay draws the next dropout and jitter
    numbers of its stream, then replays; every later step replays.
    Parameters and moments update in place, gradients live in the graph's
    pool. `run` replays K times into a [K] metrics buffer. A capture that
    fails raises: nothing falls back to the eager step."""

    def __init__(self, model: Alignn, hyper: TrainHyper,
                 log_means: np.ndarray, log_stds: np.ndarray):
        super().__init__(model, hyper, log_means, log_stds)
        self.static: Optional[DeviceBatch] = None
        self.graph: Optional[CountedGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.generator: Optional[torch.Generator] = None
        self.eager_steps = 0
        self._side = torch.cuda.Stream(self.device)

    def _one(self, batch, generator: Optional[torch.Generator]
             ) -> torch.Tensor:
        if self.static is None:
            self.static = DeviceBatch.allocate(batch, self.device)
            self.generator = generator
        elif generator is not self.generator:
            raise ValueError("a captured train step draws from the one "
                             "generator it started with")
        self.static.copy_from(batch)
        if self.graph is None and self.eager_steps < WARMUP_STEPS:
            self.eager_steps += 1
            with span("step.eager"):
                return _on_side(self._side,
                                lambda: self._step(self.static, generator))
        if self.graph is None:
            self.graph = CountedGraph("train")
            self.out = self.graph.capture(
                lambda: self._step(self.static, generator), generator)
        self.graph.replay()
        return self.out

    def close(self) -> None:
        """Free the graph, its pool (the gradients live there) and the
        static buffers."""
        captured = self.graph is not None
        if captured:
            self.graph.reset()
        self.graph = self.out = self.static = None
        for p in self.params:
            p.grad = None
        if captured:
            _release_pools()


def _release_pools() -> None:
    """Return the memory of freed graphs' pools to the card: the caching
    allocator keeps a freed private pool's blocks until `empty_cache`, so
    without it each member's captures would pile up (a capture does not
    empty the cache first, `ops/cuda/graphs.py`). Called only where a graph
    was freed: the next allocations pay for cudaMalloc again."""
    torch.cuda.empty_cache()


def _on_side(side: torch.cuda.Stream, fn: Callable[[], object]):
    """Run `fn` on the side stream, ordered after and before the current
    stream's work; its tensor outputs may be used on the current stream."""
    current = torch.cuda.current_stream(side.device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = fn()
    current.wait_stream(side)
    for t in (out if isinstance(out, tuple) else (out,)):
        t.record_stream(current)
    return out


def make_train_step(model: Alignn, hyper: TrainHyper, log_means: np.ndarray,
                    log_stds: np.ndarray, device=None) -> TrainStep:
    """The member's train step on `device` (the model moves there): a
    `GraphTrainStep` on the card, the eager `TrainStep` on the CPU. `device`
    None means CUDA, which must then be available."""
    dev = resolve_device(device)
    cls = GraphTrainStep if dev.type == "cuda" else TrainStep
    return cls(model.to(dev), hyper, log_means, log_stds)


def _shape_key(batch) -> tuple:
    """The shapes (and span fields) that fix a batch's budget."""
    return tuple((n, tuple(getattr(batch, n).shape))
                 for n, _ in DeviceBatch._dtypes(batch))


class Forward:
    """Eval forward → (mean_z f32, logvar f32 floored at `floor`), called as
    `forward(model, batch)` with a DeviceBatch or a host GraphBatch; the
    JAX package's `make_forward` and `collect_predictions_scanned`.

    `compute_dtype='bfloat16'` expects a member already cast with
    `cast_model` (cast once per member, not per batch) and casts the batch's
    features; the heads' outputs return as f32. On the CPU it runs eagerly
    (`eager`). On the card each (member, batch budget) is a captured graph:
    its first batch runs eagerly on a side stream (a real result, and the
    warm-up), its second captures the forward under `inference_mode`, and
    from then on each batch is copied into the static buffers and the
    capture replayed. The outputs returned are copies; `close` frees the
    graphs."""

    def __init__(self, floor: float = MIN_LOGVAR_FLOOR,
                 compute_dtype: str = "float32"):
        self.floor = floor
        self.dtype = _DTYPES[compute_dtype]
        self._graphs: Dict[tuple, dict] = {}

    def eager(self, model: Alignn, batch: DeviceBatch
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.inference_mode():
            mean, logvar = alignn_apply(model, cast_batch(batch, self.dtype))
            return (mean.float(),
                    torch.clamp_min(logvar.float(), self.floor))

    def __call__(self, model: Alignn, batch
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        device = next(model.parameters()).device
        if device.type != "cuda":
            return self.eager(model, _on_device(batch, device))
        key = (id(model), _shape_key(batch))
        entry = self._graphs.get(key)
        if entry is None:
            # the entry holds the model, so its id is not reused
            entry = self._graphs[key] = dict(
                model=model, static=DeviceBatch.allocate(batch, device),
                graph=None, out=None)
            entry["static"].copy_from(batch)
            return _on_side(torch.cuda.Stream(device),
                            lambda: self.eager(model, entry["static"]))
        entry["static"].copy_from(batch)
        if entry["graph"] is None:
            entry["graph"] = CountedGraph("eval")
            entry["out"] = entry["graph"].capture(
                lambda: self.eager(model, entry["static"]))
        entry["graph"].replay()
        return tuple(t.clone() for t in entry["out"])

    def close(self) -> None:
        graphs = [e["graph"] for e in self._graphs.values() if e["graph"]]
        for graph in graphs:
            graph.reset()
        self._graphs.clear()
        if graphs:
            _release_pools()


def make_forward(floor: float = MIN_LOGVAR_FLOOR,
                 compute_dtype: str = "float32") -> Forward:
    """The eval forward (`Forward`): captured on the card, eager on the
    CPU."""
    return Forward(floor, compute_dtype)


def collect_predictions(forward, model: Alignn, batches: Sequence
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
    """Run `forward` over the packed host batches → per-real-graph host
    arrays (mean_z [N,T], sigma_z [N,T], y_linear [N,T], sample_index
    [N]). Every batch is queued before the outputs are read back, once."""
    outs = [torch.stack(forward(model, b)) for b in batches]
    with span("val.readback"):
        host = torch.cat(outs, dim=1).cpu().numpy()
    return prediction_rows(batches, host)


def prediction_rows(batches: Sequence, host: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]:
    """[2, ΣG, T] (mean, logvar) of `batches`, concatenated in order →
    `collect_predictions`' per-real-graph rows."""
    means, sigmas, ys, idxs = [], [], [], []
    start = 0
    for b in batches:
        g = np.asarray(b.graph_mask).shape[0]
        mean, logvar = host[:, start:start + g]
        start += g
        mask = np.asarray(b.graph_mask) > 0
        means.append(mean[mask])
        sigmas.append(np.sqrt(np.exp(logvar))[mask])
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
