"""AOT serving bundles: exported, self-contained inference artifacts (the
counterpart of `gnnep_tpu.infer.bundle`).

`export_bundle` writes the ensemble's eval forward as `torch.export`
programs (`forward_{k}.pt2`, one per distinct member config reconciled to
the bundle's batch budget, each specialized to that budget's arena
shapes), the member checkpoints, the scaler state, the conformal record and
a `meta.json` packing contract into a directory that `ServingBundle.load`
serves from without re-building the model's forward: the deployed program
is a pinned, auditable artifact rather than whatever the installed model
code traces to. A program takes the member's parameters (in the
checkpoint's leaf order, in the compute type) and a batch's tensors as
inputs and holds no weights, so members that share a config share one
program, each with its own weights.

The conv's kernels reach a program as the custom ops
`gnnep_torch::{attn_eproj_fwd,attn_fwd,softmax_aggregate_fwd}` (kernels 5,
3 and 1): on the card the loaded program launches the hand-written
kernels, and each member's program is captured as a CUDA graph and
replayed from static input buffers, as `train.loop.Forward` runs the
model (`BundleForward`); on the CPU it runs their plain versions.

Constraints of the format, as in the JAX package: a bundle serves only on
the platform it was exported on (`cuda` or `cpu`), and graphs beyond the
recorded `BatchBudget` are a packer error at serving time (re-export with a
larger budget).
"""
from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path
from typing import Any, Dict, List, Sequence

import torch
from torch import nn

from ..data.batching import BatchBudget, epoch_batches
from ..data.store import GraphStore
from ..models.alignn import Alignn, AlignnConfig, DeviceBatch, leaf_names
# registers the forward ops the programs call, before any program loads
from ..ops.cuda import aggregate, attention, attention_eproj  # noqa: F401
from ..train.loop import (_DTYPES, MIN_LOGVAR_FLOOR, Forward, cast_batch,
                          collect_predictions, reconcile_win64)
from ..utils.device import resolve_device
from .predict import Ensemble, format_mixture_results, pack_batches

FORMAT_VERSION = 1


class EvalProgram(nn.Module):
    """The port's eval forward under one member config as a function of
    the member's parameters (checkpoint leaf order, compute type) and a
    batch's tensor fields (`fields`, the budget's `n_graphs`) → (mean_z f32,
    logvar f32 floored at `floor`), what `Forward.eager` computes. Holds no
    weights: the model it calls lives on the meta device and takes the
    given parameters."""

    def __init__(self, cfg: AlignnConfig, fields: Sequence[str],
                 n_graphs: int, floor: float, compute_dtype: str):
        super().__init__()
        with torch.device("meta"):
            self._model = [Alignn(cfg)]   # a list: not a submodule
        self.names = leaf_names(cfg)
        self.fields = list(fields)
        self.n_graphs = int(n_graphs)
        self.floor = float(floor)
        self.dtype = _DTYPES[compute_dtype]

    def forward(self, *args: torch.Tensor):
        n = len(self.names)
        params = dict(zip(self.names, args[:n]))
        batch = DeviceBatch(**dict(zip(self.fields, args[n:])),
                            n_graphs=self.n_graphs)
        mean, logvar = torch.func.functional_call(
            self._model[0], params, (cast_batch(batch, self.dtype),))
        return mean.float(), torch.clamp_min(logvar.float(), self.floor)


def member_params(model: Alignn, compute_dtype: str) -> List[torch.Tensor]:
    """A member's parameters in leaf order, in the compute type (f32 ones
    cast once), detached: a program's first inputs."""
    params = dict(model.named_parameters())
    dtype = _DTYPES[compute_dtype]
    return [params[n].detach().to(dtype) for n in leaf_names(model.cfg)]


def export_bundle(ensemble_dir: str | Path, store: GraphStore,
                  out_dir: str | Path, batch_size: int = 64,
                  compute_dtype: str = "float32",
                  min_logvar_floor: float = MIN_LOGVAR_FLOOR,
                  device=None) -> Dict:
    """Export `ensemble_dir` as a self-contained serving bundle at `out_dir`
    for `device` (None: CUDA, which must then be available).

    `store` (raw, unstandardized) supplies the arena statistics the
    programs are specialized to: the budget covers every graph in it, and
    becomes the bundle's packing contract for future inputs. Members sharing
    a reconciled config share one exported program. Returns the meta
    dict."""
    dev = resolve_device(device)
    ens = Ensemble.load(ensemble_dir, device=dev)
    std_store = ens.scaler.apply(store)
    bs = int(min(batch_size, std_store.n_graphs))
    budget, batches = pack_batches(std_store, range(std_store.n_graphs), bs)
    example = DeviceBatch.from_batch(batches[0], dev)
    fields = [n for n, _ in DeviceBatch._dtypes(example)]
    inputs = [getattr(example, f) for f in fields]

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    programs: Dict[AlignnConfig, int] = {}
    member_programs: List[int] = []
    for model in ens.members:
        rcfg = reconcile_win64(model.cfg, budget)
        if rcfg not in programs:
            prog = EvalProgram(rcfg, fields, example.n_graphs,
                               min_logvar_floor, compute_dtype)
            with torch.no_grad():
                exported = torch.export.export(
                    prog, tuple(member_params(model, compute_dtype) + inputs),
                    strict=False)
            k = len(programs)
            torch.export.save(exported, out / f"forward_{k}.pt2")
            programs[rcfg] = k
        member_programs.append(programs[rcfg])

    src = Path(ensemble_dir)
    for f in sorted(src.iterdir()):
        if (f.name.startswith("model_") and f.suffix == ".npz"
                or f.name in ("scaler_state.npz", "conformal.json")):
            shutil.copy2(f, out / f.name)

    meta = {
        "format_version": FORMAT_VERSION,
        "budget": dataclasses.asdict(budget),
        "batch_size": bs,
        "compute_dtype": compute_dtype,
        "min_logvar_floor": float(min_logvar_floor),
        "member_programs": member_programs,
        "fields": fields,
        "platform": dev.type,
        "torch_version": torch.__version__,
    }
    (out / "meta.json").write_text(json.dumps(meta, indent=2))
    return meta


class BundleMember(nn.Module):
    """One member as its loaded program and its own parameters (the static
    inputs of its captured graph: they never move)."""

    def __init__(self, program: nn.Module, params: List[torch.Tensor],
                 fields: Sequence[str]):
        super().__init__()
        self.program = program
        self.params = nn.ParameterList(
            nn.Parameter(p, requires_grad=False) for p in params)
        self.fields = list(fields)

    def forward(self, batch: DeviceBatch):
        return self.program(*self.params,
                            *(getattr(batch, f) for f in self.fields))


class BundleForward(Forward):
    """`train.loop.Forward` over bundle members: eager on the CPU; on the
    card each member's program is captured on its second batch and
    replayed from the static batch buffers after that. The program casts
    the batch and floors the logvar itself."""

    def eager(self, member: BundleMember, batch: DeviceBatch):
        with torch.inference_mode():
            return member(batch)


class ServingBundle:
    """A loaded bundle: programs + members + packing contract."""

    def __init__(self, ensemble: Ensemble, programs: List, meta: Dict):
        self.ensemble = ensemble
        self.programs = programs
        self.meta = meta
        self.budget = BatchBudget(**meta["budget"])
        self.members = [
            BundleMember(programs[k], member_params(m, meta["compute_dtype"]),
                         meta["fields"])
            for m, k in zip(ensemble.members, meta["member_programs"])]

    @classmethod
    def load(cls, bundle_dir: str | Path, device=None) -> "ServingBundle":
        """Load for `device` (None: CUDA, which must then be available);
        a bundle exported for another platform raises."""
        dev = resolve_device(device)
        d = Path(bundle_dir)
        meta = json.loads((d / "meta.json").read_text())
        if meta["platform"] != dev.type:
            raise RuntimeError(
                f"bundle was exported for platform '{meta['platform']}' but "
                f"this process serves on '{dev.type}'; re-export on the "
                "target platform")
        ensemble = Ensemble.load(d, device=dev)
        programs = [torch.export.load(d / f"forward_{k}.pt2").module()
                    for k in range(max(meta["member_programs"]) + 1)]
        return cls(ensemble, programs, meta)

    def predict(self, store: GraphStore,
                indices: Sequence[int]) -> List[Dict[str, Any]]:
        """Mixture predictions through the exported programs. `store` is an
        already-standardized store (as for `Ensemble.predict`); inputs must
        fit the bundle's recorded budget (the packer checks)."""
        batches = epoch_batches(store, [int(i) for i in indices],
                                self.budget, shuffle=False)
        forward = BundleForward(self.meta["min_logvar_floor"])
        member_means, member_vars = [], []
        order = ys = None
        for member in self.members:
            mean_z, sigma_z, ys, order = collect_predictions(
                forward, member, batches)
            member_means.append(mean_z)
            member_vars.append(sigma_z ** 2)
        forward.close()
        return format_mixture_results(member_means, member_vars, order, ys,
                                      self.ensemble.transformer, store)
