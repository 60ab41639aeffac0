"""The device mesh over (data × edge) as rank processes: the counterpart of
`gnnep_tpu.parallel.mesh`.

Axes, as in the JAX package:
- "data": data parallelism over graphs; gradients are summed across it;
- "edge": partitioning within a batch or a giant graph (the boundary
  exchange's `all_to_all` and the pooling partials ride it, and the
  edge-sharded formulation's per-conv combines and bond-state gather).

The JAX package is single-controller: one process sees every device and
`shard_map` runs the per-device body. The port runs one process per mesh
slot instead, with `torch.distributed` between them. `World` spawns the
slots' processes (the `spawn` start method) and runs module-level rank
bodies in them: `world.run(fn, *args)` calls `fn(rank, *args)` on every
slot, where `rank` is this slot's `Rank`, and returns rank 0's result.
A one-slot mesh runs in the calling process with no process group: every
collective over one slot is the identity, as a `psum` over a size-1 axis
is in JAX.

Devices and backends: on `cuda`, slot i binds `cuda:i` over NCCL, and
asking for more slots than visible cards raises a `ValueError`; on `cpu`
any number of slots runs over gloo (how the tests drive the mesh). A
library caller may name its devices and backend itself, e.g. two slots on
one card over gloo (`devices=["cuda:0", "cuda:0"], backend="gloo"`); NCCL
refuses a card used twice. Gloo does not take CUDA tensors in every
collective, so under gloo a CUDA tensor's collective is staged through a
pinned host buffer (`_staged`); NCCL reduces on the card.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import shutil
import tempfile
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
EDGE_AXIS = "edge"

# bytes this process has sent through `all_to_all_rows` (the boundary
# exchange's wire volume, forward and backward), as the kernels' wrappers
# count their launches; the chip smoke run sets it to 0 before a path
sent_bytes = 0
# bytes this process has handed to the reductions and gathers below (each
# call's own input, where the axis has more than one rank), counted the
# same way
reduced_bytes = 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data × edge) grid of slots, slot r = (r // n_edge, r % n_edge),
    each bound to `devices[r]`, joined over `backend`."""

    n_data: int
    n_edge: int
    devices: Tuple[str, ...]
    backend: str

    @property
    def size(self) -> int:
        return self.n_data * self.n_edge

    def coords(self, rank: int) -> Tuple[int, int]:
        """(data index, edge index) of slot `rank`."""
        return divmod(int(rank), self.n_edge)


def visible_cards(device) -> Optional[int]:
    """Cards a mesh on `device`'s type may use: None (no limit) on the CPU,
    `torch.cuda.device_count()` on the card."""
    return None if torch.device(device).type == "cpu" \
        else torch.cuda.device_count()


def slot_devices(n_slots: int, device) -> List[str]:
    """One device a slot: 'cpu' for each on the CPU, cuda:0..n-1 on the
    card (the caller has checked `visible_cards`)."""
    if torch.device(device).type == "cpu":
        return ["cpu"] * int(n_slots)
    return [f"cuda:{i}" for i in range(int(n_slots))]


def _indexed(device) -> torch.device:
    """A card without an index is card 0 (a rank binds its card by index)."""
    d = torch.device(device)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None \
        else d


def make_mesh(n_data: Optional[int] = None, n_edge: int = 1,
              devices: Optional[Sequence] = None,
              backend: Optional[str] = None) -> Mesh:
    """Mesh over (data × edge); devices default to every visible card, the
    data axis to all of them. The backend defaults to NCCL on cards and
    gloo on the CPU."""
    devs = [str(_indexed(d)) for d in (
        devices if devices is not None
        else slot_devices(torch.cuda.device_count(), "cuda"))]
    if n_data is None:
        n_data = len(devs) // n_edge
    if n_data * n_edge != len(devs) or not devs:
        raise ValueError(f"n_data ({n_data}) × n_edge ({n_edge}) "
                         f"!= device count ({len(devs)})")
    kinds = {torch.device(d).type for d in devs}
    if len(kinds) > 1:
        raise ValueError(f"a mesh's slots share one device type: {devs}")
    if backend is None:
        backend = "gloo" if kinds == {"cpu"} else "nccl"
    if backend == "nccl":
        if kinds != {"cuda"}:
            raise ValueError("NCCL joins CUDA devices only")
        if len(set(devs)) < len(devs):
            raise ValueError(f"NCCL refuses a card used by two slots: "
                             f"{devs}; pass backend='gloo'")
    elif backend != "gloo":
        raise ValueError(f"unsupported backend {backend!r}")
    return Mesh(int(n_data), int(n_edge), tuple(devs), backend)


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join a multi-host process group: from `MASTER_ADDR` / `MASTER_PORT`
    / `RANK` / `WORLD_SIZE` (`init_method='env://'`) or the arguments.
    Idempotent: a second call is a no-op."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=world_size if world_size is not None
        else int(os.environ["WORLD_SIZE"]),
        rank=rank if rank is not None else int(os.environ["RANK"]))


def make_multihost_mesh(n_edge: int = 1,
                        local_size: Optional[int] = None) -> Mesh:
    """The mesh of an initialized multi-host group: hosts on the outer data
    axis, the edge axis inside a host (its per-conv exchanges stay on the
    host's links; the data axis reduces once per step). `local_size`
    defaults to `LOCAL_WORLD_SIZE`, else the visible cards."""
    if not dist.is_initialized():
        raise RuntimeError("call init_distributed first")
    local = int(local_size if local_size is not None else os.environ.get(
        "LOCAL_WORLD_SIZE", max(torch.cuda.device_count(), 1)))
    if n_edge > local or local % n_edge:
        raise ValueError(f"n_edge ({n_edge}) must divide the local device "
                         f"count ({local}) so edge collectives stay on a "
                         "host")
    world = dist.get_world_size()
    backend = dist.get_backend()
    kind = "cpu" if backend == "gloo" and not torch.cuda.is_available() \
        else "cuda"
    devs = tuple("cpu" if kind == "cpu" else f"cuda:{r % local}"
                 for r in range(world))
    return Mesh(world // n_edge, n_edge, devs, backend)


class Rank:
    """One slot of a mesh in its own process: its coordinates, its device
    and the process groups of its two axes (None: the whole world)."""

    def __init__(self, mesh: Mesh, rank: int):
        self.mesh = mesh
        self.rank = int(rank)
        self.data, self.edge = mesh.coords(rank)
        self.device = torch.device(mesh.devices[self.rank])
        self.groups: Dict[str, Any] = {DATA_AXIS: None, EDGE_AXIS: None}
        if mesh.size > 1 and mesh.n_data > 1 and mesh.n_edge > 1:
            # every process creates every group, in the same order
            for d in range(mesh.n_data):
                g = dist.new_group([d * mesh.n_edge + e
                                    for e in range(mesh.n_edge)])
                if d == self.data:
                    self.groups[EDGE_AXIS] = g
            for e in range(mesh.n_edge):
                g = dist.new_group([d * mesh.n_edge + e
                                    for d in range(mesh.n_data)])
                if e == self.edge:
                    self.groups[DATA_AXIS] = g

    def axis_size(self, axis: Optional[str]) -> int:
        return {None: self.mesh.size, DATA_AXIS: self.mesh.n_data,
                EDGE_AXIS: self.mesh.n_edge}[axis]

    def group(self, axis: Optional[str]):
        return None if axis is None else self.groups[axis]


def _staged(rank: Rank, t: torch.Tensor, op: Callable[[torch.Tensor], None]
            ) -> None:
    """Run the in-place collective `op` on `t`; under gloo a CUDA tensor
    goes through a pinned host buffer and back."""
    if rank.mesh.backend == "gloo" and t.is_cuda:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        op(host)
        t.copy_(host)
    else:
        op(t)


def _count(t: torch.Tensor) -> None:
    global reduced_bytes
    reduced_bytes += t.numel() * t.element_size()


def all_reduce_sum(rank: Rank, buf: torch.Tensor,
                   axis: Optional[str] = None) -> torch.Tensor:
    """Sum `buf` over the ranks of `axis` (None: all) in place."""
    if rank.axis_size(axis) > 1:
        _count(buf)
        _staged(rank, buf, lambda t: dist.all_reduce(
            t, op=dist.ReduceOp.SUM, group=rank.group(axis)))
    return buf


def all_reduce_max(rank: Rank, buf: torch.Tensor,
                   axis: Optional[str] = None) -> torch.Tensor:
    """Elementwise max of `buf` over the ranks of `axis` in place."""
    if rank.axis_size(axis) > 1:
        _count(buf)
        _staged(rank, buf, lambda t: dist.all_reduce(
            t, op=dist.ReduceOp.MAX, group=rank.group(axis)))
    return buf


def pmax(rank: Rank, x: torch.Tensor, axis: str = EDGE_AXIS) -> torch.Tensor:
    """Elementwise max over the ranks of `axis`, a new tensor without a
    gradient (the softmax stabilizer's `stop_gradient(pmax)`)."""
    return all_reduce_max(rank, x.detach().clone(), axis)


def _gathered(rank: Rank, x: torch.Tensor, axis: str) -> List[torch.Tensor]:
    """Every rank's `x` along `axis`, in rank order, exact copies; under
    gloo a CUDA tensor's copies stay in pinned host memory."""
    _count(x)
    src = x.detach().contiguous()
    if rank.mesh.backend == "gloo" and src.is_cuda:
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        src = host.copy_(src)
    parts = [torch.empty_like(src) for _ in range(rank.axis_size(axis))]
    dist.all_gather(parts, src, group=rank.group(axis))
    return parts


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rank, axis):
        ctx.rank, ctx.axis = rank, axis
        return torch.cat(_gathered(rank, x, axis)).to(x.device)

    @staticmethod
    def backward(ctx, g):
        rows = g.shape[0] // ctx.rank.axis_size(ctx.axis)
        pos = ctx.rank.edge if ctx.axis == EDGE_AXIS else ctx.rank.data
        total = all_reduce_sum(ctx.rank, g.contiguous().clone(), ctx.axis)
        return total[pos * rows:(pos + 1) * rows], None, None


def all_gather_rows(rank: Rank, x: torch.Tensor,
                    axis: str = EDGE_AXIS) -> torch.Tensor:
    """Every rank's rows [B, ·] of `axis`, concatenated in rank order →
    [S·B, ·] (JAX's tiled `all_gather`). Differentiable: its backward sums
    the cotangents over the axis and keeps this rank's B rows (JAX's
    transpose, `psum_scatter`), so that a replicated path's gradient is
    summed S times, as the edge axis' average expects."""
    if rank.axis_size(axis) == 1:
        return x
    return _AllGatherRows.apply(x, rank, axis)


def _all_to_all(rank: Rank, x: torch.Tensor, axis: str) -> torch.Tensor:
    global sent_bytes
    sent_bytes += x.numel() * x.element_size()
    out = torch.empty_like(x)
    # gloo's all_to_all takes no bf16: it rides as bytes, rows unchanged
    raw_in = x.contiguous()
    raw_out = out
    if x.dtype == torch.bfloat16:
        raw_in, raw_out = raw_in.view(torch.uint8), out.view(torch.uint8)

    def op(t):
        got = torch.empty_like(t)
        dist.all_to_all_single(got, t, group=rank.group(axis))
        t.copy_(got)

    raw_out.copy_(raw_in)
    _staged(rank, raw_out, op)
    return out


class _AllToAllRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rank, axis):
        ctx.rank, ctx.axis = rank, axis
        return _all_to_all(rank, x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(ctx.rank, g, ctx.axis), None, None


def all_to_all_rows(rank: Rank, x: torch.Tensor,
                    axis: str = EDGE_AXIS) -> torch.Tensor:
    """Rows [S·B, W]: block t (rows t·B..t·B+B) goes to rank t of `axis`,
    and block t of the result came from rank t. Differentiable: its
    backward is the same exchange of the cotangents (JAX's transpose of
    `all_to_all`)."""
    if rank.axis_size(axis) == 1:
        return x
    return _AllToAllRows.apply(x, rank, axis)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rank, axis):
        ctx.rank, ctx.axis = rank, axis
        return all_reduce_sum(rank, x.detach().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(ctx.rank, g.contiguous().clone(),
                              ctx.axis), None, None


def psum(rank: Rank, x: torch.Tensor, axis: str = EDGE_AXIS) -> torch.Tensor:
    """Differentiable sum over the ranks of `axis`. Its backward sums the
    cotangents again (JAX's transpose of `psum`): where every rank of the
    axis computes the same loss from the sum, each rank's gradient holds
    the axis size times its own share, which is why the edge axis averages
    its gradients."""
    if rank.axis_size(axis) == 1:
        return x
    return _Psum.apply(x, rank, axis)


def all_gather(rank: Rank, x: torch.Tensor,
               axis: Optional[str] = None) -> List[torch.Tensor]:
    """Every rank's `x` (equal shapes), in rank order along `axis`."""
    if rank.axis_size(axis) == 1:
        return [x]
    return [p.to(x.device) for p in _gathered(rank, x, axis)]


def broadcast_object(rank: Rank, obj=None):
    """Rank 0's `obj` on every rank (host objects: decisions, weights)."""
    if rank.mesh.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def gather_objects(rank: Rank, obj) -> List:
    """Every rank's host `obj`, in rank order, on every rank."""
    if rank.mesh.size == 1:
        return [obj]
    out = [None] * rank.mesh.size
    dist.all_gather_object(out, obj)
    return out


def probe_collectives(rank: Rank, rows: int = 3, width: int = 5
                      ) -> Dict[str, bool]:
    """Every collective helper on this rank's device, each result held
    against its value computed here → {check: passed}. The sums are of
    small integers, exact in f32, so every check is an equality."""
    n, r, dev = rank.mesh.size, rank.rank, rank.device
    out: Dict[str, bool] = {}
    x = torch.arange(width, dtype=torch.float32, device=dev) + r
    out["all_reduce_sum"] = bool(torch.equal(
        all_reduce_sum(rank, x.clone()),
        n * torch.arange(width, dtype=torch.float32, device=dev)
        + n * (n - 1) / 2))
    out["all_reduce_max"] = bool(torch.equal(
        all_reduce_max(rank, x.clone()), x - r + (n - 1)))
    got = all_gather(rank, x)
    out["all_gather"] = all(torch.equal(g, x - r + k)
                            for k, g in enumerate(got))
    for axis in (EDGE_AXIS, DATA_AXIS):
        size = rank.axis_size(axis)
        me = rank.edge if axis == EDGE_AXIS else rank.data
        # block t of rank s holds 10·s + t, for rank t (exact in bf16)
        for dtype in (torch.float32, torch.bfloat16):
            send = (10.0 * me + torch.arange(size, device=dev)
                    ).repeat_interleave(rows)[:, None].expand(
                        size * rows, width).to(dtype).requires_grad_(True)
            recv = all_to_all_rows(rank, send, axis)
            want = (10.0 * torch.arange(size, device=dev) + me
                    ).repeat_interleave(rows)[:, None].expand_as(recv)
            # the backward sends each cotangent block back to its source
            (recv.float() * want.float()).sum().backward()
            out[f"all_to_all_{axis}_{str(dtype)[6:]}"] = bool(
                torch.equal(recv.float(), want.float())
                and torch.equal(send.grad.float(), send.detach().float()))
        y = (x + 0).requires_grad_(True)
        total = psum(rank, y, axis)
        total.sum().backward()
        out[f"psum_{axis}"] = bool(torch.equal(
            y.grad, torch.full_like(y, float(size))))
    out["broadcast_object"] = broadcast_object(rank, {"r": r}) == {"r": 0}
    out["gather_objects"] = gather_objects(rank, r) == list(range(n))
    return out


# ---------------------------------------------------------------------------
# rank processes
# ---------------------------------------------------------------------------

def _rank_main(mesh: Mesh, rank: int, init_file: str, tasks, results,
               threads: int) -> None:
    torch.set_num_threads(threads)
    device = torch.device(mesh.devices[rank])
    if device.type == "cuda":
        from ..utils.device import set_precision_flags

        torch.cuda.set_device(device)
        set_precision_flags()
    dist.init_process_group(mesh.backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=mesh.size)
    try:
        ctx = Rank(mesh, rank)
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args, every = task
            try:
                out = fn(ctx, *args)
                results.put((rank, True, out if every or rank == 0
                             else None))
            except Exception:
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    """The processes of a mesh's slots, started once and kept for the
    tasks `run` sends them, until `close` (or the `with` block's end).
    One process per slot costs a process start (torch's import, the
    card's context, the group's rendezvous), so a run keeps its worlds
    (`WorldPool`). A one-slot mesh starts nothing: `run` calls the body
    in this process."""

    POLL_S = 1.0

    def __init__(self, mesh: Mesh, threads: Optional[int] = None):
        self.mesh = mesh
        self.procs: list = []
        self.local = Rank(mesh, 0) if mesh.size == 1 else None
        if self.local is not None:
            return
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.tmp = tempfile.mkdtemp(prefix="gnnep_mesh_")
        init_file = os.path.join(self.tmp, "rendezvous")
        self.tasks = [ctx.SimpleQueue() for _ in range(mesh.size)]
        self.results = ctx.Queue()
        if threads is None:
            threads = max(1, torch.get_num_threads() // mesh.size)
        for r in range(mesh.size):
            p = ctx.Process(target=_rank_main, daemon=True,
                            args=(mesh, r, init_file, self.tasks[r],
                                  self.results, threads))
            p.start()
            self.procs.append(p)

    def run(self, fn: Callable, *args, every_rank: bool = False):
        """`fn(rank, *args)` on every slot (`fn` a module-level function,
        its arguments picklable) → rank 0's result, or every rank's in
        rank order with `every_rank`. A rank that raises ends the world and
        raises here with its traceback."""
        if self.local is not None:
            out = fn(self.local, *args)
            return [out] if every_rank else out
        if not self.procs:
            raise RuntimeError("this world is closed")
        for q in self.tasks:
            q.put((fn, args, every_rank))
        outs: Dict[int, Any] = {}
        while len(outs) < self.mesh.size:
            try:
                r, ok, val = self.results.get(timeout=self.POLL_S)
            except queue.Empty:
                dead = [p.exitcode for p in self.procs if not p.is_alive()]
                if dead:
                    self.close()
                    raise RuntimeError(f"a rank process exited (codes "
                                       f"{dead}) during {fn.__name__}")
                continue
            if not ok:
                self.close()
                raise RuntimeError(f"rank {r} failed in {fn.__name__}:\n"
                                   f"{val}")
            outs[r] = val
        return [outs[r] for r in range(self.mesh.size)] if every_rank \
            else outs[0]

    def close(self) -> None:
        """Stop the rank processes (those stuck in a collective are
        terminated) and remove the rendezvous directory."""
        if not self.procs:
            return
        for p, q in zip(self.procs, self.tasks):
            if p.is_alive():
                q.put(None)
        for p in self.procs:
            p.join(timeout=30)
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        self.procs = []
        self.results.close()
        shutil.rmtree(self.tmp, ignore_errors=True)

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class WorldPool:
    """The worlds of a run, one per mesh, each started at its first use
    and closed together by `close` (or the `with` block's end)."""

    def __init__(self):
        self.worlds: Dict[Mesh, World] = {}

    def get(self, mesh: Mesh) -> World:
        if mesh not in self.worlds:
            self.worlds[mesh] = World(mesh)
        return self.worlds[mesh]

    def close(self) -> None:
        for world in self.worlds.values():
            world.close()
        self.worlds.clear()

    def __enter__(self) -> "WorldPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
