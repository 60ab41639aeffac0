"""Boundary-exchange edge partitioning, communication ∝ partition
boundary: the counterpart of `gnnep_tpu.parallel.boundary_shard`.

Aggregation targets (atoms, and bonds as line-graph nodes) are partitioned
into contiguous per-rank row ranges at pack time (the packer's CSR sort by
target makes every rank's edge slice row-contiguous); the only per-conv
communication is an `all_to_all` of the boundary source rows each rank
needs from their owners. A bond is owned by the rank that owns its dst
atom, and the line graph is partitioned by dst bond, so each layer needs
one bond-row exchange (line-graph conv sources) and one atom-row exchange
(atom conv sources).

The host planning (`BoundaryBatch`, `BoundaryPlan`, `plan_boundary`,
`plan_boundary_batches`) is the JAX package's, copied, and its plans are
array-equal to JAX's (`tests/test_torch_boundary.py`). The conv follows
the JAX package's `boundary_conv_fused` formulation: exchange the RAW
states, then run the single-device `transformer_conv_table`, whose rung
runs its CUDA kernels on the card (kernels 5, 6 and 7 on the default
rung) and their plain versions on the CPU, over the rank-local arena
[own rows ‖ received rows ‖ zero rows ‖ dummy]. Its CSR index comes from
`build_boundary_tables`; the JAX package's dense in/pos/out tables are a
TPU layout and stay out. The arena's last row is the dummy: padding edges
point there, and the kernels write zero rows for its edges.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..data.batching import src_csr_index
from ..models.alignn import (Alignn, conv_rung, interaction_blocks,
                             readout)
from ..ops.dense_attention import transformer_conv_table
from ..ops.segment import segment_sum
from .mesh import EDGE_AXIS, Rank, all_reduce_sum, all_to_all_rows, psum


class BoundaryBatch(NamedTuple):
    """Pack-time boundary-partitioned batch; a pytree of arrays.

    Per-rank arrays are stacked on a leading shard axis [S, ...]; graph-level
    arrays are replicated across the edge axis. All shapes static.
    """

    nodes: np.ndarray        # [S, Rn, F_node] own atom rows
    node_graph: np.ndarray   # [S, Rn] graph slot (padding → G)
    a_dst: np.ndarray        # [S, E_loc] LOCAL dst atom row of own edges
    a_src_slot: np.ndarray   # [S, E_loc] index into [Rn + S·Bn] kv arena
    a_mask: np.ndarray       # [S, E_loc]
    edge_attr: np.ndarray    # [S, E_loc, F_edge] raw features of own bonds
    l_dst: np.ndarray        # [S, L_loc] LOCAL dst bond row of own LG edges
    l_src_slot: np.ndarray   # [S, L_loc] index into [E_loc + S·Bl] kv arena
    l_mask: np.ndarray       # [S, L_loc]
    lg_attr: np.ndarray      # [S, L_loc, F_angle]
    n_send: np.ndarray       # [S, S·Bn] own atom rows to send (slot t·Bn+b → rank t)
    e_send: np.ndarray       # [S, S·Bl] own bond rows to send
    # replicated graph-level fields
    globals_: np.ndarray     # [G, 59]
    sg_num: np.ndarray       # [G]
    y: np.ndarray            # [G, T]
    y_mask: np.ndarray       # [G, T]
    graph_mask: np.ndarray   # [G]
    weight: np.ndarray       # [G]


@dataclasses.dataclass(frozen=True)
class BoundaryPlan:
    """Static partition geometry (NOT part of the pytree)."""

    n_shards: int
    rn: int          # atom rows per rank (equal windows: Np / S)
    e_loc: int       # padded bond-window size (max real count over ranks)
    l_loc: int       # padded LG-window size
    bn: int          # atom boundary budget: max rows any rank pair exchanges
    bl: int          # bond boundary budget
    n_graphs: int
    # actual (pre-padding) boundary row counts, for diagnostics/tests
    atom_boundary_rows: int
    bond_boundary_rows: int

    @property
    def a_arena(self) -> int:
        """Atom-conv local arena: own rows ‖ recv rows ‖ pad ‖ dummy last,
        128-aligned as the JAX package plans it (the plans are
        array-equal; the CUDA kernels need no alignment)."""
        return _round_up(self.rn + self.n_shards * self.bn + 1, 128)

    @property
    def l_arena(self) -> int:
        return _round_up(self.e_loc + self.n_shards * self.bl + 1, 128)

    def comm_bytes_per_conv(self, hidden: int, dtype_bytes: int = 4,
                            projected: bool = True) -> Dict[str, int]:
        """Per-rank bytes SENT per convolution — ∝ boundary budget.

        `projected=True` counts owner-projected key‖value rows (2H each,
        the JAX package's COO path); the port's conv exchanges RAW states
        (H each, `projected=False`: the consumer recomputes the boundary
        rows' projections, half the wire bytes for a boundary-sized slice
        of duplicated GEMM work)."""
        width = 2 * hidden if projected else hidden
        return {
            "atom_conv": self.n_shards * self.bn * width * dtype_bytes,
            "lg_conv": self.n_shards * self.bl * width * dtype_bytes,
        }

    def allreduce_bytes_per_conv(self, n_nodes: int, n_bonds: int,
                                 hidden: int, heads: int,
                                 dtype_bytes: int = 4) -> Dict[str, int]:
        """The all-reduce formulation's per-rank per-conv volume for the same
        batch: one [rows, H+128] psum + one [rows, heads] pmax
        (edge_shard._windowed_conv) — O(N·H), independent of locality."""
        return {
            "atom_conv": n_nodes * (hidden + 128 + heads) * dtype_bytes,
            "lg_conv": n_bonds * (hidden + 128 + heads) * dtype_bytes,
        }


def _round_up(x: int, to: int) -> int:
    return ((max(int(x), 0) + to - 1) // to) * to


def plan_boundary_batches(batches, n_shards: int):
    """Plan several same-budget batches with SHARED static geometry (the
    padded window and boundary budgets are elementwise maxima over the
    batches), so the resulting BoundaryBatches stack for data parallelism
    under one compiled program. Returns ([BoundaryBatch], BoundaryPlan)."""
    geoms = [plan_boundary(b, n_shards)[1] for b in batches]
    shared = dict(
        min_e_loc=max(g.e_loc for g in geoms),
        min_l_loc=max(g.l_loc for g in geoms),
        min_bn=max(g.bn for g in geoms),
        min_bl=max(g.bl for g in geoms))
    out = [plan_boundary(b, n_shards, **shared) for b in batches]
    # geometry fields are identical across re-plans; the boundary-row
    # DIAGNOSTICS are per-batch actuals, so report the maxima rather than
    # silently returning batch 0's cut for all batches
    plan = dataclasses.replace(
        out[0][1],
        atom_boundary_rows=max(p.atom_boundary_rows for _, p in out),
        bond_boundary_rows=max(p.bond_boundary_rows for _, p in out))
    return [bb for bb, _ in out], plan


def plan_boundary(batch, n_shards: int, *, min_e_loc: int = 0,
                  min_l_loc: int = 0, min_bn: int = 0, min_bl: int = 0
                  ) -> Tuple[BoundaryBatch, BoundaryPlan]:
    """Partition a packed (CSR-sorted) GraphBatch for `n_shards` edge ranks.

    Atom rows split into equal contiguous windows of Rn = Np/S; each rank's
    bond slice is the CSR-contiguous dst range [row_ptr[s·Rn], row_ptr[(s+1)·
    Rn]) (so bond ownership = dst-atom ownership), and its LG slice is the
    CSR-contiguous range of LG edges targeting those bonds. Send lists hold
    the DEDUPLICATED cross-rank source rows per ordered rank pair, padded to
    the max pair budget (Bn / Bl). The `min_*` floors let several batches
    share one static geometry (`plan_boundary_batches`).
    """
    S = int(n_shards)
    nodes = np.asarray(batch.nodes)
    Np = nodes.shape[0]
    if Np % S != 0:
        raise ValueError(f"node arena ({Np}) not divisible by shards ({S})")
    rn = Np // S
    e_rp = np.asarray(batch.edge_row_ptr, np.int64)
    l_rp = np.asarray(batch.lg_row_ptr, np.int64)
    src = np.asarray(batch.edge_src, np.int64)
    dst = np.asarray(batch.edge_dst, np.int64)
    em = np.asarray(batch.edge_mask)
    lsrc = np.asarray(batch.lg_src, np.int64)
    ldst = np.asarray(batch.lg_dst, np.int64)
    lm = np.asarray(batch.lg_mask)
    eattr = np.asarray(batch.edge_attr)
    lattr = np.asarray(batch.lg_attr)

    e_start = e_rp[np.arange(S) * rn]
    e_end = e_rp[(np.arange(S) + 1) * rn]
    cnt_e = e_end - e_start
    # 128-multiples, as the JAX package rounds them
    e_loc = max(_round_up(cnt_e.max(), 128), int(min_e_loc))
    l_start = l_rp[e_start]
    l_end = l_rp[e_end]
    cnt_l = l_end - l_start
    l_loc = max(_round_up(cnt_l.max(), 128), int(min_l_loc))

    def build_exchange(owner_of, local_of, sources_per_rank, min_b):
        """The send plan of one exchange.

        `sources_per_rank[s]`: global source row ids of rank s's REAL edges.
        Returns (send [S, S·B], slot_map: per (s) dict global-row → slot,
        B, total_boundary_rows)."""
        need: Dict[Tuple[int, int], List[int]] = {}
        for s in range(S):
            u = np.unique(sources_per_rank[s])
            owners = owner_of(u)
            for t in np.unique(owners):
                t = int(t)
                if t == s:
                    continue
                need[(t, s)] = sorted(int(x) for x in u[owners == t])
        b = max((len(v) for v in need.values()), default=0)
        total = sum(len(v) for v in need.values())
        b = max(_round_up(b, 8) if b else 0, int(min_b))
        send = np.zeros((S, S * b), np.int32)
        slot_of: List[Dict[int, int]] = [dict() for _ in range(S)]
        for (t, s), rows in need.items():
            for pos, g in enumerate(rows):
                send[t, s * b + pos] = local_of(np.int64(g))
                slot_of[s][g] = t * b + pos
        return send, slot_of, b, total

    # ---- atom conv exchange (sources are atoms; owner = u // rn) ----------
    a_sources = [src[e_start[s]:e_end[s]][em[e_start[s]:e_end[s]] > 0]
                 for s in range(S)]
    n_send, a_slot_of, bn, atom_btotal = build_exchange(
        lambda u: u // rn, lambda g: g % rn, a_sources, min_bn)

    # ---- LG conv exchange (sources are bonds; owner by bond range) --------
    def bond_owner(b_rows):
        return np.searchsorted(e_start, b_rows, side="right") - 1

    l_sources = [lsrc[l_start[s]:l_end[s]][lm[l_start[s]:l_end[s]] > 0]
                 for s in range(S)]
    e_send, l_slot_of, bl, bond_btotal = build_exchange(
        bond_owner, lambda g: g - e_start[int(bond_owner(np.asarray([g]))[0])],
        l_sources, min_bl)

    # ---- per-rank padded windows ------------------------------------------
    # Local arena convention mirrors the global one: arena = [own rows ‖
    # received boundary rows ‖ one reserved DUMMY row]. Tail padding edges
    # point src AND dst at the dummy (keeping the local dst sequence
    # CSR-sorted — the kernels' row pointers need it); masked
    # interior rows (dilution gaps) keep their real forward-filled dst but
    # source the dummy. The dummy state row is zero-filled by the conv.
    a_arena = _round_up(rn + S * bn + 1, 128)   # == plan.a_arena
    l_arena = _round_up(e_loc + S * bl + 1, 128)
    a_dst = np.full((S, e_loc), a_arena - 1, np.int32)
    a_src_slot = np.full((S, e_loc), a_arena - 1, np.int32)
    a_mask = np.zeros((S, e_loc), np.float32)
    edge_attr_w = np.zeros((S, e_loc, eattr.shape[1]), np.float32)
    l_dst = np.full((S, l_loc), l_arena - 1, np.int32)
    l_src_slot = np.full((S, l_loc), l_arena - 1, np.int32)
    l_mask = np.zeros((S, l_loc), np.float32)
    lg_attr_w = np.zeros((S, l_loc, lattr.shape[1]), np.float32)

    for s in range(S):
        ce, cl = int(cnt_e[s]), int(cnt_l[s])
        sl = slice(int(e_start[s]), int(e_end[s]))
        a_dst[s, :ce] = np.clip(dst[sl] - s * rn, 0, rn - 1)
        # the GLOBAL dummy row's tail-padding segment must land on the LOCAL
        # arena dummy: leaving it on the global dummy's local row would count
        # toward that row's CSR segment (the JAX package's win64 bound
        # grew ~10× from it)
        glob_pad = (dst[sl] == Np - 1) & (em[sl] <= 0)
        a_dst[s, :ce][glob_pad] = a_arena - 1
        a_mask[s, :ce] = em[sl]
        edge_attr_w[s, :ce] = eattr[sl]
        u = src[sl]
        own = (u // rn) == s
        slots = np.full(ce, a_arena - 1, np.int64)
        msk = em[sl] > 0
        slots[own & msk] = u[own & msk] % rn
        for i in np.nonzero(~own & msk)[0]:
            slots[i] = rn + a_slot_of[s][int(u[i])]
        a_src_slot[s, :ce] = slots

        ll = slice(int(l_start[s]), int(l_end[s]))
        l_dst[s, :cl] = np.clip(ldst[ll] - e_start[s], 0, e_loc - 1)
        lglob_pad = (ldst[ll] == src.shape[0] - 1) & (lm[ll] <= 0)
        l_dst[s, :cl][lglob_pad] = l_arena - 1
        l_mask[s, :cl] = lm[ll]
        lg_attr_w[s, :cl] = lattr[ll]
        ub = lsrc[ll]
        owners = bond_owner(ub)
        lmsk = lm[ll] > 0
        lslots = np.full(cl, l_arena - 1, np.int64)
        # vectorized own-rank case; Python only touches the boundary edges
        # (giant graphs have millions of local LG rows — a full per-row
        # loop here would dominate pack time)
        lown = (owners == s) & lmsk
        lslots[lown] = ub[lown] - e_start[s]
        for i in np.nonzero(~lown & lmsk)[0]:
            lslots[i] = e_loc + l_slot_of[s][int(ub[i])]
        l_src_slot[s, :cl] = lslots

    bb = BoundaryBatch(
        nodes=nodes.reshape(S, rn, -1).astype(np.float32),
        node_graph=np.asarray(batch.node_graph, np.int32).reshape(S, rn),
        a_dst=a_dst, a_src_slot=a_src_slot, a_mask=a_mask,
        edge_attr=edge_attr_w,
        l_dst=l_dst, l_src_slot=l_src_slot, l_mask=l_mask, lg_attr=lg_attr_w,
        n_send=n_send, e_send=e_send,
        globals_=np.asarray(batch.globals_, np.float32),
        sg_num=np.asarray(batch.sg_num, np.int32),
        y=np.asarray(batch.y, np.float32),
        y_mask=np.asarray(batch.y_mask, np.float32),
        graph_mask=np.asarray(batch.graph_mask, np.float32),
        weight=np.asarray(batch.weight, np.float32))
    plan = BoundaryPlan(n_shards=S, rn=rn, e_loc=e_loc, l_loc=l_loc,
                        bn=bn, bl=bl, n_graphs=int(np.asarray(batch.y).shape[0]),
                        atom_boundary_rows=atom_btotal,
                        bond_boundary_rows=bond_btotal)
    return bb, plan


class BoundaryTables(NamedTuple):
    """The CSR index of every rank's local arena (the fields of the JAX
    package's `BoundaryTables` that the port's conv reads), stacked
    [S, ...]: dst row pointers, and the source-sorted order and per-row
    starts behind the kv gather's backward."""

    a_row_ptr: np.ndarray     # [S, A_n + 1]
    a_src_order: np.ndarray   # [S, E_loc]
    a_src_starts: np.ndarray  # [S, A_n]
    l_row_ptr: np.ndarray     # [S, A_l + 1]
    l_src_order: np.ndarray   # [S, L_loc]
    l_src_starts: np.ndarray  # [S, A_l]


def build_boundary_tables(bbs, plan: BoundaryPlan) -> List[BoundaryTables]:
    """The CSR index of every rank's local aggregation problem, for one
    `BoundaryBatch` or each of a list of same-plan batches (the JAX
    package's `build_boundary_tables`, these fields only)."""
    if isinstance(bbs, BoundaryBatch):
        bbs = [bbs]

    def level(bb, which, arena):
        dst = np.asarray(getattr(bb, f"{which}_dst"))
        slot = np.asarray(getattr(bb, f"{which}_src_slot"))
        rps, orders, starts = [], [], []
        for s in range(plan.n_shards):
            order, start = src_csr_index(slot[s], arena)
            rps.append(np.searchsorted(dst[s], np.arange(arena + 1))
                       .astype(np.int32))
            orders.append(order)
            starts.append(start)
        return np.stack(rps), np.stack(orders), np.stack(starts)

    return [BoundaryTables(*level(bb, "a", plan.a_arena),
                           *level(bb, "l", plan.l_arena)) for bb in bbs]


@dataclasses.dataclass
class RankBoundaryBatch:
    """One rank's slice s of a `BoundaryBatch` and its `BoundaryTables`,
    as tensors on its device (features f32, index arrays int64, CSR index
    int32), with the replicated graph-level fields."""

    nodes: torch.Tensor
    node_graph: torch.Tensor
    a_dst: torch.Tensor
    a_src_slot: torch.Tensor
    a_mask: torch.Tensor
    edge_attr: torch.Tensor
    l_dst: torch.Tensor
    l_src_slot: torch.Tensor
    l_mask: torch.Tensor
    lg_attr: torch.Tensor
    n_send: torch.Tensor
    e_send: torch.Tensor
    a_row_ptr: torch.Tensor
    a_src_order: torch.Tensor
    a_src_starts: torch.Tensor
    l_row_ptr: torch.Tensor
    l_src_order: torch.Tensor
    l_src_starts: torch.Tensor
    globals_: torch.Tensor
    sg_num: torch.Tensor
    y: torch.Tensor
    y_mask: torch.Tensor
    graph_mask: torch.Tensor
    weight: torch.Tensor

    _INDEX = ("node_graph", "a_dst", "a_src_slot", "l_dst", "l_src_slot",
              "n_send", "e_send")
    _REPLICATED = ("globals_", "sg_num", "y", "y_mask", "graph_mask",
                   "weight")
    _FEATURES = ("nodes", "edge_attr", "lg_attr", "globals_")

    @classmethod
    def from_boundary(cls, bb: BoundaryBatch, tables: BoundaryTables, s: int,
                      device) -> "RankBoundaryBatch":
        fields = {}
        for f in BoundaryBatch._fields:
            a = np.asarray(getattr(bb, f))
            a = a if f in cls._REPLICATED else a[s]
            dtype = np.int64 if f in cls._INDEX or f == "sg_num" \
                else np.float32
            fields[f] = torch.from_numpy(np.ascontiguousarray(a, dtype)
                                         ).to(device)
        for f in BoundaryTables._fields:
            fields[f] = torch.from_numpy(np.ascontiguousarray(
                getattr(tables, f)[s], np.int32)).to(device)
        return cls(**fields)

    def cast(self, dtype: torch.dtype) -> "RankBoundaryBatch":
        """The batch with its four feature arrays in `dtype`."""
        if dtype == torch.float32:
            return self
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(dtype) for f in self._FEATURES})


def boundary_conv(params, x_own: torch.Tensor, src_slot: torch.Tensor,
                  dst_loc: torch.Tensor, edge_feats: torch.Tensor,
                  send_idx: torch.Tensor, row_ptr: torch.Tensor,
                  src_order: torch.Tensor, src_starts: torch.Tensor, *,
                  rank: Rank, budget: int, arena: int,
                  edge_mask: torch.Tensor, rung: dict) -> torch.Tensor:
    """β-gated transformer conv on the rank-local arena: the own rows'
    RAW states go out to the ranks that read them (`all_to_all` of the
    `send_idx` rows, [S·B, H]), the arena is own ‖ received ‖ zero rows,
    and `transformer_conv_table` runs the rung's kernels over it → the own
    rows' outputs. Every target row's whole incoming segment is local, so
    the softmax needs no collective."""
    parts = [x_own]
    if budget > 0:
        parts.append(all_to_all_rows(rank, x_own.index_select(0, send_idx),
                                     EDGE_AXIS))
    filled = sum(p.shape[0] for p in parts)
    # zero-fill up to the arena; the last row is the dummy
    parts.append(x_own.new_zeros((arena - filled, x_own.shape[1])))
    out = transformer_conv_table(params, torch.cat(parts), src_slot, dst_loc,
                                 edge_feats, row_ptr, src_order, src_starts,
                                 edge_mask=edge_mask, **rung)
    return out[:x_own.shape[0]]


def boundary_trunk(model: Alignn, rb: RankBoundaryBatch, plan: BoundaryPlan,
                   rank: Rank, *, train: bool = False,
                   generator: Optional[torch.Generator] = None,
                   shared_generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """The boundary-partitioned trunk on one rank → the [G, H] shared
    features, the same on every rank of the edge axis: the pooling
    partials are summed over it (a [G+1, H+1] all-reduce, the only
    collective besides the exchanges). With `train`, the conv and
    residual dropout draw from `generator` (this rank's stream) and the
    replicated tail's from `shared_generator` (one stream for the edge
    axis, so the tail stays replicated; `generator` where None)."""
    cfg = model.cfg
    drop = cfg.dropout if train else 0.0
    gen = generator if train else None
    shared_gen = (shared_generator or generator) if train else None
    node_state = model.node_enc(rb.nodes)
    edge_state = model.edge_enc(rb.edge_attr)
    angle_emb = model.angle_enc(rb.lg_attr)
    # a rank without live edges still enters every collective
    live = all_reduce_sum(rank, torch.stack([rb.l_mask.sum(),
                                             rb.a_mask.sum()]), EDGE_AXIS)
    rung = conv_rung(cfg, drop, gen)

    def lg_conv(conv, state, feats):
        return boundary_conv(conv.params(), state, rb.l_src_slot, rb.l_dst,
                             feats, rb.e_send, rb.l_row_ptr, rb.l_src_order,
                             rb.l_src_starts, rank=rank, budget=plan.bl,
                             arena=plan.l_arena, edge_mask=rb.l_mask,
                             rung=rung)

    def atom_conv(conv, state, feats):
        return boundary_conv(conv.params(), state, rb.a_src_slot, rb.a_dst,
                             feats, rb.n_send, rb.a_row_ptr, rb.a_src_order,
                             rb.a_src_starts, rank=rank, budget=plan.bn,
                             arena=plan.a_arena, edge_mask=rb.a_mask,
                             rung=rung)

    node_state, _ = interaction_blocks(model, node_state, edge_state,
                                       angle_emb, lg_conv, atom_conv,
                                       live[0] > 0, live[1] > 0, drop, gen)
    # segment-mean pooling with cross-rank partials (graphs straddle the
    # ranks' row windows), summed and all-reduced in f32: a bf16 running
    # sum over a giant's rows loses its low bits (a 2,000-atom graph's
    # pooled mean moved by 0.2 on the single-device bf16 path, which sums
    # in the compute type as the JAX package does)
    g = plan.n_graphs
    state = node_state.float()
    sums = segment_sum(state, rb.node_graph, g + 1)
    counts = segment_sum(state.new_ones(state.shape[:1]), rb.node_graph,
                         g + 1)
    stacked = psum(rank, torch.cat([sums, counts[:, None]], dim=-1),
                   EDGE_AXIS)
    pooled = (stacked[:g, :-1] / torch.clamp_min(stacked[:g, -1:], 1.0)
              ).to(node_state.dtype)
    return readout(model, pooled, rb.globals_, rb.sg_num, drop, shared_gen)


def boundary_apply(model: Alignn, rb: RankBoundaryBatch, plan: BoundaryPlan,
                   rank: Rank, *, train: bool = False,
                   generator: Optional[torch.Generator] = None,
                   shared_generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (mean [G, T], logvar [G, T]), replicated over the edge axis."""
    shared = boundary_trunk(model, rb, plan, rank, train=train,
                            generator=generator,
                            shared_generator=shared_generator)
    return model.mean_head(shared), model.logvar_head(shared)


class _Apply(torch.nn.Module):
    """`boundary_apply` as a module's forward, so that
    `torch.func.functional_call` can run it on cast parameters."""

    def __init__(self, model: Alignn):
        super().__init__()
        self.model = model

    def forward(self, rb, plan, rank, train, generator, shared_generator):
        return boundary_apply(self.model, rb, plan, rank, train=train,
                              generator=generator,
                              shared_generator=shared_generator)


def boundary_outputs(model: Alignn, rb: RankBoundaryBatch,
                     plan: BoundaryPlan, rank: Rank, dtype: torch.dtype, *,
                     train: bool = False,
                     generator: Optional[torch.Generator] = None,
                     shared_generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`boundary_apply` with the f32 parameters and the features in `dtype`
    (cast inside the autograd graph, as the single-device step casts) →
    (mean, logvar) as f32, the logvar not floored."""
    rb = rb.cast(dtype)
    if dtype == torch.float32:
        mean, logvar = boundary_apply(model, rb, plan, rank, train=train,
                                      generator=generator,
                                      shared_generator=shared_generator)
    else:
        params = {f"model.{n}": (p.to(dtype) if p.dtype == torch.float32
                                 else p)
                  for n, p in model.named_parameters()}
        mean, logvar = torch.func.functional_call(
            _Apply(model), params,
            (rb, plan, rank, train, generator, shared_generator))
    return mean.float(), logvar.float()
