"""Edge-partitioned ALIGNN forward on one rank: the counterpart of
`gnnep_tpu.parallel.edge_shard`.

Within one packed batch the bond arena and the line-graph arena are cut
into equal slices along the mesh's edge axis (rank e takes rows
[e·E_loc, (e+1)·E_loc) of each: `parallel.train_step.edge_slice`); node and
bond *states* stay replicated. Each rank computes the attention partials of
its edge slice, and the partials are combined over the axis:

    m      = max over ranks of the local segment max    (no gradient)
    denom  = Σ over ranks of the local Σ exp
    msgsum = Σ over ranks of the local Σ exp·v

one max and one sum a conv (with attention dropout, which must normalize
before it drops, the denominator's sum and then α·v's), each one
collective over all rows. Partials and sums are f32.

The local partials, by `impl`:
- 'coo': plain tensor ops (`index_add_`, `scatter_reduce`), as the JAX
  package's XLA segment ops;
- 'windowed': kernel 7 (`csrc/csr_segment_sum.cu`) sums each target row's
  CSR segment within the slice: Σ exp·v ‖ Σ exp in one call (with dropout,
  Σ exp, then Σ α·v), and the backward of the q gather by dst (and of the
  denominator's gather, with dropout) is kernel 7 again. The JAX package
  falls back to 'coo' where its TPU VMEM check fails; kernel 7 has no such
  limit, so on the card this runs kernel 7 or raises;
- 'table': the JAX package's implicit dense [N, D, heads] table, a layout
  that keeps scatters off the TPU; the same function as 'windowed', which
  it runs.
`impl` alone selects the formulation.

Two arguments of the JAX package's signature are accepted and not read:
`table_widths` bound the rows its windowed kernel reads per segment, and
kernel 7 walks every segment whole; `comm_chunks` cuts the sums into row
chunks so that XLA can overlap a chunk's collective with the previous
chunk's tail, and run eagerly the chunks would only go one after another.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from ..models.alignn import Alignn, DeviceBatch, _layer_norm, readout
from ..ops.cuda.segment_sum import csr_gather, csr_window_sum
from ..ops.graph_attention import TransformerConvParams, beta_blend
from ..ops.segment import segment_max, segment_mean, segment_sum
from .mesh import EDGE_AXIS, Rank, all_gather_rows, all_reduce_sum, pmax, psum

_NEG = -1e30
IMPLS = ("coo", "windowed", "table")

RowPost = Callable[[torch.Tensor], torch.Tensor]


def _keep(shape, rate: float, generator: torch.Generator,
          device) -> torch.Tensor:
    """A dropout keep mask, drawn as `models.alignn._dropout` draws it."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def edge_sharded_conv(params: TransformerConvParams, x: torch.Tensor,
                      src: torch.Tensor, dst: torch.Tensor,
                      edge_attr: torch.Tensor, *, heads: int, rank: Rank,
                      edge_mask: Optional[torch.Tensor] = None,
                      dropout_rate: float = 0.0,
                      generator: Optional[torch.Generator] = None,
                      comm_chunks: int = 1,
                      row_post: Optional[RowPost] = None,
                      row_ptr: Optional[torch.Tensor] = None,
                      impl: str = "coo", row_window: int = 0
                      ) -> torch.Tensor:
    """β-gated transformer conv with the edge dimension sharded over the
    edge axis: `x` [N, H] the replicated states, `src`, `dst`, `edge_attr`,
    `edge_mask` this rank's slice, `row_ptr` [N + 1] the GLOBAL CSR row
    pointers of dst (needed by 'windowed' / 'table'). Equal to
    `ops.graph_attention.transformer_conv` on the whole arrays up to the
    order of float sums, then `row_post(out)` (e.g. LayerNorm and the
    residual). Attention dropout draws from `generator`, this rank's own
    stream (the JAX package folds in the rank). `comm_chunks` is not read
    (module docstring).

    `row_window` (R, a multiple of 128 from
    `train_step.measure_row_windows`) bounds the target rows any rank's
    slice reaches ('windowed' only): the q projection and every local
    reduction run on rows [r_lo, r_lo + R) instead of all N. A window
    that does not cover a rank's rows poisons the whole output with NaN
    (never a silent drop); an arena or window that is not a multiple of
    128 turns the window off (R = N), as in the JAX package."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, not {impl!r}")
    if impl != "coo":
        if row_ptr is None:
            raise ValueError(f"impl={impl!r} needs the global row_ptr")
        return _windowed_conv(params, x, src, dst, edge_attr, heads=heads,
                              rank=rank, edge_mask=edge_mask,
                              dropout_rate=dropout_rate, generator=generator,
                              row_post=row_post, row_ptr=row_ptr,
                              row_window=row_window)
    n = x.shape[0]
    hidden = params.w_query.shape[1]
    ch = hidden // heads
    q = (x @ params.w_query + params.b_query).reshape(n, heads, ch)
    k = (x @ params.w_key + params.b_key).reshape(n, heads, ch)
    v = (x @ params.w_value + params.b_value).reshape(n, heads, ch)
    e = (edge_attr @ params.w_edge).reshape(-1, heads, ch)
    k_j = k.index_select(0, src) + e
    v_j = v.index_select(0, src) + e
    logits = (q.index_select(0, dst) * k_j).sum(-1) / math.sqrt(ch)
    if edge_mask is not None:
        logits = torch.where(edge_mask[:, None] > 0, logits,
                             logits.new_tensor(_NEG))
    # the stabilizer carries no gradient (softmax is shift-invariant)
    local_max = segment_max(logits.detach(), dst, n)
    seg_max = torch.clamp_min(pmax(rank, local_max), _NEG)
    expd = torch.exp(logits - seg_max.index_select(0, dst))
    if edge_mask is not None:
        expd = expd * edge_mask[:, None]
    local_denom = segment_sum(expd, dst, n)
    if dropout_rate > 0.0 and generator is not None:
        denom = torch.clamp_min(psum(rank, local_denom), 1e-16)
        keep = _keep(logits.shape, dropout_rate, generator, x.device)
        alpha = expd / denom.index_select(0, dst)
        alpha = torch.where(keep, alpha / (1.0 - dropout_rate),
                            torch.zeros_like(alpha))
        msg = psum(rank, segment_sum(alpha[..., None] * v_j, dst, n
                                     ).reshape(n, hidden))
    else:
        local_msg = segment_sum(expd[..., None] * v_j, dst, n)
        # both partials ride one sum
        msg = _normalized(psum(rank, torch.cat(
            [local_msg.reshape(n, hidden), local_denom], -1)), heads)
    return _tail(params, x, msg, row_post)


def _normalized(summed: torch.Tensor, heads: int) -> torch.Tensor:
    """[N, H + heads] summed Σ exp·v ‖ Σ exp → the messages [N, H]."""
    hidden = summed.shape[1] - heads
    dn = torch.clamp_min(summed[:, hidden:], 1e-16)
    return (summed[:, :hidden].reshape(-1, heads, hidden // heads)
            / dn[..., None]).reshape(-1, hidden)


def _tail(params: TransformerConvParams, x: torch.Tensor, msg: torch.Tensor,
          row_post: Optional[RowPost]) -> torch.Tensor:
    """The β blend of the messages `msg` [N, H], then `row_post`."""
    out = beta_blend(params.w_beta, x @ params.w_skip + params.b_skip,
                     msg.to(x.dtype))
    return row_post(out) if row_post is not None else out


def _row_window(row_ptr: torch.Tensor, e0: int, e_loc: int, n: int,
                row_window: int):
    """(R, the window's rows r_lo .. r_lo + R, its R + 1 bound indices
    included, 1 or NaN) of a rank whose slice starts at edge e0; (N, None,
    None) where the window is off. R = `row_window` where it is below N
    and both are multiples of 128; r_lo the first row whose segment
    reaches the slice, 128-aligned down and clipped to N − R; NaN where the
    slice's last row lies beyond the window (JAX's `_windowed_conv`
    :254-279). All on the device, no host readback."""
    R = int(row_window) if 0 < int(row_window) < n else n
    if R == n or n % 128 or R % 128:
        return n, None, None
    dev = row_ptr.device
    probe = e0 + torch.arange(2, device=dev, dtype=row_ptr.dtype) * (e_loc - 1)
    lo, hi = (torch.searchsorted(row_ptr, probe, right=True) - 1).unbind()
    r_lo = torch.clamp(torch.div(lo, 128, rounding_mode="floor") * 128,
                       0, n - R)
    poison = torch.where(hi - r_lo >= R, float("nan"), 1.0)
    return R, r_lo + torch.arange(R + 1, device=dev), poison


def _windowed_conv(params: TransformerConvParams, x, src, dst, edge_attr, *,
                   heads: int, rank: Rank, edge_mask, dropout_rate,
                   generator, row_post, row_ptr, row_window: int):
    """The conv's local partials on kernel 7 (JAX's `_windowed_conv`,
    edge_shard.py:215). The slice is CSR-contiguous by dst, so its rows'
    segments are `lrp = clip(row_ptr − e0, 0, E_loc)`; a window of R rows
    from r_lo gives kernel 7 R + 1 bounds, its row pointers and the end of
    its last segment, so the window's last row is summed whether it is the
    dummy or a real row. Per-head sums and expansions are reshapes (the
    JAX package's 0/1 block GEMMs are a TPU layout)."""
    n = x.shape[0]
    hidden = params.w_query.shape[1]
    ch = hidden // heads
    e_loc = src.shape[0]
    e0 = rank.edge * e_loc
    lrp = torch.clamp(row_ptr - e0, 0, e_loc)                     # [N+1]
    R, window, poison = _row_window(row_ptr, e0, e_loc, n, row_window)
    if window is None:
        rows, bounds, dst_w, x_w = None, lrp, dst, x
    else:
        rows = window[:R]
        bounds = lrp.index_select(0, window)
        dst_w = torch.clamp(dst - window[0], 0, R - 1)
        x_w = x.index_select(0, rows)
    if edge_mask is not None:
        # the last row's segment ends at the slice's last live edge: past
        # it lies the arena's masked tail padding (the dummy row's, which
        # adds exact zeros to every sum here), thousands of rows that
        # kernel 7 would walk on one warp
        live_end = torch.where(edge_mask > 0, torch.arange(
            1, e_loc + 1, device=x.device, dtype=bounds.dtype), 0).max()
        bounds = torch.cat([bounds[:-1], torch.maximum(
            torch.minimum(bounds[-1], live_end), bounds[-2]).view(1)])

    def placed(part, fill):
        """A window's [R, ·] rows at their place in [N, ·], `fill`
        elsewhere."""
        if rows is None:
            return part
        return part.new_full((n, part.shape[1]), fill).index_copy(0, rows,
                                                                  part)

    def expand(part):
        """A sum's window partial → [N, ·], NaN everywhere on a breached
        window (a dropped row lies outside it: only the whole array is
        reliably loud)."""
        out = placed(part, 0.0)
        return out if rows is None else out + (poison - 1.0)

    q_w = x_w @ params.w_query + params.b_query                   # [R, H]
    k = x @ params.w_key + params.b_key
    v = x @ params.w_value + params.b_value
    e = edge_attr @ params.w_edge                                 # [E, H]
    k_j = k.index_select(0, src) + e
    v_j = (v.index_select(0, src) + e).reshape(e_loc, heads, ch)
    q_dst = csr_gather(q_w, dst_w, bounds, closed=True)
    logits = (q_dst * k_j).reshape(e_loc, heads, ch).sum(-1) / math.sqrt(ch)
    if edge_mask is not None:
        logits = torch.where(edge_mask[:, None] > 0, logits,
                             logits.new_tensor(_NEG))
    # out-of-window rows must not lift the max: _NEG there
    local_max = placed(segment_max(logits.detach(), dst_w, R), _NEG)
    seg_max = torch.clamp_min(pmax(rank, local_max), _NEG)
    expd = torch.exp(logits - seg_max.index_select(0, dst))
    if edge_mask is not None:
        expd = expd * edge_mask[:, None]
    if dropout_rate > 0.0 and generator is not None:
        # α normalizes with the global denominator before it drops
        denom = torch.clamp_min(
            psum(rank, expand(csr_window_sum(expd, bounds, dst_w))), 1e-16)
        keep = _keep(logits.shape, dropout_rate, generator, x.device)
        denom_w = denom if rows is None else denom.index_select(0, rows)
        denom_e = csr_gather(denom_w, dst_w, bounds, closed=True)
        alpha = expd * keep / ((1.0 - dropout_rate) * denom_e)
        msg = psum(rank, expand(csr_window_sum(
            (v_j * alpha[..., None]).reshape(e_loc, hidden), bounds, dst_w)))
    else:
        # Σ exp·v ‖ Σ exp in one kernel 7 call
        msg = _normalized(psum(rank, expand(csr_window_sum(torch.cat(
            [(v_j * expd[..., None]).reshape(e_loc, hidden), expd], 1),
            bounds, dst_w))), heads)
    return _tail(params, x, msg, row_post)


def sharded_trunk(model: Alignn, batch: DeviceBatch, rank: Rank, *,
                  train: bool = False,
                  generator: Optional[torch.Generator] = None,
                  shared_generator: Optional[torch.Generator] = None,
                  impl: str = "coo",
                  row_windows: Optional[tuple] = None) -> torch.Tensor:
    """The edge-sharded `models.alignn._shared_trunk` on one rank → the
    [G, H] shared features, the same bits on every rank of the edge axis.
    `batch` is this rank's edge slice of its data slot's batch: node and
    graph arrays whole, bond and line-graph arenas sliced. The bond states
    are encoded from the local slice and gathered whole
    (`mesh.all_gather_rows`).

    Two random streams: attention dropout draws from `generator`, this
    rank's own; the residual, pooled-feature and embedding dropout act on
    replicated states, so they draw from `shared_generator`, one stream
    for the data slot's edge ranks (`generator` where None), which keeps
    the states replicated.

    `row_windows` = (atom R, line-graph R) from
    `train_step.measure_row_windows`."""
    cfg = model.cfg
    drop = cfg.dropout if train else 0.0
    gen = generator if train else None
    shared = (shared_generator or generator) if train else None
    atom_r, lg_r = row_windows if row_windows is not None else (0, 0)
    node_state = model.node_enc(batch.nodes)
    edge_state = all_gather_rows(rank, model.edge_enc(batch.edge_attr))
    angle_emb = model.angle_enc(batch.lg_attr)
    e_local = batch.edge_src.shape[0]
    e0 = rank.edge * e_local
    live = all_reduce_sum(rank, torch.stack([batch.lg_mask.sum(),
                                             batch.edge_mask.sum()]),
                          EDGE_AXIS)

    def make_post(block, state, gate):
        """LayerNorm → residual add of dropout(relu), gated by `gate`
        (a batch without live edges leaves the state unchanged)."""
        keep = _keep(state.shape, drop, shared, state.device) \
            if drop > 0.0 and shared is not None else None

        def post(out):
            a = torch.relu(_layer_norm(out, block.ln_scale, block.ln_bias))
            if keep is not None:
                a = torch.where(keep, a / (1.0 - drop), torch.zeros_like(a))
            return torch.where(gate, state + a, state)

        return post

    conv = dict(heads=cfg.heads, rank=rank, dropout_rate=drop,
                generator=gen, impl=impl)
    for eb, nb in zip(model.edge_blocks, model.node_blocks):
        edge_state = edge_sharded_conv(
            eb.conv.params(), edge_state, batch.lg_src, batch.lg_dst,
            angle_emb, edge_mask=batch.lg_mask,
            row_post=make_post(eb, edge_state, live[0] > 0),
            row_ptr=batch.lg_row_ptr, row_window=lg_r, **conv)
        # the atom conv takes the local slice of the projected bond states
        edge_feat = edge_state[e0:e0 + e_local] @ nb.edge_proj_w \
            + nb.edge_proj_b
        node_state = edge_sharded_conv(
            nb.conv.params(), node_state, batch.edge_src, batch.edge_dst,
            edge_feat, edge_mask=batch.edge_mask,
            row_post=make_post(nb, node_state, live[1] > 0),
            row_ptr=batch.edge_row_ptr, row_window=atom_r, **conv)
    g = batch.n_graphs
    pooled = segment_mean(node_state, batch.node_graph, g + 1)[:g]
    return readout(model, pooled, batch.globals_, batch.sg_num, drop, shared)


def sharded_apply(model: Alignn, batch: DeviceBatch, rank: Rank, *,
                  train: bool = False,
                  generator: Optional[torch.Generator] = None,
                  shared_generator: Optional[torch.Generator] = None,
                  comm_chunks: int = 1,
                  table_widths: Optional[tuple] = None,
                  impl: str = "coo",
                  row_windows: Optional[tuple] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (mean [G, T], logvar [G, T]), replicated over the edge axis
    (`sharded_trunk`, then the heads). `comm_chunks` and `table_widths`
    are the JAX package's and not read (module docstring)."""
    shared = sharded_trunk(model, batch, rank, train=train,
                           generator=generator,
                           shared_generator=shared_generator, impl=impl,
                           row_windows=row_windows)
    return model.mean_head(shared), model.logvar_head(shared)
