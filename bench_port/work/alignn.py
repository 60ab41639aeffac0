"""Operations and bytes of the ALIGNN forward, training step and attention
ops, counted from a batch's live rows by one convention.

- Operations follow the plain reference's equations over live rows only:
  2 per multiply-add of a product, 1 per elementwise add or scale where the
  attention op has one; the backward counts the gradient products of each
  product (dX and dW, no dX for an input layer), never a recompute.
- Bytes count each logical input and output of an op once, at the element
  size of the configuration's type (int32 for indices). For the attention
  ops those are the node tables (q of the targets, k and v of the sources,
  their gradients in the backward), the edge sources and the targets' CSR
  pointers, the live mask, the dropout scale, the edge features, W_e and
  the outputs: never rows gathered per edge, so the count is the same
  whatever implements the op.
- A kernel's least time is max(operations / peak rate, bytes / memory
  rate) at the device's published peaks (`peaks.json`); in float32 the peak
  is the dense TF32 rate.

A batch's live rows are `counts`: graphs, atoms, bonds and line-graph rows
("lg"). The line-graph conv runs over lg edges between bonds, the atom conv
over bond edges between atoms; both take edge features of width H.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

HERE = Path(__file__).resolve().parent
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}
INDEX_BYTES = 4


def peaks(kind: str, dtype: str) -> Tuple[float, float]:
    """(operations/s, bytes/s) of the device named `kind`."""
    table = json.loads((HERE / "peaks.json").read_text())["devices"]
    for key, entry in table.items():
        if key in kind:
            return float(entry["flops"][dtype]), float(entry["bytes_per_s"])
    raise KeyError(f"no published peak for {kind!r}")


def kernel_patterns() -> Dict[str, List[str]]:
    """op → the kernel names that implement it, merged over every pattern
    file (a later kernel adds a file of its own)."""
    out: Dict[str, List[str]] = {}
    for path in sorted((HERE / "patterns").glob("*.json")):
        spec = json.loads(path.read_text())
        out.setdefault(spec["op"], []).extend(spec["names"])
    return out


def conv_sites(counts: Dict[str, int]) -> List[Tuple[int, int]]:
    """(edges, nodes) of the two convs of a block: the line-graph conv
    (edges = lg rows, nodes = bonds) and the atom conv (bonds, atoms)."""
    return [(counts["lg"], counts["bonds"]), (counts["bonds"], counts["atoms"])]


def attn_fwd(e: int, n: int, h: int, heads: int, train: bool,
             el: int) -> Tuple[float, float]:
    """(operations, bytes) of the attention op over e edges into n nodes
    (sources and targets both n): e = ea·W_e, k+e and v+e, the per-head
    logits, the segment softmax, the dropout scale, Σ α (v+e)."""
    ops = 2.0 * e * h * h + 2.0 * e * h + 2.0 * e * h + 2.0 * e * h \
        + 5.0 * e * heads + (e * heads if train else 0.0)
    nbytes = (el * (n * h + n * 2 * h + e * h + h * h + n * h)
              + INDEX_BYTES * (e + n + 1) + 4 * e
              + (4 * heads * e if train else 0))
    return ops, float(nbytes)


def attn_bwd(e: int, n: int, h: int, heads: int, el: int
             ) -> Tuple[float, float]:
    """(operations, bytes) of the attention op's gradient: d(ea) and dW_e
    (each 2·e·h·h), dα and dq (each 2·e·h), d(v+e) and d(k+e) (each e·h),
    the sum de = d(k+e) + d(v+e) (e·h), the softmax backward
    (3·e·heads). Reads q, k‖v, ea, W_e, the indices, mask, scale and
    d(out); writes dq, d(k‖v) as node tables, d(ea), dW_e."""
    ops = 4.0 * e * h * h + 7.0 * e * h + 3.0 * e * heads
    reads = el * (n * h + n * 2 * h + e * h + h * h + n * h) \
        + INDEX_BYTES * (e + n + 1) + 4 * e + 4 * heads * e
    writes = el * (n * h + n * 2 * h + e * h + h * h)
    return ops, float(reads + writes)


def _dense_products(counts: Dict[str, int], m: Dict) -> Iterable[
        Tuple[float, bool]]:
    """(multiply-adds, is an input layer) of every dense product of one
    forward."""
    h, t = m["hidden"], m["target_dim"]
    g, a, b, lg = counts["graphs"], counts["atoms"], counts["bonds"], \
        counts["lg"]
    for rows, width in ((a, m["node_dim"]), (b, m["edge_dim"]),
                        (lg, m["angle_dim"])):
        yield rows * width * h, True
        yield rows * h * h, False
    for _ in range(m["layers"]):
        for _, nodes in conv_sites(counts):
            yield nodes * h * 4 * h, False     # q, k, v, skip
            yield nodes * 3 * h, False         # β gate
        yield b * h * h, False                 # bond → atom-conv features
    yield g * (h + m["global_dim"]) * h, False
    yield g * h * 2 * t, False


def model_flops(counts: Dict[str, int], m: Dict, train: bool) -> float:
    """Operations of one forward (train False) or one training step
    (forward and backward) over a batch with these live rows."""
    el = ELEMENT_BYTES[m["compute_dtype"]]
    total = 0.0
    for macs, first in _dense_products(counts, m):
        total += 2.0 * macs * (1 + (0 if not train else (1 if first else 2)))
    for _ in range(m["layers"]):
        for e, n in conv_sites(counts):
            total += attn_fwd(e, n, m["hidden"], m["heads"], train, el)[0]
            if train:
                total += attn_bwd(e, n, m["hidden"], m["heads"], el)[0]
    return total


def op_bounds(counts: Dict[str, int], m: Dict, train: bool, flops_s: float,
              bytes_s: float) -> Dict[str, float]:
    """Least seconds of every attention launch of one forward (and, with
    `train`, its backward) over a batch, summed by op."""
    el = ELEMENT_BYTES[m["compute_dtype"]]
    out = {"attn_fwd": 0.0, "attn_bwd": 0.0}
    for _ in range(m["layers"]):
        for e, n in conv_sites(counts):
            ops, nbytes = attn_fwd(e, n, m["hidden"], m["heads"], train, el)
            out["attn_fwd"] += max(ops / flops_s, nbytes / bytes_s)
            if train:
                ops, nbytes = attn_bwd(e, n, m["hidden"], m["heads"], el)
                out["attn_bwd"] += max(ops / flops_s, nbytes / bytes_s)
    return out
