"""The work convention (`work/alignn.py`) against hand counts at a tiny
shape, and the readers that turn it into shares."""
from types import SimpleNamespace

import pytest

from bench_port import harness
from bench_port.work import alignn as W

E, N, H, HEADS = 10, 4, 8, 2
M = dict(node_dim=5, edge_dim=3, angle_dim=2, global_dim=6, target_dim=2,
         hidden=H, layers=1, heads=HEADS, compute_dtype="float32")


def test_attention_forward_by_hand():
    ops, nbytes = W.attn_fwd(E, N, H, HEADS, True, 4)
    # e = ea·W_e 2·E·H·H; k+e, v+e E·H each; logits 2·E·H; Σ α(v+e)
    # 2·E·H; softmax 5·E·heads; dropout scale E·heads
    assert ops == 2 * E * H * H + 6 * E * H + 5 * E * HEADS + E * HEADS
    # q, k‖v, out node tables; ea; W_e; src and row_ptr; mask; scale
    assert nbytes == 4 * (N * H + N * 2 * H + N * H + E * H + H * H) \
        + 4 * (E + N + 1) + 4 * E + 4 * HEADS * E
    eval_ops, eval_bytes = W.attn_fwd(E, N, H, HEADS, False, 4)
    assert eval_ops == ops - E * HEADS
    assert eval_bytes == nbytes - 4 * HEADS * E


def test_attention_backward_by_hand():
    ops, nbytes = W.attn_bwd(E, N, H, HEADS, 4)
    assert ops == 4 * E * H * H + 7 * E * H + 3 * E * HEADS
    reads = 4 * (N * H + N * 2 * H + E * H + H * H + N * H) \
        + 4 * (E + N + 1) + 4 * E + 4 * HEADS * E
    writes = 4 * (N * H + N * 2 * H + E * H + H * H)
    assert nbytes == reads + writes


@pytest.mark.parametrize("op", ["fwd", "bwd"])
def test_attention_bytes_do_not_count_gathered_rows(op):
    """The eproj rung gathers k‖v per edge ([E, 2H]) before the kernel; the
    span rung reads the node table itself. The op's bytes are the same for
    both: the count takes the node tables, never the gathered rows, and it
    lies below a count of the gathered rows by exactly (E − N)·2H
    elements."""
    def count(e, n):
        return (W.attn_fwd(e, n, H, HEADS, True, 4) if op == "fwd"
                else W.attn_bwd(e, n, H, HEADS, 4))[1]

    node_tables = count(E, N)
    as_if_gathered = node_tables + (E - N) * 2 * H * 4 * (1 if op == "fwd"
                                                           else 2)
    assert node_tables < as_if_gathered
    for rung in ("eproj, kv gathered per edge", "span, node table read"):
        assert count(E, N) == node_tables, rung


def test_step_flops_by_hand():
    counts = dict(graphs=1, atoms=N, bonds=E, lg=20)
    fwd = W.model_flops(counts, M, train=False)
    dense = (N * 5 * H + N * H * H + E * 3 * H + E * H * H + 20 * 2 * H
             + 20 * H * H                      # encoders
             + E * H * 4 * H + E * 3 * H       # line-graph conv q,k,v,skip, β
             + N * H * 4 * H + N * 3 * H       # atom conv
             + E * H * H                       # bond → atom-conv features
             + 1 * (H + 6) * H + 1 * H * 2 * 2)
    attn = W.attn_fwd(20, E, H, HEADS, False, 4)[0] \
        + W.attn_fwd(E, N, H, HEADS, False, 4)[0]
    assert fwd == pytest.approx(2 * dense + attn)
    step = W.model_flops(counts, M, train=True)
    first = N * 5 * H + E * 3 * H + 20 * 2 * H
    attn_train = W.attn_fwd(20, E, H, HEADS, True, 4)[0] \
        + W.attn_fwd(E, N, H, HEADS, True, 4)[0] \
        + W.attn_bwd(20, E, H, HEADS, 4)[0] + W.attn_bwd(E, N, H, HEADS, 4)[0]
    # backward: dW and dX of every product, no dX for the input layer
    assert step == pytest.approx(2 * (3 * dense - first) + attn_train)


def test_bounds_take_the_larger_of_ops_and_bytes():
    counts = dict(graphs=1, atoms=N, bonds=E, lg=20)
    fast_memory = W.op_bounds(counts, M, True, 1.0, 1e30)
    fast_math = W.op_bounds(counts, M, True, 1e30, 1.0)
    ops = W.attn_fwd(20, E, H, HEADS, True, 4)[0] + \
        W.attn_fwd(E, N, H, HEADS, True, 4)[0]
    nbytes = W.attn_fwd(20, E, H, HEADS, True, 4)[1] + \
        W.attn_fwd(E, N, H, HEADS, True, 4)[1]
    assert fast_memory["attn_fwd"] == pytest.approx(ops)
    assert fast_math["attn_fwd"] == pytest.approx(nbytes)


def test_peaks_and_patterns():
    assert W.peaks("NVIDIA H100 80GB HBM3", "float32") == (495e12, 3.35e12)
    assert W.peaks("NVIDIA H100 80GB HBM3", "bfloat16")[0] == 989e12
    with pytest.raises(KeyError):
        W.peaks("NVIDIA A100-SXM4-80GB", "float32")
    pats = W.kernel_patterns()
    assert pats["attn_fwd"] == ["attn_eproj_fwd_kernel"]
    assert set(pats["attn_bwd"]) == {"attn_eproj_bwd_attn_kernel",
                                     "attn_eproj_bwd_dea_kernel"}


def _ctx(**kw):
    base = dict(window_s=10.0, busy_s=8.0, by_op={}, spans={}, counters={},
                work={}, model_flops=0.0, peak_flops=495e12)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("metric,op", [("attn_fwd_roofline.train", "attn_fwd"),
                                       ("attn_bwd_roofline.train", "attn_bwd")])
def test_roofline_readers(metric, op):
    read = harness.reader(metric)
    assert read(_ctx()) is None                       # no kernel ran
    assert read(_ctx(work={op: 0.5}, by_op={op: 2.0})) == 25.0
    assert read(_ctx(work={op: 0.0}, by_op={op: 2.0})) is None


def test_share_and_count_readers():
    assert harness.reader("device_idle.train")(_ctx()) == pytest.approx(20.0)
    assert harness.reader("step_share.train")(_ctx()) is None
    assert harness.reader("step_share.train")(
        _ctx(spans={"step": [1.0, 2.0]})) == pytest.approx(30.0)
    assert harness.reader("mfu.train")(_ctx()) is None
    assert harness.reader("mfu.train")(_ctx(model_flops=495e12)) == \
        pytest.approx(10.0)


def test_trace_summary_busy_and_idle():
    """The union of device intervals inside the window, the annotations'
    device copies left out, idle time named by the innermost span."""
    class Ev:
        def __init__(self, name, dev, t0, t1):
            self._n, self._d, self._t0, self._t1 = name, dev, t0, t1

        def name(self):
            return self._n

        def device_type(self):
            from torch.autograd import DeviceType
            return getattr(DeviceType, self._d)

        def start_ns(self):
            return self._t0

        def duration_ns(self):
            return self._t1 - self._t0

    tr = harness.Trace(False)
    tr.events = [Ev("bench::window", "CPU", 100, 200),
                 Ev("bench::window", "CUDA", 100, 200),
                 Ev("bench::step", "CPU", 120, 150),
                 Ev("attn_eproj_fwd_kernel<float>", "CUDA", 90, 110),
                 Ev("gemm", "CUDA", 105, 120), Ev("gemm", "CUDA", 160, 170)]
    s = tr.summary({"attn_fwd": ["attn_eproj_fwd_kernel"]})
    assert s["window_s"] == pytest.approx(100e-9)
    assert s["busy_s"] == pytest.approx(30e-9)
    assert s["by_op"]["attn_fwd"] == pytest.approx(10e-9)
    assert s["idle"]["bench::step"] == pytest.approx(40e-9)
    assert s["idle"]["bench::window"] == pytest.approx(30e-9)
