"""`program_spans.py`: the window's device idle put down to the program's
`gnnep::` spans on synthetic trace events, and the harness's own summary
unchanged by those records."""
import pytest

from bench_port import harness, program_spans


class Ev:
    """A raw trace event as Kineto gives it."""

    def __init__(self, name, dev, t0, t1, tid=1):
        self._n, self._d, self._t0, self._t1, self._tid = \
            name, dev, t0, t1, tid

    def name(self):
        return self._n

    def device_type(self):
        from torch.autograd import DeviceType
        return getattr(DeviceType, self._d)

    def start_ns(self):
        return self._t0

    def duration_ns(self):
        return self._t1 - self._t0

    def start_thread_id(self):
        return self._tid


# window 100-200 on thread 1; the device busy 90-110, 105-120, 160-170:
# idle 120-160 and 170-200 (70 ns)
BASE = [Ev("bench::window", "CPU", 100, 200),
        Ev("bench::window", "CUDA", 100, 200),
        Ev("bench::step", "CPU", 120, 150),
        Ev("attn_eproj_fwd_kernel<float>", "CUDA", 90, 110),
        Ev("gemm", "CUDA", 105, 120), Ev("gemm", "CUDA", 160, 170)]
PROGRAM = [Ev("gnnep::member.steps", "CPU", 110, 180),
           Ev("gnnep::stage.wait", "CPU", 125, 140),
           Ev("gnnep::member.pack_wait", "CPU", 185, 195),
           # another thread's span claims no idle
           Ev("gnnep::member.val", "CPU", 100, 200, tid=2),
           # a span before the window counts for nothing
           Ev("gnnep::member.setup", "CPU", 50, 95)]


def test_idle_split_by_innermost_span_on_the_window_thread():
    out = program_spans.split(BASE + PROGRAM)
    idle = out["program_idle"]
    assert idle == pytest.approx({
        "member.steps": 35e-9,       # 120-125, 140-160, 170-180
        "stage.wait": 15e-9,         # 125-140
        "member.pack_wait": 10e-9,   # 185-195
        "untraced": 10e-9},          # 180-185, 195-200
        abs=1e-15)
    assert sum(idle.values()) == pytest.approx(70e-9)
    assert out["program_spans"] == {
        "member.steps": {"count": 1, "host_s": pytest.approx(70e-9)},
        "stage.wait": {"count": 1, "host_s": pytest.approx(15e-9)},
        "member.pack_wait": {"count": 1, "host_s": pytest.approx(10e-9)}}
    pct = program_spans.idle_pct(idle, 100e-9)
    assert pct["pack"] == pytest.approx(10.0)
    assert pct["stage"] == pytest.approx(15.0)
    assert pct["loop"] == pytest.approx(35.0)
    assert pct["untraced"] == pytest.approx(10.0)
    assert pct["device_idle"] == pytest.approx(70.0)
    assert (pct["pack"] + pct["stage"] + pct["loop"] + pct["untraced"]
            == pytest.approx(pct["device_idle"]))


def test_no_program_span_leaves_all_idle_untraced():
    """The parent's program records no span: its idle is all `untraced`,
    and it equals the harness's idle total."""
    idle = program_spans.split(BASE)["program_idle"]
    s = _summary(BASE)
    assert idle == pytest.approx({"untraced": 70e-9}, abs=1e-15)
    assert idle["untraced"] == pytest.approx(s["window_s"] - s["busy_s"])


def _summary(events):
    tr = harness.Trace(False)
    tr.events = events
    return tr.summary({"attn_fwd": ["attn_eproj_fwd_kernel"]})


def test_program_spans_leave_the_harness_summary_as_it_was():
    """The harness's busy, idle and by-kernel readings do not see the
    program's host records."""
    assert _summary(BASE + PROGRAM) == _summary(BASE)
    with pytest.raises(RuntimeError):
        program_spans.split(PROGRAM)
