"""The trace's interval arithmetic on events made by hand (nanoseconds)."""

from cfbench.lib.trace import PREFIX, Trace

DEVICE = [(10, 20, "k1"), (15, 30, "k2"), (50, 60, "k1"), (100, 130, "k3")]
HOST = [(0, 200, PREFIX + "fit"), (35, 48, PREFIX + "timed_step factor draw"),
        (40, 45, "aten::empty"), (70, 95, PREFIX + "solve_side")]


def test_busy_is_the_union_clipped_to_the_window():
    t = Trace.from_events(DEVICE, HOST)
    assert t.busy_ns(0, 200) == 20 + 10 + 30
    assert t.busy_ns(12, 55) == 18 + 5
    assert t.busy_ns(31, 49) == 0
    assert t.busy_ns(105, 110) == 5


def test_device_ops_sum_by_name():
    ops = Trace.from_events(DEVICE, HOST).device_ops()
    assert ops[0] == ["k3", 30e-9] and ["k1", 20e-9] in ops and ["k2", 15e-9] in ops


def test_idle_gaps_are_labelled_by_the_host():
    gaps = dict(Trace.from_events(DEVICE, HOST).idle_gaps(0, 200))
    # 0-10, 30-50, 60-100 and 130-200 are idle: 140 ns in all
    assert abs(sum(gaps.values()) - 140e-9) < 1e-15
    assert gaps["timed_step factor draw / aten::empty"] == 20e-9
    assert gaps["solve_side"] == 40e-9
    assert gaps["fit"] == 80e-9


def test_spans_by_label():
    assert Trace.from_events(DEVICE, HOST).spans("solve_side") == [(70, 95)]
