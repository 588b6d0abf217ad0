"""The trace reduction on hand-made intervals."""

from perfbench import trace


def test_busy_idle_and_gaps_by_stage():
    events = [("a", 0, 10), ("b", 5, 20), ("vote_kernel<3>", 30, 40),
              ("Memcpy HtoD", 45, 50), ("late", 95, 120)]
    spans = [("dispatch", 0, 42), ("collect", 42, 90)]
    r = trace.reduce(events, (0, 100), spans)
    assert r.window_s == 100e-9
    assert abs(r.busy_s - 40e-9) < 1e-15        # 0-20, 30-40, 45-50, 95-100
    assert r.launches == 4                       # the copy is not a launch
    assert abs(r.kernel_s["late"] - 5e-9) < 1e-15
    idle = r.idle_by_stage
    assert abs(idle["dispatch"] - 12e-9) < 1e-15     # 20-30, 40-42
    assert abs(idle["collect"] - 43e-9) < 1e-15      # 42-45, 50-90
    assert abs(idle[trace.OUTSIDE] - 5e-9) < 1e-15   # 90-95
    b = r.breakdown()
    assert set(b) == {"device_ops", "idle_gaps"}
    assert b["device_ops"][0][0] == "b" and len(b["device_ops"]) <= 10


def test_no_device_time_reads_as_all_idle():
    r = trace.reduce([], (0, 50), [])
    assert r.busy_s == 0 and r.launches == 0
    assert r.idle_by_stage == {trace.OUTSIDE: 50e-9}
