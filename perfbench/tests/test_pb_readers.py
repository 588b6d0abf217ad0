"""The readers of the program's own spans and counters on hand-made
``harness.Ctx`` values: what they read, and nothing from a program that
does not record it."""

from pathlib import Path

from perfbench import harness, trace

ROOT = Path(harness.__file__).resolve().parents[1]


def _read(metric, ctx):
    return harness.reader(ROOT, metric)(ctx)


def _ctx(stages=None, transfer=None, reduced=None, batches=4):
    return harness.Ctx(cell=None, setup_s=1.0, window_s=2.0, injections=400,
                       campaigns=1, batches=batches, memory_peak_bytes=0,
                       stages=dict(stages or {}),
                       transfer=dict(transfer or {}), trace=reduced)


# A program with nested spans (seconds summed over the window's campaigns).
NESTED = {"sparse_setup": 0.5, "sparse_setup/setup.columns": 0.3,
          "sparse_setup/setup.upload": 0.1, "dispatch": 0.4,
          "dispatch/engine.upload": 0.02, "dispatch/engine.fire_read": 0.01,
          "dispatch/engine.halt_read": 0.17, "collect": 0.1,
          "collect/collect.wait": 0.08}
# The parent's program: top-level stages and bytes only.
FLAT = {"sparse_setup": 0.5, "dispatch": 0.4, "collect": 0.1}


def test_host_reads_per_batch():
    assert _read("engine.host_reads_per_batch",
                 _ctx(transfer={"up": 1, "down": 2, "reads": 230})) == 57.5
    assert _read("engine.host_reads_per_batch",
                 _ctx(transfer={"up": 1, "down": 2})) is None
    assert _read("engine.host_reads_per_batch",
                 _ctx(transfer={"reads": 3}, batches=0)) is None


def test_enqueue_ms_per_batch_leaves_out_the_waits():
    got = _read("engine.enqueue_ms_per_batch", _ctx(NESTED))
    assert abs(got - 1000.0 * (0.4 - 0.02 - 0.01 - 0.17) / 4) < 1e-9
    assert _read("engine.enqueue_ms_per_batch", _ctx(FLAT)) is None
    assert _read("engine.enqueue_ms_per_batch", _ctx({})) is None


def test_upload_ms_per_batch_sums_both_uploads():
    got = _read("campaign.upload_ms_per_batch", _ctx(NESTED))
    assert abs(got - 1000.0 * (0.1 + 0.02) / 4) < 1e-9
    # A dense campaign has no resident upload: the per-batch one alone.
    dense = {"dispatch": 0.4, "dispatch/engine.upload": 0.04}
    assert abs(_read("campaign.upload_ms_per_batch", _ctx(dense))
               - 10.0) < 1e-9
    assert _read("campaign.upload_ms_per_batch", _ctx(FLAT)) is None


def test_idle_unspanned_pct_reads_the_gaps_outside_every_stage():
    events = [("k", 0, 10), ("k", 30, 40)]
    spans = [("dispatch", 0, 20), ("account", 40, 90)]
    reduced = trace.reduce(events, (0, 100), spans)
    got = _read("device.idle_unspanned_pct", _ctx(reduced=reduced))
    assert abs(got - 20.0) < 1e-9            # 20-30 and 90-100 of 100
    covered = trace.reduce(events, (0, 100), [("dispatch", 0, 100)])
    assert _read("device.idle_unspanned_pct", _ctx(reduced=covered)) == 0.0
    assert _read("device.idle_unspanned_pct", _ctx()) is None
