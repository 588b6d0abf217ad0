"""The readers of the engine's per-trip spans, ``step.region`` and
``engine.commit``, on hand-made ``harness.Ctx`` values: what they read,
and nothing from a program that does not record them."""

from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(harness.__file__).resolve().parents[1]
READERS = {"step.region_enqueue_ms_per_batch": "dispatch/step.region",
           "engine.commit_enqueue_ms_per_batch": "dispatch/engine.commit"}


def _read(metric, stages, batches=4):
    ctx = harness.Ctx(cell=None, setup_s=1.0, window_s=2.0, injections=400,
                      campaigns=1, batches=batches, memory_peak_bytes=0,
                      stages=dict(stages), transfer={})
    return harness.reader(ROOT, metric)(ctx)


# A program with the spans (seconds summed over the window's campaigns).
WITH = {"dispatch": 0.4, "dispatch/engine.halt_read": 0.1,
        "dispatch/step.region": 0.2, "dispatch/engine.commit": 0.06,
        "collect": 0.1}
# The parent's program: other nested spans, none of these two.
WITHOUT = {"dispatch": 0.4, "dispatch/engine.halt_read": 0.1,
           "collect": 0.1}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reads_its_span_per_batch(metric):
    got = _read(metric, WITH)
    assert abs(got - 1000.0 * WITH[READERS[metric]] / 4) < 1e-9


@pytest.mark.parametrize("metric", sorted(READERS))
def test_nothing_where_the_span_is_absent(metric):
    assert _read(metric, WITHOUT) is None
    assert _read(metric, {}) is None
    assert _read(metric, WITH, batches=0) is None
