"""The port's smoke drivers (``coast_tpu_torch/testing/*_smoke.py``), the
counterparts of every one of the reference's fast.yml drivers: each prints ``Success!`` with ``-d cpu``, alone and through the
harness's driver tier -- except ``fused_smoke``, whose op-count oracle
the port's engine does not meet (its other two oracles hold)."""

import contextlib
import io

import pytest
import torch

from coast_tpu_torch.testing import harness

torch.set_num_threads(1)

DRIVERS = ["resume_smoke", "stream_smoke", "faultmodel_smoke",
           "equiv_smoke", "train_smoke", "sparse_smoke", "stencil_smoke",
           "propagation_smoke", "obs_live_smoke", "fused_smoke",
           "slo_smoke", "fleet_smoke", "profile_smoke", "ci_smoke",
           "serve_smoke"]
# fused_smoke's op-count oracle does not hold on the port (ROADMAP Queue
# C): test_fused_smoke_reports_the_op_count_finding holds what it prints.
SUCCEEDING = [d for d in DRIVERS if d != "fused_smoke"]


@pytest.mark.parametrize("name", SUCCEEDING)
def test_driver_prints_success(name):
    import importlib
    mod = importlib.import_module(f"coast_tpu_torch.testing.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(["-d", "cpu"])
    assert rc == 0, buf.getvalue()
    assert buf.getvalue().splitlines()[-1] == "Success!"


def test_ported_drivers_are_fast_yml_minus_the_later_items():
    # No later item is left: the ported drivers are all of fast.yml's.
    fast = [d["module"] for d in harness.FAST["drivers"]]
    assert sorted(set(fast)) == sorted(DRIVERS)
    assert not hasattr(harness, "LATER_DRIVERS")
    assert set(harness.PORTED_DRIVERS) == set(DRIVERS) | {"fuzz"}


def test_harness_driver_tier_runs_the_ported_drivers():
    cfg = {"drivers": [{"module": m} for m in ("resume_smoke",
                                               "faultmodel_smoke")]}
    assert harness.run_drivers(cfg, quiet=True, device="cpu") == 2


def test_fused_smoke_reports_the_op_count_finding():
    from coast_tpu_torch.testing import fused_smoke
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fused_smoke.main(["-d", "cpu"])
    out = buf.getvalue().splitlines()
    assert rc == 1 and "Success!" not in out
    assert any(ln.startswith("byte parity: dense ndjson sha") for ln in out)
    assert "journal identity: cross-engine resume refused typed " \
        "(both directions)" in out
    errors = [ln for ln in out if ln.startswith("Error")]
    assert errors == [
        "Error, TMR fused overhead reduction 1.00x below the 2.0x floor",
        "Error, DWC fused overhead reduction 1.00x below the 1.5x floor"]
