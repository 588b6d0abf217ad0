"""The instrument passes of the port against the JAX reference's
``instrument`` output: the ``fn-->bb`` trace lines (and the raw
``trace_block`` / ``trace_live``), the profile counters and their
``PRINT_PROFILE_STATS`` lines, and the exit-marker final image and its
digest, on towersOfHanoi, matrixMultiply and nestedCalls under TMR, DWC
and the unprotected build, with and without CFCSS, fault-free and with a
flip (a DWC abort included).
"""

import numpy as np
import pytest
import torch

import coast_tpu_torch as ct
from coast_tpu_torch.models import REGISTRY
from coast_tpu_torch.passes import instrument
from coast_tpu_torch.passes.verification import RegionDataflow

torch.set_num_threads(1)

NAMES = ("towersOfHanoi", "matrixMultiply", "nestedCalls")


def _programs(name, strategy, cfcss):
    import coast_tpu
    from coast_tpu.models import REGISTRY as JREGISTRY
    return (getattr(coast_tpu, strategy)(JREGISTRY[name](), cfcss=cfcss),
            getattr(ct, strategy)(REGISTRY[name](), device="cpu",
                                  cfcss=cfcss))


def _faults(prog):
    """Fault-free, then one flip of the first leaf (a lane-1 flip under
    DWC aborts) and, under CFCSS, one of the signature tracker."""
    lane = min(1, prog.cfg.num_clones - 1)
    faults = [None, {"leaf_id": 0, "lane": lane, "word": 0, "bit": 1,
                     "t": 10}]
    if prog.cfg.cfcss:
        faults.append({"leaf_id": len(prog.leaf_order) - 1, "lane": lane,
                       "word": 0, "bit": 7, "t": 4})
    return faults


def _jfault(fault):
    import jax.numpy as jnp
    return None if fault is None else {k: jnp.int32(v)
                                       for k, v in fault.items()}


@pytest.mark.parametrize("cfcss", [False, True])
@pytest.mark.parametrize("strategy", ["TMR", "DWC", "unprotected"])
@pytest.mark.parametrize("name", NAMES)
def test_trace_and_profile_equal_reference(name, strategy, cfcss):
    from coast_tpu.passes import instrument as jinstrument
    jprog, tprog = _programs(name, strategy, cfcss)
    for i, fault in enumerate(_faults(tprog)):
        jrec, jlines = jinstrument.trace_run(jprog, _jfault(fault))
        if i == 0:
            rec, lines = instrument.trace_run(tprog, fault)
            counts = instrument.profile_counts(tprog, rec)
        else:
            rec, counts = instrument.profile_run(tprog, fault)
            lines = instrument.format_trace(tprog, rec)
        assert lines == jlines
        for key in ("trace_block", "trace_live"):
            np.testing.assert_array_equal(rec[key], np.asarray(jrec[key]))
        assert rec["trace_block"].shape == (tprog.region.max_steps,)
        names = tuple(tprog.region.graph.names[1:2])
        assert (instrument.format_trace(tprog, rec, names)
                == jinstrument.format_trace(jprog, jrec, names))
        assert counts == jinstrument.profile_counts(jprog, jrec)
        assert (instrument.format_profile_stats(counts)
                == jinstrument.format_profile_stats(counts))
        for key in ("errors", "steps", "done", "dwc_fault", "cfc_fault"):
            assert rec[key] == np.asarray(jrec[key]), key


@pytest.mark.parametrize("cfcss", [False, True])
@pytest.mark.parametrize("strategy", ["TMR", "DWC", "unprotected"])
@pytest.mark.parametrize("name", NAMES)
def test_exit_marker_equals_reference(name, strategy, cfcss):
    from coast_tpu.passes import instrument as jinstrument
    jprog, tprog = _programs(name, strategy, cfcss)
    for fault in _faults(tprog):
        jfinal, jrec = jinstrument.run_to_exit_marker(jprog, _jfault(fault))
        final, rec = instrument.run_to_exit_marker(tprog, fault)
        assert sorted(final) == sorted(jfinal)
        for k, v in jfinal.items():
            assert final[k].dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(final[k], np.asarray(v),
                                          err_msg=k)
        assert instrument.state_digest(final) == jinstrument.state_digest(
            jfinal)
        assert int(rec["errors"]) == int(jrec["errors"])


def test_profile_counts_stop_at_a_dwc_abort():
    """The fault step is entered (profiled) but never commits, so the
    region counter is the runtime plus one, as in the reference."""
    prog = ct.DWC(REGISTRY["towersOfHanoi"](), device="cpu")
    fault = {"leaf_id": prog.leaf_order.index("disk_pos"), "lane": 1,
             "word": 0, "bit": 1, "t": 10}
    rec, counts = instrument.profile_run(prog, fault)
    assert bool(rec["dwc_fault"])
    assert counts["towersOfHanoi"] == int(rec["steps"]) + 1


def test_region_without_graph_is_one_block():
    region = ct.Region(
        name="straightline",
        init=lambda device: {"x": torch.zeros((), dtype=torch.int32,
                                              device=device)},
        step=lambda s, t: {"x": s["x"] + 1},
        done=lambda s: s["x"] >= 4,
        check=lambda s: (s["x"] != 4).to(torch.int32),
        output=lambda s: s["x"].reshape(-1, 1),
        nominal_steps=4, max_steps=8,
        spec={"x": ct.LeafSpec("reg")},
        meta={"dataflow": RegionDataflow(written=frozenset({"x"}),
                                         deps={"x": frozenset({"x"})})})
    rec, lines = instrument.trace_run(ct.unprotected(region, device="cpu"))
    assert lines == ["straightline-->straightline"] * 4
