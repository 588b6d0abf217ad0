"""The port's shared fault-propagation walker against the reference's.

``analyze_step`` of the port (over the captured trips) and of the
reference (over the step's jaxpr) are compared fact by fact on the same
builds: ``value_fed``, ``consumed``, ``written``, ``lane_flagged``,
``check_reads``, ``out_taint``, ``guards``, ``cfcss``, ``fn_unsafe``,
``train_fallback`` and the set of leaves with a witness path.

Where the reference's facts differ they differ by its own walk's
over- or under-approximation, and each such difference is pinned exactly
(``REF_ONLY_CONSUMED``, ``PORT_ONLY_INFLUENCE``):

* the reference keys a traced helper's variables by identity, and jax
  reuses one traced ``jnp.where`` for every call of one signature, so its
  lattice joins crc16's ``crc`` into the ``i`` output's provenance;
* the reference's ``cond`` rule unions the branch outputs only, dropping
  the predicate's influence: train_mlp's DWC store-slice votes are a
  ``lax.cond`` on the phase there and a per-row select here.

``out_taint`` is compared on the outputs both steps return (the
reference's step also returns the fault flags the port's step has only
when they are used, all with empty influence).

The second test pins the walker's union-over-trips claim: the facts of
the first eight trips (``capture.MAX_TRIPS``) equal those of a capture of
the whole fault-free run.
"""

import pytest
import torch

from coast_tpu_torch.analysis.lint import capture
from coast_tpu_torch.analysis.propagation import analyze_step
from coast_tpu_torch.models import REGISTRY
from coast_tpu_torch.passes import strategies

torch.set_num_threads(1)

BUILDS = {
    "mm_tmr": ("matrixMultiply", "TMR", {}),
    "mm_dwc": ("matrixMultiply", "DWC", {}),
    "crc16_tmr": ("crc16", "TMR", {}),
    "crc16_dwc": ("crc16", "DWC", {}),
    "mm_tmr_fused": ("matrixMultiply", "TMR", {"fuse_step": True}),
    "mm_dwc_fused": ("matrixMultiply", "DWC", {"fuse_step": True}),
    "crc16_tmr_fused": ("crc16", "TMR", {"fuse_step": True}),
    "crc16_dwc_fused": ("crc16", "DWC", {"fuse_step": True}),
    "schedule2_tmr_cfcss": ("schedule2", "TMR", {"cfcss": True}),
    "schedule2_dwc_cfcss": ("schedule2", "DWC", {"cfcss": True}),
    "nestedCalls_tmr_skip_lib": ("nestedCalls", "TMR",
                                 {"skip_lib_calls": ("mix",)}),
    "nestedCalls_dwc_skip_lib": ("nestedCalls", "DWC",
                                 {"skip_lib_calls": ("mix",)}),
    "rtos_mm_tmr": ("rtos_mm", "TMR", {}),
    "rtos_mm_dwc": ("rtos_mm", "DWC", {}),
    "train_mlp_tmr": ("train_mlp", "TMR", {}),
    "train_mlp_dwc": ("train_mlp", "DWC", {}),
    "stencil_tmr": ("stencil", "TMR", {}),
    "stencil_dwc": ("stencil", "DWC", {}),
}

# Leaves the reference's lattice counts as consumed through a shared traced
# helper (see the module docstring).
REF_ONLY_CONSUMED = {"crc16_tmr": {"crc"}, "crc16_dwc": {"crc"},
                     "crc16_tmr_fused": {"crc"},
                     "crc16_dwc_fused": {"crc"}}
# Influence the reference's cond rule drops (see the module docstring):
# output -> the leaves only the port's walk sees.
_PHASE = {k: {"phase"} for k in ("dwc_fault", "g_b1", "g_b2", "g_loss",
                                 "g_w1", "g_w2", "steps", "x", "y")}
PORT_ONLY_INFLUENCE = {"train_mlp_dwc": _PHASE}


def port_prog(name, strategy, kw):
    return getattr(strategies, strategy)(REGISTRY[name](), device="cpu",
                                         **kw)


def ref_prog(name, strategy, kw):
    import coast_tpu
    from coast_tpu.models import REGISTRY as JREG
    return getattr(coast_tpu, strategy)(JREG[name](), **kw)


def facts_of(f):
    return {
        "value_fed": set(f.taint.value_fed),
        "consumed": set(f.consumed),
        "written": set(f.written),
        "lane_flagged": set(f.lane_flagged),
        "check_reads": set(f.check_reads),
        "guards": f.guards,
        "cfcss": f.cfcss,
        "fn_unsafe": f.fn_unsafe,
        "train_fallback": f.train_fallback,
        "witness": set(f.taint.witness),
    }


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_facts_equal_the_reference(build):
    from coast_tpu.analysis.propagation import analyze_step as janalyze
    name, strategy, kw = BUILDS[build]
    got = analyze_step(port_prog(name, strategy, kw))
    want = janalyze(ref_prog(name, strategy, kw))
    a, b = facts_of(got), facts_of(want)
    b["consumed"] -= REF_ONLY_CONSUMED.get(build, set())
    assert a == b
    # Witness paths end at a live value-feeding consumer.
    assert all(p[-1].endswith("!") for p in got.taint.witness.values())
    extra = PORT_ONLY_INFLUENCE.get(build, {})
    shared = set(got.out_taint) & set(want.out_taint)
    assert set(got.out_taint) <= set(want.out_taint)
    assert all(not want.out_taint[k] for k in set(want.out_taint) - shared)
    for out in shared:
        assert set(got.out_taint[out]) == (set(want.out_taint[out])
                                           | extra.get(out, set())), out


def structure(trip):
    """A trip's graph without its constant operands."""
    return tuple((n.op, tuple(n.ins), tuple(n.outs),
                  tuple(map(tuple, n.out_shapes))) for n in trip.nodes)


COVERAGE = ["mm_tmr", "crc16_dwc", "schedule2_tmr_cfcss",
            "nestedCalls_tmr_skip_lib", "rtos_mm_tmr", "train_mlp_tmr",
            "stencil_tmr", "simd_tmr"]
BUILDS["simd_tmr"] = ("simd", "TMR", {})


@pytest.mark.parametrize("build", COVERAGE)
def test_eight_trips_hold_every_trip_graph(build):
    """The whole fault-free run's distinct trip graphs all appear among
    the first eight trips (simd's trips differ only in the constant
    offsets ``t`` picks), and the facts of the eight-trip capture equal
    those of the whole run's."""
    name, strategy, kw = BUILDS[build]
    prog = port_prog(name, strategy, kw)
    first = capture.capture_run(prog)
    whole = capture.capture_run(prog, max_trips=prog.region.max_steps)
    assert {structure(t) for t in whole} <= {structure(t) for t in first}
    a = analyze_step(prog, closed=first)
    b = analyze_step(prog, closed=whole)
    assert facts_of(a) == facts_of(b)
    assert a.out_taint == b.out_taint


def test_propagation_consumers_name_item_17c():
    """Item 17c landed: the package exports the reference's whole
    ``__all__`` -- the walker, the vulnerability map and the isolation
    prover -- and the map reads the walker's facts of mm TMR."""
    from coast_tpu.analysis import propagation as jprop
    from coast_tpu_torch.analysis import propagation
    from coast_tpu_torch.analysis.propagation import isolation, vulnmap
    assert propagation.__all__ == jprop.__all__
    for name in propagation.__all__:
        assert getattr(propagation, name) is not None
    assert propagation.analyze_propagation is vulnmap.analyze_propagation
    assert propagation.prove_isolation is isolation.prove_isolation
    prog = port_prog("matrixMultiply", "TMR", {})
    facts = analyze_step(prog)
    vmap = propagation.analyze_propagation(prog, facts=facts)
    assert vmap.verdict("phase") == propagation.VERDICT_SDC
