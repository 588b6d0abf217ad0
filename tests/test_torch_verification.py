"""The derived region dataflow (``passes/verification.derive``) against the
declared one and the reference's ``analyze()``.

For each of the 36 registry regions the dataflow derived from a capture of
the port's step writes the same leaves as the declaration and the
reference's analysis, and every dependency and address role it finds is
one they name.  The reference's walk over-approximates: JAX caches one
sub-jaxpr for each ``jnp.where``/``jnp.clip``-style helper and its walk
seeds that sub-jaxpr with the union of every call site's provenance, so
a declared fact may be wider than the step shows, never narrower.
``analyze`` returns the declaration (the sync tables must equal the
reference's) and raises where the step leaves it.
"""

import dataclasses

import pytest
import torch

from coast_tpu_torch.ir.region import Region
from coast_tpu_torch.models import REGISTRY
from coast_tpu_torch.passes import verification as V
from coast_tpu_torch.passes.strategies import TMR

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_derived_dataflow_within_the_declared_and_the_reference(name):
    from coast_tpu.models import REGISTRY as JREG
    from coast_tpu.passes.verification import analyze as janalyze
    region = REGISTRY[name]()
    derived = V.derive(region)
    declared = region.meta["dataflow"]
    ref = janalyze(JREG[name]())
    assert derived.written == declared.written == ref.written
    for fact in ("load_addr", "store_addr"):
        assert getattr(declared, fact) == getattr(ref, fact)
        assert getattr(derived, fact) <= getattr(ref, fact), fact
    for leaf in region.spec:
        assert declared.deps[leaf] == ref.deps[leaf]
        assert derived.deps[leaf] <= ref.deps[leaf], leaf
        if leaf not in derived.written:
            assert derived.deps[leaf] == frozenset({leaf})
    assert V.analyze(region) is declared


def with_dataflow(region: Region, **changes) -> Region:
    flow = dataclasses.replace(region.meta["dataflow"], **changes)
    return dataclasses.replace(region, meta={**region.meta,
                                             "dataflow": flow})


def test_a_wrong_declaration_raises_naming_region_and_leaf():
    region = REGISTRY["matrixMultiply"]()
    flow = region.meta["dataflow"]
    bad = with_dataflow(region, load_addr=flow.load_addr - {"i"})
    with pytest.raises(V.SoRViolation, match="'matrixMultiply'.*'i'.*load"):
        V.analyze(bad)
    with pytest.raises(V.SoRViolation, match="'acc'"):
        TMR(with_dataflow(region, written=flow.written - {"acc"}),
            device="cpu")
    deps = dict(flow.deps)
    deps["phase"] = frozenset({"i"})
    with pytest.raises(V.SoRViolation, match="'phase'.*also reads"):
        V.analyze(with_dataflow(region, deps=deps))


def test_an_undeclared_region_runs_on_its_derived_dataflow():
    region = REGISTRY["crc16"]()
    bare = dataclasses.replace(region, meta={
        k: v for k, v in region.meta.items() if k != "dataflow"})
    flow = V.analyze(bare)
    assert flow == V.derive(region)
    assert flow.written == {"crc", "i"} and flow.load_addr == {"i"}
    assert flow.deps["i"] == {"i"}              # the step's own reads
    rec = TMR(bare, device="cpu").run()
    assert int(rec["errors"]) == 0 and bool(rec["done"])
