"""The float corpus regions of the port against the JAX reference:
whetstone and scalarize (f32 leaves).

The checks are ``tests/test_torch_corpus.py``'s, with two differences
that come from XLA, not from the port:

  * Records are equal on every row outside the exemption each model
    module declares (``whetstone.order_sensitive``: every flip of ``e``;
    ``vector.order_sensitive``: a flip below the exponent of ``x`` or
    ``y``).  XLA contracts multiply-adds of the reference's batched step
    into fused ones and the port rounds every operator, so whether a
    small perturbation is absorbed by a later rounding (a masked fault)
    may differ there.  Exempt rows still have equal ``errors`` and
    ``steps`` (the 1e-4 check and the watchdog do not see a rounding).
    Each test prints how many rows it exempts and how many of those
    differ.
  * The campaigns run the 64-row seeded schedule and a sweep of sign and
    exponent flips (bits 23-31) of every float word at several steps.
    Such a flip can leave a subnormal, which XLA on the CPU flushes to
    zero and torch keeps; the votes read a subnormal as zero on both
    sides, and the records outside the exemption are equal.

The fused build keeps the unfused program on both (``exact_dataflow``
False, as the reference's).
"""

import importlib

import numpy as np
import pytest
import torch

import coast_tpu_torch as ct
from coast_tpu_torch.models import REGISTRY
from test_torch_baseline import (COLUMNS, ROWS, SEED, STRATEGIES, Results,
                                 check_dataflow)
from test_torch_corpus import (check_final_state, check_fused,
                               check_init_image, check_sections_and_schedule,
                               check_step_dtypes)

torch.set_num_threads(1)

NAMES = ("whetstone", "scalarize")
MODULES = {"whetstone": "whetstone", "scalarize": "vector"}
FLOAT_LEAVES = {"whetstone": ("e",), "scalarize": ("x", "y")}


def exempt_rows(name, leaf_order, leaf_id, bit):
    mod = importlib.import_module(f"coast_tpu_torch.models.{MODULES[name]}")
    return mod.order_sensitive(leaf_order, leaf_id, bit)


def assert_records_equal(name, what, leaf_order, leaf_id, bit, got, want):
    """``got`` / ``want``: column name -> array.  Every column equal
    outside the exemption; ``errors`` and ``steps`` on every row."""
    exempt = exempt_rows(name, leaf_order, leaf_id, bit)
    differ = np.zeros(len(exempt), bool)
    for col in got:
        bad = np.asarray(got[col]) != np.asarray(want[col])
        differ |= bad
        rows = bad if col in ("errors", "steps") else bad & ~exempt
        assert not rows.any(), (
            f"{what}: {col} differs on rows {np.flatnonzero(rows)[:10]}")
    print(f"{what}: {len(exempt)} rows, {int(exempt.sum())} exempt, "
          f"{int(differ.sum())} of them differ")


@pytest.fixture(scope="module")
def ref():
    return Results()


@pytest.mark.parametrize("name", NAMES)
def test_init_image_equal(name, ref):
    check_init_image(name, ref)


def test_scalarize_init_is_the_jitted_linspace(ref):
    """The reference's programs compute ``jnp.linspace`` under ``jit``,
    where word 1 of ``x`` rounds one ulp above the eager result: the port
    carries the jitted words."""
    import jax
    region = ref.region("scalarize")
    eager = np.asarray(region.init()["x"]).view(np.uint32)
    jitted = np.asarray(jax.jit(region.init)()["x"]).view(np.uint32)
    port = REGISTRY["scalarize"]().init("cpu")["x"].numpy().view(np.uint32)
    np.testing.assert_array_equal(port, jitted)
    assert np.flatnonzero(port != eager).tolist() == [1]


@pytest.mark.parametrize("name", NAMES)
def test_declared_dataflow_equals_reference_analysis(name, ref):
    check_dataflow(name, ref)
    check_step_dtypes(name)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", NAMES)
def test_sections_schedule_and_plan_equal(name, strategy, ref):
    check_sections_and_schedule(name, strategy, ref)


@pytest.mark.parametrize("name", NAMES)
def test_fault_free_final_state_equals_reference_and_oracle(name, ref):
    check_final_state(name, ref)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", NAMES)
def test_campaign_parity(name, strategy, ref):
    want = ref.campaign(name, strategy)
    got = ref.port_campaign(name, strategy)
    assert got.n == want.n == ROWS
    for col in ("leaf_id", "lane", "word", "bit", "t"):
        np.testing.assert_array_equal(getattr(got.schedule, col),
                                      getattr(want.schedule, col))
    leaf_order = getattr(ct, strategy)(REGISTRY[name](),
                                       device="cpu").leaf_order
    assert_records_equal(
        name, f"{name} {strategy} seed {SEED}", leaf_order,
        got.schedule.leaf_id, got.schedule.bit,
        {c: getattr(got, c) for c in COLUMNS},
        {c: getattr(want, c) for c in COLUMNS})


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", NAMES)
def test_fused_equals_unfused(name, strategy, ref):
    check_fused(name, strategy, ref)


@pytest.mark.parametrize("strategy", ("unprotected", *STRATEGIES))
@pytest.mark.parametrize("name", NAMES)
def test_exponent_flips_like_reference(name, strategy, ref):
    """Sign and exponent flips (bits 23-31) of every float word, lane 0,
    at every fifth step: the records against the reference's batched
    program (``jax.vmap`` of its ``run``, as its campaigns batch rows)."""
    import coast_tpu
    import jax
    import jax.numpy as jnp
    region = ref.region(name)
    jprog = getattr(coast_tpu, strategy)(region)
    tprog = getattr(ct, strategy)(REGISTRY[name](), device="cpu")
    assert tprog.leaf_order == jprog.leaf_order
    cols = {k: [] for k in ("leaf_id", "lane", "word", "bit", "t")}
    for leaf in FLOAT_LEAVES[name]:
        leaf_id = tprog.leaf_order.index(leaf)
        for word in range(tprog.lane_words(leaf)):
            for bit in range(23, 32):
                for t in range(0, region.nominal_steps, 5):
                    for k, v in zip(cols, (leaf_id, 0, word, bit, t)):
                        cols[k].append(v)
    cols = {k: np.asarray(v, np.int32) for k, v in cols.items()}
    got = tprog.run_batch(cols)
    want = jax.jit(jax.vmap(jprog.run))(
        {k: jnp.asarray(v) for k, v in cols.items()})
    keys = ("errors", "corrected", "steps", "done", "dwc_fault")
    assert_records_equal(
        name, f"{name} {strategy} sign/exponent sweep", tprog.leaf_order,
        cols["leaf_id"], cols["bit"],
        {k: got[k].numpy().astype(np.int64) for k in keys},
        {k: np.asarray(want[k]).astype(np.int64) for k in keys})
