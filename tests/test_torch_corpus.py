"""The corner-case corpus of the port against the JAX reference: trivial,
helloWorld, simpleTMR, crazyCF, cache_test, schedule2 and simd.

For every name, against the JAX twin built in the same process: the init
image (as uint32 bits), the spec and meta, the declared dataflow (against
the reference's ``analyze()``), the leaf order, sections, sync tables and
the sync tags of one step (against the ``coast:sync:`` tags in the
reference step's jaxpr), the seeded schedules, the fused plan, and the
fault-free unprotected final state with its dtypes, which must also be
what each package's host oracle computes; then the records of a 64-row
campaign (seed 3, batch 64) under TMR and DWC, equal on every row with
no exemption, and the port's fused engine equal to its unfused one.
The index words these regions read from state are flipped on purpose
below, so each index rule meets its edge values.

The float regions (whetstone, scalarize) are in
``tests/test_torch_corpus_float.py`` and towersOfHanoi with
``-protectStack`` in ``tests/test_torch_hanoi.py``: they call the shared
checks here, and a file each lets ``--dist loadfile`` spread the JAX
twins over workers.
"""

import importlib

import numpy as np
import pytest
import torch

import coast_tpu_torch as ct
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.interop import state_to_numpy
from coast_tpu_torch.models import REGISTRY
from test_torch_baseline import (COLUMNS, ROWS, SEED, STRATEGIES, BATCH,
                                 Results, assert_states_equal,
                                 check_campaign, check_dataflow)
from test_torch_baseline import \
    check_sections_and_schedule as _baseline_sections

torch.set_num_threads(1)

NAMES = ("trivial", "helloWorld", "simpleTMR", "crazyCF", "cache_test",
         "schedule2", "simd")


# -- shared checks (the float and hanoi files call these too) ----------------

def oracle(name, package):
    """The leaves a fault-free run must end with, by ``package``'s own host
    oracle (``coast_tpu`` or ``coast_tpu_torch``).  The float regions'
    goldens hold within the regions' 1e-4 check tolerance."""
    def mod(path):
        return importlib.import_module(f"{package}.models.{path}")

    if name == "trivial":
        return {"ret": np.int32(0)}
    if name == "helloWorld":
        text = mod("smoke")._HELLO
        return {"out": np.frombuffer(text, np.uint8).astype(np.uint32)}
    if name == "simpleTMR":
        return {"acc": np.int32(sum(range(mod("smoke").N_ACC)) * 3 + 7)}
    if name == "crazyCF":
        m = mod("crazycf")
        return {"acc": np.uint32(m.golden_reference(m.make_input()))}
    if name == "cache_test":
        return {"table": mod("cache_test").golden_reference()}
    if name == "schedule2":
        m = mod("schedule2")
        return {"log": m.golden_reference(m.make_tape()).astype(np.int32)}
    if name == "simd":
        return {"v": mod("vector")._simd_golden()}
    if name == "towersOfHanoi":
        m = mod("hanoi")
        return {"disk_pos": np.full(m.NUM_DISKS, m.PEG_TO, np.int32),
                "moves": np.int32(m.TOTAL_MOVES)}
    if name == "scalarize":
        g = mod("vector")._scalarize_golden()
        return {"x": g[:8], "y": g[8:]}
    return {"e": mod("whetstone").golden_reference()}


def check_init_image(name, ref):
    """The init image as uint32 bits, against the image the reference's
    programs start from: its ``init()`` under ``jit`` (scalarize's
    ``jnp.linspace`` rounds word 1 one ulp higher there than eagerly)."""
    import jax
    jr, tr = ref.region(name), REGISTRY[name]()
    assert list(tr.spec) == list(jr.spec)
    for k, spec in tr.spec.items():
        want = jr.spec[k]
        assert (spec.kind, spec.xmr, spec.inject, spec.no_verify,
                spec.stack) == (want.kind, want.xmr, want.inject,
                                want.no_verify, want.stack), k
    assert {k: v.unsigned for k, v in tr.spec.items()} == {
        k: np.asarray(v).dtype == np.uint32 for k, v in jr.init().items()}
    assert_states_equal(state_to_numpy(tr.init("cpu"), tr), {
        k: np.asarray(v) for k, v in jax.jit(jr.init)().items()})
    assert (tr.nominal_steps, tr.max_steps) == (jr.nominal_steps,
                                                 jr.max_steps)
    assert tr.default_xmr == jr.default_xmr
    assert {k: v for k, v in tr.meta.items() if k != "dataflow"} == jr.meta


def reference_sync_tags(jprog):
    """``(class, leaf)`` of every ``coast:sync:`` tag in the reference
    step's jaxpr, sub-jaxprs included."""
    import jax
    import jax.numpy as jnp
    from jax._src import core as jcore
    from coast_tpu.ops.voters import TAG_SYNC
    pstate, flags = jax.eval_shape(jprog.init_pstate)
    closed = jax.make_jaxpr(jprog.step)(pstate, flags, jnp.int32(0))
    tags = set()

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            tag = str(eqn.params.get("name", "")) \
                if eqn.primitive.name == "name" else ""
            if tag.startswith(TAG_SYNC):
                klass, _, leaf = tag[len(TAG_SYNC):].partition(":")
                tags.add((klass, leaf))
            for sub in jcore.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(closed.jaxpr)
    return frozenset(tags)


def check_programs(jprog, tprog):
    """Two builds of one region and config: the same memory map, sync
    tables, sync tags and fused-plan decision."""
    assert tprog.leaf_order == jprog.leaf_order
    assert tprog.injectable_sections() == jprog.injectable_sections()
    assert tprog.replicated == jprog.replicated
    assert tprog.step_sync == jprog.step_sync
    assert tprog.pre_sync == jprog.pre_sync
    assert tprog.sync_tags() == reference_sync_tags(jprog)
    if jprog.fuse_plan_info is None:
        assert tprog.fuse_plan_info is None
    else:
        for field in ("done_leaves", "frozen_leaves", "bounded_scan",
                      "exact_dataflow"):
            assert getattr(tprog.fuse_plan_info, field) == getattr(
                jprog.fuse_plan_info, field), field
    assert (tprog._fuse_plan is None) == (jprog._fuse_plan is None)


def check_sections_and_schedule(name, strategy, ref):
    import coast_tpu
    region = ref.region(name)
    for fused in (False, True):
        check_programs(
            getattr(coast_tpu, strategy)(region, fuse_step=fused),
            getattr(ct, strategy)(REGISTRY[name](), device="cpu",
                                  fuse_step=fused))
    if ct.TMR(REGISTRY[name](), device="cpu",
              fuse_step=True)._fuse_plan is not None:
        _baseline_sections(name, strategy, ref)


def check_final_state(name, ref):
    region = REGISTRY[name]()
    final = region.run_unprotected(device="cpu")
    port_np = state_to_numpy(final, region)
    assert_states_equal(port_np, ref.final(name))
    one = {k: v.unsqueeze(0) for k, v in final.items()}
    assert int(region.check(one)[0]) == 0
    assert int(ref.region(name).check(ref.final(name))) == 0
    want = oracle(name, "coast_tpu_torch")
    exact = name not in ("whetstone", "scalarize")
    for key, value in oracle(name, "coast_tpu").items():
        np.testing.assert_array_equal(want[key], value, err_msg=key)
        assert port_np[key].dtype == np.asarray(value).dtype, key
        if exact:
            np.testing.assert_array_equal(port_np[key], value, err_msg=key)
        else:
            assert np.abs(port_np[key] - value).max() <= 1e-4, key


def check_fused(name, strategy, ref):
    """The fused build's records equal the unfused engine's; a float
    region keeps the unfused program under ``fuse_step=True``."""
    prog = getattr(ct, strategy)(REGISTRY[name](), device="cpu",
                                 fuse_step=True)
    exact = prog.fuse_plan_info.exact_dataflow
    assert (prog._fuse_plan is not None) == exact
    fused = CampaignRunner(prog, strategy_name=strategy).run(
        ROWS, seed=SEED, batch_size=BATCH)
    base = ref.port_campaign(name, strategy)    # the unfused engine's
    for col in COLUMNS:
        np.testing.assert_array_equal(getattr(fused, col),
                                      getattr(base, col), err_msg=col)
    assert fused.counts == base.counts


def check_step_dtypes(name):
    """Every leaf a step writes keeps its word dtype (an int64 or float64
    step output would break the vote)."""
    region = REGISTRY[name]()
    state = {k: v.unsqueeze(0) for k, v in region.init("cpu").items()}
    out = region.step(state, 0)
    assert set(out) == set(region.meta["dataflow"].written)
    for k, v in out.items():
        assert v.dtype == state[k].dtype and v.shape == state[k].shape, k


# -- this file's names -----------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    return Results()


@pytest.mark.parametrize("name", NAMES)
def test_init_image_equal(name, ref):
    check_init_image(name, ref)


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
    check_campaign(name, strategy, ref)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", NAMES)
def test_fused_equals_unfused(name, strategy, ref):
    check_fused(name, strategy, ref)


# Index words read from state, each flipped at its high bits (negative,
# far out of range) and low bits (just out of range), at an early and a
# late step: (name, leaf, word).
INDEX_WORDS = (("helloWorld", "i", 0), ("crazyCF", "i", 0),
               ("cache_test", "idx", 0), ("cache_test", "i", 0),
               ("schedule2", "i", 0), ("schedule2", "counts", 0),
               ("schedule2", "counts", 3), ("schedule2", "log_n", 0),
               ("schedule2", "tape", 1), ("schedule2", "tape", 40),
               ("schedule2", "next_id", 0), ("simpleTMR", "i", 0),
               ("trivial", "i", 0))


@pytest.mark.parametrize("name,leaf,word", INDEX_WORDS)
def test_flipped_index_words_like_reference(name, leaf, word, ref):
    """Unprotected (one lane, no vote repairs the index) and TMR runs with
    bit 31, 30, 10, 5 and 4 of an index word flipped: every record equal
    to the reference's, the output too."""
    import coast_tpu
    import jax
    region = ref.region(name)
    steps = region.nominal_steps
    for strategy in ("unprotected", "TMR"):
        jprog = getattr(coast_tpu, strategy)(region)
        tprog = getattr(ct, strategy)(REGISTRY[name](), device="cpu")
        leaf_id = tprog.leaf_order.index(leaf)
        assert jprog.leaf_order.index(leaf) == leaf_id
        cols = {"leaf_id": [], "lane": [], "word": [], "bit": [], "t": []}
        for bit in (31, 30, 10, 5, 4):
            for t in sorted({0, steps // 2, steps - 1}):
                for k, v in zip(cols, (leaf_id, 0, word, bit, t)):
                    cols[k].append(v)
        cols = {k: np.asarray(v, np.int32) for k, v in cols.items()}
        got = tprog.run_batch(cols)
        run = jax.jit(jax.vmap(jprog.run))
        want = run({k: jax.numpy.asarray(v) for k, v in cols.items()})
        for key in ("errors", "corrected", "steps", "done", "dwc_fault",
                    "output"):
            np.testing.assert_array_equal(
                got[key].numpy().astype(np.int64),
                np.asarray(want[key]).astype(np.uint32).view(np.int32)
                .astype(np.int64) if key == "output" else
                np.asarray(want[key]).astype(np.int64),
                err_msg=f"{strategy} {key}")
