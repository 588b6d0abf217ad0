"""The PyTorch port's regions, memory map and schedules against the JAX
reference.

For mm, mm256(side=64, block=16), mm256(side=128, block=32, bf16) and
crc16: the init image (through ``interop``), the leaf order, the injectable
sections, the declared dataflow (against the reference's ``analyze()``)
and the fault-free unprotected final state must be equal, bit for bit;
so must the memory map and the seeded schedule columns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coast_tpu
import coast_tpu_torch as ct
from coast_tpu.inject.mem import MemoryMap as JMemoryMap
from coast_tpu.inject.schedule import generate as jgenerate
from coast_tpu.models import common as jcommon
from coast_tpu.models import crc16 as jcrc16
from coast_tpu.models import mm as jmm
from coast_tpu.models import mm256 as jmm256
from coast_tpu.native import splitmix_fill as jsplitmix_fill
from coast_tpu.ops import indexing as jindexing
from coast_tpu.passes.verification import analyze as janalyze
from coast_tpu_torch.inject.mem import MemoryMap
from coast_tpu_torch.inject.schedule import generate, splitmix_fill
from coast_tpu_torch.interop import (fault_from_numpy, state_from_numpy,
                                     state_to_numpy)
from coast_tpu_torch.models import REGISTRY, common, crc16, mm, mm256
from coast_tpu_torch.ops import indexing
from coast_tpu_torch.passes.verification import SoRViolation, analyze

# The suite runs under xdist, several workers to a host: one intra-op
# thread per worker keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

REGIONS = {
    "mm": (jmm.make_region, mm.make_region),
    "mm256_64": (lambda: jmm256.make_region(side=64, block=16),
                 lambda: mm256.make_region(side=64, block=16)),
    "mm256_128_bf16": (
        lambda: jmm256.make_region(side=128, block=32, bf16_matmul=True),
        lambda: mm256.make_region(side=128, block=32, bf16_matmul=True)),
    "crc16": (jcrc16.make_region, crc16.make_region),
}
STRATEGIES = {"unprotected": (coast_tpu.unprotected, ct.unprotected),
              "DWC": (coast_tpu.DWC, ct.DWC),
              "TMR": (coast_tpu.TMR, ct.TMR)}


def jax_numpy(state):
    return {k: np.asarray(v) for k, v in state.items()}


def assert_states_equal(port_np, ref_np):
    assert sorted(port_np) == sorted(ref_np)
    for k in ref_np:
        assert port_np[k].dtype == ref_np[k].dtype, k
        assert port_np[k].shape == ref_np[k].shape, k
        np.testing.assert_array_equal(port_np[k].view(np.uint32),
                                      ref_np[k].view(np.uint32), err_msg=k)


@pytest.mark.parametrize("name", sorted(REGIONS))
def test_init_image_equal(name):
    jr, tr = (f() for f in REGIONS[name])
    region = tr
    assert list(region.spec) == list(jr.spec)
    assert_states_equal(state_to_numpy(region.init("cpu"), region),
                        jax_numpy(jr.init()))
    assert region.nominal_steps == jr.nominal_steps
    assert region.max_steps == jr.max_steps


@pytest.mark.parametrize("name", sorted(REGIONS))
def test_declared_dataflow_equals_reference_analysis(name):
    jr, tr = (f() for f in REGIONS[name])
    ref, port = janalyze(jr), analyze(tr)
    assert port.written == ref.written
    assert port.load_addr == ref.load_addr
    assert port.store_addr == ref.store_addr
    assert port.deps == ref.deps


@pytest.mark.parametrize("name", sorted(REGIONS))
@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_sections_and_schedule_equal(name, strategy):
    jr, tr = (f() for f in REGIONS[name])
    js, ts = STRATEGIES[strategy]
    jprog, tprog = js(jr), ts(tr, device="cpu")
    assert tprog.leaf_order == jprog.leaf_order
    assert tprog.injectable_sections() == jprog.injectable_sections()
    assert tprog.replicated == jprog.replicated
    assert tprog.step_sync == jprog.step_sync
    assert tprog.pre_sync == jprog.pre_sync
    jmap, tmap = JMemoryMap(jprog), MemoryMap(tprog)
    assert tmap.total_bits == jmap.total_bits
    assert ([tuple(vars(s).values()) for s in tmap.sections]
            == [tuple(vars(s).values()) for s in jmap.sections])
    for s in jmap.sections:
        assert vars(tmap.by_name(s.name)) == vars(s)
        assert tmap.by_name(s.name).bits == s.bits
    for seed in (0, 3):
        a = jgenerate(jmap, 500, seed, jr.nominal_steps)
        b = generate(tmap, 500, seed, tr.nominal_steps)
        for col in ("leaf_id", "lane", "word", "bit", "t", "section_idx"):
            np.testing.assert_array_equal(getattr(b, col), getattr(a, col),
                                          err_msg=col)


@pytest.mark.parametrize("name", sorted(REGIONS))
def test_fault_free_unprotected_final_state_bit_equal(name):
    jr, tr = (f() for f in REGIONS[name])
    ref = jax_numpy(jax.jit(jr.run_unprotected)())
    port = state_to_numpy(tr.run_unprotected(device="cpu"), tr)
    assert_states_equal(port, ref)
    assert int(jr.check(jr.run_unprotected())) == 0


def test_mm_golden_xor_equal():
    assert mm.make_region().meta["golden_xor"] == \
        jmm.make_region().meta["golden_xor"]


def test_lcg_and_splitmix_streams_equal():
    for seed, n, bits in ((42, 5000, 7), (43, 81, 15), (1, 9000, 8)):
        np.testing.assert_array_equal(common.lcg_words(seed, n, bits),
                                      jcommon.lcg_words(seed, n, bits))
    for seed in (0, 3, 2**63 + 5):
        np.testing.assert_array_equal(splitmix_fill(seed, 777),
                                      jsplitmix_fill(seed, 777))


def test_registry_names_match_reference():
    from coast_tpu.models import REGISTRY as JREGISTRY
    assert set(REGISTRY) <= set(JREGISTRY)
    assert set(REGISTRY) == {"matrixMultiply", "matrixMultiply256",
                             "matrixMultiply1024", "matrixMultiply1024b512",
                             "crc16"}
    assert REGISTRY["matrixMultiply"]().name == "matrixMultiply"
    assert REGISTRY["crc16"]().name == "crc16"


@pytest.mark.parametrize("i", [-20, -9, -3, -1, 0, 4, 8, 9, 17, 2**31 - 1,
                               -2**31])
def test_row_select_update_clamp_like_reference(i):
    mat = np.arange(9 * 4, dtype=np.int32).reshape(9, 4)
    row = np.full(4, -7, np.int32)
    ref_sel = np.asarray(jindexing.row_select(jnp.asarray(mat), jnp.int32(i),
                                              mode="slice"))
    ref_upd = np.asarray(jindexing.row_update(jnp.asarray(mat),
                                              jnp.asarray(row), jnp.int32(i),
                                              mode="slice"))
    tmat = torch.from_numpy(mat)[None]
    ti = torch.tensor([i], dtype=torch.int32)
    np.testing.assert_array_equal(indexing.row_select(tmat, ti)[0].numpy(),
                                  ref_sel)
    np.testing.assert_array_equal(
        indexing.row_update(tmat, torch.from_numpy(row)[None], ti)[0].numpy(),
        ref_upd)


def test_interop_round_trip_keeps_words():
    region = mm.make_region()
    arrays = {"results": np.array([[0, 2**32 - 1]], np.uint32),
              "first": np.array([[-5, 7]], np.int32),
              "golden": np.array([[1, 2**31]], np.uint32)}
    state = state_from_numpy(arrays, "cpu")
    assert all(t.dtype == torch.int32 for t in state.values())
    back = state_to_numpy(state, region)
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)
    with pytest.raises(TypeError):
        state_from_numpy({"x": np.zeros(2, np.int64)}, "cpu")
    fault = fault_from_numpy({"t": [1, -1]}, "cpu")
    assert fault["t"].dtype == torch.int32


def test_scope_lists_verified_like_reference():
    from coast_tpu.passes.verification import SoRViolation as JSoRViolation
    jr, tr = jmm.make_region(), mm.make_region()
    for kw in ({"ignore_globals": ("nope",)},
               {"ignore_globals": ("i",)},
               {"xmr_globals": ("golden",)},
               {"ignore_globals": ("acc",), "xmr_globals": ("acc",)},
               {"ignore_globals": ("acc",)}):
        with pytest.raises(JSoRViolation):
            coast_tpu.TMR(jr, **kw)
        with pytest.raises(SoRViolation):
            ct.TMR(tr, device="cpu", **kw)
    # Protected -> NotProtected is fine, with a forced vote.
    jp = coast_tpu.TMR(jr, ignore_globals=("results",))
    tp = ct.TMR(tr, device="cpu", ignore_globals=("results",))
    assert tp.forced_sync == jp.forced_sync == frozenset({"results"})


def test_unported_features_refuse_with_roadmap_item():
    with pytest.raises(NotImplementedError, match="item 15"):
        ct.LeafSpec(kind="stack")
    assert ct.ProtectionConfig(fuse_step=True).fuse_step    # item 11 landed
    with pytest.raises(NotImplementedError, match="item 13"):
        ct.ProtectionConfig(protect_stack=True)
    with pytest.raises(NotImplementedError, match="item 13"):
        ct.ProtectionConfig(cfcss=True)
    with pytest.raises(NotImplementedError):
        ct.ProtectionConfig(pallas_voters=True)
    region = mm.make_region()
    with pytest.raises(NotImplementedError, match="item 13"):
        ct.TMR(region, device="cpu", segmented=True)
    with pytest.raises(NotImplementedError, match="item 14"):
        ct.Region(**{**{k: getattr(region, k) for k in (
            "name", "init", "step", "done", "check", "output",
            "nominal_steps", "max_steps", "spec")},
            "train_probe": lambda s: s})
    with pytest.raises(NotImplementedError, match="DWC"):
        ct.EDDI(region, device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        ct.TMR(region, device="cpu").run({"leaf_id": [0, 1], "lane": [0, 0],
                                          "word": [0, 0], "bit": [0, 0],
                                          "t": [1, 2]})
    with pytest.raises(NotImplementedError, match="item 10"):
        generate(MemoryMap(ct.TMR(region, device="cpu")), 4, 0, 18,
                 model="burst")
