"""Per-record parity of the PyTorch port's engine against the JAX engine.

For every row of a seeded 64-row schedule, the port's ``prog.run(fault)``
must give the reference ``prog.run(fault)``'s errors, corrected, steps,
sync_count, done and dwc_fault, on mm, crc16 and the mm256 family.  Exact on every row, except on the
mm256 family the rows a float32 summation order may decide (a mantissa
flip of first/second/acc; ``mm256.order_sensitive``), which are listed and
left out of the comparison.
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
from coast_tpu.models import crc16 as jcrc16
from coast_tpu.models import mm as jmm
from coast_tpu.models import mm256 as jmm256
from coast_tpu_torch.models import crc16, mm, mm256
from coast_tpu_torch.ops import bitflip

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
KEYS = ("errors", "corrected", "steps", "sync_count", "done", "dwc_fault")
CASES = ([(r, s, {}) for r in sorted(REGIONS) for s in sorted(STRATEGIES)]
         + [("mm", "TMR", {"count_syncs": True}),
            ("mm", "DWC", {"count_syncs": True}),
            ("mm", "TMR", {"no_load_sync": True}),
            ("mm", "TMR", {"no_store_data_sync": True}),
            ("mm256_64", "TMR", {"count_syncs": True})])


def case_id(case):
    region, strategy, cfg = case
    return "-".join([region, strategy, *sorted(cfg)])


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_per_record_parity(case):
    region, strategy, cfg = case
    jr, tr = (f() for f in REGIONS[region])
    js, ts = STRATEGIES[strategy]
    jprog, tprog = js(jr, **cfg), ts(tr, device="cpu", **cfg)
    sched = jgenerate(JMemoryMap(jprog), 64, 11, jr.nominal_steps)
    cols = sched.device_arrays()
    ref = jax.jit(jax.vmap(jprog.run))(
        {k: jnp.asarray(v) for k, v in cols.items()})
    ref = {k: np.asarray(ref[k]) for k in KEYS}
    port = {k: [] for k in KEYS}
    for r in range(len(sched)):
        rec = tprog.run({k: v[r] for k, v in cols.items()})
        for k in KEYS:
            port[k].append(rec[k].item())
    exempt = np.zeros(len(sched), bool)
    if region.startswith("mm256"):
        exempt = mm256.order_sensitive(tprog.leaf_order, sched.leaf_id,
                                       sched.bit)
    for k in KEYS:
        got = np.asarray(port[k], ref[k].dtype)
        np.testing.assert_array_equal(got[~exempt], ref[k][~exempt],
                                      err_msg=f"{k} (exempt rows "
                                              f"{np.nonzero(exempt)[0]})")
    assert (~exempt).sum() >= 16          # the comparison is not vacuous


@pytest.mark.parametrize("strategy", ["DWC", "TMR"])
def test_store_slice_starts_follow_dynamic_slice(strategy):
    # Hint starts below 0 and past the end: the reference's dynamic_slice
    # wraps a negative start once, then clamps; the port must vote the
    # same window on every row.  These windows also vote rows not yet
    # written (zeros), where a mantissa flip makes a subnormal: both the
    # reference's voter and the port's read it as zero.  Only the rows of
    # mm256.order_sensitive (the step's own float ops) are left out.
    import dataclasses

    def shifted(hint, by):
        def h(view, t):
            (r0, c0), sizes, active = hint(view, t)
            return (r0 + by, c0), sizes, active
        return h

    jr = jmm256.make_region(side=64, block=16)
    tr = mm256.make_region(side=64, block=16)
    js, ts = STRATEGIES[strategy]
    for by in (-100, -20, 40):
        jreg = dataclasses.replace(jr, meta={**jr.meta, "store_slice": {
            "results": shifted(jr.meta["store_slice"]["results"], by)}})
        treg = dataclasses.replace(tr, meta={**tr.meta, "store_slice": {
            "results": shifted(tr.meta["store_slice"]["results"], by)}})
        jprog, tprog = js(jreg), ts(treg, device="cpu")
        sched = jgenerate(JMemoryMap(jprog), 96, 5, jr.nominal_steps)
        cols = sched.device_arrays()
        ref = jax.jit(jax.vmap(jprog.run))(
            {k: jnp.asarray(v) for k, v in cols.items()})
        got = tprog.run_batch(cols)
        exempt = mm256.order_sensitive(tprog.leaf_order, sched.leaf_id,
                                       sched.bit)
        assert (~exempt).sum() >= 24
        for k in KEYS:
            np.testing.assert_array_equal(
                got[k].numpy()[~exempt], np.asarray(ref[k])[~exempt],
                err_msg=f"{k} shift {by}")


@pytest.mark.parametrize("strategy", ["DWC", "TMR"])
def test_fault_free_record_clean(strategy):
    prog = STRATEGIES[strategy][1](mm.make_region(), device="cpu")
    rec = prog.run(bitflip.noop_fault())
    assert rec["errors"].item() == 0 and rec["done"].item()
    assert rec["steps"].item() == 18 and rec["corrected"].item() == 0
    assert set(rec) == {"errors", "corrected", "steps", "sync_count", "done",
                        "dwc_fault", "cfc_fault", "stack_fault",
                        "assert_fault", "output"}
    assert rec["output"].shape == (81,)


def test_flip_bit_31_is_int32_min_and_out_of_range_flips_nothing():
    assert bitflip.bit_word(np.array([0, 5, 31, 32, -1])).tolist() == [
        1, 32, -2**31, 0, 0]
    state = {"x": torch.zeros((2, 3, 4), dtype=torch.float32)}
    site = bitflip.build_site(["x"], {"x": 4}, {"x": 3},
                              {"leaf_id": np.array([0, 0]),
                               "lane": np.array([2, 3]),
                               "word": np.array([1, 1]),
                               "bit": np.array([31, 0])}, "cpu", [0])
    bitflip.apply_site(state, site, torch.tensor([True, True]))
    flipped = state["x"].view(torch.int32)
    assert flipped[0, 2, 1].item() == -2**31          # -0.0's bits
    assert int((flipped != 0).sum()) == 1            # row 1: lane 3 of 3
    before = flipped.clone()
    bitflip.apply_site(state, site, torch.tensor([False, False]))
    assert torch.equal(state["x"].view(torch.int32), before)


def test_tmr_repair_is_materialised_per_lane():
    # One flip must hit one lane of one row, even after a TMR repair has
    # written the voted value back into every lane.
    prog = ct.TMR(mm.make_region(), device="cpu")
    pstate, flags = prog.init_pstate(2)
    pstate, flags = prog.step(pstate, flags, 0)
    site = bitflip.build_site(prog.leaf_order, {"i": 1}, {"i": 3},
                              {"leaf_id": np.array([5, 5]),
                               "lane": np.array([1, 1]),
                               "word": np.array([0, 0]),
                               "bit": np.array([3, 3])}, "cpu", [5])
    bitflip.apply_site(pstate, site, torch.tensor([True, False]))
    assert pstate["i"].tolist() == [[0, 8, 0], [0, 0, 0]]


def test_dwc_boundary_view_is_lane_zero_and_a_flip_stays_in_its_row():
    """The DWC boundary compares flags only and reads lane 0 of the final
    state in place (no copy is written).  The view aliases ``pstate``, so
    a flip after it shows in its own row's lane 0 and nowhere else."""
    prog = ct.DWC(mm.make_region(), device="cpu")
    pstate, _ = prog.init_pstate(4)
    before = {k: v.clone() for k, v in pstate.items()}
    view, mis = prog.boundary_votes(pstate)
    assert mis.tolist() == [0, 0, 0, 0]
    for name, arr in pstate.items():
        if prog.replicated[name]:
            assert view[name].data_ptr() == arr[:, 0].data_ptr()
    before_view = {k: v.clone() for k, v in view.items()}
    pstate["results"][2, 0, 4, 5] ^= 1 << 7            # row 2, lane 0
    for name, arr in pstate.items():
        changed = (arr != before[name]).nonzero().tolist()
        assert changed == ([[2, 0, 4, 5]] if name == "results" else [])
    diff = (view["results"] != before_view["results"]).nonzero().tolist()
    assert diff == [[2, 4, 5]]
    # A flip in lane 1 reaches no view, and the next compare sees it.
    pstate["i"][1, 1] ^= 1
    assert torch.equal(view["i"], before_view["i"])
    assert prog.boundary_votes(pstate)[1].tolist() == [0, 1, 1, 0]


def test_grouped_calls_launch_at_most_16_sites_in_order():
    """A sync point with more sites than a launch takes is split into
    launches of at most ``MAX_SITES``, outputs and flag rows in order."""
    from coast_tpu_torch.ops import site_table
    from coast_tpu_torch.passes.dataflow_protection import _grouped
    launches = []

    def fake(sites, n):
        assert len(sites) <= site_table.MAX_SITES and n == 3
        launches.append(len(sites))
        return (list(sites), [-x for x in sites],
                torch.tensor([[x] for x in sites], dtype=torch.int32))

    first, second, flags = _grouped(fake, list(range(37)), 3)
    assert launches == [16, 16, 5]
    assert first == list(range(37)) and second == [-x for x in range(37)]
    assert flags[:, 0].tolist() == list(range(37))
    assert _grouped(fake, [1, 2], 3)[2].shape == (2, 1)
