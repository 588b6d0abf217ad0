"""The halt-freeze select left out of a step that no row halts in
(``passes/dataflow_protection.py``: ``NoneHalted``, ``ProtectedProgram.
step``, ``run_batch``'s halt count; ``CampaignResult.transfer``'s
``freeze_run`` / ``freeze_skipped``).

``run_batch``'s records and final views equal, bit for bit, those of the
same program whose step always makes the select (its flags handed on as a
plain dict): TMR unfused and fused, a small bf16 mm256, DWC and CFCSS
(which keep every select), under single-bit and multibit schedules, a
control leaf flipped in one lane (DWC aborts the row at that step) and
flip groups that corrupt it in two lanes of a row, so that rows halt at
different steps.  A halt-free step commits every written
leaf contiguous and of its own: no leaf shares storage with another or
with the old state, and a flip of one lane changes that lane only.  A
region whose step returns an input leaf, or one tensor under two names,
or a part of a larger tensor, keeps the select there.
"""

import numpy as np
import pytest
import torch

import coast_tpu_torch as ct
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.inject.mem import MemoryMap
from coast_tpu_torch.inject.schedule import FaultModel, generate
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_REG, LeafSpec,
                                       Region)
from coast_tpu_torch.models import crc16, mm, mm256
from coast_tpu_torch.ops import bitflip
from coast_tpu_torch.passes.dataflow_protection import NoneHalted

torch.set_num_threads(1)

PROGRAMS = {
    "mm-TMR": lambda: ct.TMR(mm.make_region(), device="cpu"),
    "mm-TMR-fused": lambda: ct.TMR(mm.make_region(), device="cpu",
                                   fuse_step=True),
    "mm256_64_bf16-TMR": lambda: ct.TMR(
        mm256.make_region(side=64, block=16, bf16_matmul=True),
        device="cpu"),
    "crc16-DWC": lambda: ct.DWC(crc16.make_region(), device="cpu"),
    "mm-TMR-CFCSS": lambda: ct.TMR(mm.make_region(), device="cpu",
                                   cfcss=True),
}
# Programs whose step can halt a row inside it: every select stays.
KEEPS_SELECT = {"crc16-DWC", "mm-TMR-CFCSS"}
SCHEDULES = ("single", "multibit", "ctrl_lane1", "ctrl_two_lanes")
ROWS = 48


def always_select(prog):
    """``prog`` with its step handed plain-dict flags: the select runs on
    every written leaf, as before the halt count."""
    step = prog.step
    prog.step = lambda pstate, flags, t: step(pstate, dict(flags), t)
    return prog


def columns(prog, kind, seed=5):
    """Fault columns of ``ROWS`` rows.  ``ctrl_lane1``: one bit of the
    first control leaf in lane 1 (DWC aborts the row at that step).
    ``ctrl_two_lanes``: flip groups of two sites, the same bit of it in
    lanes 0 and 1 at the same step, so a vote takes the corrupted value
    and rows halt at different steps (early, late or at the watchdog)."""
    steps = prog.region.nominal_steps
    if kind.startswith("ctrl_"):
        ctrl = next(k for k in prog.leaf_order if k in prog.region.spec
                    and prog.region.spec[k].kind == KIND_CTRL)
        rows = np.arange(ROWS)
        col = {"leaf_id": np.full(ROWS, prog.leaf_order.index(ctrl)),
               "lane": np.ones(ROWS), "word": np.zeros(ROWS),
               "bit": np.array([0, 1, 2, 3, 4, 30, 31, 1])[rows % 8],
               "t": (rows // 8) % steps}
        if kind == "ctrl_two_lanes":
            col = {k: np.stack([v, v], axis=1) for k, v in col.items()}
            col["lane"][:, 0] = 0
        return {k: v.astype(np.int32) for k, v in col.items()}
    model = FaultModel.parse("multibit(k=3)") if kind == "multibit" else None
    return generate(MemoryMap(prog), ROWS, seed, steps,
                    model=model).device_arrays()


def bits(x):
    return x.contiguous().reshape(-1).view(torch.uint8)


def assert_bit_identical(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        if key == "final_state":
            assert_bit_identical(dict(got[key]), dict(value))
            continue
        assert got[key].dtype == value.dtype and \
            got[key].shape == value.shape, key
        assert torch.equal(bits(got[key]), bits(value)), key


@pytest.mark.parametrize("kind", SCHEDULES)
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_records_and_final_views_equal_the_select_loop(name, kind):
    prog, ref = PROGRAMS[name](), always_select(PROGRAMS[name]())
    cols = columns(prog, kind)
    got = prog.run_batch(cols, return_state=True)
    want = ref.run_batch(cols, return_state=True)
    assert_bit_identical(got, want)
    assert ref.freeze_skipped == 0
    assert prog.freeze_run + prog.freeze_skipped == ref.freeze_run
    if name in KEEPS_SELECT:
        assert prog.freeze_skipped == 0
    else:
        assert prog.freeze_skipped > 0
    if kind == "ctrl_two_lanes" and name not in KEEPS_SELECT:
        # Rows halt at different steps: the select is back after the
        # first halt and runs until the last.
        assert len(set(got["steps"].tolist())) > 1
        assert prog.freeze_run > 0


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_traced_run_equals_the_select_loop(name):
    """``trace=True`` runs every trip with no halt read: only the first
    step is known halt-free."""
    prog, ref = PROGRAMS[name](), always_select(PROGRAMS[name]())
    cols = columns(prog, "ctrl_two_lanes")
    got = prog.run_batch(cols, trace=True, return_state=True)
    want = ref.run_batch(cols, trace=True, return_state=True)
    assert_bit_identical(got, want)
    first = 0 if name in KEEPS_SELECT else prog.freeze_skipped
    assert prog.freeze_skipped == first
    assert prog.freeze_run == ref.freeze_run - first
    assert first < prog.freeze_run


# -- the contract a skipped select keeps ---------------------------------------

CONTRACT = ("mm-TMR", "mm-TMR-fused", "mm256_64_bf16-TMR")


def written(pstate, new_state):
    return [k for k, v in new_state.items() if v is not pstate[k]]


def storages(tensors):
    return [x.untyped_storage().data_ptr() for x in tensors]


@pytest.mark.parametrize("name", CONTRACT)
def test_halt_free_step_commits_leaves_of_their_own(name):
    prog = PROGRAMS[name]()
    pstate, flags = prog.init_pstate(4)
    new_state, _ = prog.step(pstate, NoneHalted(flags), 0)
    names = written(pstate, new_state)
    assert names and prog.freeze_skipped == len(names)
    assert prog.freeze_run == 0
    new = storages(new_state[k] for k in names)
    assert len(set(new)) == len(new)
    assert not set(new) & set(storages(pstate.values()))
    assert all(new_state[k].is_contiguous() for k in names)


@pytest.mark.parametrize("name", CONTRACT)
def test_flip_after_a_halt_free_step_changes_one_lane(name):
    prog = PROGRAMS[name]()
    pstate, flags = prog.init_pstate(4)
    new_state, _ = prog.step(pstate, NoneHalted(flags), 0)
    before_old = {k: v.clone() for k, v in pstate.items()}
    before_new = {k: v.clone() for k, v in new_state.items()}
    leaf = written(pstate, new_state)[0]
    fault = {"leaf_id": np.full(4, prog.leaf_order.index(leaf), np.int32),
             "lane": np.full(4, 1, np.int32), "word": np.zeros(4, np.int32),
             "bit": np.full(4, 3, np.int32)}
    site = bitflip.build_site(
        prog.leaf_order, {k: prog.lane_words(k) for k in prog.leaf_order},
        {k: prog.lanes_of(k) for k in prog.leaf_order}, fault, "cpu",
        [prog.leaf_order.index(leaf)])
    bitflip.apply_site(new_state, site,
                       torch.tensor([False, True, False, False]))
    for k, v in pstate.items():
        assert torch.equal(bits(v), bits(before_old[k])), k
    for k, v in new_state.items():
        diff = bits(v) != bits(before_new[k])
        if k != leaf:
            assert not diff.any(), k
            continue
        changed = (v.view(torch.int32) != before_new[k].view(torch.int32))
        where = changed.nonzero().tolist()
        assert where == [[1, 1] + [0] * (v.dim() - 2)], (k, where)


def aliasing_region():
    """A step that returns the input leaf ``x`` unchanged, one fresh
    tensor as both ``y`` and ``z``, and ``v`` as the first half of a
    fresh tensor twice its size; ``i`` counts the steps."""
    def init(device):
        return {k: torch.zeros(4, dtype=torch.int32, device=device)
                for k in ("x", "y", "z", "v")} | {
            "i": torch.tensor(0, dtype=torch.int32, device=device)}

    def step(s, t):
        w = s["y"] + s["x"] + 1
        return {"x": s["x"], "y": w, "z": w,
                "v": torch.stack([s["v"] + 1, s["v"] + 2])[0],
                "i": s["i"] + 1}

    return Region(
        name="aliasing", init=init, step=step,
        done=lambda s: s["i"] >= 3,
        check=lambda s: torch.zeros_like(s["i"]),
        output=lambda s: s["z"],
        nominal_steps=3, max_steps=6,
        spec={"x": LeafSpec(KIND_REG), "y": LeafSpec(KIND_REG),
              "z": LeafSpec(KIND_REG), "v": LeafSpec(KIND_REG),
              "i": LeafSpec(KIND_CTRL)})


def test_a_leaf_not_of_its_own_keeps_the_select():
    prog = ct.TMR(aliasing_region(), device="cpu")
    pstate, flags = prog.init_pstate(2)
    new_state, _ = prog.step(pstate, NoneHalted(flags), 0)
    # x views the old state, y and z are one tensor and v shares its
    # storage with bytes of no leaf: four selects; i is the vote's fresh
    # repair.
    assert (prog.freeze_run, prog.freeze_skipped) == (4, 1)
    new = storages(new_state[k] for k in ("x", "y", "z", "v", "i"))
    assert len(set(new)) == 5
    assert all(new_state[k].untyped_storage().nbytes() == new_state[k].nbytes
               for k in new_state)
    assert not set(new) & set(storages(pstate.values()))
    ref = always_select(ct.TMR(aliasing_region(), device="cpu"))
    assert_bit_identical(prog.run_batch(batch=3, return_state=True),
                         ref.run_batch(batch=3, return_state=True))


# -- the counters in a campaign -------------------------------------------------

def test_fault_free_fused_mm9_batch_skips_every_freeze():
    """A fault-free 64-row batch of the fused mm9 program: 18 trips, each
    with its four leaf freezes left out, and one halt read a trip."""
    prog = ct.TMR(mm.make_region(), device="cpu", fuse_step=True)
    trips = [0]
    step = prog.step

    def counting(*args):
        trips[0] += 1
        return step(*args)

    prog.step = counting
    rec = prog.run_batch(batch=64)
    assert bool(rec["done"].all()) and trips[0] == 18
    assert len(prog._fuse_plan.frozen_leaves) == 4
    assert (prog.freeze_run, prog.freeze_skipped) == (0, 4 * 18)
    assert prog.host_reads == 18


@pytest.mark.parametrize("collect", ["dense", "sparse"])
def test_campaign_transfer_counts_the_freezes(collect):
    """A 64-row fused mm9 campaign: ``freeze_skipped`` = 4 leaves x 18
    trips, ``freeze_run`` 0, and the reads the fire-plan copy, one halt
    read a trip and the collect's copies."""
    prog = ct.TMR(mm.make_region(), device="cpu", fuse_step=True)
    runner = CampaignRunner(prog, collect=collect)
    res = runner.run(64, seed=3, batch_size=64)
    assert res.transfer["freeze_skipped"] == 4 * 18
    assert res.transfer["freeze_run"] == 0
    collect_reads = 1 if collect == "dense" else 2
    assert res.transfer["reads"] == 1 + 18 + collect_reads


def test_dwc_campaign_skips_no_freeze():
    prog = ct.DWC(crc16.make_region(), device="cpu")
    res = CampaignRunner(prog).run(64, seed=3, batch_size=64)
    assert res.transfer["freeze_skipped"] == 0
    assert res.transfer["freeze_run"] > 0


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host; K2 runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k2_repaired_sets_are_allocations_of_their_own(cuda):
    """K2's repaired replica sets, which the fused engine commits as
    state, each fill a storage of their own."""
    from coast_tpu_torch.ops import fused_step
    sites = [(torch.arange(4 * 3 * w, dtype=torch.int32, device=cuda
                           ).view(4, 3, w), None) for w in (81, 1, 9)]
    repaired, _, _ = fused_step.commit_sites(sites, 3)
    assert len(set(storages(repaired))) == len(repaired)
    for rep, (lanes, _) in zip(repaired, sites):
        assert rep.untyped_storage().nbytes() == rep.nbytes
        assert rep.shape == lanes.shape and rep.is_contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mm-TMR", "mm-TMR-fused"])
def test_card_runs_skip_every_freeze_and_equal_the_select_loop(cuda, name):
    kw = {"fuse_step": name == "mm-TMR-fused"}
    prog = ct.TMR(mm.make_region(), device=cuda, **kw)
    ref = always_select(ct.TMR(mm.make_region(), device=cuda, **kw))
    prog.run_batch(batch=64)
    assert (prog.freeze_run, prog.freeze_skipped) == (0, 4 * 18)
    cols = columns(prog, "ctrl_two_lanes")
    assert_bit_identical(prog.run_batch(cols, return_state=True),
                         ref.run_batch(cols, return_state=True))
