"""The PyTorch port's fused engine (``fuse_step=True``) and crc16 against the
JAX reference.

  * the ``FusePlan`` fields equal the reference's ``build_plan`` for mm,
    crc16 and mm256(64); the float region keeps the unfused program;
  * dense campaigns of the port's fused engine give the JAX fused engine's
    codes, counts, errors, corrected and steps, and the port's unfused
    engine's, on {mm, crc16} x {TMR, DWC} and unprotected mm, and on the
    bounded loop (mm with ``max_steps = nominal_steps``);
  * the plain ``vote_flip_commit`` equals the reference's Pallas commit
    kernel (interpret mode) bit for bit, with masks, +-0, NaN and
    subnormals; K2 is held to the plain version on the card by the tests
    marked ``cuda``, which skip without one.  On the card's machine, which
    has no JAX, they run alone:

        python -m pytest tests/test_torch_fused.py -m cuda --noconftest -q

  * crc16: golden, fault-free records, and campaigns with bit-31 flips of
    ``crc`` and ``i`` forced into the schedule.
"""

import dataclasses

import numpy as np
import pytest
import torch

import coast_tpu_torch as ct
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.inject.schedule import FaultSchedule
from coast_tpu_torch.models import crc16, mm, mm256
from coast_tpu_torch.ops import (bitflip, fused_step, hopper_commit,
                                 hopper_voters)

# The suite runs under xdist, several workers to a host: one intra-op
# thread per worker keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

COLUMNS = ("codes", "errors", "corrected", "steps")
PORT = {"TMR": ct.TMR, "DWC": ct.DWC, "unprotected": ct.unprotected}


def jax_regions():
    from coast_tpu.models import crc16 as jcrc16
    from coast_tpu.models import mm as jmm
    from coast_tpu.models import mm256 as jmm256
    return {"mm": (jmm.make_region, mm.make_region),
            "crc16": (jcrc16.make_region, crc16.make_region),
            "mm256_64": (lambda: jmm256.make_region(side=64, block=16),
                         lambda: mm256.make_region(side=64, block=16))}


def jax_strategy(name):
    import coast_tpu
    return {"TMR": coast_tpu.TMR, "DWC": coast_tpu.DWC,
            "unprotected": coast_tpu.unprotected}[name]


def assert_same_records(a, b, what):
    assert a.counts == b.counts, what
    for col in COLUMNS:
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col),
                                      err_msg=f"{what}: {col}")


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["TMR", "DWC"])
@pytest.mark.parametrize("region", ["mm", "crc16", "mm256_64"])
def test_plan_fields_equal_reference(region, strategy):
    jr, tr = (f() for f in jax_regions()[region])
    ref = jax_strategy(strategy)(jr, fuse_step=True).fuse_plan_info
    prog = PORT[strategy](tr, device="cpu", fuse_step=True)
    plan = prog.fuse_plan_info
    for field in ("done_leaves", "frozen_leaves", "bounded_scan",
                  "exact_dataflow"):
        assert getattr(plan, field) == getattr(ref, field), field
    assert plan.sparse_flip
    assert (prog._fuse_plan is plan) == ref.exact_dataflow


def test_float_region_keeps_the_unfused_program():
    prog = ct.TMR(mm256.make_region(side=64, block=16), device="cpu",
                  fuse_step=True)
    assert prog.cfg.fuse_step
    assert prog._fuse_plan is None
    assert not prog.fuse_plan_info.exact_dataflow
    _, flags = prog.init_pstate(2)
    assert "latch" not in flags


def test_done_cone_falls_back_to_every_leaf():
    region = mm.make_region()
    assert fused_step.done_cone(region) == frozenset({"i"})

    def broken(state):
        raise RuntimeError("not traceable")

    assert fused_step.done_cone(dataclasses.replace(region, done=broken)) \
        == frozenset(region.spec)

    def walks(state):
        return torch.stack([v.reshape(v.shape[0], -1)[:, 0] for v in
                            state.values()]).sum(dim=0) < 0

    assert fused_step.done_cone(dataclasses.replace(region, done=walks)) \
        == frozenset(region.spec)


# ---------------------------------------------------------------------------
# campaign parity: port fused == JAX fused == port unfused
# ---------------------------------------------------------------------------

CAMPAIGNS = [("mm", "TMR"), ("mm", "DWC"), ("crc16", "TMR"),
             ("crc16", "DWC"), ("mm", "unprotected")]


@pytest.mark.parametrize("region,strategy", CAMPAIGNS)
def test_dense_campaign_parity(region, strategy):
    from coast_tpu.inject.campaign import CampaignRunner as JCampaignRunner
    jr, tr = (f() for f in jax_regions()[region])
    n = 128
    ref = JCampaignRunner(jax_strategy(strategy)(jr, fuse_step=True),
                          strategy_name=strategy).run(n, seed=11,
                                                      batch_size=n)
    fused = PORT[strategy](tr, device="cpu", fuse_step=True)
    assert fused._fuse_plan is not None
    got = CampaignRunner(fused, strategy_name=strategy).run(
        n, seed=11, batch_size=64)
    assert_same_records(got, ref, "port fused vs JAX fused")
    base = CampaignRunner(fused.unfused_twin(), strategy_name=strategy).run(
        n, seed=11, batch_size=64)
    assert_same_records(got, base, "port fused vs port unfused")
    # The campaign is not vacuous: faults landed and were told apart.
    assert len({k for k, v in ref.counts.items() if v}) >= 2


@pytest.mark.parametrize("strategy", ["TMR", "DWC"])
def test_bounded_scan_parity(strategy):
    """No registry region has max_steps == nominal_steps, so the bounded
    loop runs on mm with the bound tightened to the nominal trip count."""
    from coast_tpu.inject.campaign import CampaignRunner as JCampaignRunner
    jr, tr = jax_regions()["mm"][0](), mm.make_region()
    jr = dataclasses.replace(jr, max_steps=jr.nominal_steps)
    tr = dataclasses.replace(tr, max_steps=tr.nominal_steps)
    fused = PORT[strategy](tr, device="cpu", fuse_step=True)
    assert fused._fuse_plan.bounded_scan
    ref = JCampaignRunner(jax_strategy(strategy)(jr, fuse_step=True),
                          strategy_name=strategy).run(48, seed=13,
                                                      batch_size=48)
    got = CampaignRunner(fused).run(48, seed=13, batch_size=48)
    assert_same_records(got, ref, "bounded port fused vs JAX fused")
    base = CampaignRunner(fused.unfused_twin()).run(48, seed=13,
                                                    batch_size=48)
    assert_same_records(got, base, "bounded port fused vs port unfused")


def count_calls(monkeypatch, module, name):
    """Record the site shapes of every call of ``module.name``."""
    calls = []
    real = getattr(module, name)

    def counting(sites, num_clones):
        calls.append([tuple((s[0] if isinstance(s, tuple) else s.lanes).shape)
                      for s in sites])
        return real(sites, num_clones)

    monkeypatch.setattr(module, name, counting)
    return calls


def count_trips(prog):
    """Count the engine's step() calls (loop trips) on ``prog``."""
    trips = [0]
    step = prog.step

    def counting(*args):
        trips[0] += 1
        return step(*args)

    prog.step = counting
    return trips


def test_fused_tmr_commits_through_vote_flip_commit(monkeypatch):
    """mm TMR has four vote sites a repair follows (pre-step ``i``; commit
    ``results``, ``i``, ``phase``): two grouped fused commits a step, one
    per sync point, and no K1 vote in the step."""
    calls = count_calls(monkeypatch, fused_step, "commit_sites")
    votes = count_calls(monkeypatch, hopper_voters, "vote_sites")
    prog = ct.TMR(mm.make_region(), device="cpu", fuse_step=True)
    pstate, flags = prog.init_pstate(4)
    prog.step(pstate, flags, 0)
    assert calls == [[(4, 3)], [(4, 3, 9, 9), (4, 3), (4, 3)]]
    assert votes == []
    calls.clear()
    trips = count_trips(prog)
    prog.run_batch(batch=4)
    assert len(calls) == 2 * trips[0] and trips[0] == 18
    assert votes == [[(4, 3, 9, 9)] * 3 + [(4, 3, 9), (4, 3), (4, 3)]]
    calls.clear()
    ct.DWC(mm.make_region(), device="cpu", fuse_step=True).run(
        bitflip.noop_fault())
    assert calls == []                 # DWC has no repair to fuse


@pytest.mark.parametrize("region,per_step,n_sites",
                         [("mm", 3, 6), ("crc16", 2, 3)])
def test_unfused_tmr_votes_once_per_sync_point(monkeypatch, region, per_step,
                                               n_sites):
    """The unfused mm step makes three grouped K1 votes (pre-step, commit,
    the ``done()`` view's vote of ``i``; crc16 has no commit vote) and the
    boundary one, over every replicated leaf."""
    calls = count_calls(monkeypatch, hopper_voters, "vote_sites")
    commits = count_calls(monkeypatch, fused_step, "commit_sites")
    prog = ct.TMR(jax_regions()[region][1](), device="cpu")
    pstate, flags = prog.init_pstate(4)
    prog.step(pstate, flags, 0)
    if region == "mm":
        assert calls == [[(4, 3)], [(4, 3, 9, 9), (4, 3), (4, 3)], [(4, 3)]]
    assert len(calls) == per_step
    calls.clear()
    trips = count_trips(prog)
    prog.run_batch(batch=4)
    assert len(calls) == per_step * trips[0] + 1 and trips[0] > 1
    assert len(calls[-1]) == n_sites
    assert commits == []


# ---------------------------------------------------------------------------
# latch, flags, twin
# ---------------------------------------------------------------------------

def test_latch_round_trip():
    latch = torch.zeros(3, dtype=torch.int32)
    latch = fused_step.latch_or(latch, fused_step.LATCH_DONE,
                                torch.tensor([True, False, True]))
    latch = fused_step.latch_or(latch, fused_step.LATCH_ASSERT,
                                torch.tensor([False, False, True]))
    assert latch.tolist() == [1, 0, 1 | 1 << 4]
    flags = {"latch": latch, "tmr_cnt": torch.tensor([1, 2, 3]),
             "sync_cnt": torch.zeros(3), "steps": torch.ones(3)}
    out = fused_step.unpack_latch(flags)
    assert out["done"].tolist() == [True, False, True]
    assert out["assert_fault"].tolist() == [False, False, True]
    assert not out["dwc_fault"].any() and not out["cfc_fault"].any()
    assert out["tmr_cnt"] is flags["tmr_cnt"]
    assert fused_step.LATCH_DONE_ONLY == 1 << fused_step.LATCH_DONE
    # The reference's bit assignment, word for word.
    from coast_tpu.ops import fused_step as jfused
    for name in ("LATCH_DONE", "LATCH_DWC", "LATCH_CFC", "LATCH_STACK",
                 "LATCH_ASSERT", "LATCH_DONE_ONLY"):
        assert getattr(fused_step, name) == getattr(jfused, name), name


def test_fused_flags_are_one_packed_word():
    prog = ct.TMR(mm.make_region(), device="cpu", fuse_step=True)
    _, flags = prog.init_pstate(5)
    assert set(flags) == {"latch", "tmr_cnt", "sync_cnt", "steps"}
    assert flags["latch"].dtype == torch.int32
    assert flags["latch"].shape == (5,)
    rec = prog.run(bitflip.noop_fault())
    assert rec["done"].item() and rec["errors"].item() == 0
    assert rec["steps"].item() == 18
    assert set(rec) == set(ct.TMR(mm.make_region(), device="cpu").run(
        bitflip.noop_fault()))


def test_unfused_twin():
    region = mm.make_region()
    fused = ct.TMR(region, device="cpu", fuse_step=True)
    twin = fused.unfused_twin()
    assert not twin.cfg.fuse_step and twin._fuse_plan is None
    assert twin.cfg == dataclasses.replace(fused.cfg, fuse_step=False)
    assert twin.device == fused.device
    plain = ct.TMR(region, device="cpu")
    assert plain.unfused_twin() is plain


# ---------------------------------------------------------------------------
# the fused commit: plain version vs the reference's kernel, K2 vs plain
# ---------------------------------------------------------------------------

def commit_case(seed, rows, n, shape, dtype):
    """Seeded ``[rows, n, *shape]`` replica sets and int32 flip masks: equal
    lanes, a one-lane flip in every odd row, several mask flips in every
    row (one cancelling a lane flip), and for float32 +0/-0 pairs, NaN and
    subnormals (against zero, and two different ones)."""
    rng = np.random.default_rng(seed)
    words = int(np.prod(shape))
    if dtype == np.float32:
        base = rng.standard_normal((rows, words)).astype(np.float32)
    else:
        base = rng.integers(-2**31, 2**31, (rows, words)).astype(np.int32)
    lanes = np.repeat(base[:, None, :], n, axis=1)
    masks = np.zeros(lanes.shape, np.uint32)
    bits = lanes.view(np.uint32)
    for r in range(rows):
        if r % 2:
            lane, w = int(rng.integers(n)), int(rng.integers(words))
            bits[r, lane, w] ^= np.uint32(1 << int(rng.integers(32)))
            if r % 4 == 3:
                masks[r, lane, w] = bits[r, lane, w] ^ bits[r, (lane + 1) % n,
                                                            w]
        for _ in range(3):
            masks[r, rng.integers(n), rng.integers(words)] ^= np.uint32(
                1 << int(rng.integers(32)))
        if dtype == np.float32:
            w = rng.integers(words, size=6)
            lanes[r, :, w[0]] = 0.0
            lanes[r, 1, w[0]] = -0.0
            lanes[r, :, w[1]] = np.nan
            bits[r, :, w[2]] = 0
            bits[r, r % n, w[2]] = 1 << int(rng.integers(23))   # vs zero
            bits[r, :, w[3]] = 0
            masks[r, (r + 1) % n, w[3]] = 1 << int(rng.integers(23))
            bits[r, :, w[4]] = 0x80000005                        # -subnormal
            bits[r, n - 1, w[4]] = 0x00000300                    # another one
            bits[r, :, w[5]] = 0
    return (lanes.reshape(rows, n, *shape),
            masks.view(np.int32).reshape(rows, n, *shape))


def as_bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.uint32)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("n", [2, 3])
def test_plain_commit_equals_reference_kernel_interpret(n, dtype):
    import jax.numpy as jnp
    from coast_tpu.ops import fused_step as jfused
    lanes, masks = commit_case(17 + n, 3, n, (256, 128), dtype)
    repaired, voted, mis = fused_step.vote_flip_commit(
        torch.from_numpy(lanes), torch.from_numpy(masks), n)
    for r in range(lanes.shape[0]):
        ref = jfused.vote_flip_commit(
            jnp.asarray(lanes[r]), jnp.asarray(masks[r].view(np.uint32)), n,
            interpret=True)
        np.testing.assert_array_equal(as_bits(repaired[r]), as_bits(ref[0]))
        np.testing.assert_array_equal(as_bits(voted[r]), as_bits(ref[1]))
        assert bool(mis[r]) == bool(ref[2]), r
    assert mis.all()                    # every row carries a flip


@pytest.mark.parametrize("n", [2, 3])
def test_plain_commit_without_masks_is_a_vote_and_repair(n):
    lanes, _ = commit_case(5, 6, n, (13,), np.float32)
    t = torch.from_numpy(lanes)
    before = hopper_commit.LAUNCHES
    repaired, voted, mis = fused_step.vote_flip_commit(t, None, n)
    assert hopper_commit.LAUNCHES == before          # no kernel on the CPU
    from coast_tpu_torch.ops import voters
    pv, pm = voters.vote(t, n)
    assert torch.equal(mis, pm)
    np.testing.assert_array_equal(as_bits(voted), as_bits(pv))
    want = pv.unsqueeze(1).expand(t.shape) if n == 3 else t
    np.testing.assert_array_equal(as_bits(repaired), as_bits(want))
    # Fresh tensors: writing the outputs leaves the input as it was.
    snapshot = t.clone()
    repaired.view(torch.int32).fill_(7)
    voted.view(torch.int32).fill_(7)
    assert torch.equal(t.view(torch.int32), snapshot.view(torch.int32))


COMMIT_SHAPES = [((), np.int32, True), ((13,), np.float32, False),
                 ((9, 9), np.int32, True), ((300,), np.float32, True)]


def commit_group(seed, n, rows=6):
    """Seeded K2 sites of mixed width and dtype, some with masks."""
    return [commit_case(seed + j, rows, n, shape or (1,), dtype)
            + (masked,) for j, (shape, dtype, masked)
            in enumerate(COMMIT_SHAPES)]


def as_sites(group, device="cpu"):
    sites = []
    for (lanes, masks, masked), (shape, _, _) in zip(group, COMMIT_SHAPES):
        lead = lanes.shape[:2]
        lanes = torch.from_numpy(lanes).reshape(lead + shape).to(device)
        masks = (torch.from_numpy(masks).reshape(lead + shape).to(device)
                 if masked else None)
        sites.append((lanes, masks))
    return sites


@pytest.mark.parametrize("n", [2, 3])
def test_plain_commit_sites_equal_reference_kernel_interpret(n):
    import jax
    import jax.numpy as jnp
    from coast_tpu.ops import fused_step as jfused
    group = commit_group(40 + n, n)
    before = hopper_commit.LAUNCHES
    repaired, voted, flags = fused_step.commit_sites(as_sites(group), n)
    assert hopper_commit.LAUNCHES == before
    assert flags.dtype == torch.int32 and flags.shape == (len(group), 6)
    call = jax.vmap(lambda a, b: jfused._vote_flip_call(a, b, n, True))
    for s, (lanes, masks, masked) in enumerate(group):
        rows, k = lanes.shape[0], int(np.prod(lanes.shape[2:]))
        m = masks if masked else np.zeros_like(masks)
        ref = call(jnp.asarray(lanes.reshape(rows, n, 1, k)),
                   jnp.asarray(m.view(np.uint32).reshape(rows, n, 1, k)))
        np.testing.assert_array_equal(
            as_bits(repaired[s]).reshape(rows, -1),
            as_bits(ref[0]).reshape(rows, -1), err_msg=f"site {s}")
        np.testing.assert_array_equal(
            as_bits(voted[s]).reshape(rows, -1),
            as_bits(ref[1]).reshape(rows, -1), err_msg=f"site {s}")
        np.testing.assert_array_equal(flags[s].numpy(),
                                      np.asarray(ref[2]).astype(np.int32))
    assert flags[:, 1::2].all()          # every odd row carries a flip


def test_commit_sites_outputs_never_alias_their_inputs():
    sites = as_sites(commit_group(7, 3))
    snapshot = [lanes.clone() for lanes, _ in sites]
    repaired, voted, _ = fused_step.commit_sites(sites, 3)
    for out in repaired + voted:
        out.view(torch.int32).fill_(7)
    for (lanes, _), before in zip(sites, snapshot):
        assert torch.equal(lanes.view(torch.int32), before.view(torch.int32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host; K2 runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("shape", [(1,), (13,), (9, 9), (131072 + 3,)])
def test_kernel_bit_equal_to_plain_on_card(cuda, shape, n, dtype, masked):
    lanes, masks = commit_case(len(shape) + n, 8, n, shape, dtype)
    lanes = torch.from_numpy(lanes).to(cuda)
    masks = torch.from_numpy(masks).to(cuda) if masked else None
    before = hopper_commit.LAUNCHES
    repaired, voted, mis = fused_step.vote_flip_commit(lanes, masks, n)
    assert hopper_commit.LAUNCHES == before + 1
    p_repaired, p_voted, p_mis = fused_step.plain_vote_flip_commit(
        lanes, masks, n)
    for got, want in ((repaired, p_repaired), (voted, p_voted)):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(mis, p_mis)
    assert repaired.data_ptr() != lanes.data_ptr()


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    lanes = torch.zeros((4, 3, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        fused_step.vote_flip_commit(lanes.to(torch.int64), None, 3)
    with pytest.raises(ValueError):
        fused_step.vote_flip_commit(lanes, None, 2)      # n != num_clones
    with pytest.raises(ValueError):
        fused_step.vote_flip_commit(lanes, torch.zeros((4, 3, 7),
                                                       dtype=torch.int32,
                                                       device=cuda), 3)


# ---------------------------------------------------------------------------
# crc16
# ---------------------------------------------------------------------------

def test_crc16_golden_and_fault_free_records():
    from coast_tpu.models import crc16 as jcrc16
    assert crc16.GOLDEN == jcrc16.GOLDEN == jcrc16._crc16_host(
        crc16.MESSAGE)
    region = crc16.make_region()
    assert region.meta["oracle"] == jcrc16.make_region().meta["oracle"]
    for strategy in ("TMR", "DWC", "unprotected"):
        for fuse in (False, True):
            rec = PORT[strategy](region, device="cpu",
                                 fuse_step=fuse).run(bitflip.noop_fault())
            assert rec["errors"].item() == 0 and rec["done"].item()
            assert rec["steps"].item() == 13
            assert rec["corrected"].item() == 0
            assert not rec["dwc_fault"].item()
            assert rec["output"].tolist() == [crc16.GOLDEN]


def forced_bit31_schedule(jprog, n, seed):
    """A seeded schedule whose first rows flip bit 31 of ``crc`` and ``i``
    in several lanes and steps (those flips make the words negative)."""
    from coast_tpu.inject.mem import MemoryMap as JMemoryMap
    from coast_tpu.inject.schedule import generate as jgenerate
    sched = jgenerate(JMemoryMap(jprog), n, seed, 13)
    row = 0
    for name in ("crc", "i"):
        leaf = jprog.leaf_order.index(name)
        for lane in range(jprog.cfg.num_clones):
            for t in (0, 5, 12):
                sched.leaf_id[row], sched.lane[row] = leaf, lane
                sched.word[row], sched.bit[row], sched.t[row] = 0, 31, t
                row += 1
    return sched, row


@pytest.mark.parametrize("strategy", ["TMR", "DWC"])
def test_crc16_bit31_flips_campaign_parity(strategy):
    from coast_tpu.inject.campaign import CampaignRunner as JCampaignRunner
    jr, tr = jax_regions()["crc16"][0](), crc16.make_region()
    jprog = jax_strategy(strategy)(jr)
    sched, forced = forced_bit31_schedule(jprog, 96, 4)
    ref = JCampaignRunner(jprog, strategy_name=strategy).run_schedule(
        sched, batch_size=96)
    port_sched = FaultSchedule(sched.leaf_id, sched.lane, sched.word,
                               sched.bit, sched.t, sched.section_idx,
                               sched.seed)
    for fuse in (False, True):
        prog = PORT[strategy](tr, device="cpu", fuse_step=fuse)
        got = CampaignRunner(prog, strategy_name=strategy).run_schedule(
            port_sched, batch_size=48)
        assert_same_records(got, ref, f"crc16 {strategy} fuse={fuse}")
    # Bit 31 of crc never reaches the CRC's low 16 bits (the next update
    # masks it away); bit 31 of i is caught by the pre-step vote.
    assert (ref.codes[:forced // 2] == 0).all()
    assert (ref.codes[forced // 2:forced] != 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3])
def test_grouped_kernel_bit_equal_to_plain_on_card(cuda, n):
    sites = as_sites(commit_group(60 + n, n, rows=4096), cuda)
    lanes, masks = commit_case(9, 4096, n, (131072 + 3,), np.float32)
    sites.insert(1, (torch.from_numpy(lanes[:8]).to(cuda),
                     torch.from_numpy(masks[:8]).to(cuda)))
    groups = [sites[:1] + sites[2:], sites[1:2]]     # R = 4096 and R = 8
    for group in groups:
        before = hopper_commit.LAUNCHES
        got = fused_step.commit_sites(group, n)
        assert hopper_commit.LAUNCHES == before + 1
        want = fused_step.plain_commit_sites(group, n)
        assert torch.equal(got[2], want[2])
        for g, w, (lanes, _) in zip(got[0] + got[1], want[0] + want[1],
                                    group + group):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
            assert g.data_ptr() != lanes.data_ptr()


@pytest.mark.cuda
def test_grouped_kernel_refuses_bad_tables(cuda):
    lanes = torch.zeros((4, 3, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        fused_step.commit_sites([(lanes, None)] * 17, 3)
    with pytest.raises(ValueError):                       # R differs
        fused_step.commit_sites([(lanes, None), (lanes[:2], None)], 3)
    with pytest.raises(ValueError):                       # a CPU site
        fused_step.commit_sites([(lanes, None), (lanes.cpu(), None)], 3)
    with pytest.raises(TypeError):
        fused_step.commit_sites([(lanes, None), (lanes.long(), None)], 3)
    with pytest.raises(ValueError):                       # mask shape
        fused_step.commit_sites([(lanes, lanes[:, :, :4].contiguous())], 3)
