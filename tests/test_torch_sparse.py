"""Sparse collection and the device generator of the PyTorch port.

``coast_tpu_torch/inject/device_gen.py`` must regenerate the host
``generate()`` stream bit for bit for every fault-model kind, and
``CampaignRunner(collect="sparse")`` must give the dense path's counts,
interesting rows and columns -- and the JAX reference's sparse ones -- on
the generated path, the resident path (strata), under buffer overflow and
at misaligned batch starts.  Its ``transfer`` is the reference's plus one
documented fire-plan copy a batch.

The card's machine has no JAX, so the reference is imported where it is
used; the tests marked ``cuda`` (the generator and the device accounting
on the card against the CPU) run there alone:

    python -m pytest tests/test_torch_sparse.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

import coast_tpu_torch as ct
from coast_tpu_torch.inject import campaign as camp
from coast_tpu_torch.inject import classify as cls
from coast_tpu_torch.inject import mem
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.inject.device_gen import (DeviceGenError,
                                               DeviceScheduleGen, _mod64,
                                               _splitmix64)
from coast_tpu_torch.inject.schedule import (FaultModel, generate,
                                             generate_stratified)
from coast_tpu_torch.models import crc16, mm
from coast_tpu_torch.native import splitmix_fill

torch.set_num_threads(1)

KINDS = ("single", "multibit(k=4)", "cluster(span=4,k=3)",
         "burst(window=8,rate=0.5)")
COLUMNS = ("codes", "errors", "corrected", "steps")
REGIONS = {"mm": mm.make_region, "crc16": crc16.make_region}


def runner(region="mm", strategy="TMR", spec="single", **kw):
    prog = getattr(ct, strategy)(REGIONS[region](), device="cpu",
                                 fuse_step=kw.pop("fuse_step", False))
    return CampaignRunner(prog, fault_model=FaultModel.parse(spec), **kw)


def ref_runner(spec="single", **kw):
    import coast_tpu
    from coast_tpu.inject.campaign import CampaignRunner as JCampaignRunner
    from coast_tpu.inject.schedule import FaultModel as JFaultModel
    from coast_tpu.models import mm as jmm
    return JCampaignRunner(coast_tpu.TMR(jmm.make_region()),
                           fault_model=JFaultModel.parse(spec), **kw)


def assert_parity(dense, sparse):
    """Sparse counts, interesting rows and columns equal the dense run's."""
    assert sparse.collect == "sparse" and dense.collect == "dense"
    assert dense.counts == sparse.counts
    rows = np.flatnonzero(dense.codes > cls.CORRECTED)
    np.testing.assert_array_equal(sparse.interesting_rows, rows)
    for col in COLUMNS:
        np.testing.assert_array_equal(getattr(dense, col)[rows],
                                      getattr(sparse, col), err_msg=col)


def synthetic_map(kinds, words, lanes):
    mmap = mem.MemoryMap.__new__(mem.MemoryMap)
    mmap.sections = [mem.MemorySection(f"s{i}", i, kind, ln, w)
                     for i, (kind, ln, w) in enumerate(zip(kinds, lanes,
                                                           words))]
    mmap.total_bits = sum(s.bits for s in mmap.sections)
    return mmap


# -- the generator -----------------------------------------------------------

@pytest.mark.parametrize("region", sorted(REGIONS))
@pytest.mark.parametrize("spec", KINDS)
def test_device_gen_rows_equal_host_stream(region, spec):
    run = runner(region, spec=spec)
    steps = run.prog.region.nominal_steps
    model = FaultModel.parse(spec)
    want = generate(run.mmap, 257, 11, steps, model=model).device_arrays()
    gen = DeviceScheduleGen(run.mmap, steps, model, "cpu")
    got = gen.rows_np(11, 257, np.arange(257))
    sub = np.array([3, 77, 256, 9, 31, 0])
    got_sub = gen.rows_np(11, 257, sub)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_array_equal(got_sub[k], v[sub], err_msg=k)
        assert got[k].dtype == np.int32


@pytest.mark.parametrize("spec", KINDS + ("link", "link(offset=1,period=3)",
                                          "multibit(k=32)"))
def test_device_gen_link_partition(spec):
    """The link restriction tables and the non-link relocation, on a map
    with link sections (no port region has one)."""
    mmap = synthetic_map(("mem", "link", "ctrl", "link"), (3, 1, 40, 7),
                         (3, 1, 3, 2))
    model = FaultModel.parse(spec)
    want = generate(mmap, 400, 2**64 - 5, 12, model=model).slice(
        100, 400).device_arrays()
    got = DeviceScheduleGen(mmap, 12, model, "cpu").rows_np(
        2**64 - 5, 400, np.arange(100, 400))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_device_gen_refuses_2_32_bits_as_the_reference():
    from coast_tpu.inject import device_gen as jdg
    from coast_tpu.inject import mem as jmem
    big = synthetic_map(("mem",), (1 << 25,), (4,))      # 2^32 bits
    assert big.total_bits == 1 << 32
    jbig = jmem.MemoryMap.__new__(jmem.MemoryMap)
    jbig.sections = [jmem.MemorySection("s0", 0, "mem", 4, 1 << 25)]
    jbig.total_bits = 1 << 32
    with pytest.raises(jdg.DeviceGenError) as want:
        jdg.DeviceScheduleGen(jbig, 10)
    with pytest.raises(DeviceGenError) as got:
        DeviceScheduleGen(big, 10, device="cpu")
    assert str(got.value) == str(want.value)
    DeviceScheduleGen(synthetic_map(("mem",), ((1 << 25) - 1,), (4,)), 10,
                      device="cpu")
    z = torch.zeros(1, dtype=torch.int64)
    for m in (0, 1 << 32):
        with pytest.raises(DeviceGenError):
            _mod64(z, m)


def test_mod64_and_splitmix64_against_numpy():
    raw = np.concatenate([splitmix_fill(12345, 4000),
                          np.array([0, 1, 2**63 - 1, 2**63, 2**64 - 1],
                                   np.uint64)])
    z = torch.from_numpy(raw.view(np.int64))
    moduli = ([1, 3, 7919, 2**31 + 1, 2**32 - 1, 2**32 - 5]
              + [2**k for k in range(32)])
    for m in moduli:
        np.testing.assert_array_equal(
            _mod64(z, m).numpy(), (raw % np.uint64(m)).astype(np.int64),
            err_msg=str(m))
    got = _splitmix64(2**64 - 1, torch.arange(1, 4001)).numpy()
    np.testing.assert_array_equal(got.view(np.uint64),
                                  splitmix_fill(2**64 - 1, 4000))


# -- the device accounting --------------------------------------------------

def accounting_inputs(seed, b=77, n_valid=70):
    """Seeded batch outputs: classes 0..7, rows that pack and rows that do
    not (negative or huge E, F or T), an interesting row at bit 31 of the
    first and second mask words."""
    rng = np.random.default_rng(seed)
    code = rng.integers(0, 8, b).astype(np.int32)
    code[[31, 63]] = cls.SDC
    err = rng.integers(0, 82, b).astype(np.int32)
    cor = rng.integers(0, 5, b).astype(np.int32)
    steps = rng.integers(0, 55, b).astype(np.int32)
    err[5], cor[9], steps[12], err[31] = -3, 2**30, 2**21, 2**31 - 1
    code[[5, 9, 12]] = cls.INVALID
    w = rng.integers(0, 4, b).astype(np.int32)
    return ({"code": code, "errors": err, "corrected": cor, "steps": steps},
            w, np.arange(b) < n_valid)


@pytest.mark.parametrize("cap", (64, 3))
def test_sparse_device_outputs_equal_reference(cap):
    import jax.numpy as jnp
    from coast_tpu.inject import campaign as jcamp
    out, w, valid = accounting_inputs(cap)
    pack = camp._pack_layout(81, 54)
    assert pack == jcamp._pack_layout(81, 54)
    want = jcamp._sparse_device_outputs(
        {k: jnp.asarray(v) for k, v in out.items()}, jnp.asarray(w),
        jnp.asarray(valid), cap, pack)
    got = camp._sparse_device_outputs(
        {k: torch.from_numpy(v) for k, v in out.items()},
        torch.from_numpy(w), torch.from_numpy(valid), cap, pack)
    k, ke = int(want["n_int"]), int(want["n_exact"])
    assert (int(got["n_int"]), int(got["n_exact"])) == (k, ke)
    assert ke > 0 and (k > cap) == (cap == 3)
    np.testing.assert_array_equal(got["hist"].numpy(), np.asarray(
        want["hist"]))
    np.testing.assert_array_equal(got["head"].numpy(), np.concatenate(
        [np.asarray(want["hist"]), [k, ke]]))
    mask = got["mask"].numpy().view(np.uint32)
    np.testing.assert_array_equal(mask, np.asarray(want["mask"]))
    assert mask[0] >> 31 & 1 and mask[1] >> 31 & 1
    np.testing.assert_array_equal(camp._mask_rows(mask, 70),
                                  jcamp._mask_rows(np.asarray(want["mask"]),
                                                   70))
    keep, keep_e = min(k, cap), min(ke, cap)
    np.testing.assert_array_equal(
        got["packed"].numpy().view(np.uint32)[:keep],
        np.asarray(want["packed"])[:keep])
    np.testing.assert_array_equal(got["exact"].numpy()[:keep_e],
                                  np.asarray(want["exact"])[:keep_e])


def test_pack_layout_and_sentinel_roundtrip_equal_reference():
    from coast_tpu.inject import campaign as jcamp
    for out_words, max_steps in ((81, 200), (1, 1), (1 << 20, 54),
                                 (2**30, 2**21), (1048576, 96)):
        assert camp._pack_layout(out_words, max_steps) == \
            jcamp._pack_layout(out_words, max_steps)
    e, f, t = camp._pack_layout(out_words=81, max_steps=200)
    sentinel = (1 << f) - 1
    word = (np.uint32(2) | np.uint32(81 << 4) | np.uint32(3 << (4 + e))
            | np.uint32(199 << (4 + e + f)))
    packed = np.array([word, np.uint32(4 | (sentinel << (4 + e)))],
                      np.uint32)
    exact = np.array([[123456, -7, 99999]], np.int32)
    got = camp._unpack_rows(packed, exact, (e, f, t))
    want = jcamp._unpack_rows(packed, exact, (e, f, t))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    assert [list(x) for x in got] == [[2, 4], [81, 123456], [3, -7],
                                      [199, 99999]]
    with pytest.raises(RuntimeError, match="sentinel"):
        camp._unpack_rows(packed, exact[:0], (e, f, t))


# -- campaigns ---------------------------------------------------------------

@pytest.mark.parametrize("spec", KINDS)
def test_sparse_equals_dense_equals_reference(spec):
    """Generated path, 220 rows at batch 64 from injection 30 of the
    stream (a ragged tail): port sparse = port dense = reference sparse,
    and the transfer bytes are the reference's plus one fire-plan copy a
    batch (``ProtectedProgram.fire_plan_bytes``)."""
    ref = ref_runner(spec, collect="sparse").run(220, seed=7, batch_size=64,
                                                 start_num=30)
    dense = runner(spec=spec).run(220, seed=7, batch_size=64, start_num=30)
    run = runner(spec=spec, collect="sparse")
    sparse = run.run(220, seed=7, batch_size=64, start_num=30)
    assert_parity(dense, sparse)
    np.testing.assert_array_equal(sparse.interesting_rows,
                                  ref.interesting_rows)
    for col in COLUMNS:
        np.testing.assert_array_equal(getattr(sparse, col), getattr(ref, col))
    assert sparse.counts == ref.counts
    batches, sites = 4, run.fault_model.sites
    plan = run.prog.fire_plan_bytes(sites)
    assert sparse.transfer["up"] == ref.transfer["up"] == 20 * batches
    assert sparse.transfer["down"] == ref.transfer["down"] + batches * plan
    assert plan == 54 + sites * len(run.prog.leaf_order)
    assert sum(sparse.transfer.values()) < sum(dense.transfer.values())


@pytest.mark.parametrize("region,strategy", (("mm", "DWC"), ("crc16", "TMR"),
                                             ("crc16", "DWC")))
@pytest.mark.parametrize("spec", KINDS[1:])
def test_sparse_equals_dense_fused_and_unfused(region, strategy, spec):
    dense = runner(region, strategy, spec).run(150, seed=2, batch_size=64)
    for fuse in (False, True):
        sparse = runner(region, strategy, spec, collect="sparse",
                        fuse_step=fuse).run(150, seed=2, batch_size=64)
        assert_parity(dense, sparse)


def test_resident_path_strata_equals_dense_and_reference():
    """A stratified schedule has no generation metadata: it is uploaded
    once (with a batch of headroom) and sliced on the device."""
    from coast_tpu.inject.schedule import \
        generate_stratified as jgenerate_stratified
    from coast_tpu.inject.schedule import FaultModel as JFaultModel
    spec = "cluster(span=4,k=3)"
    dense_run = runner(spec=spec)
    run = runner(spec=spec, collect="sparse")
    steps = run.prog.region.nominal_steps
    sched = generate_stratified(run.mmap, 30, 3, steps,
                                model=FaultModel.parse(spec))
    assert sched.gen_stream_n is None and len(sched) == 210
    dense = dense_run.run_schedule(sched, batch_size=64)
    sparse = run.run_schedule(sched, batch_size=64)
    assert_parity(dense, sparse)
    jrun = ref_runner(spec, collect="sparse")
    ref = jrun.run_schedule(jgenerate_stratified(
        jrun.mmap, 30, 3, steps, model=JFaultModel.parse(spec)),
        batch_size=64)
    np.testing.assert_array_equal(sparse.interesting_rows,
                                  ref.interesting_rows)
    assert sparse.counts == ref.counts
    assert sparse.transfer["up"] == ref.transfer["up"] > 100
    assert sparse.transfer["down"] == (ref.transfer["down"]
                                       + 4 * run.prog.fire_plan_bytes(3))


def test_overflow_fallback_equals_dense():
    dense = runner().run(300, seed=7, batch_size=64)
    tiny = runner(collect="sparse", sparse_capacity=1).run(300, seed=7,
                                                           batch_size=64)
    assert_parity(dense, tiny)
    assert tiny.transfer["down"] > 300 * 4
    assert camp.CampaignRunner._sparse_cap(
        runner(collect="sparse", sparse_capacity=10**6), 64) == 64


def test_custom_step_window_rides_the_schedule():
    dense_run, run = runner(), runner(collect="sparse")
    steps = run.prog.region.nominal_steps * 2 + 3
    dense = dense_run.run_schedule(generate(dense_run.mmap, 200, 3, steps),
                                   batch_size=64)
    sparse = run.run_schedule(generate(run.mmap, 200, 3, steps),
                              batch_size=64)
    assert_parity(dense, sparse)
    assert sparse.transfer["up"] < 200          # the generated path


def test_resident_arrays_cover_misaligned_batch_starts():
    run = runner(spec="burst(window=8,rate=0.5)", collect="sparse")
    sched = generate(run.mmap, 100, 3, run.prog.region.nominal_steps,
                     model=run.fault_model)
    sched.gen_stream_n = None                   # force the resident path
    transfer = {"up": 0, "down": 0}
    state = run._sparse_setup(sched, 64, transfer)
    assert state["mode"] == "resident"
    for lo in (0, 1, 37, len(sched) - 1):
        fault, count_w = run._sparse_args(state, lo, transfer)
        for k, v in fault.items():
            assert v.shape == (64, 4), k
            np.testing.assert_array_equal(
                v[:len(sched) - lo].numpy(),
                sched.device_arrays()[k][lo:lo + 64])
        assert count_w.shape == (64,)
        assert int(count_w.sum()) == min(64, len(sched) - lo)
    dense = runner(spec="burst(window=8,rate=0.5)").run_schedule(
        sched, batch_size=64)
    assert_parity(dense, run.run_schedule(sched, batch_size=64))


def test_never_firing_rows_count_as_cache_invalid():
    run = runner(collect="sparse")
    sched = generate(run.mmap, 90, 4, run.prog.region.nominal_steps)
    sched.t[::7] = -1
    sched.gen_stream_n = None
    dense = runner().run_schedule(sched, batch_size=32)
    sparse = run.run_schedule(sched, batch_size=32)
    assert_parity(dense, sparse)
    assert sparse.counts["cache_invalid"] == 13


def test_device_gen_runs_on_the_card_unless_asked_for_the_cpu():
    mmap = runner().mmap
    if torch.cuda.is_available():
        assert DeviceScheduleGen(mmap, 12).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DeviceScheduleGen(mmap, 12)
    assert DeviceScheduleGen(mmap, 12, device="cpu").device.type == "cpu"


def test_sparse_layers_are_profiler_spans_once_a_batch():
    """The generator and the device accounting each run inside their
    ``campaign.SPANS`` span, once a batch, so a profile of the campaign
    itself attributes their device time (``breakdown.py``)."""
    run = runner(spec="multibit(k=4)", collect="sparse")
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        run.run(150, seed=2, batch_size=64)
    counts = {e.key: e.count for e in prof.key_averages()}
    assert [counts.get(span) for span in camp.SPANS] == [3, 3]


def test_flip_plan_builds_each_site_column_only_its_leaves():
    """One fire-plan copy a batch names the steps any row fires at and,
    for each site column of a group, the leaves that column targets."""
    prog = ct.TMR(mm.make_region(), device="cpu")
    cols = {"leaf_id": np.array([[0, 5], [0, 3], [1, 5]]),
            "lane": np.zeros((3, 2), np.int32),
            "word": np.zeros((3, 2), np.int32),
            "bit": np.array([[1, 2], [3, 4], [5, 6]]),
            "t": np.array([[2, 2], [4, -1], [60, 7]])}
    sites, fire_at, fault_t = prog._flip_plan(cols)
    names = prog.leaf_order
    assert [set(site) for site in sites] == [{names[0], names[1]},
                                             {names[3], names[5]}]
    assert fire_at == frozenset({2, 4, 7})
    assert fault_t.shape == (3, 2) and fault_t.dtype == torch.int32
    assert prog.fire_plan_bytes(2) == (prog.region.max_steps
                                       + 2 * len(names))


def test_device_columns_run_as_host_columns():
    """``run_batch`` on fault columns already on the device (the
    generator's) gives the records of the same host columns, after one
    fire-plan copy."""
    prog = ct.TMR(mm.make_region(), device="cpu")
    run = CampaignRunner(prog, fault_model=FaultModel.parse(
        "burst(window=8,rate=0.5)"))
    cols = generate(run.mmap, 96, 5, prog.region.nominal_steps,
                    model=run.fault_model).device_arrays()
    want = prog.run_batch(cols)
    got = prog.run_batch({k: torch.from_numpy(v) for k, v in cols.items()})
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_unknown_collect_mode_refused_as_the_reference():
    with pytest.raises(ValueError) as want:
        ref_runner(collect="weird")
    with pytest.raises(ValueError) as got:
        runner(collect="weird")
    assert str(got.value) == str(want.value)


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("spec", KINDS)
def test_device_gen_on_card_equals_cpu(cuda, spec):
    run = runner(spec=spec)
    steps = run.prog.region.nominal_steps
    model = FaultModel.parse(spec)
    rows = np.arange(70_000, 74_099)
    want = generate(run.mmap, 80_000, 3, steps, model=model).device_arrays()
    got = DeviceScheduleGen(run.mmap, steps, model, cuda).rows_np(
        3, 80_000, rows)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v[rows], err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", (64, 3))
def test_sparse_device_outputs_on_card_equal_cpu(cuda, cap):
    out, w, valid = accounting_inputs(cap + 1)
    pack = camp._pack_layout(81, 54)
    cpu = camp._sparse_device_outputs(
        {k: torch.from_numpy(v) for k, v in out.items()},
        torch.from_numpy(w), torch.from_numpy(valid), cap, pack)
    card = camp._sparse_device_outputs(
        {k: torch.from_numpy(v).to(cuda) for k, v in out.items()},
        torch.from_numpy(w).to(cuda), torch.from_numpy(valid).to(cuda), cap,
        pack)
    k, ke = min(int(cpu["n_int"]), cap), min(int(cpu["n_exact"]), cap)
    for name in ("head", "hist", "mask"):
        assert torch.equal(card[name].cpu(), cpu[name]), name
    assert torch.equal(card["packed"][:k].cpu(), cpu["packed"][:k])
    assert torch.equal(card["exact"][:ke].cpu(), cpu["exact"][:ke])
