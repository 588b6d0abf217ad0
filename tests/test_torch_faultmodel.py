"""Multi-site fault models of the PyTorch port against the JAX reference.

``coast_tpu_torch/inject/schedule.py`` (``FaultModel``, ``generate(model=)``,
the stratified schedules) and ``coast_tpu_torch/native.py``
(``fault_expand``) must reproduce the reference's columns bit for bit, and
its refusals with the same messages.  Port campaigns with flip groups must
give the reference's codes, errors, corrected, steps and counts on mm and
crc16 under TMR and DWC, on the unfused and the fused engine.
"""

import numpy as np
import pytest
import torch

import coast_tpu
import coast_tpu_torch as ct
from coast_tpu.inject import classify as jcls
from coast_tpu.inject import mem as jmem
from coast_tpu.inject import schedule as jsched
from coast_tpu.inject.campaign import CampaignRunner as JCampaignRunner
from coast_tpu.models import crc16 as jcrc16
from coast_tpu.models import mm as jmm
from coast_tpu.models import mm256 as jmm256
from coast_tpu_torch import native
from coast_tpu_torch.inject import classify as cls
from coast_tpu_torch.inject import mem
from coast_tpu_torch.inject import schedule as sched
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.models import crc16, mm, mm256

torch.set_num_threads(1)

REGIONS = {
    "mm": (jmm.make_region, mm.make_region),
    "crc16": (jcrc16.make_region, crc16.make_region),
    "mm256_64": (lambda: jmm256.make_region(side=64, block=16),
                 lambda: mm256.make_region(side=64, block=16)),
}
SPECS = ("single", "multibit(k=4)", "cluster(span=4,k=3)",
         "cluster(span=64,k=8)", "burst(window=8,rate=0.5)",
         "burst(window=4,rate=0.2)")
GROUP_SPECS = ("multibit(k=4)", "cluster(span=4,k=3)",
               "burst(window=8,rate=0.5)")
COLUMNS = ("codes", "errors", "corrected", "steps")


def maps(region):
    """The reference's and the port's TMR memory maps of one region."""
    jr, tr = (f() for f in REGIONS[region])
    return (jmem.MemoryMap(coast_tpu.TMR(jr)),
            mem.MemoryMap(ct.TMR(tr, device="cpu")), tr)


def synthetic_maps(kinds, words=(3, 1, 40, 7), lanes=(3, 1, 3, 2)):
    """The same hand-made section table as a reference and a port map
    (``kinds`` may name ``link`` sections, which no port region has)."""
    out = []
    for module in (jmem, mem):
        mmap = module.MemoryMap.__new__(module.MemoryMap)
        mmap.sections = [module.MemorySection(f"s{i}", i, kind, ln, w)
                         for i, (kind, ln, w) in enumerate(
                             zip(kinds, lanes, words))]
        mmap.total_bits = sum(s.bits for s in mmap.sections)
        out.append(mmap)
    return out


def assert_same_schedule(got, want):
    for k in ("leaf_id", "lane", "word", "bit", "t", "section_idx"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    assert (got.extra is None) == (want.extra is None)
    if want.extra is not None:
        assert set(got.extra) == set(want.extra)
        for k, v in want.extra.items():
            np.testing.assert_array_equal(got.extra[k], v, err_msg=k)
            assert got.extra[k].dtype == v.dtype
    assert got.model.spec() == want.model.spec()
    assert (got.gen_stream_n, got.gen_lo, got.gen_steps) == (
        want.gen_stream_n, want.gen_lo, want.gen_steps)
    for k, v in want.device_arrays().items():
        np.testing.assert_array_equal(got.device_arrays()[k], v, err_msg=k)


# -- the descriptor ----------------------------------------------------------

@pytest.mark.parametrize("text", [
    "single", "multibit(k=4)", "multibit:k=4", "multibit", "cluster",
    "cluster(span=8,k=3)", "burst(window=8,rate=0.5)",
    "burst:window=4,rate=2", "burst(window=3,rate=0.1)", "link",
    "link(offset=1,period=2)", " multibit(k=32) "])
def test_parse_spec_sites_equal_reference(text):
    got, want = sched.FaultModel.parse(text), jsched.FaultModel.parse(text)
    assert dataclasses_of(got) == dataclasses_of(want)
    assert (got.spec(), got.sites) == (want.spec(), want.sites)
    assert sched.FaultModel.parse(got.spec()) == got


def dataclasses_of(model):
    return (model.kind, model.k, model.span, model.window, model.rate,
            model.t_offset, model.t_period)


@pytest.mark.parametrize("text", [
    "multibit(k=1)", "multibit(k=40)", "burst(window=0,rate=1)",
    "burst(window=2,rate=0)", "meteor(k=2)", "single(k=2)",
    "cluster(span=0,k=2)", "cluster(k=1)", "link(offset=2)",
    "link(offset=-1,period=2)", "multibit(k)", "multibit(q=3)",
    "(k=2)"])
def test_validation_errors_equal_reference(text):
    with pytest.raises(ValueError) as want:
        jsched.FaultModel.parse(text)
    with pytest.raises(ValueError) as got:
        sched.FaultModel.parse(text)
    assert str(got.value) == str(want.value)


def test_constructor_refusals_equal_reference():
    for kw in ({"kind": "single", "t_period": 2},
               {"kind": "burst", "t_offset": 1}):
        with pytest.raises(ValueError) as want:
            jsched.FaultModel(**kw)
        with pytest.raises(ValueError) as got:
            sched.FaultModel(**kw)
        assert str(got.value) == str(want.value)


# -- the schedules -----------------------------------------------------------

@pytest.mark.parametrize("region", sorted(REGIONS))
@pytest.mark.parametrize("spec", SPECS)
def test_generate_equals_reference(region, spec):
    jmap, tmap, tr = maps(region)
    model_j, model_t = jsched.FaultModel.parse(spec), \
        sched.FaultModel.parse(spec)
    for n, seed in ((333, 17), (64, 0)):
        want = jsched.generate(jmap, n, seed, tr.nominal_steps, model=model_j)
        got = sched.generate(tmap, n, seed, tr.nominal_steps, model=model_t)
        assert_same_schedule(got, want)


@pytest.mark.parametrize("spec", GROUP_SPECS + ("cluster(span=64,k=8)",))
def test_fault_expand_equals_reference_native_and_numpy(spec):
    from coast_tpu import native as jnative
    jmap, tmap, tr = maps("mm")
    base_sched = sched.generate(tmap, 333, 17, tr.nominal_steps)
    base = {k: getattr(base_sched, k)
            for k in ("leaf_id", "lane", "word", "bit", "t", "section_idx")}
    model = sched.FaultModel.parse(spec)
    args = (17, model.kind, model.sites, model.span, model.window,
            tr.nominal_steps, base)
    got = native.fault_expand(*args, tmap.section_tables())
    for force in (False, True):
        want = jnative.fault_expand(*args, jmap.section_tables(),
                                    force_python=force)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype == np.int32
    for x, y in zip(tmap.section_tables(), jmap.section_tables()):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype


def test_splitmix_at_and_salt_equal_reference():
    from coast_tpu import native as jnative
    assert native.FAULT_EXPAND_SALT == jnative.FAULT_EXPAND_SALT
    for seed in (0, 1, 2**64 - 1, 0x5EED):
        assert native._splitmix_at(seed, native.FAULT_EXPAND_SALT) == \
            jnative._splitmix_at(seed, jnative.FAULT_EXPAND_SALT)


def test_slice_rebases_groups():
    jmap, tmap, tr = maps("mm")
    for spec in ("cluster(span=4,k=3)", "burst(window=8,rate=0.5)"):
        whole = sched.generate(tmap, 60, 3, tr.nominal_steps,
                               model=sched.FaultModel.parse(spec))
        part = whole.slice(20, 50)
        want = jsched.generate(jmap, 60, 3, tr.nominal_steps,
                               model=jsched.FaultModel.parse(spec)
                               ).slice(20, 50)
        assert_same_schedule(part, want)
        assert part.extra["group"].min() == 0
        assert part.extra["group"].max() == 29
        for k, v in part.device_arrays().items():
            np.testing.assert_array_equal(v, whole.device_arrays()[k][20:50])


@pytest.mark.parametrize("spec", ("single",) + GROUP_SPECS)
def test_stratified_equals_reference(spec):
    jmap, tmap, tr = maps("crc16")
    for fn, arg in (("generate_stratified", 8),
                    ("generate_stratified_total", 40)):
        want = getattr(jsched, fn)(jmap, arg, 5, tr.nominal_steps,
                                   model=jsched.FaultModel.parse(spec))
        got = getattr(sched, fn)(tmap, arg, 5, tr.nominal_steps,
                                 model=sched.FaultModel.parse(spec))
        assert_same_schedule(got, want)


def test_stratified_budget_warning(capsys):
    _, tmap, tr = maps("mm")
    n_sec = len(tmap.sections)
    sched.generate_stratified_total(tmap, 4 * n_sec, 0, tr.nominal_steps)
    assert "warning" not in capsys.readouterr().err
    got = sched.generate_stratified_total(tmap, max(2, n_sec // 2), 0,
                                          tr.nominal_steps)
    assert len(got) == n_sec
    err = capsys.readouterr().err
    assert "stratified budget" in err and "off the" in err


def test_link_refusals_equal_reference():
    jmap, tmap, tr = maps("mm")
    for call in (lambda s, m: s.generate(m, 8, 0, tr.nominal_steps,
                                         model=s.FaultModel.link()),
                 lambda s, m: s.generate_stratified(
                     m, 2, 0, tr.nominal_steps, model=s.FaultModel.link())):
        with pytest.raises(ValueError) as want:
            call(jsched, jmap)
        with pytest.raises(ValueError) as got:
            call(sched, tmap)
        assert str(got.value) == str(want.value)
    runner = CampaignRunner(ct.TMR(tr, device="cpu"),
                            fault_model=sched.FaultModel.link())
    with pytest.raises(ValueError, match="link-kind section"):
        runner.run(8)


@pytest.mark.parametrize("spec", ("single", "link", "link(offset=1,period=3)",
                                  "cluster(span=4,k=3)",
                                  "burst(window=4,rate=0.5)"))
def test_link_partition_on_a_map_with_link_sections(spec):
    """No port region has a link section, so the draw restriction is held
    to the reference on a hand-made map: link draws land on link sections
    only, every other model's base draws on the rest."""
    jmap, tmap = synthetic_maps(("mem", "link", "ctrl", "link"))
    want = jsched.generate(jmap, 500, 9, 12,
                           model=jsched.FaultModel.parse(spec))
    got = sched.generate(tmap, 500, 9, 12, model=sched.FaultModel.parse(spec))
    assert_same_schedule(got, want)
    on_link = np.isin(got.section_idx, (1, 3))
    assert on_link.all() if spec.startswith("link") else not on_link.any()
    jall, tall = synthetic_maps(("link", "link"), words=(2, 3), lanes=(1, 3))
    with pytest.raises(ValueError) as want:
        jsched.generate(jall, 4, 0, 12)
    with pytest.raises(ValueError) as got:
        sched.generate(tall, 4, 0, 12)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jsched.link_steps(jsched.FaultModel.link(offset=20, period=2), 12)
    with pytest.raises(ValueError) as got:
        sched.link_steps(sched.FaultModel.link(offset=20, period=2), 12)
    assert str(got.value) == str(want.value)


def test_equiv_still_refuses():
    # Item 17b landed: equiv= reduces single-bit schedules; a flip group or
    # a link model is refused with the reference's message.
    jmap, tmap, tr = maps("mm")
    for model in ("multibit(k=2)", "link"):
        with pytest.raises(ValueError) as want:
            jsched.generate(jmap, 4, 0, tr.nominal_steps,
                            model=jsched.FaultModel.parse(model),
                            equiv=object())
        with pytest.raises(ValueError) as got:
            sched.generate(tmap, 4, 0, tr.nominal_steps,
                           model=sched.FaultModel.parse(model),
                           equiv=object())
        assert str(got.value) == str(want.value)


def test_counts_histogram_equals_reference():
    binc = np.arange(cls.NUM_CLASSES, dtype=np.int64) * 3
    counts = cls.counts_dict(binc, train=True)
    counts["cache_invalid"] = 99
    for c in (counts, {"sdc": 4}, {}):
        got = cls.counts_histogram(c)
        np.testing.assert_array_equal(got, jcls.counts_histogram(c))
        assert got.dtype == np.int64
    np.testing.assert_array_equal(cls.counts_histogram(counts), binc)


# -- flip groups through the engine -----------------------------------------

@pytest.mark.parametrize("region", ("mm", "crc16"))
@pytest.mark.parametrize("strategy", ("TMR", "DWC"))
@pytest.mark.parametrize("spec", GROUP_SPECS)
def test_grouped_campaign_parity(region, strategy, spec):
    """200 rows at batch 64 (a ragged tail): the port's unfused and fused
    engines give the reference's records and counts (the reference's own
    fused engine equals its unfused one, tests/test_fused.py)."""
    jr, tr = (f() for f in REGIONS[region])
    ref = JCampaignRunner(getattr(coast_tpu, strategy)(jr),
                          fault_model=jsched.FaultModel.parse(spec)
                          ).run(200, seed=3, batch_size=64)
    assert ref.schedule.extra is not None
    for fuse in (False, True):
        prog = getattr(ct, strategy)(tr, device="cpu", fuse_step=fuse)
        assert (prog._fuse_plan is not None) == fuse
        res = CampaignRunner(prog, fault_model=sched.FaultModel.parse(spec)
                             ).run(200, seed=3, batch_size=64)
        assert res.fault_model.spec() == spec
        for col in COLUMNS:
            np.testing.assert_array_equal(getattr(res, col),
                                          getattr(ref, col), err_msg=col)
        assert res.counts == ref.counts
        # The port adds one fire-plan copy a batch (4 batches).
        assert res.transfer["up"] == ref.transfer["up"]
        assert res.transfer["down"] == (
            ref.transfer["down"]
            + 4 * prog.fire_plan_bytes(res.fault_model.sites))


def test_tmr_votes_away_intra_lane_group_but_not_cross_lane():
    """k flips inside one replica are voted away like a single flip; the
    same word corrupted the same way in two replicas outvotes the clean
    lane.  Equal to the reference's record, site for site."""
    import jax
    jr, tr = jmm.make_region(), mm.make_region()
    jprog, prog = coast_tpu.TMR(jr), ct.TMR(tr, device="cpu")
    sec = CampaignRunner(prog).mmap.by_name("second")
    assert sec.lanes == 3

    def run(lanes, bits, t=(1, 1)):
        fault = {"leaf_id": np.full(len(lanes), sec.leaf_id, np.int32),
                 "word": np.zeros(len(lanes), np.int32),
                 "t": np.array(t, np.int32),
                 "lane": np.array(lanes, np.int32),
                 "bit": np.array(bits, np.int32)}
        want = jax.jit(jprog.run)(fault)
        got = prog.run(fault)
        for k in ("errors", "corrected", "steps", "done", "dwc_fault"):
            assert int(got[k]) == int(want[k]), k
        return int(jcls.classify(want, 10_000))

    assert run([0, 0], [3, 7]) in (jcls.SUCCESS, jcls.CORRECTED)
    assert run([0, 1], [3, 3]) not in (jcls.SUCCESS, jcls.CORRECTED)
    # Two flips of one bit at one step cancel; at two steps each lands.
    assert run([2, 2], [5, 5]) == jcls.SUCCESS
    run([2, 2], [5, 5], t=(1, 4))
