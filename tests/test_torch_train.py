"""The protected training step (train_mlp, SGD with momentum) of the port
against the JAX reference.

In one process: the init image (data, parameters) equals the
reference's bit for bit and the declared dataflow its ``analyze()``; the
port's golden loss trajectory matches the reference's within
``RTOL``/``ATOL`` and converges, and so does the port's own step run from
the reference's image; fault-free rows of every strategy classify
``success``; the reference's seeded flips (``tests/test_train.py``) give
its outcome classes on the port's own golden; classify splits SDC by the
probe below the DUE classes; the class distributions of 256-row seed-11
campaigns overlap the reference's (Wilson 95 %, per class); the train
sections, the journal resume, the logs read back through the reference's
parser, the FLOPs table and the registry.  The helpers are shared with
``tests/test_torch_train_adam.py``.

The reference's own float pins depend on the host (its ``-TMR``/``-DWC``
fault-free rows land ulps off its golden on some hosts and read
``train_self_heal``), so the distributions are compared class by class
where a class does not depend on that (``train_sdc`` and the DUEs), and
with ``success``, ``corrected`` and ``train_self_heal`` pooled as the
converged outcome; the unprotected campaign, whose golden is its own
program's, is compared class by class.
"""

import json

import numpy as np
import pytest
import torch

import coast_tpu_torch as ct
from coast_tpu_torch.inject import classify as cls
from coast_tpu_torch.inject import logs, supervisor
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.inject.mem import MemoryMap
from coast_tpu_torch.interop import state_from_numpy, state_to_numpy
from coast_tpu_torch.models import REGISTRY, model_source
from coast_tpu_torch.obs.convergence import intervals_overlap, interval_table
from coast_tpu_torch.passes.verification import analyze
from coast_tpu_torch.train import mlp

torch.set_num_threads(1)

OPTIMIZER = "sgd"
NAME = "train_mlp"
# The loss trajectory's tolerance against the reference's: XLA and the
# port round the same f32 chain in other orders.
RTOL, ATOL = 1e-5, 1e-7
ROWS, SEED, BATCH = 256, 11, 128
STRATEGIES = ("unprotected", "DWC", "TMR", "selective")
PROBE_KEYS = ("errors", "corrected", "steps", "done", "dwc_fault",
              "cfc_fault", "stack_fault", "assert_fault", "train_probe")
# Classes the reference's host-dependent float residual moves between.
CONVERGED = ("success", "corrected", "train_self_heal")


# -- shared helpers ----------------------------------------------------------

def port_prog(region, strategy, **kw):
    if strategy == "selective":
        return mlp.selective_xmr(region, device="cpu", **kw)
    make = {"unprotected": ct.unprotected, "DWC": ct.DWC, "TMR": ct.TMR}
    return make[strategy](region, device="cpu", **kw)


def ref_prog(jregion, strategy):
    from coast_tpu import DWC, TMR, unprotected
    from coast_tpu.train import selective_xmr
    make = {"unprotected": unprotected, "DWC": DWC, "TMR": TMR,
            "selective": selective_xmr}
    return make[strategy](jregion)


def flip(prog, leaf, *, bit, t, lane=0, word=0):
    """One run with one flip -> the record, host values."""
    rec = prog.run({"leaf_id": prog.leaf_order.index(leaf), "lane": lane,
                    "word": word, "bit": bit, "t": t})
    return {k: v.numpy() for k, v in rec.items()}


def code_of(rec, prog):
    return int(cls.classify({k: torch.as_tensor(rec[k])[None]
                             for k in PROBE_KEYS}, prog.output_words)[0])


def check_image_and_dataflow(optimizer, name):
    from coast_tpu.models import REGISTRY as JREGISTRY
    from coast_tpu.passes.verification import analyze as janalyze
    region, jregion = REGISTRY[name](), JREGISTRY[name]()
    want, got = janalyze(jregion), analyze(region)
    assert (got.written, got.deps, got.load_addr, got.store_addr) == (
        want.written, want.deps, want.load_addr, want.store_addr)
    assert list(region.spec) == list(jregion.spec)
    assert {k: (s.kind, s.xmr) for k, s in region.spec.items()} == {
        k: (s.kind, s.xmr) for k, s in jregion.spec.items()}
    assert sorted(region.functions) == sorted(jregion.functions)
    assert set(region.meta["store_slice"]) == set(
        jregion.meta["store_slice"])
    for key in ("state_bytes", "opt_state_bytes", "param_bytes"):
        assert region.meta[key] == jregion.meta[key], key
    jtrain = jregion.meta["train"]
    for key, value in region.meta["train"].items():
        assert jtrain[key] == value, key
    assert (region.nominal_steps, region.max_steps) == (
        jregion.nominal_steps, jregion.max_steps)
    assert region.graph is None and jregion.graph is None
    image = state_to_numpy(region.init("cpu"), region)
    jimage = {k: np.asarray(v) for k, v in jregion.init().items()}
    assert sorted(image) == sorted(jimage)
    for k, v in jimage.items():
        if k.startswith("g_"):
            continue       # each package's own golden
        assert image[k].dtype == v.dtype, k
        assert image[k].tobytes() == v.tobytes(), k
    # The reference's image carried into the port keeps every bit.
    carried = state_to_numpy(state_from_numpy(jimage, "cpu"), region)
    for k, v in jimage.items():
        assert carried[k].tobytes() == v.tobytes(), k
    return region, jregion


def check_golden(optimizer, jregion):
    gold = mlp.golden(optimizer, "cpu")
    jimage = jregion.init()
    np.testing.assert_allclose(gold["losses"], np.asarray(jimage["g_loss"]),
                               rtol=RTOL, atol=ATOL)
    assert gold["losses"][-1] < gold["losses"][0]
    for n in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(gold["params"][n],
                                   np.asarray(jimage[f"g_{n}"]),
                                   rtol=RTOL, atol=ATOL, err_msg=n)


def check_steps_from_reference_image(region, jregion):
    """The port's step from the reference's init image (its golden leaves
    included): the losses of every iteration and the final weights within
    tolerance of the reference's golden."""
    jimage = {k: np.asarray(v) for k, v in jregion.init().items()}
    state = {k: v.unsqueeze(0)
             for k, v in state_from_numpy(jimage, "cpu").items()}
    step = region.bound_step()
    losses = []
    for t in range(region.nominal_steps):
        state = {**state, **step(state, t)}
        losses.append(float(state["loss"][0]))
    assert bool(region.done(state)[0])
    np.testing.assert_allclose(losses[::mlp.PHASES], jimage["g_loss"],
                               rtol=RTOL, atol=ATOL)
    for n in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(state[n][0].numpy(), jimage[f"g_{n}"],
                                   rtol=RTOL, atol=ATOL, err_msg=n)
    assert int(state["dev"][0]) == 0


def check_fault_free(region, strategy):
    prog = port_prog(region, strategy)
    for batch in (1, 7, 64):
        rec = prog.run_batch(batch=batch)
        assert rec["done"].all() and (rec["errors"] == 0).all()
        assert (rec["train_probe"] == 0).all()
        assert (rec["steps"] == region.nominal_steps).all()
        codes = cls.classify(rec, prog.output_words)
        assert (codes == cls.SUCCESS).all(), (strategy, batch)


def coarse(counts):
    """The converged outcome pooled; every other class as it is."""
    out = {k: v for k, v in counts.items()
           if k not in CONVERGED and k != "cache_invalid"}
    out["converged"] = sum(counts[k] for k in CONVERGED)
    return out


def check_distribution_overlaps(region, jregion, strategy):
    from coast_tpu.inject.campaign import CampaignRunner as JRunner
    got = CampaignRunner(port_prog(region, strategy),
                         strategy_name=strategy).run(ROWS, seed=SEED,
                                                     batch_size=BATCH)
    want = JRunner(ref_prog(jregion, strategy), strategy_name=strategy).run(
        ROWS, seed=SEED, batch_size=BATCH)
    for col in ("leaf_id", "lane", "word", "bit", "t"):
        np.testing.assert_array_equal(getattr(got.schedule, col),
                                      getattr(want.schedule, col))
    assert set(got.counts) == set(want.counts)
    views = [coarse] + ([dict] if strategy == "unprotected" else [])
    for view in views:
        a = interval_table(view(got.counts))
        b = interval_table(view(want.counts))
        for k in a:
            assert intervals_overlap(a[k], b[k]), (strategy, k, got.counts,
                                                   want.counts)
    assert got.counts["sdc"] == 0
    return got


def check_tmr_repairs(region, bits=(1, 30)):
    prog = port_prog(region, "TMR")
    for bit in bits:
        rec = flip(prog, "w1", bit=bit, t=4)
        assert rec["errors"] == 0 and rec["train_probe"] == 0, bit
        assert rec["corrected"] > 0, bit


def check_flops(region, jregion):
    from coast_tpu.train import flops_overhead as jflops
    for n in (1, 2, 3):
        for selective in (False, True):
            assert mlp.flops_overhead(region, n, selective) == jflops(
                jregion, n, selective)


# -- the tests ---------------------------------------------------------------

@pytest.fixture(scope="module")
def regions():
    from coast_tpu.models import REGISTRY as JREGISTRY
    return REGISTRY[NAME](), JREGISTRY[NAME]()


def test_image_and_dataflow_equal_reference():
    check_image_and_dataflow(OPTIMIZER, NAME)


def test_golden_trajectory_matches_reference(regions):
    check_golden(OPTIMIZER, regions[1])


def test_steps_from_reference_image(regions):
    check_steps_from_reference_image(*regions)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_fault_free_rows_clean(strategy, regions):
    check_fault_free(regions[0], strategy)


def test_seeded_mantissa_flip_self_heals(regions):
    prog = port_prog(regions[0], "unprotected")
    rec = flip(prog, "w1", bit=1, t=4)
    assert rec["errors"] > 0 and rec["train_probe"] < 2
    assert code_of(rec, prog) == cls.TRAIN_SELF_HEAL


def test_seeded_exponent_flip_persists(regions):
    prog = port_prog(regions[0], "unprotected")
    rec = flip(prog, "w1", bit=30, t=4)
    assert rec["errors"] > 0 and rec["train_probe"] == 2
    assert code_of(rec, prog) == cls.TRAIN_SDC


def test_tmr_repairs_both_seeds(regions):
    check_tmr_repairs(regions[0])


def test_selective_xmr_repairs_param_and_opt_state_hits(regions):
    prog = port_prog(regions[0], "selective")
    for leaf, t in (("w1", 5), ("m_w2", 3), ("m_w2", 4), ("m_w2", 5)):
        rec = flip(prog, leaf, bit=30, t=t)
        assert rec["errors"] == 0, (leaf, t)
        assert rec["corrected"] > 0, (leaf, t)


def test_selective_xmr_transient_gradient_exposure(regions):
    prog = port_prog(regions[0], "selective")
    rec = flip(prog, "w1", bit=30, t=4)
    assert rec["errors"] > 0 and rec["train_probe"] == 2
    rec = flip(prog, "w1", bit=1, t=4)
    assert rec["errors"] == 0 and rec["corrected"] > 0


def test_classify_precedence_with_probe():
    one = torch.tensor
    base = {"errors": one([3]), "corrected": one([0]), "steps": one([5]),
            "done": one([True]), "dwc_fault": one([False]),
            "cfc_fault": one([False]), "stack_fault": one([False]),
            "assert_fault": one([False]), "train_probe": one([2])}
    assert int(cls.classify(base, 100)) == cls.TRAIN_SDC
    assert int(cls.classify({**base, "train_probe": one([1])}, 100)) \
        == cls.TRAIN_SELF_HEAL
    assert int(cls.classify({**base, "train_probe": one([0])}, 100)) \
        == cls.TRAIN_SELF_HEAL
    assert int(cls.classify({**base, "done": one([False])}, 100)) \
        == cls.DUE_TIMEOUT
    assert int(cls.classify({**base, "dwc_fault": one([True])}, 100)) \
        == cls.DUE_ABORT
    assert int(cls.classify({**base, "errors": one([-1])}, 100)) \
        == cls.INVALID
    assert int(cls.classify({**base, "errors": one([0]),
                             "corrected": one([1])}, 100)) == cls.CORRECTED
    no_probe = {k: v for k, v in base.items() if k != "train_probe"}
    assert int(cls.classify(no_probe, 100)) == cls.SDC


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_class_distributions_overlap_reference(strategy, regions):
    got = check_distribution_overlaps(*regions, strategy)
    if strategy == "unprotected":
        assert got.counts["train_self_heal"] > 0
        assert got.counts["train_sdc"] > 0
        assert got.sdc_total == got.counts["train_sdc"]
    if strategy in ("TMR", "selective"):
        assert got.counts["corrected"] > 0


def test_selective_xmr_recovers_most_of_tmr_coverage(regions):
    region = regions[0]
    unprot = CampaignRunner(port_prog(region, "unprotected")).run(
        ROWS, seed=SEED, batch_size=BATCH)
    sel = CampaignRunner(port_prog(region, "selective")).run(
        ROWS, seed=SEED, batch_size=BATCH)
    assert sel.counts["corrected"] > 0
    assert sel.counts["train_sdc"] * 2 < unprot.counts["train_sdc"]
    assert mlp.flops_overhead(region, 3, selective=True) \
        < 0.7 * mlp.flops_overhead(region, 3)


def test_flops_overhead_equals_reference(regions):
    check_flops(*regions)


def test_train_sections(regions):
    """'params'/'opt_state' pick exactly those leaves in both packages;
    a ``-s params`` campaign draws the reference's sites."""
    from coast_tpu.inject.mem import MemoryMap as JMemoryMap
    from coast_tpu.inject.supervisor import section_filter as jfilter
    region, jregion = regions
    prog = port_prog(region, "TMR")
    jprog = ref_prog(jregion, "TMR")
    assert supervisor.section_filter(prog, "params") == ("param",)
    assert supervisor.section_filter(prog, "opt_state") == ("opt_state",)
    for section in ("params", "opt_state", "memory"):
        got = MemoryMap(prog, sections=supervisor.section_filter(prog,
                                                                 section))
        want = JMemoryMap(jprog, sections=jfilter(jprog, section))
        assert [(s.name, s.kind, s.lanes, s.words) for s in got.sections] \
            == [(s.name, s.kind, s.lanes, s.words) for s in want.sections]
    names = {s.name for s in MemoryMap(
        prog, sections=supervisor.section_filter(prog, "params")).sections}
    assert names == {"w1", "b1", "w2", "b2"}


@pytest.mark.parametrize("section", ["params", "opt_state"])
def test_train_section_through_the_supervisor(section, tmp_path, capsys):
    import ast
    rc = supervisor.main(["-f", NAME, "-O", "-TMR", "-s", section, "-t",
                          "96", "--batch-size", "48", "--seed", "3", "-d",
                          "cpu", "-l", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    summary = ast.literal_eval(next(ln for ln in out.splitlines()
                                    if ln.startswith("{")))
    assert summary["injections"] == 96
    assert "train_self_heal" in summary and "train_sdc" in summary
    assert summary["sdc"] == 0 and summary["corrected"] > 0


def _crash_after(runner, n_batches):
    orig = runner._collect
    state = {"n": 0}

    def bomb(pending):
        state["n"] += 1
        if state["n"] > n_batches:
            raise RuntimeError("simulated crash")
        return orig(pending)
    runner._collect = bomb


def test_journal_resume_bit_for_bit(regions, tmp_path):
    region = regions[0]
    path = str(tmp_path / "train.journal")
    full = CampaignRunner(port_prog(region, "TMR"), strategy_name="TMR").run(
        192, seed=3, batch_size=64)
    crasher = CampaignRunner(port_prog(region, "TMR"), strategy_name="TMR")
    _crash_after(crasher, 2)
    with pytest.raises(RuntimeError, match="simulated crash"):
        crasher.run(192, seed=3, batch_size=64, journal=path)
    resumed = CampaignRunner(port_prog(region, "TMR"),
                             strategy_name="TMR").run(
        192, seed=3, batch_size=64, journal=path)
    for col in ("codes", "errors", "corrected", "steps"):
        np.testing.assert_array_equal(getattr(resumed, col),
                                      getattr(full, col))
    assert resumed.counts == full.counts
    with open(path) as fh:
        last = [json.loads(ln) for ln in fh if '"batch"' in ln][-1]
    assert "train_self_heal" in last["counts"]
    sparse = CampaignRunner(port_prog(region, "TMR"), strategy_name="TMR",
                            collect="sparse").run(192, seed=3, batch_size=64)
    assert sparse.counts == full.counts


@pytest.fixture(scope="module")
def campaign(regions):
    runner = CampaignRunner(port_prog(regions[0], "unprotected"),
                            strategy_name="unprotected")
    return runner.run(ROWS, seed=SEED, batch_size=BATCH), runner


def test_logs_read_back_through_reference_parser(campaign, tmp_path):
    from coast_tpu.analysis import json_parser as jp
    from coast_tpu_torch.analysis import json_parser as port_jp
    res, runner = campaign
    logs.write_json(res, runner.mmap, str(tmp_path / "a.json"))
    logs.write_ndjson(res, runner.mmap, str(tmp_path / "b.ndjson.json"))
    logs.write_columnar(res, runner.mmap, str(tmp_path / "c.json"))
    for fname in ("a.json", "b.ndjson.json", "c.json"):
        # The reference's parser and the port's own read the same counts.
        for parser in (jp, port_jp):
            s = parser.summarize_path(str(tmp_path / fname))
            assert s.n == res.n, fname
            for c in jp._CLASSES:
                assert s.counts[c] == res.counts.get(c, 0), (fname, c)
            assert s.error_rate == res.counts["train_sdc"] / res.n
    doc = jp.read_json_file(str(tmp_path / "a.json"))
    seen = set()
    for i, run in enumerate(doc["runs"]):
        got = jp.classify_run(run)
        assert got == cls.CLASS_NAMES[int(res.codes[i])]
        seen.add(got)
    assert {"train_self_heal", "train_sdc"} <= seen
    text = jp.summarize_path(str(tmp_path / "c.json")).format()
    assert "silent training corruption" in text


def test_registry_and_model_source():
    for name in ("train_mlp", "train_mlp_adam"):
        assert REGISTRY[name]().name == name
        assert model_source(name).endswith("coast_tpu_torch/train/mlp.py")
    assert REGISTRY["train_mlp_adam"]().meta["train"]["optimizer"] == "adam"


def test_counts_keys_and_non_train_campaigns():
    binc = np.zeros(cls.NUM_CLASSES, np.int64)
    binc[cls.SUCCESS] = 3
    assert list(cls.counts_dict(binc)) == list(cls.BASE_CLASS_NAMES)
    assert list(cls.counts_dict(binc, train=True)) == list(cls.CLASS_NAMES)
    res = CampaignRunner(ct.TMR(REGISTRY["matrixMultiply"](),
                                device="cpu")).run(48, seed=5, batch_size=48)
    assert set(res.counts) == set(cls.BASE_CLASS_NAMES) | {"cache_invalid"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host; K1 runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_train_on_card(cuda, optimizer):
    """The card's golden equals the host's bit for bit (the step's float
    ops are elementwise in a fixed order); fault-free rows are clean at
    batch 1 and 512 under TMR and selective xMR; a selective campaign
    votes on K1 and equals the host's on every row."""
    from coast_tpu_torch.ops import hopper_voters
    card, host = mlp.golden(optimizer, cuda), mlp.golden(optimizer, "cpu")
    assert card["losses"].tobytes() == host["losses"].tobytes()
    for n in card["params"]:
        assert card["params"][n].tobytes() == host["params"][n].tobytes()
    region = mlp.make_train_region(optimizer)
    for make in (ct.TMR, mlp.selective_xmr):
        prog = make(region, device=cuda)
        for batch in (1, 512):
            codes = cls.classify(prog.run_batch(batch=batch),
                                 prog.output_words)
            assert (codes == cls.SUCCESS).all()
    before = hopper_voters.LAUNCHES
    res = CampaignRunner(mlp.selective_xmr(region, device=cuda)).run(
        512, seed=SEED, batch_size=256)
    assert hopper_voters.LAUNCHES > before
    want = CampaignRunner(mlp.selective_xmr(region, device="cpu")).run(
        512, seed=SEED, batch_size=256)
    np.testing.assert_array_equal(res.codes, want.codes)
