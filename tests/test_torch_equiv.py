"""The port's equivalence partition and weighted campaigns against the
reference's.

The counterparts of ``tests/test_equiv.py``: the merge modes of
matrixMultiply and crc16, the dead class, the ``generate(equiv=)`` API,
the class keys, representatives, weights and schedule sha equal to the
reference's bit for bit on the same schedule, differential parity (the
reduced campaign's weighted counts equal the exhaustive ones), the four
cells of ``artifacts/equiv_study.json``, weighted logs read back by both
packages' parsers, equivalence journals (resume, partition identity, the
cross-package rule), the sharded runner, the fused build, the training
fallback and the supervisor's ``--equiv`` through both CLIs.

The partition fingerprints are the port's own (aten cone entries), so
they never equal the reference's; everything else does.  The tests marked
``cuda`` run on the card (``-m cuda --noconftest``: the reference is
imported only inside the tests that use it).
"""

import ast
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from coast_tpu_torch import DWC, TMR
from coast_tpu_torch.analysis.equiv import (TRAIN_FALLBACK,
                                            analyze_equivalence)
from coast_tpu_torch.analysis.equiv.partition import (MODE_EXH, MODE_FREE,
                                                      MODE_LT, MODE_LTW)
from coast_tpu_torch.inject import logs
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.inject.journal import (JournalMismatchError,
                                            schedule_fingerprint)
from coast_tpu_torch.inject.schedule import (FaultModel, FaultSchedule,
                                             generate)
from coast_tpu_torch.models import REGISTRY

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRATS = {"TMR": TMR, "DWC": DWC}


class _Kill(Exception):
    pass


def port_prog(name, strat, **kw):
    return STRATS[strat](REGISTRY[name](), device="cpu", **kw)


def ref_prog(name, strat, **kw):
    import coast_tpu
    from coast_tpu.models import REGISTRY as JREG
    return getattr(coast_tpu, strat)(JREG[name](), **kw)


@pytest.fixture(scope="module")
def mm_tmr():
    return port_prog("matrixMultiply", "TMR")


@pytest.fixture(scope="module")
def mm_tmr_equiv(mm_tmr):
    return CampaignRunner(mm_tmr, strategy_name="TMR", equiv=True)


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


# -- the static partition -----------------------------------------------------

def test_partition_modes_mm(mm_tmr_equiv):
    sigs = mm_tmr_equiv.equiv_partition.signatures
    assert sigs["golden"].mode == MODE_FREE
    assert sigs["first"].mode == MODE_LT
    assert sigs["second"].mode == MODE_LT
    assert sigs["i"].mode == MODE_LT and sigs["i"].pre_voted
    assert sigs["acc"].mode == MODE_LTW
    assert sigs["results"].mode == MODE_LTW
    assert sigs["phase"].mode == MODE_EXH and sigs["phase"].value_fed


@pytest.mark.parametrize("strat", ["TMR", "DWC"])
@pytest.mark.parametrize("name", ["matrixMultiply", "crc16"])
def test_signatures_equal_the_reference(name, strat):
    """Every signature field but the fingerprint, and clean_steps, equal
    the live reference's.  (crc16's ``crc`` is consumed in the reference's
    lattice only, through a shared traced helper: tests/test_torch_
    walker.py pins that difference.)"""
    from coast_tpu.analysis.equiv import analyze_equivalence as janalyze
    got = analyze_equivalence(port_prog(name, strat))
    want = janalyze(ref_prog(name, strat))
    assert got.clean_steps == want.clean_steps
    assert got.fallback_reason == want.fallback_reason

    def strip(sig, ref):
        out = {k: v for k, v in dataclasses.asdict(sig).items()
               if k != "fingerprint"}
        if ref and name == "crc16" and sig.name == "crc":
            assert out.pop("consumed") is True
            out["consumed"] = False
        return out
    assert ({k: strip(s, False) for k, s in got.signatures.items()}
            == {k: strip(s, True) for k, s in want.signatures.items()})
    assert got.fingerprint != want.fingerprint


def test_value_fed_register_stays_exhaustive():
    part = analyze_equivalence(port_prog("crc16", "TMR"))
    assert part.signatures["crc"].mode == MODE_EXH
    assert part.signatures["crc"].value_fed


def test_dead_window_is_one_class(mm_tmr_equiv):
    part = mm_tmr_equiv.equiv_partition
    n = 6
    sched = FaultSchedule(
        np.zeros(n, np.int32), np.arange(n, dtype=np.int32) % 3,
        np.arange(n, dtype=np.int32), np.arange(n, dtype=np.int32),
        np.full(n, part.clean_steps + 5, np.int32),
        np.zeros(n, np.int32), seed=0)
    assert (part.class_keys(sched) == -1).all()
    reduced = part.reduce(sched)
    assert len(reduced) == 1 and reduced.class_weight.sum() == n


def test_generate_equiv_api(mm_tmr_equiv):
    runner = mm_tmr_equiv
    part = runner.equiv_partition
    full = generate(runner.mmap, 2048, 7, 18)
    red = generate(runner.mmap, 2048, 7, 18, equiv=part)
    assert red.class_weight is not None and red.class_weight.dtype == np.int64
    assert red.effective_n == 2048 and len(red) < 2048
    assert red.equiv_sha == part.fingerprint
    assert red.gen_stream_n is None
    full_keys = set(zip(*(getattr(full, k).tolist() for k in
                          ("leaf_id", "lane", "word", "bit", "t"))))
    assert set(zip(*(getattr(red, k).tolist() for k in
                     ("leaf_id", "lane", "word", "bit", "t")))) <= full_keys
    # The slice carries the weights and the partition.
    sl = red.slice(3, 9)
    assert np.array_equal(sl.class_weight, red.class_weight[3:9])
    assert sl.equiv_sha == red.equiv_sha
    with pytest.raises(ValueError, match="single-bit"):
        generate(runner.mmap, 64, 7, 18, model=FaultModel.multibit(k=2),
                 equiv=part)
    with pytest.raises(ValueError, match="single"):
        CampaignRunner(runner.prog, equiv=True,
                       fault_model=FaultModel.cluster())


@pytest.mark.parametrize("strat", ["TMR", "DWC"])
@pytest.mark.parametrize("name", ["matrixMultiply", "crc16"])
def test_class_keys_and_reduce_equal_the_reference(name, strat):
    from coast_tpu.analysis.equiv import analyze_equivalence as janalyze
    from coast_tpu.inject import journal as jjournal
    from coast_tpu.inject.mem import MemoryMap as JMemoryMap
    from coast_tpu.inject.schedule import generate as jgenerate
    from coast_tpu_torch.inject.mem import MemoryMap
    prog, jprog = port_prog(name, strat), ref_prog(name, strat)
    part, jpart = analyze_equivalence(prog), janalyze(jprog)
    steps = prog.region.nominal_steps
    sched = generate(MemoryMap(prog), 8192, 21, steps)
    jsched = jgenerate(JMemoryMap(jprog), 8192, 21, steps)
    np.testing.assert_array_equal(part.class_keys(sched),
                                  jpart.class_keys(jsched))
    red, jred = part.reduce(sched), jpart.reduce(jsched)
    for k in ("leaf_id", "lane", "word", "bit", "t", "section_idx",
              "class_weight"):
        np.testing.assert_array_equal(getattr(red, k), getattr(jred, k))
    assert red.class_weight.dtype == jred.class_weight.dtype
    assert schedule_fingerprint(red) == jjournal.schedule_fingerprint(jred)


# -- differential parity: reduced == exhaustive -------------------------------

@pytest.mark.parametrize("strat", ["TMR", "DWC"])
@pytest.mark.parametrize("name,seed", [("matrixMultiply", 11),
                                       ("crc16", 13)])
def test_differential_parity(name, seed, strat):
    prog = port_prog(name, strat)
    a = CampaignRunner(prog, strategy_name=strat).run(
        2048, seed=seed, batch_size=512)
    b = CampaignRunner(prog, strategy_name=strat, equiv=True).run(
        2048, seed=seed, batch_size=512)
    assert a.counts == b.counts
    assert b.n == 2048 and b.physical_n < 2048
    assert int(b.schedule.class_weight.sum()) == 2048
    assert b.summary()["physical_injections"] == b.physical_n
    assert b.summary()["equiv_reduction"] == round(2048 / b.physical_n, 2)
    if name == "crc16":
        assert b.n / b.physical_n >= 5.0


@pytest.fixture(scope="module")
def study():
    with open(os.path.join(REPO, "artifacts", "equiv_study.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("strat", ["TMR", "DWC"])
@pytest.mark.parametrize("name", ["matrixMultiply", "crc16"])
def test_recorded_study_cell(name, strat, study):
    """The reference's recorded cell (16,384 at seed 2026): the reduced
    campaign's weighted counts, its physical rows and the section modes."""
    cell = study["targets"][name][strat]
    runner = CampaignRunner(port_prog(name, strat), strategy_name=strat,
                            equiv=True)
    res = runner.run(study["n"], seed=study["seed"], batch_size=2048)
    assert nonzero(res.counts) == cell["counts"]
    assert res.physical_n == cell["physical_injections"]
    assert res.n == cell["effective_injections"]
    part = runner.equiv_partition
    assert part.clean_steps == cell["clean_steps"]
    assert {k: s.mode_name for k, s in part.signatures.items()} \
        == cell["section_modes"]


# -- logs ---------------------------------------------------------------------

def test_weighted_logs_read_by_both_parsers(mm_tmr_equiv, tmp_path):
    from coast_tpu.analysis import json_parser as jjp
    from coast_tpu_torch.analysis import json_parser as jp
    runner = mm_tmr_equiv
    res = runner.run(2048, seed=3, batch_size=512)
    for fmt, writer in (("ndjson", logs.write_ndjson),
                        ("columnar", logs.write_columnar),
                        ("json", logs.write_json)):
        path = str(tmp_path / f"eq_{fmt}.json")
        writer(res, runner.mmap, path)
        for parser in (jp, jjp):
            s = parser.summarize_path(path)
            assert s.n == 2048 and s.physical_n == res.physical_n
            assert nonzero(s.counts) == {
                k: v for k, v in nonzero(res.counts).items()
                if k != "cache_invalid"}
            text = s.format()
            assert "effective" in text and "physical" in text
    with open(tmp_path / "eq_ndjson.json") as fh:
        rows = [json.loads(ln) for ln in fh.read().splitlines()[1:]]
    assert [r["weight"] for r in rows] == res.schedule.class_weight.tolist()


def test_weighted_stream_equals_one_shot(mm_tmr_equiv, tmp_path,
                                        monkeypatch):
    monkeypatch.setattr(logs, "_timestamp", lambda: FIXED_TS)
    runner = mm_tmr_equiv
    for fmt, writer in (("ndjson", logs.write_ndjson),
                        ("columnar", logs.write_columnar)):
        stream = logs.StreamLogWriter(str(tmp_path / f"s.{fmt}"),
                                      runner.mmap, fmt=fmt)
        res = runner.run(1024, seed=4, batch_size=256, stream=stream)
        stream.finish(res)
        writer(res, runner.mmap, str(tmp_path / f"o.{fmt}"))
        a = (tmp_path / f"s.{fmt}").read_text()
        b = (tmp_path / f"o.{fmt}").read_text()
        if fmt == "ndjson":
            a, b = a.split("\n", 1)[1], b.split("\n", 1)[1]
        else:
            a, b = (json.loads(x)["columns"] for x in (a, b))
        assert a == b
        assert "weight" in (a if fmt == "ndjson" else a.keys())


def test_exhaustive_logs_unchanged(mm_tmr, tmp_path):
    runner = CampaignRunner(mm_tmr, strategy_name="TMR")
    res = runner.run(256, seed=3, batch_size=128)
    assert res.physical_n is None
    assert "physical_injections" not in res.summary()
    path = str(tmp_path / "plain.ndjson")
    logs.write_ndjson(res, runner.mmap, path)
    with open(path) as fh:
        assert "weight" not in fh.read()


def test_sparse_reduced_equals_dense_reduced(mm_tmr, mm_tmr_equiv,
                                            tmp_path):
    part = mm_tmr_equiv.equiv_partition
    dense = mm_tmr_equiv.run(2048, seed=6, batch_size=512)
    sparse_runner = CampaignRunner(mm_tmr, strategy_name="TMR", equiv=part,
                                   collect="sparse", sparse_capacity=64)
    sparse = sparse_runner.run(2048, seed=6, batch_size=512)
    assert sparse.counts == dense.counts
    assert sparse.physical_n == dense.physical_n
    rows = np.flatnonzero(dense.codes > 1)
    assert np.array_equal(sparse.interesting_rows, rows)
    assert np.array_equal(sparse.codes, dense.codes[rows])
    path = str(tmp_path / "sparse.ndjson")
    logs.write_ndjson(sparse, sparse_runner.mmap, path)
    with open(path) as fh:
        got = [json.loads(ln)["weight"] for ln in fh.read().splitlines()[1:]]
    assert got == dense.schedule.class_weight[rows].tolist()


# -- journals -----------------------------------------------------------------

def kill_on_second():
    beats = {"n": 0}

    def progress(done, counts):
        beats["n"] += 1
        if beats["n"] >= 2:
            raise _Kill
    return progress


def test_equiv_journal_resume_bit_for_bit(mm_tmr_equiv, tmp_path):
    runner = mm_tmr_equiv
    baseline = runner.run(1024, seed=5, batch_size=256)
    jpath = str(tmp_path / "eq.journal")
    with pytest.raises(_Kill):
        runner.run(1024, seed=5, batch_size=256, journal=jpath,
                   progress=kill_on_second())
    resumed = runner.run(1024, seed=5, batch_size=256, journal=jpath)
    assert np.array_equal(resumed.codes, baseline.codes)
    assert resumed.counts == baseline.counts
    assert resumed.physical_n == baseline.physical_n
    with open(jpath) as fh:
        kinds = [json.loads(ln).get("kind") for ln in fh]
    assert kinds.count("equiv_schedule") == 1


def test_partition_mismatch_refused(mm_tmr, mm_tmr_equiv, tmp_path):
    jpath = str(tmp_path / "eq2.journal")
    mm_tmr_equiv.run(512, seed=5, batch_size=256, journal=jpath)
    plain = CampaignRunner(mm_tmr, strategy_name="TMR")
    with pytest.raises(JournalMismatchError):
        plain.run(512, seed=5, batch_size=256, journal=jpath)
    jpath2 = str(tmp_path / "plain2.journal")
    plain.run(512, seed=5, batch_size=256, journal=jpath2)
    with pytest.raises(JournalMismatchError):
        mm_tmr_equiv.run(512, seed=5, batch_size=256, journal=jpath2)


def test_pre_fingerprint_journal_resumes(mm_tmr_equiv, tmp_path):
    runner = mm_tmr_equiv
    jpath = str(tmp_path / "old.journal")
    with pytest.raises(_Kill):
        runner.run(1024, seed=5, batch_size=256, journal=jpath,
                   progress=kill_on_second())
    with open(jpath) as fh:
        lines = fh.read().splitlines()
    header = json.loads(lines[0])
    assert header.pop("section_fingerprints")
    with open(jpath, "w") as fh:
        fh.write("\n".join([json.dumps(header, separators=(",", ":"))]
                           + lines[1:]) + "\n")
    baseline = runner.run(1024, seed=5, batch_size=256)
    resumed = runner.run(1024, seed=5, batch_size=256, journal=jpath)
    assert np.array_equal(resumed.codes, baseline.codes)


def test_equiv_journal_does_not_cross_packages(mm_tmr_equiv, tmp_path):
    """A reference equivalence journal is refused by the port, naming both
    partition fingerprints (the port's are its own); a non-equivalence
    journal of the reference resumes under the port."""
    from coast_tpu.inject.campaign import CampaignRunner as JRunner
    jprog = ref_prog("matrixMultiply", "TMR")
    jrunner = JRunner(jprog, strategy_name="TMR", equiv=True)
    jpath = str(tmp_path / "ref_eq.journal")
    jrunner.run(512, seed=5, batch_size=256, journal=jpath)
    with pytest.raises(JournalMismatchError) as err:
        mm_tmr_equiv.run(512, seed=5, batch_size=256, journal=jpath)
    assert jrunner.equiv_partition.fingerprint in str(err.value)
    assert mm_tmr_equiv.equiv_partition.fingerprint in str(err.value)
    # Non-equivalence journals go on resuming across packages.
    plain = JRunner(jprog, strategy_name="TMR")
    ppath = str(tmp_path / "ref_plain.journal")
    with pytest.raises(_Kill):
        plain.run(1024, seed=5, batch_size=256, journal=ppath,
                  progress=kill_on_second())
    port = CampaignRunner(mm_tmr_equiv.prog, strategy_name="TMR")
    resumed = port.run(1024, seed=5, batch_size=256, journal=ppath)
    whole = port.run(1024, seed=5, batch_size=256)
    assert np.array_equal(resumed.codes, whole.codes)


# -- the sharded runner, the fused build, the training fallback --------------

@pytest.mark.parametrize("collect", ["dense", "sparse"])
def test_sharded_mesh_equiv_parity(mm_tmr, mm_tmr_equiv, collect):
    from coast_tpu_torch.parallel.mesh import make_mesh
    sharded = CampaignRunner(mm_tmr, strategy_name="TMR",
                             equiv=mm_tmr_equiv.equiv_partition,
                             mesh=make_mesh(8, device="cpu"),
                             collect=collect)
    a = mm_tmr_equiv.run(1024, seed=9, batch_size=256)
    b = sharded.run(1024, seed=9, batch_size=256)
    assert a.counts == b.counts
    assert a.physical_n == b.physical_n
    if collect == "dense":
        assert np.array_equal(a.codes, b.codes)
    else:
        rows = np.flatnonzero(a.codes > 1)
        assert np.array_equal(b.interesting_rows, rows)
        assert np.array_equal(b.codes, a.codes[rows])
    assert b.summary()["mesh"]["devices"] == 8


@pytest.mark.parametrize("name", ["matrixMultiply", "crc16"])
def test_fused_partition_equals_unfused(name):
    plain = CampaignRunner(port_prog(name, "TMR"), strategy_name="TMR",
                           equiv=True)
    fused = CampaignRunner(port_prog(name, "TMR", fuse_step=True),
                           strategy_name="TMR", equiv=True)
    assert (fused.equiv_partition.summary()
            == plain.equiv_partition.summary())
    a = plain.run(1024, seed=2, batch_size=256)
    b = fused.run(1024, seed=2, batch_size=256)
    assert a.counts == b.counts and np.array_equal(a.codes, b.codes)


@pytest.fixture(scope="module")
def train_tmr():
    return port_prog("train_mlp", "TMR")


def test_train_partition_typed_fallback(train_tmr):
    part = analyze_equivalence(train_tmr)
    assert part.fallback_reason == TRAIN_FALLBACK
    assert all(sig.mode == MODE_EXH for sig in part.signatures.values())
    assert part.summary()["fallback_reason"] == TRAIN_FALLBACK
    assert "fallback_reason" not in analyze_equivalence(
        port_prog("matrixMultiply", "TMR")).summary()
    for name in ("w1", "b1", "w2", "b2", "m_w1", "m_b2"):
        assert part.signatures[name].written
    for name in ("x", "y", "g_w1", "g_loss"):
        assert not part.signatures[name].written


def test_train_dead_class_still_merges(train_tmr):
    part = analyze_equivalence(train_tmr)
    n = 8
    sched = FaultSchedule(
        np.zeros(n, np.int32), np.arange(n, dtype=np.int32) % 3,
        np.arange(n, dtype=np.int32), np.arange(n, dtype=np.int32),
        np.concatenate([np.full(n // 2, part.clean_steps + 3, np.int32),
                        np.arange(n // 2, dtype=np.int32)]),
        np.zeros(n, np.int32), seed=0)
    keys = part.class_keys(sched)
    assert (keys[:n // 2] == -1).all()
    live = keys[n // 2:]
    assert len(np.unique(live, axis=0)) == len(live)
    assert len(part.reduce(sched)) == n // 2 + 1


# -- the CLI ------------------------------------------------------------------

FIXED_TS = "2026-01-01 00:00:00.000000"
VOLATILE = ("seconds", "injections_per_sec", "stages", "transfer_bytes")


@pytest.mark.parametrize("fmt", ["columnar", "ndjson"])
def test_supervisor_equiv_through_both_clis(fmt, tmp_path, capsys,
                                            monkeypatch):
    from coast_tpu.inject import logs as jlogs
    from coast_tpu.inject import supervisor as jsup
    from coast_tpu_torch.inject import supervisor
    monkeypatch.setattr(logs, "_timestamp", lambda: FIXED_TS)
    monkeypatch.setattr(jlogs, "_timestamp", lambda: FIXED_TS)
    argv = ["-f", "matrixMultiply", "-O=-TMR", "-t", "512", "--equiv",
            "--seed", "3", "--batch-size", "128", "--log-format", fmt,
            "-d", "cpu"]
    outs = {}
    for tag, main in (("port", supervisor.main), ("ref", jsup.main)):
        d = tmp_path / tag
        d.mkdir()
        assert main([*argv, "-l", str(d)]) == 0
        line = next(ln for ln in capsys.readouterr().out.splitlines()
                    if ln.startswith("{"))
        outs[tag] = {k: v for k, v in ast.literal_eval(line).items()
                     if k not in VOLATILE}
        outs[tag + "_log"] = (d / "matrixMultiply_TMR_memory.json"
                              ).read_text()
    assert outs["port"] == outs["ref"]
    assert outs["port"]["physical_injections"] < 512
    got, want = outs["port_log"], outs["ref_log"]
    if fmt == "ndjson":
        assert got.split("\n", 1)[1] == want.split("\n", 1)[1]
        assert '"weight": ' in got
    else:
        assert json.loads(got)["columns"] == json.loads(want)["columns"]
        assert "weight" in json.loads(got)["columns"]


def test_supervisor_equiv_flag_gates():
    from coast_tpu_torch.inject import supervisor
    for argv in (["--equiv", "--fault-model", "multibit(k=2)"],
                 ["--equiv", "--stratified"],
                 ["--delta-from", "x.journal", "--journal", "y.journal"],
                 ["--delta-from", "x.journal", "--collect", "sparse"]):
        with pytest.raises(SystemExit) as exc:
            supervisor.parse_command_line(
                ["-f", "matrixMultiply", "-t", "8", *argv])
        assert exc.value.code == -1


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("strat", ["TMR", "DWC"])
def test_weighted_sparse_equals_dense_on_card(cuda, strat):
    prog = STRATS[strat](REGISTRY["matrixMultiply"](), device=cuda)
    dense = CampaignRunner(prog, strategy_name=strat, equiv=True)
    sparse = CampaignRunner(prog, strategy_name=strat,
                            equiv=dense.equiv_partition, collect="sparse")
    a = dense.run(4096, seed=8, batch_size=1024)
    b = sparse.run(4096, seed=8, batch_size=1024)
    assert a.counts == b.counts and a.physical_n == b.physical_n
    rows = np.flatnonzero(a.codes > 1)
    assert np.array_equal(b.interesting_rows, rows)
    cpu = CampaignRunner(STRATS[strat](REGISTRY["matrixMultiply"](),
                                       device="cpu"),
                         strategy_name=strat, equiv=True).run(
        4096, seed=8, batch_size=1024)
    assert cpu.counts == a.counts


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["matrixMultiply", "crc16"])
def test_card_fingerprints_equal_cpu(cuda, name):
    from coast_tpu_torch.analysis.equiv import section_fingerprints
    card = TMR(REGISTRY[name](), device=cuda)
    host = TMR(REGISTRY[name](), device="cpu")
    assert section_fingerprints(card) == section_fingerprints(host)
    assert (analyze_equivalence(card).fingerprint
            == analyze_equivalence(host).fingerprint)
