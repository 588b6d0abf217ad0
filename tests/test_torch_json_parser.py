"""The port's campaign-log parser (``coast_tpu_torch/analysis``) against the
reference's (``coast_tpu/analysis/json_parser.py``).

Campaigns of both packages -- matrixMultiply unprotected/TMR/DWC,
crc16 fused, a sparse collect, ``multibit(k=3)``, rtos_mm with its DUE
sub-buckets and train_mlp with the train classes -- are written in every
log format, ``.gz`` included, and as a streamed ndjson log.  On each file
the port's ``summarize_path`` gives the reference's ``Summary``, field for
field; on a dense ndjson file it goes through the port's native classifier
(``csrc/ndjson.cpp``) and equals the Python path.  The CLI prints the
reference's bytes on stdout with its exit codes and ``--hist-out`` files.
The reference's own fixture logs (``tests/test_analysis.py``'s matrixMultiply
campaigns) are among the inputs.
"""

import dataclasses
import json
import math
import os
import shutil

import pytest
import torch

from coast_tpu_torch import native
from coast_tpu_torch.analysis import json_parser as jp
from coast_tpu_torch.inject import logs
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.inject.schedule import FaultModel
from coast_tpu_torch.models import REGISTRY
from coast_tpu_torch.passes.strategies import DWC, TMR, unprotected

torch.set_num_threads(1)

FIXED_TS = "2026-01-01 00:00:00.000000"

# name -> (region, strategy, runner keywords, rows)
CAMPAIGNS = {
    "mm_none": ("matrixMultiply", "none", {}, 200),
    "mm_tmr": ("matrixMultiply", "TMR", {}, 200),
    "mm_dwc": ("matrixMultiply", "DWC", {}, 200),
    "crc16_dwc_fused": ("crc16", "DWC", {"fuse_step": True}, 160),
    "crc16_tmr_sparse": ("crc16", "TMR", {"collect": "sparse"}, 160),
    "crc16_multibit3": ("crc16", "none",
                        {"fault_model": "multibit(k=3)"}, 160),
    "rtos_mm_dwc": ("rtos_mm", "DWC", {}, 256),
    "train_mlp_none": ("train_mlp", "none", {}, 192),
}
# writer -> file suffix
WRITERS = {"write_json": ".json", "write_ndjson": ".ndjson.json",
           "write_columnar": ".columnar.json",
           "write_reference_json": ".ref.json"}


def writers(name):
    """The formats a campaign is written in: every one, but the reference
    container holds no summary, so a sparse log cannot take it."""
    return {w: x for w, x in WRITERS.items()
            if "sparse" not in name or w != "write_reference_json"}


def build(name):
    region, strategy, kw, rows = CAMPAIGNS[name]
    kw = dict(kw)
    prog_kw = {"fuse_step": kw.pop("fuse_step")} if "fuse_step" in kw \
        else {}
    if "fault_model" in kw:
        kw["fault_model"] = FaultModel.parse(kw["fault_model"])
    make = {"none": unprotected, "TMR": TMR, "DWC": DWC}[strategy]
    runner = CampaignRunner(make(REGISTRY[region](), device="cpu",
                                 **prog_kw),
                            strategy_name=strategy, **kw)
    return runner, rows


@pytest.fixture(scope="module")
def log_dir(tmp_path_factory):
    """Every campaign in every format (and ``.gz``), a streamed ndjson log,
    and the reference's fixture logs."""
    from coast_tpu.inject import logs as jlogs
    d = tmp_path_factory.mktemp("logs")
    saved = (logs._timestamp, jlogs._timestamp)
    logs._timestamp = jlogs._timestamp = lambda: FIXED_TS
    try:
        for name in CAMPAIGNS:
            runner, rows = build(name)
            res = runner.run(rows, seed=3, batch_size=64)
            for writer, suffix in writers(name).items():
                for gz in ("", ".gz"):
                    if writer == "write_reference_json" and gz:
                        continue
                    getattr(logs, writer)(res, runner.mmap,
                                          str(d / f"{name}{suffix}{gz}"))
        runner, rows = build("mm_tmr")
        stream = logs.StreamLogWriter(str(d / "mm_tmr.stream.ndjson.json"),
                                      runner.mmap, fmt="ndjson")
        stream.finish(runner.run(rows, seed=3, batch_size=64,
                                 stream=stream))
        # The reference's fixture campaigns (tests/test_analysis.py).
        from coast_tpu import TMR as JTMR, unprotected as junprotected
        from coast_tpu.inject.campaign import CampaignRunner as JRunner
        from coast_tpu.models import mm as jmm
        for label, make in (("none", junprotected), ("TMR", JTMR)):
            jr = JRunner(make(jmm.make_region()), strategy_name=label)
            jres = jr.run(300, seed=11, batch_size=150)
            jlogs.write_json(jres, jr.mmap, str(d / f"ref_{label}.json"))
            jlogs.write_ndjson(jres, jr.mmap,
                               str(d / f"ref_{label}.ndjson.json.gz"))
    finally:
        logs._timestamp, jlogs._timestamp = saved
    return d


def fields(summary):
    """A Summary as a dict, NaN made comparable."""
    return {k: ("nan" if isinstance(v, float) and math.isnan(v) else v)
            for k, v in dataclasses.asdict(summary).items()}


def ref_parser():
    from coast_tpu.analysis import json_parser
    return json_parser


def test_every_log_summarizes_like_the_reference(log_dir):
    jjp = ref_parser()
    names = sorted(os.listdir(log_dir))
    assert len(names) > 50
    for fname in names:
        path = str(log_dir / fname)
        got, want = jp.summarize_path(path), jjp.summarize_path(path)
        assert fields(got) == fields(want), fname
        assert got.format() == want.format(), fname


def test_directory_summary_like_the_reference(log_dir):
    got = jp.summarize_path(str(log_dir))
    assert fields(got) == fields(ref_parser().summarize_path(str(log_dir)))


@pytest.mark.parametrize("name", sorted(CAMPAIGNS))
def test_counts_equal_the_campaign(name, log_dir):
    runner, rows = build(name)
    res = runner.run(rows, seed=3, batch_size=64)
    for suffix in writers(name).values():
        s = jp.summarize_path(str(log_dir / f"{name}{suffix}"))
        assert s.n == res.n
        assert {c: s.counts[c] for c in s.counts if s.counts[c]} == {
            c: v for c, v in res.counts.items() if v and c in s.counts}


def test_dense_ndjson_takes_the_native_path(log_dir):
    """A dense ndjson log is classified by the library, and the counts,
    runs and step mean equal the Python path's; a sparse one, whose counts
    come from its summary, takes the Python path."""
    for fname in sorted(os.listdir(log_dir)):
        if ".ndjson" not in fname:
            continue
        path = str(log_dir / fname)
        before = native.CLASSIFIED_LINES
        fast = jp.summarize_path(path)
        slow = jp.summarize_runs(fast.name,
                                 (doc for _, doc in jp._iter_docs(path)))
        sparse = "sparse" in fname
        assert (native.CLASSIFIED_LINES > before) == (not sparse), fname
        assert fast.n == slow.n and fast.counts == slow.counts, fname
        assert fields(fast)["mean_steps"] == fields(slow)["mean_steps"]


def test_native_classifier_chunks_and_refusals(log_dir):
    """The carry loop gives the same counts at any chunk size; a line that
    is not InjectionLog-shaped raises (the caller's Python fallback)."""
    path = str(log_dir / "rtos_mm_dwc.ndjson.json")
    with open(path, "rb") as f:
        f.readline()
        body = f.read()
    whole = native.ndjson_classify_stream(_reader(body), 1 << 20)
    for chunk in (7, 100, 4096):
        got = native.ndjson_classify_stream(_reader(body), chunk)
        assert got[1:] == whole[1:]
        assert (got[0] == whole[0]).all()
    assert whole[3] == jp.summarize_path(path).n
    with pytest.raises(ValueError):
        native.ndjson_classify_stream(_reader(b'{"no": 1}\n'))
    foreign = log_dir / "foreign.ndjson.txt"
    foreign.write_bytes(open(path, "rb").readline() + b'{"x": 1}\n')
    s = jp.summarize_path(str(foreign))
    assert s.n == 1 and s.counts["invalid"] == 1
    foreign.unlink()


def _reader(data: bytes):
    pos = [0]

    def read(n):
        out = data[pos[0]:pos[0] + n]
        pos[0] += n
        return out

    return read


def test_equivalence_weighted_logs_read_like_the_reference(tmp_path):
    """The ``physical_injections`` / ``weight`` column path (the logs of
    reduced campaigns: tests/test_torch_equiv.py writes them with the
    port)."""
    doc = {"summary": {"physical_injections": 3, "injections": 7},
           "columns": {"code": [0, 2, 4], "steps": [5, 6, 7],
                       "weight": [4, 2, 1], "leaf_id": [0, 0, 0],
                       "lane": [0, 0, 0], "word": [0, 1, 2],
                       "bit": [0, 0, 0], "t": [0, 1, 2],
                       "errors": [0, 1, 0], "corrected": [0, 0, 0]}}
    path = tmp_path / "weighted.json"
    path.write_text(json.dumps(doc))
    got = jp.summarize_path(str(path))
    assert fields(got) == fields(ref_parser().summarize_path(str(path)))
    assert got.n == 7 and got.physical_n == 3


def cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, out


@pytest.mark.parametrize("case", [
    "summary", "summary_gz", "compare_k", "compare_dir", "per_section",
    "registers_traps_no_summary", "histogram_out", "sparse_tables",
    "train", "rtos_due", "reference_fixture", "missing", "bad_flag",
    "k_without_path", "no_paths", "hist_out_without_path"])
def test_cli_equals_the_reference(case, log_dir, tmp_path, capsys):
    jjp = ref_parser()
    d = log_dir
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    shutil.copy(d / "mm_none.json", a / "none.json")
    shutil.copy(d / "mm_tmr.ndjson.json.gz", b / "tmr.json.gz")
    argv = {
        "summary": [str(d / "mm_tmr.json")],
        "summary_gz": [str(d / "crc16_dwc_fused.ndjson.json.gz")],
        "compare_k": [str(d / "mm_none.json"), "-k",
                      str(d / "mm_tmr.columnar.json")],
        "compare_dir": [str(a), "-d", str(b)],
        "per_section": [str(d / "mm_dwc.ref.json"), "-p", "-c"],
        "registers_traps_no_summary": [str(d / "mm_tmr.json"), "-n", "-r",
                                       "-t"],
        "histogram_out": [str(d / "crc16_multibit3.json"), "--hist-out",
                          "HIST"],
        "sparse_tables": [str(d / "crc16_tmr_sparse.ndjson.json"), "-p",
                          "-t"],
        "train": [str(d / "train_mlp_none.columnar.json.gz"), "-p"],
        "rtos_due": [str(d / "rtos_mm_dwc.json"), "-t", "-r"],
        "reference_fixture": [str(d / "ref_none.json"), "-k",
                              str(d / "ref_TMR.ndjson.json.gz"), "-p",
                              "-c"],
        "missing": [str(tmp_path / "typo.json")],
        "bad_flag": ["-x"],
        "k_without_path": ["a.json", "-k"],
        "no_paths": [],
        "hist_out_without_path": ["a.json", "--hist-out="],
    }[case]
    results = []
    for main, tag in ((jp.main, "port"), (jjp.main, "ref")):
        args = [str(tmp_path / f"{tag}.hist.json") if x == "HIST" else x
                for x in argv]
        results.append(cli(main, args, capsys))
    assert results[0] == results[1]
    if case == "histogram_out":
        assert ((tmp_path / "port.hist.json").read_bytes()
                == (tmp_path / "ref.hist.json").read_bytes())
    if case in ("missing", "bad_flag", "k_without_path", "no_paths"):
        assert results[0][0] in (1, 2)
