"""The port's campaign supervisor CLI against the reference's.

The same argv goes through ``coast_tpu.inject.supervisor.main`` (on the
CPU) and ``coast_tpu_torch.inject.supervisor.main`` (``-d cpu``), with the
log timestamp fixed in both packages.  The printed summaries are equal
outside the volatile keys, and so are the log files: every per-injection
line or row byte for byte, the reference format after its line 1 (which
names each package's own model module).  A journal one package wrote and
a kill cut short resumes under the other to the uninterrupted result.
Flags whose subsystem the port does not have yet exit 2 naming their
ROADMAP item; the shared refusals give the reference's messages.  The
port's cache schedules equal the reference's bit for bit.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from coast_tpu_torch.inject import logs, supervisor

torch.set_num_threads(1)

FIXED_TS = "2026-01-01 00:00:00.000000"
VOLATILE = ("seconds", "injections_per_sec", "stages", "transfer_bytes")


@pytest.fixture(autouse=True)
def fixed_timestamps(monkeypatch):
    from coast_tpu.inject import logs as jlogs
    monkeypatch.setattr(logs, "_timestamp", lambda: FIXED_TS)
    monkeypatch.setattr(jlogs, "_timestamp", lambda: FIXED_TS)


def ref_main(argv):
    from coast_tpu.inject import supervisor as jsup
    return jsup.main(argv)


def summary_of(stdout, volatile=VOLATILE):
    """The summary dict a supervisor printed, without its volatile keys."""
    line = next(ln for ln in stdout.splitlines() if ln.startswith("{"))
    return {k: v for k, v in ast.literal_eval(line).items()
            if k not in volatile}


def drive(main, argv, log_dir, capsys):
    log_dir.mkdir(exist_ok=True)
    rc = main([*argv, "-d", "cpu", "-l", str(log_dir)])
    assert rc == 0
    return capsys.readouterr().out


def assert_logs_equal(port_dir, ref_dir, fmt, volatile=VOLATILE):
    names = sorted(os.listdir(ref_dir))
    assert sorted(os.listdir(port_dir)) == names and names
    for name in names:
        got = (port_dir / name).read_bytes()
        want = (ref_dir / name).read_bytes()
        if fmt == "reference":
            assert got.split(b"\n", 1)[1] == want.split(b"\n", 1)[1]
            continue
        if fmt == "ndjson":
            head_g, rows_g = got.split(b"\n", 1)
            head_w, rows_w = want.split(b"\n", 1)
            assert rows_g == rows_w
            got_s = json.loads(head_g)["summary"]
            want_s = json.loads(head_w)["summary"]
        else:
            got_j, want_j = json.loads(got), json.loads(want)
            got_s, want_s = got_j.pop("summary"), want_j.pop("summary")
            assert json.dumps(got_j) == json.dumps(want_j)
        assert ({k: v for k, v in got_s.items() if k not in volatile}
                == {k: v for k, v in want_s.items() if k not in volatile})


# name -> argv (without -d/-l); each runs 100-1000 rows on the CPU.
CAMPAIGNS = {
    "t_mm_tmr_json": ["-f", "matrixMultiply", "-O", "-TMR", "-t", "240",
                      "--batch-size", "80", "--seed", "3"],
    "t_mm_dwc_start_num": ["-f", "matrixMultiply", "-O=-DWC", "-t", "150",
                           "--batch-size", "64", "--seed", "2",
                           "--start-num", "40", "--log-format", "columnar"],
    "t_crc16_fused_sparse_multibit": [
        "-f", "crc16", "-O", "-DWC -fuseStep", "-t", "200",
        "--batch-size", "64", "--collect", "sparse",
        "--fault-model", "multibit(k=4)", "--log-format", "ndjson"],
    "t_mm_stream_ndjson": ["-f", "matrixMultiply", "-t", "200",
                           "--batch-size", "64", "--stream-logs",
                           "--log-format", "ndjson"],
    "t_mm_stream_reference": ["-f", "matrixMultiply", "-t", "130",
                              "--batch-size", "50", "--stream-logs",
                              "--log-format", "reference"],
    "e_mm_tmr": ["-f", "matrixMultiply", "-O", "-TMR", "-e", "2",
                 "--batch-size", "100", "--seed", "4"],
    "stratified_crc16": ["-f", "crc16", "-t", "120", "--stratified",
                         "--log-format", "columnar"],
    "registers_crc16": ["-f", "crc16", "-s", "registers", "-t", "100",
                        "--batch-size", "50", "--seed", "5",
                        "--log-format", "reference"],
    "dcache_mm": ["-f", "matrixMultiply", "-s", "dcache", "-t", "120",
                  "--batch-size", "60", "--seed", "6"],
    "l2cache_crc16_unprotected": ["-f", "crc16", "-O", "", "-s",
                                  "l2cache", "-t", "100", "--seed", "7",
                                  "--log-format", "ndjson"],
    # The reference's voter switch (C1) on two of the BASELINE regions.
    "t_aes_tmr_pallas_voters": ["-f", "aes", "-O", "-TMR -pallasVoters",
                                "-t", "128", "--batch-size", "64",
                                "--seed", "3"],
    "t_quicksort_dwc_no_pallas_voters": [
        "-f", "quicksort", "-O", "-DWC -noPallasVoters", "-t", "64",
        "--batch-size", "64", "--log-format", "ndjson"],
    # The function-scope regions, CFCSS (BASELINE config 5) and segmented
    # scheduling, which the CLI's -O string reaches.
    "t_nestedCalls_tmr_ignore_fns": [
        "-f", "nestedCalls", "-O", "-TMR -ignoreFns=fold -countSyncs",
        "-t", "96", "--batch-size", "48", "--seed", "2"],
    "t_rtos_app_dwc_scope_lists": [
        "-f", "rtos_app", "--opt-passes=-DWC -configFile=rtos/functions.config"
        " -protectedLibFn=ring_push -cloneAfterCall=rng_next", "-t", "64",
        "--batch-size", "64", "--log-format", "ndjson"],
    "t_mm_tmr_cfcss_segmented": [
        "-f", "matrixMultiply", "-O", "-TMR -CFCSS -s", "-t", "120",
        "--batch-size", "60", "--seed", "4"],
    "text_crc16_cfcss_fused": [
        "-f", "crc16", "-O", "-DWC -CFCSS -fuseStep", "-s", "text", "-t",
        "100", "--seed", "8", "--log-format", "columnar"],
    # The sharded backend (--mesh: logical CPU shards here, the reference's
    # virtual CPU devices there; summaries carry the mesh block) and the
    # stencil under both voter placements.
    "t_mm_tmr_mesh2": ["-f", "matrixMultiply", "-O", "-TMR", "-t", "240",
                       "--batch-size", "80", "--seed", "3", "--mesh", "2"],
    "t_crc16_dwc_mesh4_sparse": [
        "-f", "crc16", "-O", "-DWC", "-t", "200", "--batch-size", "64",
        "--mesh", "4", "--collect", "sparse", "--log-format", "ndjson"],
    "t_mm_mesh8_ragged_columnar": [
        "-f", "matrixMultiply", "-t", "100", "--batch-size", "60",
        "--mesh", "8", "--seed", "5", "--log-format", "columnar"],
    "e_mm_tmr_mesh2": ["-f", "matrixMultiply", "-O", "-TMR", "-e", "2",
                       "--batch-size", "100", "--seed", "4", "--mesh", "2"],
    "interconnect_stencil_link_placement_link_model": [
        "-f", "stencil", "--placement", "link", "--fault-model", "link",
        "-s", "interconnect", "-t", "128", "--batch-size", "64",
        "--seed", "7"],
    "interconnect_stencil_compute_link_model_mesh2": [
        "-f", "stencil", "--fault-model", "link", "-s", "interconnect",
        "-t", "128", "--batch-size", "64", "--seed", "7", "--mesh", "2",
        "--log-format", "ndjson"],
    "t_stencil_link_tmr_fused_mesh2_sparse": [
        "-f", "stencil", "--placement", "link", "-O", "-TMR -fuseStep",
        "-t", "160", "--batch-size", "64", "--mesh", "2", "--collect",
        "sparse", "--log-format", "ndjson"],
    "t_stencil_compute_dwc_cluster_columnar": [
        "-f", "stencil", "-O", "-DWC", "--fault-model", "cluster(span=4,k=3)",
        "-t", "128", "--batch-size", "64", "--seed", "7", "--log-format",
        "columnar"],
    "registers_stencil_link_stream_reference": [
        "-f", "stencil", "--placement", "link", "-s", "registers", "-t",
        "96", "--batch-size", "48", "--stream-logs", "--log-format",
        "reference"],
    # --unroll N: the reference's early-exit loop unroll, clamped to >= 1
    # and classification-identical at any value.
    "t_mm_tmr_unroll2": ["-f", "matrixMultiply", "-O", "-TMR", "-t", "160",
                         "--batch-size", "80", "--seed", "3", "--unroll",
                         "2"],
    "t_crc16_dwc_unroll4_ndjson": ["-f", "crc16", "-O", "-DWC", "-t", "128",
                                   "--batch-size", "64", "--unroll", "4",
                                   "--log-format", "ndjson"],
    "stratified_stencil_link_placement": [
        "-f", "stencil", "--placement", "link", "-t", "120", "--stratified",
        "--log-format", "ndjson"],
}


def log_format(argv):
    return argv[argv.index("--log-format") + 1] if "--log-format" in argv \
        else "json"


@pytest.mark.parametrize("name", sorted(CAMPAIGNS))
def test_campaign_equals_the_reference(name, tmp_path, capsys):
    argv = CAMPAIGNS[name]
    got = drive(supervisor.main, argv, tmp_path / "port", capsys)
    want = drive(ref_main, argv, tmp_path / "ref", capsys)
    assert summary_of(got) == summary_of(want)
    assert got.splitlines()[-1].startswith("wrote ")
    assert_logs_equal(tmp_path / "port", tmp_path / "ref", log_format(argv))


def test_force_break_equals_the_reference(capsys):
    argv = ["-f", "matrixMultiply", "-b", "results:1:0:20:5", "-c", "2",
            "-q", "-d", "cpu"]
    assert supervisor.main(argv) == 0
    got = capsys.readouterr().out
    assert ref_main(argv) == 0
    want = capsys.readouterr().out
    assert got == want and got.count("forced injection") == 2


def cut_journal(path, batches):
    """What a kill leaves: the header and the first ``batches`` records."""
    with open(path) as f:
        lines = f.readlines()
    with open(path, "w") as f:
        f.writelines(lines[:1 + batches])


@pytest.mark.parametrize("killed_by", ["port", "reference"])
@pytest.mark.parametrize("case", [
    ["-f", "matrixMultiply", "-O", "-TMR", "-t", "300", "--batch-size", "60",
     "--seed", "9", "--log-format", "ndjson", "--stream-logs"],
    ["-f", "crc16", "-O", "-DWC -fuseStep", "-t", "240", "--batch-size",
     "60", "--collect", "sparse", "--fault-model", "multibit(k=4)",
     "--log-format", "json"],
    ["-f", "chstone_motion", "-O", "-TMR -pallasVoters", "-t", "300",
     "--batch-size", "60", "--seed", "5", "--log-format", "json"],
    ["-f", "stencil", "--placement", "link", "--fault-model", "link", "-t",
     "300", "--batch-size", "60", "--seed", "7", "--mesh", "2",
     "--log-format", "ndjson", "--stream-logs"],
    ["-f", "stencil", "-O", "-DWC -fuseStep", "-t", "300", "--batch-size",
     "60", "--collect", "sparse", "--mesh", "4", "--log-format", "json"],
    ["-f", "crc16", "-O", "-TMR", "-t", "240", "--batch-size", "60",
     "--seed", "2", "--unroll", "2", "--log-format", "ndjson"],
], ids=["mm_tmr_dense", "crc16_dwc_fused_sparse", "motion_tmr_pallas_voters",
        "stencil_link_mesh2_streamed", "stencil_dwc_fused_sparse_mesh4",
        "crc16_tmr_unroll2"])
def test_journal_resume_across_packages(case, killed_by, tmp_path, capsys):
    """A journal cut after two batches resumes under the other package to
    the uninterrupted run's summary and log."""
    full = drive(supervisor.main, case, tmp_path / "full", capsys)
    j = str(tmp_path / "j.ndjson")
    first, second = ((supervisor.main, ref_main) if killed_by == "port"
                     else (ref_main, supervisor.main))
    drive(first, [*case, "--journal", j], tmp_path / "killed", capsys)
    cut_journal(j, 2)
    resumed = drive(second, [*case, "--journal", j, "--resume"],
                    tmp_path / "resumed", capsys)
    # The mesh block's ledger counts the interesting rows this process ran,
    # not the replayed batches' (the reference's rule): its geometry and
    # everything else equal the uninterrupted run's.
    volatile = (*VOLATILE, "mesh")
    assert summary_of(resumed, volatile) == summary_of(full, volatile)
    if "--mesh" in case:
        got = summary_of(resumed)["mesh"]
        want = summary_of(full)["mesh"]
        assert got["axes"] == want["axes"]
        assert sum(got["per_shard_interesting"]) <= sum(
            want["per_shard_interesting"])
    assert_logs_equal(tmp_path / "resumed", tmp_path / "full",
                      log_format(case), volatile)
    with open(j) as f:
        records = [json.loads(ln) for ln in f]
    assert sum(r.get("kind") == "batch" for r in records) == 5 - (
        "crc16" in case)
    if "--placement" in case:
        assert records[0]["placement"] == "link"


UNPORTED = [
    (["--static-budget"], "needs --delta-from AND --stop-when"),
    (["--slo", "sdc<0.1"], "bad --slo spec"),
    (["-d", "tpu"], "coast_tpu.inject.supervisor"),
    (["-f", "prog.c"], "Error, file prog.c does not exist!"),
]


@pytest.mark.parametrize("extra,why", UNPORTED,
                         ids=[" ".join(a) for a, _ in UNPORTED])
def test_unported_flag_refused_with_its_item(extra, why, capsys):
    argv = ["-f", "matrixMultiply", "-t", "4", "-q", "-d", "cpu", *extra]
    if extra[0] == "--slo":
        # Item 19a landed: the flag is ported, and a malformed spec is
        # refused (exit 1) with the reference's message.
        assert supervisor.main(argv) == 1
        err = capsys.readouterr().err
        assert why in err
        from coast_tpu.inject import supervisor as jsup
        assert jsup.main(argv) == 1
        assert capsys.readouterr().err.strip().splitlines()[-1] \
            == err.strip().splitlines()[-1]
        return
    with pytest.raises(SystemExit) as exc:
        supervisor.main(argv)
    if extra == ["--static-budget"]:
        # Item 17c landed: the flag is ported, and refused as the
        # reference refuses it without --delta-from and --stop-when.
        err = capsys.readouterr().err
        assert exc.value.code == -1 and why in err
        with pytest.raises(SystemExit) as ref_exc:
            from coast_tpu.inject import supervisor as jsup
            jsup.parse_command_line(argv)
        assert ref_exc.value.code == -1
        assert capsys.readouterr().err.strip().splitlines()[-1] \
            == err.strip().splitlines()[-1]
        return
    if extra[0] == "-f":
        # Item 17d landed: a .c program is lifted, and a missing one is
        # refused as the reference refuses it.
        err = capsys.readouterr().err
        assert exc.value.code == -1 and why in err
        with pytest.raises(SystemExit) as ref_exc:
            from coast_tpu.inject import supervisor as jsup
            jsup.main(argv)
        assert ref_exc.value.code == -1
        assert capsys.readouterr().err.strip().splitlines()[-1] \
            == err.strip().splitlines()[-1]
        return
    assert exc.value.code == 2
    assert why in capsys.readouterr().err


def refusal(main, argv, capsys):
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    return rc, capsys.readouterr().err.strip().splitlines()[-1]


@pytest.mark.parametrize("case", [
    "resume_without_journal", "journal_exists", "journal_with_force_break",
    "stream_with_json", "sparse_with_e", "board_pynq", "unknown_benchmark",
    "missing_log_dir", "bad_fault_model", "bad_stop_when",
    "pallas_voters_pair", "placement_without_knob", "stratified_link_model",
    "stencil_unknown_placement",
])
def test_shared_refusals_give_the_reference_messages(case, tmp_path, capsys):
    existing = tmp_path / "old.ndjson"
    existing.write_text('{"kind": "header"}\n')
    base = ["-f", "matrixMultiply", "-t", "4", "-d", "cpu", "-q"]
    argv = {
        "resume_without_journal": [*base, "--resume"],
        "journal_exists": [*base, "--journal", str(existing)],
        "journal_with_force_break": [*base, "--journal",
                                     str(tmp_path / "new.ndjson"),
                                     "-b", "results:1:0:20:5"],
        "stream_with_json": [*base[:-1], "--stream-logs"],
        "sparse_with_e": [*base, "-e", "3", "--collect", "sparse"],
        "board_pynq": ["-f", "matrixMultiply", "-d", "pynq"],
        "unknown_benchmark": ["-f", "noSuchBench", "-d", "cpu"],
        "missing_log_dir": [*base[:-1], "-l", str(tmp_path / "nowhere")],
        "bad_fault_model": [*base, "--fault-model", "multibit(k=0)"],
        "bad_stop_when": [*base, "--stop-when", "sdc:2"],
        "pallas_voters_pair": [*base, "-O",
                               "-TMR -pallasVoters -noPallasVoters"],
        # The stencil's --placement knob (ROADMAP item 16, landed): refused
        # on a benchmark without it, and with the link model's strata.
        "placement_without_knob": [*base, "--placement", "link"],
        "stratified_link_model": ["-f", "stencil", "-t", "8", "-d", "cpu",
                                  "-q", "--stratified", "--fault-model",
                                  "link"],
        "stencil_unknown_placement": ["-f", "stencil", "-d", "cpu", "-q",
                                      "--placement", "wire"],
    }[case]
    assert refusal(supervisor.main, argv, capsys) == refusal(ref_main, argv,
                                                             capsys)


@pytest.mark.parametrize("passes", ["-TMR -pallasVoters",
                                    "-DWC -noPallasVoters", "-TMR"])
def test_voter_switch_config_sha_equals_the_reference(passes):
    """C1: -pallasVoters / -noPallasVoters parse to the reference's config,
    so the journal header's config_sha is the reference's."""
    import coast_tpu
    from coast_tpu import opt as jopt
    from coast_tpu.inject.journal import config_fingerprint as jsha

    import coast_tpu_torch as ct
    from coast_tpu_torch import opt
    from coast_tpu_torch.inject.journal import config_fingerprint
    argv = passes.split()
    jover = jopt.build_overrides(jopt.parse_argv(argv)[0])
    over = opt.build_overrides(opt.parse_argv(argv)[0])
    assert over == jover
    n = 3 if "-TMR" in argv else 2
    cfg = ct.ProtectionConfig(num_clones=n, **over)
    assert cfg.pallas_voters is jover.get("pallas_voters")
    assert config_fingerprint(cfg) == jsha(
        coast_tpu.ProtectionConfig(num_clones=n, **jover))


def test_stop_when_campaign_equals_the_reference(tmp_path, capsys):
    argv = ["-f", "matrixMultiply", "-t", "400", "--batch-size", "50",
            "--stop-when", "corrected:0.05;min=100", "--log-format",
            "ndjson"]
    got = drive(supervisor.main, argv, tmp_path / "port", capsys)
    want = drive(ref_main, argv, tmp_path / "ref", capsys)
    assert summary_of(got) == summary_of(want)
    assert summary_of(got)["convergence"]["stopped"]
    assert_logs_equal(tmp_path / "port", tmp_path / "ref", "ndjson")


# -- hierarchy ----------------------------------------------------------------

@pytest.mark.parametrize("bench", ["matrixMultiply", "crc16"])
@pytest.mark.parametrize("cache", ["dcache", "l2cache", None])
def test_cache_schedule_equals_the_reference(bench, cache):
    import coast_tpu
    from coast_tpu.inject import hierarchy as jh
    from coast_tpu.inject.mem import MemoryMap as JMemoryMap
    from coast_tpu.models import REGISTRY as JREGISTRY

    import coast_tpu_torch as ct
    from coast_tpu_torch.inject import hierarchy as th
    from coast_tpu_torch.inject.mem import MemoryMap
    from coast_tpu_torch.models import REGISTRY

    prog = ct.TMR(REGISTRY[bench](), device="cpu")
    jprog = coast_tpu.TMR(JREGISTRY[bench]())
    got = th.generate_cache_schedule(MemoryMap(prog), th.MemHierarchy("gpu"),
                                     300, 13, prog.region.nominal_steps,
                                     cache)
    want = jh.generate_cache_schedule(JMemoryMap(jprog),
                                      jh.MemHierarchy("tpu"), 300, 13,
                                      jprog.region.nominal_steps, cache)
    for f in ("leaf_id", "lane", "word", "bit", "t", "section_idx"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.seed == want.seed
    assert th.RegisterFile(prog).names == jh.RegisterFile(jprog).names
