"""Campaign supervisor CLI of the port: the simulation/platform/supervisor.py
surface on the card.

The counterpart of ``coast_tpu/inject/supervisor.py``, with its flags, its
section vocabulary, its cross-flag refusals and messages, its summary line
and its logs::

    python -m coast_tpu_torch.inject.supervisor -f matrixMultiply -s memory -t 1000
    python -m coast_tpu_torch.inject.supervisor -f crc16 -O "-DWC" -s registers -t 500
    python -m coast_tpu_torch.inject.supervisor -f matrixMultiply -O "-TMR" \\
        -t 1000000 --batch-size 65536 --journal j.ndjson --stream-logs \\
        --log-format ndjson -l logs/

It runs on the card (``--board gpu``, the default; a host without one is an
error) unless ``-d cpu`` asks for the host.  A ``--journal`` campaign killed
at any point resumes with ``--resume`` at its first missing batch and gives
the uninterrupted run's codes, counts and log lines.

``--equiv`` reduces a seeded ``-t`` campaign to one representative a
propagation class (``analysis/equiv``), the counts weighted back to ``-t``;
``--delta-from JOURNAL`` re-injects only the sections whose propagation
fingerprint changed since that ``--equiv --journal`` run and splices the
rest (it implies ``--equiv``); ``--static-budget`` (with ``--delta-from``
and ``--stop-when``) re-injects the static vulnerability map's
``sdc-possible`` sections first and relaxes the ``min_done`` floor of the
proven ones.

``--mesh N`` splits the campaign batch over N shards
(``parallel/mesh.py``: the first N cards, or N logical shards of the host
with ``-d cpu``), and ``--placement link`` builds the exchange-then-vote
stencil (``models/stencil.py``).

Observability (``coast_tpu_torch/obs``): ``--metrics-port`` serves the
live metrics hub (``/metrics``, ``/status``), ``--status-json`` mirrors
its status document to a file, ``--heartbeat`` / ``--console`` print live
progress, ``--trace-out`` writes the campaign's Perfetto trace and
``--profile`` adds per-dispatch device-time attribution and the roofline
block to the summary, and ``--slo SPEC`` evaluates a reliability SLO set
live (``obs/slo``: the verdicts ride ``/status``, ``/metrics``, the
heartbeat and console line, and ``summary()["slo"]``).  ``--unroll N`` is
accepted and clamped to at least 1, as the reference does: it changes no
record.  ``--port-range`` is accepted and ignored, as the reference
does.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from coast_tpu_torch.inject.hierarchy import DCACHE_KINDS, ICACHE_KINDS
from coast_tpu_torch.ir.region import KIND_STACK

#: Geometry-overlay sections: these draw their own cache schedules
#: (coast_tpu_torch.inject.hierarchy), outside the seeded generate() paths.
CACHE_SECTIONS = ("cache", "icache", "dcache", "l2cache")

SECTION_CHOICES = ["stack", "text", "rodata", "data", "bss", "heap", "init",
                   "registers", "memory", "params", "opt_state",
                   "interconnect", *CACHE_SECTIONS]

_KIND_SECTIONS = {
    "memory": (*DCACHE_KINDS, "link"),
    "interconnect": ("link",),
    "data": ("mem",),
    "bss": ("mem",),
    "heap": ("mem",),
    "init": ("mem",),
    "rodata": ("ro",),
    "registers": ("reg", "ctrl"),
    "text": ICACHE_KINDS,
    "params": ("param",),
    "opt_state": ("opt_state",),
}

def parse_command_line(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        description="Supervisor for batched fault injection on the card")
    parser.add_argument("--filename", "-f", type=str, required=True,
                        help="program to run: a benchmark registry name")
    parser.add_argument("--port-range", "-p", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("-t", metavar="N", type=int, default=1,
                        help="number of injections")
    parser.add_argument("-e", "--errorCount", metavar="N", type=int,
                        help="run until N errors seen, then complete the "
                        "next 1000 injections")
    parser.add_argument("--section", "-s", type=str, default="memory",
                        choices=SECTION_CHOICES,
                        help="memory section to inject faults into")
    parser.add_argument("--board", "-d", type=str, default="gpu",
                        choices=["gpu", "cpu", "tpu", "pynq", "hifive1"],
                        help="execution backend: gpu (the card, default) or "
                        "cpu (the host)")
    parser.add_argument("--opt-passes", "-O", type=str, default="-TMR",
                        help="protection to apply (opt CLI flag string). "
                        "All of `-O -TMR`, `-O '-TMR -countErrors'` and "
                        "`--opt-passes=-TMR` work; pass flags that "
                        "collide with supervisor flags (e.g. the `-s` "
                        "segmenting flag) need the quoted or `=` form")
    parser.add_argument("--log-dir", "-l", type=str, default=None,
                        help="directory in which to create the log files")
    parser.add_argument("--no-logging", "-q", action="store_true",
                        help="do not produce log files")
    parser.add_argument("--verbosity", "-v", default="n",
                        choices=["n", "c", "e", "s", "i", "a"])
    parser.add_argument("--forceBreak", "-b", metavar="EXPRESSION", type=str,
                        help="forced injection leaf:lane:word:bit:t")
    parser.add_argument("--breakCount", "-c", metavar="ITERATION", type=int,
                        default=1, help="how many forced injections to run")
    parser.add_argument("--seed", type=int, default=0,
                        help="campaign schedule seed (replayable)")
    parser.add_argument("--start-num", type=int, default=0,
                        help="resume the seeded campaign at injection #N")
    parser.add_argument("--batch-size", type=int, default=4096)
    parser.add_argument("--unroll", type=int, default=1,
                        help="early-exit loop steps per iteration in the "
                        "reference's batched runner; accepted and clamped "
                        "to >= 1, classification-identical at any value")
    parser.add_argument("--fault-model", type=str, default="single",
                        metavar="SPEC",
                        help="what one injection IS: 'single' (default), "
                        "'multibit(k=K)', 'cluster(span=S,k=K)', "
                        "'burst(window=W,rate=R)' or 'link' / "
                        "'link(offset=O,period=P)' (one bit in the "
                        "in-flight interconnect buffers of a sharded "
                        "region; bare 'link' takes the region's own "
                        "window).  Colon form works too (multibit:k=3).  "
                        "Recorded in the log summary and the journal "
                        "header; resume under a different model is "
                        "refused with a typed error")
    parser.add_argument("--placement", type=str, default="compute",
                        choices=["compute", "link"],
                        help="voter placement of a sharded halo-exchange "
                        "benchmark (stencil): 'compute' votes before the "
                        "exchange (a compute flip stays in its shard; a "
                        "flip on the link is the blind spot), 'link' "
                        "votes after it (the receiver's majority repairs "
                        "a link flip; the pack is a single point of "
                        "failure).  Campaign identity: it joins the "
                        "journal header, and resume under the other "
                        "placement is refused with a typed error")
    parser.add_argument("--equiv", action="store_true",
                        help="fault-site equivalence reduction: partition "
                        "the site space into propagation classes, inject "
                        "one representative a class and weight the "
                        "counts by the class sizes (the distribution over "
                        "effective injections equals the exhaustive "
                        "campaign's).  Seeded -t campaigns, single-bit "
                        "fault model only")
    parser.add_argument("--delta-from", type=str, default=None,
                        metavar="JOURNAL",
                        help="delta campaign: re-inject only the sections "
                        "whose propagation fingerprint changed since "
                        "JOURNAL (a completed --equiv --journal run of the "
                        "same campaign) and splice the recorded outcomes "
                        "of the rest.  Implies --equiv; with --stop-when "
                        "each re-injected section converges on its own")
    parser.add_argument("--static-budget", action="store_true",
                        help="delta campaigns: allocate the per-section "
                        "convergence budget by the static vulnerability "
                        "map (analysis/propagation) -- sdc-possible "
                        "sections re-inject first, and sections the map "
                        "proves masked/detected-bounded run under a "
                        "quartered --stop-when min floor (same per-class "
                        "thresholds, fewer physical injections).  Needs "
                        "--delta-from")
    parser.add_argument("--stratified", action="store_true",
                        help="equal-allocation sampling per section: -t "
                        "is divided across sections (floored at 1 each)")
    parser.add_argument("--log-format", type=str, default="json",
                        choices=["json", "ndjson", "columnar", "reference"],
                        help="log writer: json = reference InjectionLog "
                        "schema, ndjson/columnar = bulk formats, reference "
                        "= the reference tool's own container")
    parser.add_argument("--collect", type=str, default="dense",
                        choices=["dense", "sparse"],
                        help="result-collection mode: 'dense' (default) "
                        "fetches every row's outcome columns; 'sparse' "
                        "keeps the loop device-resident and fetches the "
                        "class histogram and the interesting rows only.  "
                        "Campaign identity (journaled)")
    parser.add_argument("--stream-logs", action="store_true",
                        help="serialize the log in a background thread as "
                        "each batch is collected (the one-shot writer's "
                        "bytes); ndjson/columnar/reference formats")
    parser.add_argument("--mesh", type=int, default=None, metavar="N",
                        help="split the campaign batch over N shards (the "
                        "first N cards; N logical shards of the host with "
                        "-d cpu): codes and counts equal the single-device "
                        "run's at the same seed")
    parser.add_argument("--journal", type=str, default=None,
                        help="append-only campaign journal: every "
                        "collected batch (or chunk, with -e) is fsync'd "
                        "here so a crash/SIGKILL loses nothing; relaunch "
                        "with --resume to continue at the first missing "
                        "batch with identical results")
    parser.add_argument("--resume", action="store_true",
                        help="resume the campaign recorded in --journal "
                        "(its header must match this invocation)")
    parser.add_argument("--stop-when", type=str, default=None,
                        metavar="SPEC",
                        help="statistical early stop, e.g. "
                        "'sdc:0.002;min=4096': stop once every target "
                        "class's Wilson CI half-width is at or below its "
                        "threshold")
    parser.add_argument("--metrics-port", type=int, default=None,
                        metavar="PORT",
                        help="serve live campaign metrics over HTTP on "
                        "127.0.0.1:PORT while the campaign runs: "
                        "/metrics is Prometheus text exposition, "
                        "/status the full JSON document (rates with "
                        "Wilson CIs, time-series rings, stage totals). "
                        "0 picks an ephemeral port (printed)")
    parser.add_argument("--status-json", type=str, default=None,
                        metavar="PATH",
                        help="mirror the live JSON status document to "
                        "PATH, atomically replaced after every "
                        "collected batch -- the headless-fleet "
                        "observation surface (a scraper never sees a "
                        "torn file)")
    parser.add_argument("--heartbeat", type=float, default=0.0,
                        metavar="SECONDS",
                        help="rate-limited one-line progress heartbeat "
                        "on stderr every SECONDS (0 disables); the "
                        "final state is always flushed, even on a "
                        "wedged campaign")
    parser.add_argument("--console", action="store_true",
                        help="live TTY dashboard on stderr (progress "
                        "bar, per-class rates with Wilson CI bars, "
                        "stage breakdown) repainted in place; replaces "
                        "the bare --heartbeat line")
    parser.add_argument("--trace-out", type=str, default=None,
                        metavar="PATH",
                        help="write the campaign's Chrome/Perfetto "
                        "trace_event JSON here at the end (per-batch "
                        "spans; on a resumed --journal campaign the "
                        "crashed run's recorded batches are included, "
                        "marked as replayed)")
    parser.add_argument("--profile", action="store_true",
                        help="per-dispatch device-time attribution: "
                        "measure each batch's device-busy duration and "
                        "host-side gap (ready-event timing), record the summary profile/mfu "
                        "blocks (roofline accounting), feed the "
                        "dispatch-latency histograms to --metrics-port, "
                        "and put device spans on their own --trace-out "
                        "track.  Outputs are byte-identical either way")
    parser.add_argument("--slo", type=str, default=None, metavar="SPEC",
                        help="declarative reliability SLO set evaluated "
                        "live over the campaign's own evidence, e.g. "
                        "'sdc_rate<=0.002,availability>=0.99;min=4096': "
                        "Wilson-backed attainment, error budgets, and "
                        "burn verdicts ride /status, /metrics, the "
                        "heartbeat/console line, and summary()['slo']")
    parser.add_argument("--max-retries", type=int, default=0,
                        help="retry transient dispatch failures up to N "
                        "times per batch (exponential backoff + jitter); "
                        "an out-of-memory failure halves the batch size "
                        "instead.  0 keeps failures fatal")
    parser.add_argument("--collect-timeout", type=float, default=None,
                        help="watchdog seconds on the device-to-host copy "
                        "of a batch's results: a wedged batch raises "
                        "CampaignWedgedError and is re-dispatched; implies "
                        "retries even if --max-retries is 0")
    # `-O -TMR` ergonomics: pre-join the pass flags following -O into
    # `-O=<flags>` before argparse sees them; tokens that ARE supervisor
    # options stop the join.
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    known = {s for a in parser._actions for s in a.option_strings}
    joined, i = [], 0
    while i < len(argv):
        tok = argv[i]
        if tok in ("-O", "--opt-passes") and i + 1 < len(argv):
            passes, j = [], i + 1
            while (j < len(argv) and argv[j].startswith("-")
                   and argv[j] not in known):
                passes.append(argv[j])
                j += 1
            if passes:
                joined.append(tok + "=" + " ".join(passes))
                i = j
                continue
        joined.append(tok)
        i += 1
    args = parser.parse_args(joined)

    if args.board == "tpu":
        print("Error, --board tpu is the JAX package's board (python -m "
              "coast_tpu.inject.supervisor); this port runs on gpu or cpu",
              file=sys.stderr)
        sys.exit(2)
    if args.port_range is not None:
        print("Warning, --port-range/-p is deprecated and ignored: the "
              "GDB/QEMU port fabric it parceled out no longer exists",
              file=sys.stderr)
    if args.board in ("pynq", "hifive1"):
        print("This board not yet supported in this version", file=sys.stderr)
        sys.exit(-1)
    if args.stratified and (args.errorCount or args.start_num
                            or args.section in CACHE_SECTIONS):
        print("Error, --stratified cannot be combined with -e/--errorCount, "
              "--start-num, or cache sections (those draw their own "
              "schedules; strata are separately seeded streams)",
              file=sys.stderr)
        sys.exit(-1)
    if args.errorCount and args.start_num:
        print("Error, --start-num cannot be combined with -e/--errorCount",
              file=sys.stderr)
        sys.exit(-1)
    if args.log_dir and not os.path.isdir(args.log_dir):
        print(f"Error, directory {args.log_dir} does not exist!",
              file=sys.stderr)
        sys.exit(-1)
    if args.resume and not args.journal:
        print("Error, --resume requires --journal (there is nothing to "
              "resume from)", file=sys.stderr)
        sys.exit(-1)
    if args.fault_model != "single":
        from coast_tpu_torch.inject.schedule import FaultModel
        try:
            args.fault_model_parsed = FaultModel.parse(args.fault_model)
        except ValueError as e:
            print(f"Error, bad --fault-model: {e}", file=sys.stderr)
            sys.exit(-1)
        if args.forceBreak or args.section in CACHE_SECTIONS:
            print("Error, --fault-model applies to the seeded campaign "
                  "paths (-t/-e/--stratified), not --forceBreak or cache "
                  "sections", file=sys.stderr)
            sys.exit(-1)
        if args.fault_model_parsed.kind == "link" and args.stratified:
            print("Error, --stratified contradicts --fault-model link "
                  "(link draws target only the interconnect sections; "
                  "use the seeded -t path)", file=sys.stderr)
            sys.exit(-1)
    else:
        args.fault_model_parsed = None
    if args.stream_logs and (args.no_logging or args.errorCount
                             or args.forceBreak
                             or args.log_format == "json"):
        print("Error, --stream-logs needs a single-schedule campaign "
              "with --log-format ndjson/columnar/reference (not -e/"
              "--errorCount, --forceBreak, -q/--no-logging, or the "
              "default json format)", file=sys.stderr)
        sys.exit(-1)
    if args.delta_from:
        args.equiv = True      # the fingerprints come from the partition
    if args.equiv and (args.forceBreak or args.stratified or args.errorCount
                       or args.section in CACHE_SECTIONS):
        # The partition reasons over the seeded generate() stream.
        print("Error, --equiv/--delta-from apply to the seeded -t "
              "campaign path, not -e/--errorCount, --stratified, "
              "--forceBreak, or cache sections", file=sys.stderr)
        sys.exit(-1)
    if args.equiv and args.fault_model != "single":
        print("Error, --equiv needs the single-bit fault model (a flip "
              "group has no per-site propagation class)", file=sys.stderr)
        sys.exit(-1)
    if args.delta_from and (args.journal or args.resume
                            or args.stream_logs):
        print("Error, --delta-from reads its journal as the splice base; "
              "it cannot be combined with --journal/--resume/"
              "--stream-logs", file=sys.stderr)
        sys.exit(-1)
    if args.static_budget and not (args.delta_from and args.stop_when):
        # Without a stop condition there is no per-section budget to
        # allocate: the flag would record a block for a run it never
        # shaped.
        print("Error, --static-budget allocates a delta campaign's "
              "per-section convergence budget; it needs --delta-from "
              "AND --stop-when", file=sys.stderr)
        sys.exit(-1)
    if args.collect == "sparse":
        if args.errorCount or args.forceBreak or args.delta_from:
            print("Error, --collect sparse applies to the seeded -t/"
                  "--stratified/cache campaign paths, not -e/"
                  "--errorCount, --forceBreak, or --delta-from",
                  file=sys.stderr)
            sys.exit(-1)
        if args.stream_logs and args.log_format != "ndjson":
            print("Error, --collect sparse with --stream-logs supports "
                  "--log-format ndjson only (sparse rows have no "
                  "streaming columnar/reference form)", file=sys.stderr)
            sys.exit(-1)
        if args.log_format == "reference" and not args.no_logging:
            print("Error, --collect sparse needs a summary-carrying "
                  "--log-format (json/ndjson/columnar): the reference "
                  "container has no summary block to hold the sparse "
                  "histogram counts", file=sys.stderr)
            sys.exit(-1)
    if args.stop_when:
        from coast_tpu_torch.obs.convergence import StopWhen, StopWhenError
        if args.errorCount or args.forceBreak:
            print("Error, --stop-when applies to the seeded/stratified/"
                  "cache/delta campaign paths, not -e/--errorCount or "
                  "--forceBreak", file=sys.stderr)
            sys.exit(-1)
        try:
            args.stop_when_parsed = StopWhen.parse(args.stop_when)
        except StopWhenError as e:
            print(f"Error, bad --stop-when: {e}", file=sys.stderr)
            sys.exit(-1)
    else:
        args.stop_when_parsed = None
    if args.journal and (args.forceBreak or args.stratified
                         or args.section in CACHE_SECTIONS):
        print("Error, --journal supports the seeded campaign paths (-t/"
              "-e), not --forceBreak, --stratified, or cache sections",
              file=sys.stderr)
        sys.exit(-1)
    return args


def build_program(bench: str, opt_passes: str, device: str,
                  placement: str = "compute"):
    """Build the protected program from an opt-CLI flag string, with the
    opt parser's own flag semantics.  ``placement`` other than
    ``compute`` goes to the benchmark's factory, and a benchmark without
    the knob is refused.  A benchmark or flag the port does not have yet
    exits 2 with its ROADMAP item."""
    from coast_tpu_torch.frontend import LiftError
    from coast_tpu_torch.interface.config import ConfigError
    from coast_tpu_torch.models import resolve_region
    from coast_tpu_torch.opt import UsageError, build_overrides, parse_argv
    from coast_tpu_torch.passes.strategies import DWC, TMR, unprotected
    try:
        # Only the sharded halo-exchange benchmark takes the knob: passing
        # the default to every factory would hide "no such knob".  A .c
        # path is lifted (the reference's -f takes the program by file).
        if placement != "compute":
            region = resolve_region(bench, device=device,
                                    placement=placement)
        else:
            region = resolve_region(bench, device=device)
    except (FileNotFoundError, KeyError):
        print(f"Error, file {bench} does not exist!", file=sys.stderr)
        sys.exit(-1)
    except LiftError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        sys.exit(-1)
    except TypeError:
        print(f"Error, benchmark {bench} has no --placement knob (voter "
              "placement applies to sharded halo-exchange regions, e.g. "
              "stencil)", file=sys.stderr)
        sys.exit(-1)
    except NotImplementedError as e:
        print(f"Error, {e}", file=sys.stderr)
        sys.exit(2)
    try:
        flags, positional = parse_argv(opt_passes.split())
        if positional:
            raise UsageError(
                f"unexpected positional argument(s) in -O: {positional}")
        if flags.get("i") and flags.get("s"):
            raise UsageError("-i and -s are mutually exclusive")
        overrides = build_overrides(flags)
    except (UsageError, ConfigError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        sys.exit(-1)
    # The supervisor always wants the correction counter (it feeds the
    # 'faults' column of the logs).
    overrides["count_errors"] = True
    try:
        if flags.get("TMR"):
            return TMR(region, device=device, **overrides), "TMR"
        if flags.get("DWC"):
            return DWC(region, device=device, **overrides), "DWC"
        return unprotected(region, device=device, **overrides), "unprotected"
    except NotImplementedError as e:
        print(f"Error, {e}", file=sys.stderr)
        sys.exit(2)


def section_filter(prog, section: str):
    """CLI section choice -> MemoryMap ``sections`` argument (kind names or
    leaf names), or None for the full map (cache overlays)."""
    if section in _KIND_SECTIONS:
        return _KIND_SECTIONS[section]
    if section == "stack":
        # Both stack notions: the -protectStack frames (LeafSpec.stack)
        # and the rtos kernel's per-task KIND_STACK stacks.
        names = [n for n, s in prog.region.spec.items()
                 if s.stack or s.kind == KIND_STACK]
        if not names:
            print(f"Error, {prog.region.name} has no stack-class leaves!",
                  file=sys.stderr)
            sys.exit(-1)
        return names
    return None


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_command_line(argv)

    from coast_tpu_torch.inject import logs
    from coast_tpu_torch.inject.campaign import CampaignRunner
    from coast_tpu_torch.inject.hierarchy import (MemHierarchy,
                                                  generate_cache_schedule)

    device = "cpu" if args.board == "cpu" else "cuda"
    prog, strategy = build_program(args.filename, args.opt_passes, device,
                                   placement=args.placement)
    retry = None
    if args.max_retries > 0 or args.collect_timeout:
        from coast_tpu_torch.inject.resilience import RetryPolicy
        retry = RetryPolicy(max_attempts=max(1, args.max_retries) + 1,
                            collect_timeout=args.collect_timeout)
    mesh = None
    if args.mesh:
        from coast_tpu_torch.parallel.mesh import make_mesh
        if device == "cuda":
            import torch
            count = torch.cuda.device_count()
            if args.mesh > count:
                print(f"Error, --mesh {args.mesh} wants more devices than "
                      f"the backend exposes ({count})", file=sys.stderr)
                return 1
        mesh = make_mesh(args.mesh, device=device)
    # Live observability surfaces: one metrics hub fed by the runner per
    # collected batch; the HTTP endpoint and the status file read it.  The
    # multi-chunk paths (-e, --delta-from) run several campaigns, so they
    # feed the hub through the cross-chunk progress callback instead.
    metrics = None
    server = None
    chunked = bool(args.errorCount or args.delta_from)
    slo_set = None
    if args.slo:
        from coast_tpu_torch.obs.slo import SLOError, SLOSet
        try:
            slo_set = SLOSet.parse(args.slo)
        except SLOError as e:
            print(f"Error, bad --slo spec: {e}", file=sys.stderr)
            return 1
    if args.metrics_port is not None or args.status_json:
        from coast_tpu_torch.obs.metrics import CampaignMetrics
        metrics = CampaignMetrics(status_path=args.status_json,
                                  slo=slo_set)
    if args.metrics_port is not None:
        from coast_tpu_torch.obs.serve import MetricsServer
        server = MetricsServer(metrics, port=args.metrics_port)
        port = server.start()
        print(f"# metrics: http://127.0.0.1:{port}/metrics  "
              f"status: http://127.0.0.1:{port}/status",
              file=sys.stderr, flush=True)
    try:
        runner = CampaignRunner(prog,
                                sections=section_filter(prog, args.section),
                                strategy_name=strategy,
                                retry=retry, mesh=mesh,
                                unroll=args.unroll,
                                fault_model=args.fault_model_parsed,
                                equiv=args.equiv,
                                metrics=None if chunked else metrics,
                                collect=args.collect,
                                profile=args.profile,
                                slo=slo_set)
    except ValueError as e:
        if args.equiv:
            print(f"Error, {e}", file=sys.stderr)
            return 1
        print(f"Error, {prog.region.name} has no injectable leaves in "
              f"section '{args.section}'!", file=sys.stderr)
        return 1
    mmap = runner.mmap

    # Refuse an existing journal without --resume before anything runs
    # (the library check only fires after the schedule is generated).
    if args.journal and not args.resume and os.path.exists(args.journal) \
            and os.path.getsize(args.journal) > 0:
        print(f"Error, journal {args.journal} already exists; pass "
              "--resume to continue it or delete the file to start "
              "fresh", file=sys.stderr)
        return 1

    if args.forceBreak:
        from coast_tpu_torch.opt import UsageError, _parse_inject
        try:
            fault = _parse_inject(args.forceBreak, prog)
        except (UsageError, ValueError) as e:
            print(f"ERROR: {e}", file=sys.stderr)
            return 2
        for i in range(args.breakCount):
            rec = prog.run(fault)
            print(f"forced injection {i}: E: {int(rec['errors'])} "
                  f"F: {int(rec['corrected'])} T: {int(rec['steps'])} "
                  f"dwc={bool(rec['dwc_fault'])} cfc={bool(rec['cfc_fault'])}")
        return 0

    log_dir = args.log_dir or "."
    log_path = os.path.join(
        log_dir, f"{prog.region.name}_{strategy}_{args.section}.json")
    # A lifted C program's guest-executable line is its source file.
    src_paths = prog.region.meta.get("source_paths")
    exec_path = (src_paths[0] if args.log_format == "reference"
                 and src_paths else None)
    stream = None
    if args.stream_logs:
        stream = logs.StreamLogWriter(log_path, mmap, fmt=args.log_format,
                                      exec_path=exec_path)

    # Live progress: the TTY dashboard (--console) or the one-line
    # heartbeat (--heartbeat); the last beat is re-emitted in the
    # ``finally`` below, so a campaign's final state always reaches the
    # terminal.
    beat = None
    progress = None
    last_beat = {}
    if args.console or args.heartbeat > 0:
        # -e sizes itself as it goes and --equiv counts representative
        # rows: neither gets a percent bar.
        total = 0 if (args.errorCount or args.equiv) else args.t
        if args.console:
            from coast_tpu_torch.obs.console import Console
            beat = Console(total, interval_s=(args.heartbeat or 1.0),
                           label=f"{prog.region.name}/{strategy}",
                           metrics=metrics,
                           stop_when=args.stop_when_parsed)
        else:
            from coast_tpu_torch.obs.heartbeat import Heartbeat
            beat = Heartbeat(total, interval_s=args.heartbeat,
                             metrics=metrics)

        def progress(done, counts):
            last_beat["state"] = (done, counts)
            # The beat's marks land in the runner's recorder.
            with runner.telemetry.activate():
                beat.update(done, counts)

    if metrics is not None and chunked:
        metrics.campaign_started(prog.region.name, strategy, 0, 0)
        _mrows = {"done": 0}
        _beat_progress = progress

        def progress(done, counts, _inner=_beat_progress):
            metrics.record_batch(done, max(0, done - _mrows["done"]),
                                 counts, {}, {})
            _mrows["done"] = done
            if _inner is not None:
                _inner(done, counts)

    try:
        if args.section in CACHE_SECTIONS:
            cache_name = None if args.section == "cache" else args.section
            sched = generate_cache_schedule(
                mmap, MemHierarchy("gpu"), args.t, args.seed,
                prog.region.nominal_steps, cache_name)
            res = runner.run_schedule(
                sched, batch_size=min(args.batch_size, len(sched)),
                progress=progress, stream=stream,
                stop_when=args.stop_when_parsed)
        elif args.errorCount:
            res = runner.run_until_errors(args.errorCount, seed=args.seed,
                                          batch_size=args.batch_size,
                                          progress=progress,
                                          journal=args.journal)
        elif args.stratified:
            from coast_tpu_torch.inject.schedule import (
                generate_stratified_total)
            sched = generate_stratified_total(mmap, args.t, args.seed,
                                              prog.region.nominal_steps,
                                              model=runner.fault_model)
            res = runner.run_schedule(
                sched, batch_size=min(args.batch_size, len(sched)),
                progress=progress, stream=stream,
                stop_when=args.stop_when_parsed)
        elif args.delta_from:
            from coast_tpu_torch.analysis.equiv import DeltaMismatchError
            try:
                res = runner.run_delta(args.t, args.delta_from,
                                       seed=args.seed,
                                       batch_size=args.batch_size,
                                       start_num=args.start_num,
                                       progress=progress,
                                       stop_when=args.stop_when_parsed,
                                       static_budget=args.static_budget)
            except DeltaMismatchError as e:
                print(f"Error, {e}", file=sys.stderr)
                return 1
        else:
            res = runner.run(args.t, seed=args.seed,
                             batch_size=args.batch_size,
                             start_num=args.start_num, journal=args.journal,
                             stream=stream, progress=progress,
                             stop_when=args.stop_when_parsed)
    except BaseException as e:
        if stream is not None:
            stream.abort()       # never leave a half-written final log
        if metrics is not None and chunked:
            # The single-campaign paths report a failure from inside
            # run_schedule; the chunked paths report it here.
            metrics.campaign_finished(error=f"{type(e).__name__}: {e}")
        raise
    finally:
        if beat is not None and "state" in last_beat:
            with runner.telemetry.activate():
                beat.final(*last_beat["state"])
        if server is not None:
            server.stop()

    if metrics is not None and chunked:
        metrics.campaign_finished(res.summary())

    if args.trace_out:
        from coast_tpu_torch import obs as obs_mod
        obs_mod.write_trace(
            runner.telemetry, args.trace_out,
            metadata={"benchmark": prog.region.name, "strategy": strategy,
                      "section": args.section},
            process_name=f"supervisor {prog.region.name}/{strategy}")
        print(f"# trace -> {args.trace_out} (open at ui.perfetto.dev)",
              file=sys.stderr, flush=True)

    print(res.summary())
    if not args.no_logging:
        if stream is not None:
            stream.finish(res)
        else:
            writer = {"json": logs.write_json, "ndjson": logs.write_ndjson,
                      "columnar": logs.write_columnar,
                      "reference": logs.write_reference_json
                      }[args.log_format]
            if exec_path is not None:
                writer(res, mmap, log_path, exec_path=exec_path)
            else:
                writer(res, mmap, log_path)
        print(f"wrote {log_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
