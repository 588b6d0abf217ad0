"""Fleet supervisor CLI: many campaigns x many workers, one command.

The port's copy of ``coast_tpu/fleet/supervisor.py``.  Workers run on the
card unless ``-d cpu`` is given; several workers may share one card.

    # queue work (the journal-identity vocabulary, one item per campaign)
    python -m coast_tpu_torch.fleet enqueue --queue /tmp/q -f matrixMultiply \\
        -O -TMR -t 4096 --seed 0 --count 8

    # drain it: N worker processes, merged live telemetry, crash babysit
    python -m coast_tpu_torch.fleet run --queue /tmp/q --workers 2 \\
        --metrics-port 9100 [-d cpu]

    # observe / merge later
    python -m coast_tpu_torch.fleet status --queue /tmp/q
    python -m coast_tpu_torch.fleet merge  --queue /tmp/q

``run`` is the zero-to-aha path: it launches the workers, requeues
expired leases, restarts dead workers (requeueing their claimed items
immediately -- no need to wait out a lease it *watched* die), serves the
fleet-aggregate ``/metrics``+``/status`` endpoint while they work, and
finishes with the **parity-checked merge**: every merged count is
re-derived from the item's durable journal (codes sha + final
cumulative counts must match what the worker reported), the same
trust-the-device-not-the-messenger discipline as the mesh backend's
single-device-identical classification pin.  The merged artifact lands
atomically at ``<queue>/fleet_result.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from coast_tpu_torch.fleet.queue import CampaignQueue, QueueError, item_spec
from coast_tpu_torch.obs.metrics import atomic_write_json

__all__ = ["FleetParityError", "merge_fleet", "main"]


class FleetParityError(RuntimeError):
    """A done record disagrees with its own journal: the merge refuses
    to publish counts it cannot re-derive from the durable batch
    stream."""


# -- parity-checked merge ----------------------------------------------------

def _journal_columns(path: str):
    """(codes, last_cumulative_counts) re-derived from a journal's batch
    records: sorted by row offset, deduped (a resumed journal never
    duplicates, but the merge does not *trust* that), contiguity
    checked.  Parsing -- torn-tail tolerance included -- is
    ``CampaignJournal._load``, the one reader of the format; anything
    it refuses, the merge refuses as a parity failure."""
    from coast_tpu_torch.inject.journal import CampaignJournal, JournalError
    try:
        _header, records, _valid = CampaignJournal._load(path)
    except JournalError as e:
        raise FleetParityError(
            f"journal {path!r} is unreadable: {e}") from e
    batches: Dict[int, Dict[str, object]] = {}
    for rec in records:
        if rec.get("kind") == "batch":
            lo = int(rec["lo"])
            prev = batches.get(lo)
            if prev is not None and prev != rec:
                raise FleetParityError(
                    f"journal {path!r} has two CONFLICTING batch "
                    f"records at row {lo}; refusing to pick one")
            batches[lo] = rec
    if not batches:
        raise FleetParityError(f"journal {path!r} has no batch records")
    codes: List[int] = []
    expected = min(batches)
    last = None
    for lo in sorted(batches):
        rec = batches[lo]
        if lo != expected:
            raise FleetParityError(
                f"journal {path!r} has a gap: batch at row {expected} "
                f"missing (next record starts at {lo})")
        codes.extend(int(c) for c in rec["codes"])
        expected = lo + int(rec["n"])
        last = rec
    return np.asarray(codes, dtype=np.int32), dict(last["counts"])


def merge_fleet(queue: "CampaignQueue | str") -> Dict[str, object]:
    """Merge every completed item into one fleet-level artifact, parity-
    checking each against its journal.  Raises
    :class:`FleetParityError` on any disagreement."""
    from coast_tpu_torch.fleet.worker import codes_sha256
    q = (queue if isinstance(queue, CampaignQueue)
         else CampaignQueue(queue))
    items_out: List[Dict[str, object]] = []
    totals: Dict[str, int] = {}
    cache_events: Dict[str, int] = {}
    injections = 0
    physical = 0
    for rec in sorted(q.items("done"), key=lambda r: str(r.get("id"))):
        item_id = str(rec["id"])
        result = rec.get("result") or {}
        codes, last_counts = _journal_columns(q.journal_path(item_id))
        sha = codes_sha256(codes)
        if sha != result.get("codes_sha256"):
            raise FleetParityError(
                f"item {item_id}: journal codes sha {sha[:12]} != "
                f"reported {str(result.get('codes_sha256'))[:12]}; the "
                "done record does not describe its own journal")
        reported = {k: int(v)
                    for k, v in (result.get("counts") or {}).items()}
        derived = {k: int(v) for k, v in last_counts.items()}
        if reported != derived:
            raise FleetParityError(
                f"item {item_id}: journal cumulative counts {derived} "
                f"!= reported {reported}")
        for k, v in reported.items():
            totals[k] = totals.get(k, 0) + v
        injections += int(result.get("injections", 0))
        physical += int(result.get("physical_injections",
                                   result.get("injections", 0)))
        event = result.get("cache_event")
        if event:
            cache_events[event] = cache_events.get(event, 0) + 1
        items_out.append({
            "id": item_id,
            "benchmark": result.get("benchmark"),
            "strategy": result.get("strategy"),
            "injections": int(result.get("injections", 0)),
            "counts": reported,
            "codes_sha256": sha,
            "cache_event": event,
            "worker": result.get("worker"),
            "attempts": int(rec.get("attempts", 1)),
        })
    failed = [{"id": r.get("id"), "error": r.get("error")}
              for r in q.items("failed")]
    return {
        "format": "coast-fleet-result", "version": 1,
        "items": items_out, "failed": failed,
        "totals": totals, "injections": injections,
        "physical_injections": physical,
        "cache": {**cache_events,
                  "hits": sum(v for k, v in cache_events.items()
                              if k.endswith("hit")),
                  "misses": cache_events.get("miss", 0)},
        "queue": q.stats(),
        "parity": "ok",
    }


# -- CLI ---------------------------------------------------------------------

def _add_queue(p: argparse.ArgumentParser) -> None:
    p.add_argument("--queue", "-Q", required=True, metavar="DIR",
                   help="fleet queue root directory (created if absent)")


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", "-d", default="cuda",
                   choices=["cuda", "cpu"],
                   help="where the workers run their campaigns: the card "
                   "(cuda, default) or the host (cpu)")


def parse_command_line(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        prog="python -m coast_tpu_torch.fleet",
        description="Campaign fleet: schedule many campaigns across many "
                    "worker processes with crash-kill-resume and merged "
                    "parity-checked results")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("enqueue", help="queue one (or --count) campaigns")
    _add_queue(p)
    p.add_argument("--filename", "-f", required=True,
                   help="benchmark registry name or restricted-C path")
    p.add_argument("--opt-passes", "-O", default="-TMR",
                   help="protection flags (opt CLI string)")
    p.add_argument("--section", "-s", default="memory")
    p.add_argument("-t", metavar="N", type=int, required=True,
                   help="injections per campaign")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--start-num", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--fault-model", default="single")
    p.add_argument("--equiv", action="store_true")
    p.add_argument("--stop-when", default=None)
    p.add_argument("--delta-from", default=None, metavar="JOURNAL",
                   help="make the item a DELTA campaign: re-inject only "
                   "the sections whose propagation fingerprint changed "
                   "since JOURNAL (a completed --equiv run of the same "
                   "campaign), splicing the rest; implies --equiv.  "
                   "Combined with --stop-when, each re-injected section "
                   "is convergence-bounded on its own (the CI work "
                   "unit)")
    p.add_argument("--unroll", type=int, default=1)
    p.add_argument("--collect", default="dense",
                   choices=["dense", "sparse"],
                   help="result-collection mode for the item's worker: "
                   "'sparse' keeps the campaign loop device-resident "
                   "(on-device flip generation + histogram accounting, "
                   "only interesting rows fetched); counts identical, "
                   "journal records sparse-shaped")
    p.add_argument("--throttle", type=float, default=0.0, metavar="S",
                   help="sleep S seconds per collected batch (operator "
                   "rate limit)")
    p.add_argument("--count", type=int, default=1, metavar="K",
                   help="enqueue K copies with seeds seed..seed+K-1")

    p = sub.add_parser("run", help="launch workers and drain the queue")
    _add_queue(p)
    p.add_argument("--workers", "-w", type=int, default=2, metavar="N")
    p.add_argument("--mesh", type=int, default=None, metavar="M",
                   help="each worker shards its batch over the first M "
                   "devices (CampaignRunner mesh backend)")
    p.add_argument("--lease", type=float, default=30.0, metavar="S",
                   help="work-item lease seconds (renewed per batch; an "
                   "expired lease requeues the item)")
    p.add_argument("--poll", type=float, default=0.5, metavar="S")
    p.add_argument("--max-restarts", type=int, default=3,
                   help="per-worker-slot restart budget for crashed "
                   "workers")
    p.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                   help="serve the merged fleet /metrics + /status here "
                   "(0 = ephemeral, printed; conflicts fall back to "
                   "ephemeral with a warning)")
    p.add_argument("--bind", default="127.0.0.1", metavar="ADDR",
                   help="aggregate endpoint bind address")
    p.add_argument("--status-json", default=None, metavar="PATH",
                   help="mirror the fleet status JSON here (atomic "
                   "replace) every poll")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="write ONE federated Perfetto trace here after "
                   "the drain: every item's journal span timeline "
                   "(clock-skew corrected, SIGKILL'd+resumed workers' "
                   "batches exactly once) plus the queue's "
                   "claim/lease/complete events (obs/federate.py)")
    _add_device(p)
    p.add_argument("--slo", default=None, metavar="SPEC",
                   help="evaluate this reliability SLO spec live against "
                   "the fleet aggregate (obs/slo.py grammar); verdicts "
                   "ride /status, /metrics and the spawned workers' "
                   "own status docs")

    p = sub.add_parser("worker", help="run ONE worker process (what "
                       "`run` spawns)")
    _add_queue(p)
    p.add_argument("--worker-id", required=True)
    p.add_argument("--mesh", type=int, default=None)
    p.add_argument("--lease", type=float, default=30.0)
    p.add_argument("--poll", type=float, default=0.25)
    p.add_argument("--max-retries", type=int, default=2)
    _add_device(p)
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve this worker's own live campaign metrics "
                   "(port conflicts fall back to an ephemeral port, so "
                   "per-worker servers coexist on one host)")
    p.add_argument("--slo", default=None, metavar="SPEC",
                   help="evaluate this reliability SLO spec live against "
                   "the worker's campaign metrics (obs/slo.py grammar, "
                   "e.g. 'sdc_rate<=0.002;min=4096'); the verdict rides "
                   "the worker status doc and /metrics")

    p = sub.add_parser("status", help="print the fleet status document")
    _add_queue(p)

    p = sub.add_parser("merge", help="parity-checked merge of completed "
                       "items into fleet_result.json")
    _add_queue(p)
    p.add_argument("--out", default=None, metavar="PATH",
                   help="artifact path (default <queue>/fleet_result.json)")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="also write the federated Perfetto trace of "
                   "every item's journal timeline + queue events")

    # `-O -TMR` ergonomics, exactly as the inject supervisor CLI: argparse
    # eats a bare `-TMR` as an unknown option, so pre-join the pass flags
    # following -O/--opt-passes into `-O=<flags>`.  Tokens that ARE fleet
    # options stop the join.
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    known = {"-h", "--help"}
    for sp in (parser, *sub.choices.values()):
        known.update(s for a in sp._actions for s in a.option_strings)
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
    return parser.parse_args(joined)


def cmd_enqueue(args) -> int:
    q = CampaignQueue(args.queue)
    if args.delta_from and args.count > 1:
        # --count varies the seed per item, and a delta base journal
        # records ONE seed: items 2..K would deterministically fail
        # at claim time with DeltaMismatchError.  Refuse the enqueuer.
        print("Error, --delta-from cannot be combined with --count > 1: "
              "the delta base journal records one seed, and --count "
              "enqueues seed-varied copies that can never splice from "
              "it", file=sys.stderr)
        return 1
    try:
        specs = [item_spec(args.filename, args.t,
                           seed=args.seed + i,
                           opt_passes=args.opt_passes,
                           section=args.section,
                           batch_size=args.batch_size,
                           start_num=args.start_num,
                           fault_model=args.fault_model,
                           equiv=args.equiv or bool(args.delta_from),
                           stop_when=args.stop_when,
                           unroll=args.unroll, throttle_s=args.throttle,
                           delta_from=args.delta_from,
                           collect=args.collect)
                 for i in range(max(1, args.count))]
    except (QueueError, ValueError) as e:
        print(f"Error, bad item spec: {e}", file=sys.stderr)
        return 1
    for spec in specs:
        print(q.enqueue(spec))
    return 0


def _spawn_worker(args, wid: str) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "coast_tpu_torch.fleet", "worker",
           "--queue", args.queue, "--worker-id", wid,
           "--lease", str(args.lease), "--device", args.device]
    if args.mesh:
        cmd += ["--mesh", str(args.mesh)]
    if getattr(args, "slo", None):
        cmd += ["--slo", args.slo]
    # The package may be run from a source checkout rather than an
    # installed dist: make sure the child resolves the same
    # coast_tpu_torch this supervisor is running.
    import coast_tpu_torch
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.abspath(coast_tpu_torch.__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(cmd, env=env)


def cmd_run(args) -> int:
    from coast_tpu_torch.fleet.telemetry import FleetTelemetry
    q = CampaignQueue(args.queue)
    if q.drained():
        print("Error, the queue has no live work; enqueue items first",
              file=sys.stderr)
        return 1
    try:
        telemetry = FleetTelemetry(q, stale_s=max(10.0, 2.0 * args.lease),
                                   slo=args.slo)
    except Exception as e:              # noqa: BLE001 - bad --slo spec
        print(f"Error, bad --slo spec: {e}", file=sys.stderr)
        return 2
    server = None
    if args.metrics_port is not None:
        from coast_tpu_torch.obs.serve import MetricsServer
        server = MetricsServer(telemetry, port=args.metrics_port,
                               bind=args.bind)
        port = server.start()
        print(f"# fleet metrics: http://{args.bind}:{port}/metrics  "
              f"status: http://{args.bind}:{port}/status",
              file=sys.stderr, flush=True)
    ids = [f"w{i}" for i in range(max(1, args.workers))]
    procs: Dict[str, Optional[subprocess.Popen]] = {
        wid: _spawn_worker(args, wid) for wid in ids}
    restarts = {wid: 0 for wid in ids}
    rc = 0
    try:
        while True:
            q.requeue_expired()
            if args.status_json:
                atomic_write_json(args.status_json, telemetry.snapshot())
            if q.drained():
                break
            alive = 0
            for wid in ids:
                proc = procs[wid]
                if proc is None:
                    continue
                code = proc.poll()
                if code is None:
                    alive += 1
                    continue
                # The worker died (or drained and exited while work was
                # requeued behind its back).  Reclaim anything it held
                # NOW -- the supervisor watched it exit, no lease wait
                # needed -- and restart the slot if budget remains.
                requeued = q.requeue_worker(wid)
                if code != 0 or requeued:
                    print(f"# worker {wid} exited rc={code}; requeued "
                          f"{len(requeued)} item(s)",
                          file=sys.stderr, flush=True)
                if q.drained():
                    procs[wid] = None
                    continue
                if restarts[wid] < args.max_restarts:
                    restarts[wid] += 1
                    procs[wid] = _spawn_worker(args, wid)
                    alive += 1
                else:
                    procs[wid] = None
            if alive == 0 and not q.drained():
                print("Error, all workers exhausted their restart "
                      "budget with work remaining", file=sys.stderr)
                rc = 1
                break
            time.sleep(args.poll)
    finally:
        for proc in procs.values():
            if proc is not None and proc.poll() is None:
                try:
                    proc.wait(timeout=max(5.0, 2.0 * args.poll))
                except subprocess.TimeoutExpired:
                    proc.terminate()
                    proc.wait(timeout=5.0)
        if args.status_json:
            # Terminal snapshot: the workers have exited, so a headless
            # consumer polling this file must see the drained state.
            atomic_write_json(args.status_json, telemetry.snapshot())
        if server is not None:
            server.stop()
    try:
        result = merge_fleet(q)
    except FleetParityError as e:
        print(f"Error, fleet merge parity check failed: {e}",
              file=sys.stderr)
        return 1
    out = os.path.join(q.root, "fleet_result.json")
    atomic_write_json(out, result)
    if args.trace_out:
        from coast_tpu_torch.obs.federate import write_merged_trace
        write_merged_trace(q, args.trace_out)
        print(f"wrote federated trace {args.trace_out}")
    totals = ", ".join(f"{k}={v}" for k, v in sorted(
        result["totals"].items()) if v)
    print(f"fleet: {len(result['items'])} campaigns merged "
          f"({result['injections']} injections; {totals}); "
          f"cache hits={result['cache']['hits']} "
          f"misses={result['cache']['misses']}; parity ok")
    print(f"wrote {out}")
    if result["failed"]:
        for rec in result["failed"]:
            print(f"FAILED item {rec['id']}: {rec['error']}",
                  file=sys.stderr)
        return 1
    return rc


def cmd_worker(args) -> int:
    from coast_tpu_torch import device as device_mod
    try:
        device_mod.resolve(args.device)
    except RuntimeError as e:
        print(f"Error, {e}", file=sys.stderr)
        return 2
    from coast_tpu_torch.fleet.worker import Worker
    from coast_tpu_torch.obs import flightrec
    from coast_tpu_torch.obs.metrics import CampaignMetrics
    from coast_tpu_torch.obs.slo import SLOError
    # Process-lifetime blackbox: lease/journal/dispatch events land in
    # one ring, bundles land under the queue root (the supervisor's and
    # the tests' harvest surface), SIGUSR1 dumps on demand.
    rec = flightrec.install(dump_dir=os.environ.get(
        "COAST_FLIGHTREC_DIR") or os.path.join(args.queue, "flightrec"),
        source=f"fleet-worker:{args.worker_id}")
    rec.install_signal_handler()
    try:
        metrics = CampaignMetrics(slo=args.slo)
    except SLOError as e:
        print(f"Error, bad --slo spec: {e}", file=sys.stderr)
        return 2
    server = None
    if args.metrics_port is not None:
        from coast_tpu_torch.obs.serve import MetricsServer
        server = MetricsServer(metrics, port=args.metrics_port)
        port = server.start()
        print(f"# worker {args.worker_id} metrics: "
              f"http://127.0.0.1:{port}/metrics",
              file=sys.stderr, flush=True)
    try:
        worker = Worker(args.queue, args.worker_id,
                        mesh_devices=args.mesh, lease_s=args.lease,
                        poll_s=args.poll, metrics=metrics,
                        max_retries=args.max_retries, device=args.device)
        done = worker.drain()
    finally:
        if server is not None:
            server.stop()
    from coast_tpu_torch.ops import hopper_commit, hopper_voters
    print(f"# worker {args.worker_id} drained: {done} item(s) completed; "
          f"kernel launches K1 {hopper_voters.LAUNCHES}, "
          f"K2 {hopper_commit.LAUNCHES}", file=sys.stderr, flush=True)
    return 0


def cmd_status(args) -> int:
    from coast_tpu_torch.fleet.telemetry import FleetTelemetry
    print(json.dumps(FleetTelemetry(args.queue).snapshot(), indent=2,
                     sort_keys=True))
    return 0


def cmd_merge(args) -> int:
    q = CampaignQueue(args.queue)
    try:
        result = merge_fleet(q)
    except FleetParityError as e:
        print(f"Error, fleet merge parity check failed: {e}",
              file=sys.stderr)
        return 1
    out = args.out or os.path.join(q.root, "fleet_result.json")
    atomic_write_json(out, result)
    print(f"wrote {out} ({len(result['items'])} items, "
          f"{result['injections']} injections, parity ok)")
    if args.trace_out:
        from coast_tpu_torch.obs.federate import write_merged_trace
        write_merged_trace(q, args.trace_out)
        print(f"wrote federated trace {args.trace_out}")
    return 1 if result["failed"] else 0


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_command_line(argv)
    return {"enqueue": cmd_enqueue, "run": cmd_run, "worker": cmd_worker,
            "status": cmd_status, "merge": cmd_merge}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
