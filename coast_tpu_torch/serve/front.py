"""The serving HTTP front + the ``python -m coast_tpu_torch serve`` verb.

The port's copy of ``coast_tpu/serve/front.py``, with its endpoints and
flags, plus ``--device/-d`` (the card unless given ``-d cpu``).  The
:mod:`coast_tpu_torch.obs.serve` server shape (stdlib threaded
``http.server``, daemon thread, handler class bound per-server, silent
logs, ephemeral-port fallback), extended with the one write endpoint a
protected inference service needs:

  * ``POST /v1/infer``  -- body ``{"payload": str, "sla_s"?: float,
    "strategy"?: "DWC"|"TMR"}``; blocks until the request is served,
    rejected, or its SLA (plus a small grace) elapses.  Responses are
    deterministic JSON (``sort_keys``, no timing fields): two identical
    request streams serialize byte-identically, injection lanes on or
    off -- the differential contract the smoke driver pins.
  * ``GET /metrics``    -- Prometheus text: the campaign hub's rows
    (injection-lane classes, dispatch-latency histograms, SLO verdicts)
    plus the ``coast_serve_*`` request-plane rows.
  * ``GET /status``     -- the serving status document (``format:
    coast-serve-status``: campaign snapshot + ``serving`` block + live
    ``slo`` block).
  * ``GET /healthz``    -- liveness.

Ingest threads do no protected compute: a handler submits into the
admission queue and parks on the request's completion event; the single
dispatch loop does all the batching.
"""

from __future__ import annotations

import argparse
import errno
import http.server
import json
import signal
import sys
import threading
import time
from typing import List, Optional

from coast_tpu_torch.serve.engine import ServeEngine

__all__ = ["ServeFront", "main"]

#: Extra wait beyond a request's SLA before the HTTP handler gives up
#: on its completion event (the loop itself rejects at the deadline;
#: the grace only covers scheduling slop between loop and handler).
_HANDLER_GRACE_S = 1.0


class _Handler(http.server.BaseHTTPRequestHandler):
    # Bound per-server via the class factory in ServeFront.start.
    engine: ServeEngine

    protocol_version = "HTTP/1.1"   # keep-alive: loadtest connections

    def _send(self, status: int, body: bytes, ctype: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, status: int, doc) -> None:
        self._send(status,
                   json.dumps(doc, sort_keys=True).encode("utf-8"),
                   "application/json")

    def do_GET(self) -> None:          # noqa: N802 - http.server API
        path = self.path.split("?", 1)[0]
        metrics = self.engine.metrics
        if path == "/metrics":
            self._send(200, metrics.prometheus().encode("utf-8"),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif path in ("/status", "/status.json"):
            self._send_json(200, metrics.snapshot())
        elif path in ("/", "/healthz"):
            body = (b"coast_tpu_torch protected serving: POST /v1/infer, "
                    b"see /metrics, /status\n")
            self._send(200, body, "text/plain; charset=utf-8")
        else:
            self.send_error(404, "unknown path (want /v1/infer, "
                                 "/metrics, /status)")

    def do_POST(self) -> None:         # noqa: N802 - http.server API
        path = self.path.split("?", 1)[0]
        if path != "/v1/infer":
            self.send_error(404, "unknown path (POST /v1/infer)")
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            doc = json.loads(self.rfile.read(length) or b"{}")
            payload = str(doc.get("payload", ""))
            sla_s = doc.get("sla_s")
            strategy = doc.get("strategy")
            if strategy is not None and strategy not in \
                    self.engine.admission.strategies:
                raise ValueError(f"unknown strategy {strategy!r}")
        except (ValueError, json.JSONDecodeError) as e:
            self._send_json(400, {"error": f"bad request: {e}"})
            return
        try:
            req = self.engine.submit(payload, sla_s=sla_s,
                                     strategy=strategy)
        except RuntimeError as e:       # engine failed (lane leak etc.)
            self._send_json(503, {"error": str(e)})
            return
        if not req.done.wait(req.sla_s + _HANDLER_GRACE_S):
            self._send_json(504, {"error": "timeout", "id": req.rid})
            return
        if req.response is not None:
            self._send_json(200, req.response)
        else:
            status = 504 if req.error == "deadline_expired" else 503
            self._send_json(status, {"error": req.error, "id": req.rid})

    def log_message(self, fmt: str, *args: object) -> None:
        # Request traffic must not spam the server's terminal.
        pass


class ServeFront:
    """Threaded HTTP front over one ServeEngine (loopback by default:
    rebind explicitly to expose beyond the host)."""

    def __init__(self, engine: ServeEngine, port: int = 0,
                 host: str = "127.0.0.1"):
        self.engine = engine
        self.host = host
        self.port = int(port)
        self._httpd: Optional[http.server.ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        """Start the engine loop and bind the HTTP front; returns the
        bound port (a taken port falls back to an ephemeral one, like
        the metrics server -- the service must not die over a reused
        port number)."""
        if self._httpd is not None:
            return self.port
        self.engine.start()
        handler = type("BoundHandler", (_Handler,),
                       {"engine": self.engine})
        try:
            self._httpd = http.server.ThreadingHTTPServer(
                (self.host, self.port), handler)
        except OSError as e:
            if self.port == 0 or e.errno not in (errno.EADDRINUSE,
                                                 errno.EACCES):
                raise
            print(f"# warning: serve port {self.port} on {self.host} "
                  f"is taken ({e.strerror}); falling back to an "
                  "ephemeral port", file=sys.stderr, flush=True)
            self._httpd = http.server.ThreadingHTTPServer(
                (self.host, 0), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="coast-serve-front", daemon=True)
        self._thread.start()
        return self.port

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            if self._thread is not None:
                self._thread.join(timeout=5.0)
            self._httpd = None
            self._thread = None
        self.engine.stop()

    def __enter__(self) -> "ServeFront":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m coast_tpu_torch serve <benchmark> [flags]``."""
    p = argparse.ArgumentParser(
        prog="python -m coast_tpu_torch serve",
        description="Protected inference service: live request lanes + "
                    "background fault-injection lanes in one "
                    "batch, self-measuring its own SDC rate.")
    p.add_argument("benchmark",
                   help="registry name (the protected region served and "
                        "measured)")
    p.add_argument("--port", type=int, default=8321,
                   help="HTTP port (0 = ephemeral; default 8321)")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (loopback by default)")
    p.add_argument("--batch-size", type=int, default=64,
                   help="rows per dispatch (requests + "
                        "injection + padding)")
    p.add_argument("--inject-share", type=float, default=0.5,
                   help="fraction of each batch offered to injection "
                        "lanes (0 disables self-measurement)")
    p.add_argument("--sla-s", type=float, default=0.25,
                   help="default per-request SLA (seconds)")
    p.add_argument("--retry-factor", type=float, default=2.0,
                   help="a request picks DWC when its SLA covers "
                        "retry-factor x the estimated dispatch time")
    p.add_argument("--seed", type=int, default=0,
                   help="injection schedule seed")
    p.add_argument("--inject-n", type=int, default=1_000_000,
                   help="standing injection campaign length per "
                        "strategy")
    p.add_argument("--section", default="memory",
                   help="injected section set (supervisor section "
                        "vocabulary; default memory)")
    p.add_argument("--journal-dir", default=None,
                   help="directory for crash-safe standing injection "
                        "journals (resumed bit-for-bit on restart)")
    p.add_argument("--queue", default=None,
                   help="fleet CampaignQueue root: injection work is "
                        "enqueued/claimed/completed as fleet items")
    p.add_argument("--slo", default=None,
                   help="SLO spec string, e.g. "
                        "'sdc_rate<=0.002,availability>=0.99,"
                        "p99_dispatch<=0.05;min=1024'; add 'mwtf>=N' "
                        "with --baseline to gate on Mean-Work-To-"
                        "Failure improvement live")
    p.add_argument("--baseline", default=None, metavar="PATH",
                   help="recorded UNPROTECTED run evidence (status "
                        "JSON, run doc with summary, summary JSON, or "
                        "NDJSON log -- the slo CLI's --baseline "
                        "vocabulary): feeds the mwtf objective's "
                        "improvement denominator so 'mwtf>=N' gets a "
                        "live verdict on /status and /metrics instead "
                        "of no-data")
    p.add_argument("--status-json", default=None,
                   help="atomically-rewritten serving status file")
    p.add_argument("--status-interval", type=float, default=2.0,
                   help="minimum seconds between status-file writes")
    p.add_argument("--wedge-timeout", type=float, default=0.0,
                   help="seconds before a hung dispatch dumps a "
                        "flight-recorder bundle and fails (0 = off)")
    p.add_argument("--idle-throttle", type=float, default=0.0,
                   help="sleep between injection-only dispatches when "
                        "no requests are queued (0 = free-run)")
    p.add_argument("--duration", type=float, default=0.0,
                   help="serve for N seconds then exit cleanly "
                        "(0 = until SIGINT/SIGTERM)")
    p.add_argument("--flightrec-dir", default=None,
                   help="flight-recorder bundle directory")
    p.add_argument("--device", "-d", default="cuda",
                   help="cuda (the card, default) or cpu: where both "
                        "programs are built and every dispatch runs")
    args = p.parse_args(argv)

    from coast_tpu_torch import device as device_mod
    try:
        device_mod.resolve(args.device)
    except RuntimeError as e:
        print(f"Error, {e}", file=sys.stderr)
        return 2

    from coast_tpu_torch.obs import flightrec
    from coast_tpu_torch.serve.metrics import ServeMetrics
    flightrec.install(dump_dir=args.flightrec_dir)

    queue = None
    if args.queue:
        from coast_tpu_torch.fleet.queue import CampaignQueue
        queue = CampaignQueue(args.queue)
    slo_baseline = None
    if args.baseline:
        from coast_tpu_torch.obs.slo import SLOError, baseline_from
        try:
            slo_baseline = baseline_from(args.baseline)
        except (OSError, ValueError, SLOError) as e:
            print(f"Error, cannot load --baseline {args.baseline}: {e}",
                  file=sys.stderr)
            return 2
    metrics = ServeMetrics(slo=args.slo, status_path=args.status_json,
                           slo_baseline=slo_baseline,
                           status_interval_s=args.status_interval)
    engine = ServeEngine(
        args.benchmark, batch_size=args.batch_size,
        inject_share=args.inject_share, sla_default_s=args.sla_s,
        retry_factor=args.retry_factor, seed=args.seed,
        inject_n=args.inject_n, section=args.section,
        journal_dir=args.journal_dir, queue=queue, metrics=metrics,
        wedge_timeout_s=args.wedge_timeout,
        idle_throttle_s=args.idle_throttle, device=args.device)
    for strategy, lane in engine._lanes.items():
        print(f"# {lane.proof.format()}", flush=True)

    stop = threading.Event()
    for signum in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(signum, lambda *_: stop.set())
        except ValueError:
            pass                        # not the main thread (tests)
    front = ServeFront(engine, port=args.port, host=args.host)
    with front:
        print(f"# serving {engine.benchmark} on {front.url} "
              f"(batch={args.batch_size}, "
              f"inject_share={args.inject_share})", flush=True)
        t_end = (time.monotonic() + args.duration
                 if args.duration > 0 else None)
        while not stop.is_set():
            if t_end is not None and time.monotonic() >= t_end:
                break
            if engine.error:
                break
            stop.wait(0.2)
    doc = engine.summary()
    print(json.dumps(doc, sort_keys=True), flush=True)
    return 1 if engine.error else 0


if __name__ == "__main__":
    sys.exit(main())
