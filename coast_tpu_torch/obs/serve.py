"""Zero-dependency local metrics endpoint for a running campaign.

``MetricsServer`` wraps stdlib ``http.server`` in a daemon thread and
serves the :class:`coast_tpu_torch.obs.metrics.CampaignMetrics` hub the
campaign loop is feeding:

  * ``GET /metrics``      -- Prometheus text exposition (0.0.4), the
    scrape target a fleet supervisor (ROADMAP item 3) aggregates;
  * ``GET /status``       -- the full JSON status document (rates with
    Wilson CIs, ring-buffer series, stage totals, resilience counters);
  * ``GET /`` or ``/healthz`` -- a one-line liveness body.

Binding is loopback by default -- this is an operator's local
observation port, not a public service; a fleet scraper on another host
tunnels or rebinds explicitly.  ``port=0`` asks the OS for an ephemeral
port (tests, and running several campaigns on one box without port
bookkeeping); ``.port`` reports what was actually bound.

The server never touches the campaign thread: handlers read coherent
snapshots under the hub's lock, so a slow scraper can delay *its own*
response only.
"""

from __future__ import annotations

import errno
import http.server
import json
import sys
import threading
from typing import Optional

from coast_tpu_torch.obs.metrics import CampaignMetrics

__all__ = ["MetricsServer"]


class _Handler(http.server.BaseHTTPRequestHandler):
    # Set per-server via the class factory in MetricsServer.start.
    metrics: CampaignMetrics

    def do_GET(self) -> None:          # noqa: N802 - http.server API
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            body = self.metrics.prometheus().encode("utf-8")
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path in ("/status", "/status.json"):
            body = (json.dumps(self.metrics.snapshot(), sort_keys=True)
                    .encode("utf-8"))
            ctype = "application/json"
        elif path in ("/", "/healthz"):
            body = b"coast_tpu campaign metrics: see /metrics, /status\n"
            ctype = "text/plain; charset=utf-8"
        else:
            self.send_error(404, "unknown path (want /metrics or /status)")
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt: str, *args: object) -> None:
        # Scrape traffic must not spam the campaign's terminal.
        pass


class MetricsServer:
    """Threaded HTTP server over one CampaignMetrics hub."""

    def __init__(self, metrics: CampaignMetrics, port: int = 0,
                 host: str = "127.0.0.1", bind: Optional[str] = None):
        """``bind`` is the listen address (default stays the loopback
        ``host``); pass ``bind="0.0.0.0"`` for a fleet aggregator that
        other hosts scrape.  ``metrics`` is duck-typed: anything with
        ``prometheus()``/``snapshot()`` serves (a CampaignMetrics hub,
        or a fleet aggregate)."""
        self.metrics = metrics
        self.host = bind if bind is not None else host
        self.port = int(port)
        self._httpd: Optional[http.server.ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        """Bind and serve in a daemon thread; returns the bound port.

        A requested port that is already taken falls back to an
        ephemeral one (with a warning on stderr) instead of dying: on a
        fleet host, per-worker servers and the aggregator coexist, and
        "which port exactly" matters less than "the worker must not
        crash because an operator reused a number"."""
        if self._httpd is not None:
            return self.port
        handler = type("BoundHandler", (_Handler,),
                       {"metrics": self.metrics})
        try:
            self._httpd = http.server.ThreadingHTTPServer(
                (self.host, self.port), handler)
        except OSError as e:
            if self.port == 0 or e.errno not in (errno.EADDRINUSE,
                                                 errno.EACCES):
                raise
            print(f"# warning: metrics port {self.port} on {self.host} "
                  f"is taken ({e.strerror}); falling back to an "
                  "ephemeral port", file=sys.stderr, flush=True)
            self._httpd = http.server.ThreadingHTTPServer(
                (self.host, 0), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="coast-metrics-server", daemon=True)
        self._thread.start()
        return self.port

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._httpd = None
        self._thread = None

    def __enter__(self) -> "MetricsServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
