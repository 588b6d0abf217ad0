"""Blackbox flight recorder: bounded event ring + crash forensics.

The port's copy of ``coast_tpu/obs/flightrec.py``: the same ring, bundle
format and hooks; the bundle's metadata names torch, its CUDA build, the
card and its power limit where the reference names jax and its backend.

A wedge that dies with a one-line diagnosis and zero recorded state
cannot be diagnosed.  This module is the aircraft-style blackbox: a bounded
ring buffer of structured events (dispatch, retry, OOM-halving,
watchdog fire, lease claim/renew/loss, journal open/resume,
compile-cache hits, spawn stages) that any layer can append to for
near-zero cost, plus an atomic forensic *bundle* dump -- last-N
events, ``faulthandler`` all-thread stacks, process/torch/card
metadata -- written on crash, on :class:`CampaignWedgedError`, on
lease loss, on ``SIGUSR1``, and by the bench parent when a child
exceeds its spawn budget.

Design constraints (ordered, matching :mod:`coast_tpu_torch.obs.spans`):

  * **Overhead**: a disabled ``record()`` costs one attribute test
    (the span recorder's < 2% budget applies); an enabled one costs two clock
    reads and a locked deque append.  Events are infrequent (per
    dispatch / per lifecycle edge), never per injection.
  * **Multi-thread**: unlike the spans stack, the ambient recorder is
    *process-global* -- the watchdog thread, the lease-keeper thread,
    and a signal handler must all land events in the same ring, so
    every append takes the recorder lock and tags the thread name.
  * **Atomic dumps**: a bundle is written tmp + rename (the
    ``atomic_write_json`` discipline) so the parent that SIGKILLs a
    wedged child a moment later never reads a torn file.

Env knobs: ``COAST_FLIGHTREC=0`` disables recording process-wide;
``COAST_FLIGHTREC_DIR`` overrides the bundle directory (the bench
parent points the child at a scratch dir it will harvest);
``COAST_FLIGHTREC_CAP`` overrides the ring capacity.
"""

from __future__ import annotations

import collections
import contextlib
import faulthandler
import json
import os
import signal
import sys
import threading
import time
from typing import Deque, Dict, Iterator, List, Optional

__all__ = ["FlightRecorder", "NULL", "current", "install", "uninstall",
           "record", "activate", "newest_bundle", "BUNDLE_FORMAT"]

BUNDLE_FORMAT = "coast-flightrec"
BUNDLE_VERSION = 1
DEFAULT_CAPACITY = 512


def _env_enabled() -> bool:
    """Default on; COAST_FLIGHTREC=0/off/false disables process-wide."""
    return os.environ.get("COAST_FLIGHTREC", "1").lower() not in (
        "0", "off", "false", "no")


def _default_dir() -> str:
    return os.environ.get("COAST_FLIGHTREC_DIR") or os.path.join(
        "artifacts", "flightrec")


def _torch_meta() -> Dict[str, object]:
    """Best-effort torch/card identity WITHOUT initialising CUDA: a dump
    can fire while the card is the thing that is wedged, so the card is
    read only when this process already initialised it, and
    ``nvidia-smi`` gets a short timeout."""
    meta: Dict[str, object] = {}
    try:
        torch = sys.modules.get("torch")
        if torch is None:
            return meta
        meta["torch_version"] = getattr(torch, "__version__", None)
        meta["cuda_version"] = getattr(torch.version, "cuda", None)
        if not torch.cuda.is_initialized():
            meta["backend"] = "cpu"
            return meta
        meta["backend"] = "gpu"
        meta["device_count"] = int(torch.cuda.device_count())
        meta["device_name"] = torch.cuda.get_device_name(0)
        from coast_tpu_torch.device import card_line
        line = card_line(timeout=5)
        if line:
            meta["power_limit"] = line.rsplit(", ", 1)[-1]
    except Exception:  # noqa: BLE001 - metadata is best-effort
        pass
    return meta


def _all_thread_stacks() -> str:
    """All-thread tracebacks into a string (the in-process analogue of
    the py-spy dump the wedge forensics never had).

    ``sys._current_frames`` + ``threading.enumerate`` rather than
    ``faulthandler.dump_traceback``: faulthandler on this interpreter
    prints only thread ids, and a wedge diagnosis needs the NAMES
    (``coast-collect-watchdog``, lease keeper, ...) to tell the hung
    collect from the scaffolding.  Falls back to faulthandler if frame
    walking fails."""
    try:
        import traceback
        names = {t.ident: t.name for t in threading.enumerate()}
        chunks = []
        for ident, frame in sorted(sys._current_frames().items()):
            name = names.get(ident, "<unknown>")
            chunks.append(f"Thread {ident:#x} [{name}] "
                          "(most recent call last):\n"
                          + "".join(traceback.format_stack(frame)))
        return "\n".join(chunks)
    except Exception:  # noqa: BLE001 - stacks are best-effort
        try:
            import tempfile
            with tempfile.TemporaryFile(mode="w+") as fh:
                faulthandler.dump_traceback(file=fh, all_threads=True)
                fh.seek(0)
                return fh.read()
        except Exception as e:  # noqa: BLE001
            return f"<stack dump failed: {type(e).__name__}: {e}>"


class FlightRecorder:
    """One blackbox: a bounded ring of structured events + dump()."""

    def __init__(self, capacity: Optional[int] = None,
                 enabled: Optional[bool] = None,
                 dump_dir: Optional[str] = None,
                 source: str = ""):
        cap = capacity
        if cap is None:
            try:
                cap = int(os.environ.get("COAST_FLIGHTREC_CAP",
                                         DEFAULT_CAPACITY))
            except ValueError:
                cap = DEFAULT_CAPACITY
        self.capacity = max(int(cap), 1)
        self.enabled = _env_enabled() if enabled is None else bool(enabled)
        self.dump_dir = dump_dir
        self.source = source
        self.events: Deque[Dict[str, object]] = collections.deque(
            maxlen=self.capacity)
        self.dumps: List[str] = []       # bundle paths written so far
        self._lock = threading.Lock()
        self._seq = 0
        self._epoch = time.time()
        self._origin = time.perf_counter()

    # -- event side ----------------------------------------------------------
    def record(self, event: str, **fields: object) -> None:
        """Append one structured event; thread-safe, bounded, cheap."""
        if not self.enabled:
            return
        t_mono = time.perf_counter()
        row: Dict[str, object] = {
            "event": str(event),
            "t_unix_s": round(self._epoch + (t_mono - self._origin), 6),
            "t_mono_s": round(t_mono, 6),
            "thread": threading.current_thread().name,
        }
        if fields:
            row.update(fields)
        with self._lock:
            row["seq"] = self._seq
            self._seq += 1
            self.events.append(row)

    def tail(self, n: Optional[int] = None) -> List[Dict[str, object]]:
        with self._lock:
            rows = list(self.events)
        return rows if n is None else rows[-int(n):]

    # -- dump side -----------------------------------------------------------
    def dump(self, reason: str, extra: Optional[Dict[str, object]] = None,
             stacks: bool = True) -> Optional[str]:
        """Write one atomic forensic bundle; returns its path (None when
        disabled or the write failed -- a dump must never take the
        process down with it, it IS the crash path)."""
        if not self.enabled:
            return None
        try:
            out_dir = self.dump_dir or _default_dir()
            os.makedirs(out_dir, exist_ok=True)
            with self._lock:
                rows = list(self.events)
                seq = self._seq
            bundle: Dict[str, object] = {
                "format": BUNDLE_FORMAT,
                "version": BUNDLE_VERSION,
                "reason": str(reason),
                "source": self.source,
                "written_unix_s": round(time.time(), 6),
                "process": {
                    "pid": os.getpid(),
                    "argv": list(sys.argv),
                    "python": sys.version.split()[0],
                    "platform": sys.platform,
                    "cwd": os.getcwd(),
                },
                "torch": _torch_meta(),
                "events_recorded_total": seq,
                "events": rows,
                "stacks": _all_thread_stacks() if stacks else "",
            }
            if extra:
                bundle["extra"] = dict(extra)
            name = (f"flightrec_{os.getpid()}_"
                    f"{int(time.time() * 1000)}_"
                    f"{_slug(reason)}.json")
            path = os.path.join(out_dir, name)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump(bundle, fh, separators=(",", ":"))
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
            with self._lock:
                self.dumps.append(path)
            return path
        except Exception:  # noqa: BLE001 - never crash the crash path
            return None

    # -- signal hook ---------------------------------------------------------
    def install_signal_handler(self,
                               signum: int = signal.SIGUSR1) -> bool:
        """Dump a bundle on ``signum`` (default SIGUSR1): the bench
        parent's "give me your blackbox before I kill you" channel.
        Main thread only (CPython restriction); returns False when the
        hook could not be installed."""
        def _handler(sig, frame):  # noqa: ARG001
            self.record("signal_dump", signum=int(sig))
            self.dump(f"signal:{int(sig)}")
        try:
            signal.signal(signum, _handler)
            return True
        except (ValueError, OSError):   # non-main thread / exotic platform
            return False


def _slug(text: str, limit: int = 48) -> str:
    out = "".join(c if c.isalnum() or c in "-_" else "-"
                  for c in str(text))[:limit]
    return out.strip("-") or "dump"


#: Shared no-op recorder: the ambient default, so ``record(...)`` is
#: always safe and costs one attribute test when nothing is installed.
NULL = FlightRecorder(capacity=1, enabled=False)

_active_lock = threading.Lock()
_active: List[FlightRecorder] = []


def current() -> FlightRecorder:
    """The innermost installed recorder of this PROCESS, else ``NULL``
    (process-global, unlike the spans stack: watchdog / lease-keeper
    threads and signal handlers must share the ring)."""
    return _active[-1] if _active else NULL


def install(recorder: Optional[FlightRecorder] = None,
            **kwargs: object) -> FlightRecorder:
    """Install a process-lifetime ambient recorder (fleet worker, bench
    worker, CLI verbs); returns it.  Idempotent layering: the newest
    install wins ``current()`` until :func:`uninstall`."""
    rec = recorder if recorder is not None else FlightRecorder(**kwargs)
    with _active_lock:
        _active.append(rec)
    return rec


def uninstall(recorder: FlightRecorder) -> None:
    with _active_lock:
        try:
            _active.remove(recorder)
        except ValueError:
            pass


@contextlib.contextmanager
def activate(recorder: Optional[FlightRecorder] = None,
             **kwargs: object) -> Iterator[FlightRecorder]:
    """Scoped install for tests and embedded runs."""
    rec = install(recorder, **kwargs)
    try:
        yield rec
    finally:
        uninstall(rec)


def record(event: str, **fields: object) -> None:
    """``current().record(...)`` -- the one-liner for instrumenting
    free functions (one attribute test when nothing is installed)."""
    current().record(event, **fields)


def newest_bundle(dump_dir: Optional[str] = None) -> Optional[str]:
    """Path of the most recently written bundle in ``dump_dir`` (the
    bench parent's harvest after SIGUSR1-ing a wedged child), or None."""
    out_dir = dump_dir or _default_dir()
    try:
        names = [n for n in os.listdir(out_dir)
                 if n.startswith("flightrec_") and n.endswith(".json")]
    except OSError:
        return None
    if not names:
        return None
    paths = [os.path.join(out_dir, n) for n in names]
    try:
        return max(paths, key=os.path.getmtime)
    except OSError:
        return None


def read_bundle(path: str) -> Dict[str, object]:
    """Parse + sanity-check one bundle (the smoke/test oracle)."""
    with open(path) as fh:
        doc = json.load(fh)
    if doc.get("format") != BUNDLE_FORMAT:
        raise ValueError(f"not a flight-recorder bundle: {path}")
    return doc
