"""Campaign logs in the reference's InjectionLog JSON schema.

The counterpart of ``coast_tpu/inject/logs.py``: the same writers and the
same bytes.  Each injection serialises to the dict layout of
supportClasses.InjectionLog.getDict (supportClasses.py:338-353) with a
result sub-dict whose discriminating keys match the FromDict dispatch
(supportClasses.py:355-389): "core" -> RunResult, "timeout" ->
TimeoutResult, "message" -> AbortResult, "invalid" -> InvalidResult.

Container formats: ``write_reference_json`` emits the reference tool's own
file container (exec path line + bare InjectionLog array,
jsonParser.py:121-133); ``write_json`` / ``write_ndjson`` /
``write_columnar`` use the repo's containers (summary header + runs) that
``coast_tpu/analysis/json_parser.py`` reads.  For the same campaign, every
per-injection line or row the port writes equals the reference's byte for
byte (``tests/test_torch_logs.py``); line 1 of the reference container
names the port's own model module (``models.model_source``).

Dense ndjson rows, one-shot and streamed, are formatted by the native C++
encoder (``native.ndjson_stream_rows`` / ``ndjson_stream_batch``); sparse
rows keep the Python template formatter (``_ndjson_rows_py``), as in the
reference, whose rules these are.  The two give the same bytes.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import queue
import shutil
import threading
import time
from typing import Dict, List, Optional

from coast_tpu_torch import native, obs
from coast_tpu_torch.inject import classify as cls
from coast_tpu_torch.inject.campaign import CampaignResult, _rows_subset
from coast_tpu_torch.inject.mem import MemoryMap


def _timestamp() -> str:
    return datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S.%f")


def _gz_writer(raw, mode: str):
    """Deterministic gzip layer over an open binary file: no filename, no
    mtime in the member header, so the same campaign bytes compress to
    the same .gz bytes (the streamed-vs-one-shot parity tests compare
    compressed files directly).  Text modes get a TextIOWrapper whose
    close() finalises the gzip trailer but leaves ``raw`` open -- the
    caller still owns the fsync + rename."""
    import gzip
    import io
    gz = gzip.GzipFile(filename="", mode="wb", fileobj=raw, mtime=0)
    return gz if "b" in mode else io.TextIOWrapper(gz)


@contextlib.contextmanager
def _atomic_write(path: str, mode: str = "w"):
    """Crash-safe log writing: serialize into a same-directory temp file
    and ``os.replace`` it into place only when complete, so a crash (or
    SIGKILL) mid-serialize never leaves a truncated log that json_parser
    chokes on -- readers see either the old file or the whole new one.
    Any exception from the body discards the temp file and propagates.

    A ``.gz`` path transparently gzip-compresses the body (deterministic
    header; analysis/json_parser decompresses just as transparently) --
    one extension flip turns a 347 MB campaign ndjson into its
    compressed form with no call-site changes."""
    tmp = f"{path}.tmp.{os.getpid()}"
    gzipped = path.endswith(".gz")
    raw = open(tmp, "wb" if gzipped else mode)
    f = _gz_writer(raw, mode) if gzipped else raw
    try:
        yield f
        f.flush()
        if f is not raw:
            f.close()          # gzip trailer; GzipFile leaves raw open
        raw.flush()
        os.fsync(raw.fileno())
        raw.close()
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError, ValueError):
            if f is not raw:
                f.close()
        with contextlib.suppress(OSError):
            raw.close()
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


@contextlib.contextmanager
def _serialize_stage(res: CampaignResult):
    """Bill a writer's wall clock to the campaign's 'serialize' stage.  The
    campaign object exists before any log is written, so serialization
    lands in ``res.stages`` after the fact via record_stage; a result with
    no stage block (rebuilt, not run) gets none.  The writer also records
    a ``serialize`` span into the ambient telemetry, for trace export."""
    t0 = time.perf_counter()
    with obs.span("serialize"):
        yield
    if res.stages:
        res.record_stage("serialize", time.perf_counter() - t0)


def _result_dict(code: int, errors: int, corrected: int, steps: int,
                 ts: str) -> Dict[str, object]:
    if code in (cls.SUCCESS, cls.CORRECTED, cls.SDC):
        return {"timestamp": ts, "core": 0, "runtime": int(steps),
                "errors": int(errors), "faults": int(corrected)}
    if code == cls.DUE_ABORT:
        return {"type": "DWC/CFCSS", "message": "FAULT_DETECTED abort",
                "timestamp": ts, "errors": 1}
    if code == cls.DUE_TIMEOUT:
        return {"trap": False, "timeout": f"hit step bound at {int(steps)}",
                "timestamp": ts}
    if code == cls.DUE_STACK_OVERFLOW:
        # StackOverflowResult class: the guest's FreeRTOS hook line names
        # the overflowing task (decoder.py:69); the batched campaign
        # records which step the kernel's check tripped at instead.
        return {"stackOverflow": f"stack check tripped at step {int(steps)}",
                "taskName": "<kernel>", "timestamp": ts, "errors": 1}
    if code == cls.DUE_ASSERT:
        # AssertionFailResult class (decoder.py:67 configASSERT line).
        return {"assertion": f"kernel assert tripped at step {int(steps)}",
                "timestamp": ts, "errors": 1}
    if code == cls.TRAIN_SELF_HEAL:
        # Completed training run whose weights differ bit-for-bit from
        # the golden trajectory (errors > 0) but whose loss re-converged
        # within the heal window: the discriminating "selfHeal" key
        # rides alongside the ordinary RunResult fields so runtime/
        # error accounting works unchanged.
        return {"selfHeal": f"transient loss perturbation healed "
                            f"(E={int(errors)})",
                "timestamp": ts, "core": 0, "runtime": int(steps),
                "errors": int(errors), "faults": int(corrected)}
    if code == cls.TRAIN_SDC:
        # Persistent silent training corruption: final weights AND loss
        # diverged from the fault-free trajectory.
        return {"trainSdc": f"persistent weight corruption "
                            f"(E={int(errors)})",
                "timestamp": ts, "core": 0, "runtime": int(steps),
                "errors": int(errors), "faults": int(corrected)}
    return {"invalid": f"self-check out of domain (E={int(errors)})",
            "timestamp": ts}


def _columns(res: CampaignResult, mmap: MemoryMap):
    """Per-run columns as plain Python lists (one C-speed conversion each).

    Sparse-collect campaigns (``res.collect == "sparse"``) have per-run
    columns only for their INTERESTING rows: the site columns come from
    the host schedule at ``res.interesting_rows`` and an explicit
    ``number`` column carries each row's absolute injection number --
    the class totals live in the summary's histogram-derived counts, not
    in the rows."""
    secs = {s.leaf_id: s for s in mmap.sections}
    sched = res.schedule
    if res.collect != "dense":
        sched = _rows_subset(sched, res.interesting_rows)
    col = {
        "leaf_id": sched.leaf_id.tolist(),
        "lane": sched.lane.tolist(),
        "word": sched.word.tolist(),
        "bit": sched.bit.tolist(),
        "t": sched.t.tolist(),
        "code": res.codes.tolist(),
        "errors": res.errors.tolist(),
        "corrected": res.corrected.tolist(),
        "steps": res.steps.tolist(),
    }
    # Equivalence-reduced campaigns: each row is a class representative,
    # and the weight column multiplies it back out to effective
    # injections.  Exhaustive logs carry no such key.
    if sched.class_weight is not None:
        col["weight"] = sched.class_weight.tolist()
    if res.collect != "dense":
        col["number"] = [int(r) for r in res.interesting_rows]
    return col, secs


def _batch_arrays(part, out: Dict[str, "np.ndarray"]):
    """Per-run columns of ONE collected batch (or a whole dense campaign)
    as numpy arrays, the native encoder's input: the schedule slice
    supplies where/when, the collected ``out`` dict the outcome columns."""
    return {"leaf_id": part.leaf_id, "lane": part.lane, "word": part.word,
            "bit": part.bit, "t": part.t, "code": out["code"],
            "errors": out["errors"], "corrected": out["corrected"],
            "steps": out["steps"]}


def _batch_columns(part, out: Dict[str, "np.ndarray"]):
    """:func:`_batch_arrays` as plain Python lists, with the ``weight``
    column of a reduced schedule.  The streaming writer's unit of work."""
    col = {k: v.tolist() for k, v in _batch_arrays(part, out).items()}
    if part.class_weight is not None:
        col["weight"] = part.class_weight.tolist()
    return col


def _injection_log_rows(col, sec_kind: Dict[int, str],
                        sec_name: Dict[int, str], ts: str,
                        num0: int = 0) -> List[Dict[str, object]]:
    """InjectionLog dicts for the rows of ``col`` (plain-list columns),
    numbered ``num0``...: the one formatting loop behind the one-shot
    ``to_injection_logs`` AND the streaming reference writer, so the two
    cannot drift."""
    logs = []
    weights = col.get("weight")
    numbers = col.get("number")
    for i in range(len(col["code"])):
        lid = col["leaf_id"][i]
        t_i = col["t"][i]
        if t_i < 0:
            # Cache draw outside the program footprint: never fired (the
            # plugin's invalid-line discard); must not be attributed to a
            # real section.
            section, symbol = "cache-invalid", "<invalid-line>"
            name = f"<invalid-line>^bit{col['bit'][i]}"
        else:
            section, symbol = sec_kind[lid], sec_name[lid]
            name = f"{sec_name[lid]}[lane {col['lane'][i]}]^bit{col['bit'][i]}"
        row = {
            "timestamp": ts,
            "number": numbers[i] if numbers is not None else num0 + i,
            "section": section,
            "address": col["word"][i],
            "oldValue": None,              # values live on-device; the flip
            "newValue": None,              # is XOR(1<<bit), recorded below
            "sleepTime": 0,
            "cycles": t_i,                 # step index = cycle analogue
            "PC": t_i,
            "name": name,
            "symbol": symbol,              # clean key for per-symbol
                                           # attribution (elfUtils.py:105-176)
            "result": _result_dict(col["code"][i], col["errors"][i],
                                   col["corrected"][i], col["steps"][i], ts),
            "cacheInfo": None,
        }
        if weights is not None:
            # A class representative of a reduced campaign: it stands for
            # this many drawn sites.
            row["weight"] = weights[i]
        logs.append(row)
    return logs


def to_injection_logs(res: CampaignResult,
                      mmap: MemoryMap) -> List[Dict[str, object]]:
    ts = _timestamp()
    col, secs = _columns(res, mmap)
    sec_kind = {lid: s.kind for lid, s in secs.items()}
    sec_name = {lid: s.name for lid, s in secs.items()}
    return _injection_log_rows(col, sec_kind, sec_name, ts)


def write_reference_json(res: CampaignResult, mmap: MemoryMap, path: str,
                         exec_path: str = None) -> None:
    """Campaign log in the reference tool's OWN container: line 1 names
    the protected program (the guest-executable line; readJsonFile
    refuses the file when that path does not exist on disk,
    jsonParser.py:121-133), followed by one JSON array of InjectionLog
    dicts.  The reference's simulation/platform/jsonParser.py -- not a
    reimplementation -- parses these files directly, so its summary,
    compare-files/-dirs, and MWTF reports run unmodified on campaigns
    from this engine.  ``exec_path`` defaults to the benchmark's model
    module in the port (models.model_source).

    Known reference-tool limitation (theirs, not this writer's): its
    otherStats takes statistics.mean over fully-clean runs and raises
    StatisticsError on a campaign with zero successes (e.g. a small TMR
    campaign where every injection was corrected); its own QEMU
    campaigns always contain clean runs, so the path was never guarded."""
    if res.collect != "dense":
        raise ValueError(
            "write_reference_json needs a dense result: the reference "
            "container is a bare InjectionLog array with no summary "
            "block, so a sparse campaign's histogram counts would be "
            "silently lost (readers would summarize only the "
            "interesting rows)")
    if exec_path is None:
        from coast_tpu_torch.models import model_source
        exec_path = model_source(res.benchmark)
    exec_path = os.path.realpath(exec_path)
    if not os.path.exists(exec_path):
        raise FileNotFoundError(
            f"exec_path {exec_path!r} does not exist; the reference's "
            "readJsonFile exits on logs whose line-1 path is missing")
    with _serialize_stage(res):
        with _atomic_write(path) as f:
            f.write(exec_path + "\n")
            json.dump(to_injection_logs(res, mmap), f, indent=1)


def write_json(res: CampaignResult, mmap: MemoryMap, path: str) -> None:
    """Reference-schema structured log (threadFunctions.py:195-198 flushes
    per injection; we flush per campaign)."""
    with _serialize_stage(res):
        with _atomic_write(path) as f:
            json.dump({
                "summary": res.summary(),
                "runs": to_injection_logs(res, mmap),
            }, f, indent=1)


def write_ndjson(res: CampaignResult, mmap: MemoryMap, path: str) -> None:
    """Newline-delimited bulk log: line 1 is the campaign summary (with a
    ``"format": "ndjson"`` marker), each following line one run in the
    InjectionLog schema.  A dense campaign's rows are formatted by the
    native encoder in one C pass over the columns; a sparse campaign's
    (the interesting rows, with their own numbers) by the Python
    template loop.

    The stage accounting (res.stages['serialize']) is recorded *after*
    the write, so the summary line inside the file reflects the stages
    known before this serialization -- the serialize stage of a log file
    describes earlier writers, not itself."""
    ts = _timestamp()
    with _serialize_stage(res):
        # A reduced campaign's rows carry a weight key the native encoder
        # does not know: the Python formatter writes them.
        if res.collect == "dense" and res.schedule.class_weight is None:
            _write_ndjson_native(res, mmap, ts, path)
        else:
            _write_ndjson_py(res, mmap, ts, path)


def _escaped_leaf_tables(mmap: MemoryMap):
    """Per-leaf (kind, name) strings, JSON-escaped once a campaign, indexed
    by leaf id: the native encoder only formats numbers."""
    secs = {s.leaf_id: s for s in mmap.sections}
    n_leaves = max(secs) + 1 if secs else 0
    kind_by_leaf = [""] * n_leaves
    name_by_leaf = [""] * n_leaves
    for lid, s in secs.items():
        kind_by_leaf[lid] = json.dumps(s.kind)[1:-1]
        name_by_leaf[lid] = json.dumps(s.name)[1:-1]
    return kind_by_leaf, name_by_leaf


def _write_ndjson_native(res: CampaignResult, mmap: MemoryMap, ts: str,
                         path: str) -> None:
    col = _batch_arrays(res.schedule, {
        "code": res.codes, "errors": res.errors, "corrected": res.corrected,
        "steps": res.steps})
    with _atomic_write(path, "wb") as f:
        f.write((json.dumps({"summary": {**res.summary(),
                                         "format": "ndjson"}})
                 + "\n").encode())
        native.ndjson_stream_rows(0, res.n, col,
                                  *_escaped_leaf_tables(mmap), ts, f.write)


def _ndjson_templates(ts: str):
    """(result templates by class code, line template) for the Python
    ndjson formatter -- one compile per campaign, shared by the one-shot
    writer and the streaming writer."""
    # One result template per class, mirroring _result_dict (timestamps
    # identical across the campaign, as with write_json).
    run_tpl = ('{"timestamp": "%s", "core": 0, "runtime": %%(steps)d, '
               '"errors": %%(errors)d, "faults": %%(faults)d}' % ts)
    res_tpl = {
        cls.SUCCESS: run_tpl,
        cls.CORRECTED: run_tpl,
        cls.SDC: run_tpl,
        cls.DUE_ABORT: ('{"type": "DWC/CFCSS", "message": "FAULT_DETECTED '
                        'abort", "timestamp": "%s", "errors": 1}' % ts),
        cls.DUE_TIMEOUT: ('{"trap": false, "timeout": "hit step bound at '
                          '%%(steps)d", "timestamp": "%s"}' % ts),
        cls.INVALID: ('{"invalid": "self-check out of domain '
                      '(E=%%(errors)d)", "timestamp": "%s"}' % ts),
        cls.DUE_STACK_OVERFLOW: (
            '{"stackOverflow": "stack check tripped at step %%(steps)d", '
            '"taskName": "<kernel>", "timestamp": "%s", "errors": 1}' % ts),
        cls.DUE_ASSERT: (
            '{"assertion": "kernel assert tripped at step %%(steps)d", '
            '"timestamp": "%s", "errors": 1}' % ts),
        cls.TRAIN_SELF_HEAL: (
            '{"selfHeal": "transient loss perturbation healed '
            '(E=%%(errors)d)", "timestamp": "%s", "core": 0, '
            '"runtime": %%(steps)d, "errors": %%(errors)d, '
            '"faults": %%(faults)d}' % ts),
        cls.TRAIN_SDC: (
            '{"trainSdc": "persistent weight corruption (E=%%(errors)d)", '
            '"timestamp": "%s", "core": 0, "runtime": %%(steps)d, '
            '"errors": %%(errors)d, "faults": %%(faults)d}' % ts),
    }
    line_tpl = (
        '{"timestamp": "%s", "number": %%(i)d, "section": "%%(section)s", '
        '"address": %%(word)d, "oldValue": null, "newValue": null, '
        '"sleepTime": 0, "cycles": %%(t)d, "PC": %%(t)d, '
        '"name": "%%(name)s", "symbol": "%%(symbol)s", '
        '"result": %%(result)s, "cacheInfo": null}' % ts)
    return res_tpl, line_tpl


def _ndjson_rows_py(col, sec_kind: Dict[int, str], sec_name: Dict[int, str],
                    ts: str, num0: int, write) -> None:
    """Python template formatter for ndjson rows of ``col`` (plain-list
    columns), numbered ``num0``...; one ``write(str)`` per line.  Shared
    by the one-shot writer (num0=0, full columns) and the streaming
    writer (per-batch columns), byte-identical by construction."""
    res_tpl, line_tpl = _ndjson_templates(ts)
    weights = col.get("weight")
    numbers = col.get("number")
    for i in range(len(col["code"])):
        lid = col["leaf_id"][i]
        t_i = col["t"][i]
        if t_i < 0:
            section, symbol = "cache-invalid", "<invalid-line>"
            name = f"<invalid-line>^bit{col['bit'][i]}"
        else:
            section, symbol = sec_kind[lid], sec_name[lid]
            name = (f"{sec_name[lid]}[lane {col['lane'][i]}]"
                    f"^bit{col['bit'][i]}")
        result = res_tpl[col["code"][i]] % {
            "errors": col["errors"][i], "faults": col["corrected"][i],
            "steps": col["steps"][i]}
        # json.dumps on the string fields: leaf names are arbitrary
        # author-chosen strings and must be JSON-escaped.
        line = line_tpl % {
            "i": numbers[i] if numbers is not None else num0 + i,
            "section": json.dumps(section)[1:-1],
            "word": col["word"][i], "t": t_i,
            "name": json.dumps(name)[1:-1],
            "symbol": json.dumps(symbol)[1:-1],
            "result": result}
        if weights is not None:
            # A reduced campaign's representative: the weight goes before
            # the closing brace (exhaustive lines are unchanged).
            line = f'{line[:-1]}, "weight": {weights[i]}}}'
        write(line + "\n")


def _write_ndjson_py(res: CampaignResult, mmap: MemoryMap, ts: str,
                     path: str) -> None:
    col, secs = _columns(res, mmap)
    sec_kind = {lid: s.kind for lid, s in secs.items()}
    sec_name = {lid: s.name for lid, s in secs.items()}
    with _atomic_write(path) as f:
        f.write(json.dumps({"summary": {**res.summary(),
                                        "format": "ndjson"}}) + "\n")
        _ndjson_rows_py(col, sec_kind, sec_name, ts, 0, f.write)


#: Column order of _columns / write_columnar; the streaming columnar
#: assembly must emit keys in exactly this order for byte-identity.
_COLUMN_KEYS = ("leaf_id", "lane", "word", "bit", "t",
                "code", "errors", "corrected", "steps")


class StreamLogWriter:
    """Overlapped campaign-log serialization: the one-shot writers' output,
    produced incrementally while the campaign is still dispatching.

    A one-shot writer strictly follows the device work; this writer
    overlaps the two: ``CampaignRunner.run_schedule(stream=...)`` hands
    every collected batch to a background thread that serializes it
    immediately, so by the time the last batch is collected, nearly the
    whole log is already on disk.  (The thread shares the interpreter
    lock with the campaign's host loop: what it costs the campaign is
    measured in ``chip_smoke.py``.)

    Guarantees:

    * **Byte-identical output** to the one-shot writer of the same
      format (``write_ndjson`` / ``write_columnar`` /
      ``write_reference_json``) for the same campaign result.
    * **Journal composition**: a journal-resumed campaign feeds its
      replayed batches from disk through the same path, so the resumed
      stream file equals the uninterrupted run's (the batch columns come
      from the journal; no re-dispatch).
    * **Atomicity**: rows accumulate in a same-directory temp file; the
      final file appears only via ``os.replace`` at :meth:`finish`
      (``.gz`` paths compress at finish, trading that overlap for size).

    Accounting: ``finish`` bills the campaign's ``stages`` block with
    ``serialize`` = the *non-overlapped* wall clock (feed stalls + the
    finish-side drain/assemble) and ``overlap`` = the fraction of total
    serialization work that ran concurrently with dispatch.
    """

    FORMATS = ("ndjson", "columnar", "reference")

    def __init__(self, path: str, mmap: MemoryMap, fmt: str = "ndjson",
                 exec_path: Optional[str] = None, queue_batches: int = 8):
        if fmt not in self.FORMATS:
            raise ValueError(f"unknown stream log format {fmt!r}; "
                             f"one of {self.FORMATS}")
        self.path = path
        self.fmt = fmt
        self._secs = {s.leaf_id: s for s in mmap.sections}
        self._sec_kind = {lid: s.kind for lid, s in self._secs.items()}
        self._sec_name = {lid: s.name for lid, s in self._secs.items()}
        self._tables = _escaped_leaf_tables(mmap)
        self._exec_path = exec_path
        if exec_path is not None and not os.path.exists(exec_path):
            raise FileNotFoundError(
                f"exec_path {exec_path!r} does not exist; the reference's "
                "readJsonFile exits on logs whose line-1 path is missing")
        # Bounded queue: feed() blocks when the writer falls this many
        # batches behind -- that stall is the honest non-overlapped
        # serialize cost, and it caps resident batch memory.
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, queue_batches))
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None
        self._ts: Optional[str] = None
        self._rows_tmp = f"{path}.rows.{os.getpid()}"
        self._rows_f = None
        self._frags: Dict[str, List[str]] = {k: [] for k in _COLUMN_KEYS}
        self._expected = 0          # next row number feed() must supply
        self._bg_busy = 0.0         # background serialization seconds
        self._blocked = 0.0         # main-thread seconds stalled on feed
        self._finished = False
        self._sparse = False        # armed by the first feed_sparse()

    # -- lifecycle -----------------------------------------------------------
    def begin(self) -> None:
        """Open the rows temp file and start the writer thread.  Idempotent;
        ``feed`` calls it lazily on the first batch."""
        if self._thread is not None:
            return
        if self._finished:
            raise RuntimeError("StreamLogWriter already finished/aborted")
        self._ts = _timestamp()
        if self.fmt in ("ndjson", "reference"):
            self._rows_f = open(self._rows_tmp, "wb")
        self._thread = threading.Thread(target=self._worker,
                                        name="coast-stream-log",
                                        daemon=True)
        self._thread.start()

    def feed(self, num0: int, part, out: Dict[str, object]) -> None:
        """Hand one collected batch to the writer: ``part`` is the batch's
        FaultSchedule slice (where/when), ``out`` the trimmed outcome
        columns, ``num0`` the batch's first global row number.  Batches
        must arrive in order with no gaps -- exactly how
        ``run_schedule`` collects them."""
        if self._finished:
            # Without this guard a feed after finish()/abort() would
            # enqueue into the exited worker's queue -- the first
            # queue_batches feeds silently vanish, the next blocks
            # forever on the bounded put.
            raise RuntimeError("StreamLogWriter already finished/aborted")
        if self._exc is not None:
            raise RuntimeError(
                f"stream log writer for {self.path!r} failed"
            ) from self._exc
        self.begin()
        n = len(out["code"])
        if len(part) != n:
            raise ValueError(f"schedule slice ({len(part)} rows) does not "
                             f"match batch columns ({n} rows)")
        if num0 != self._expected:
            raise ValueError(
                f"stream feed out of order: got rows [{num0}, {num0 + n}) "
                f"but expected the stream to continue at {self._expected}")
        self._expected += n
        if n == 0:
            return
        t0 = time.perf_counter()
        self._q.put((num0, part, out))
        self._blocked += time.perf_counter() - t0

    def feed_sparse(self, numbers, part, out: Dict[str, object]) -> None:
        """Hand one sparse-collect batch's INTERESTING rows to the
        writer: ``numbers`` are the rows' absolute injection numbers
        (non-contiguous by construction), ``part`` the schedule subset
        at those rows, ``out`` their outcome columns.  ndjson only --
        the columnar/reference containers have no sparse row form."""
        if self.fmt != "ndjson":
            raise ValueError(
                "sparse streams support the ndjson format only (got "
                f"{self.fmt!r}); columnar/reference sparse logs are "
                "one-shot writers")
        if self._finished:
            raise RuntimeError("StreamLogWriter already finished/aborted")
        if self._exc is not None:
            raise RuntimeError(
                f"stream log writer for {self.path!r} failed"
            ) from self._exc
        self._sparse = True
        self.begin()
        n = len(out["code"])
        if len(part) != n or len(numbers) != n:
            raise ValueError(
                f"sparse feed shape mismatch: {len(numbers)} numbers, "
                f"{len(part)} schedule rows, {n} outcome rows")
        self._expected += n
        if n == 0:
            return
        t0 = time.perf_counter()
        self._q.put(([int(r) for r in numbers], part, out))
        self._blocked += time.perf_counter() - t0

    def finish(self, res: CampaignResult) -> None:
        """Drain the writer, assemble the final file atomically, and bill
        the campaign's stage block (``serialize`` non-overlapped seconds
        + ``overlap`` fraction).  ``res`` is the completed campaign the
        stream's batches came from -- its summary becomes the file
        header, exactly as the one-shot writer would emit it."""
        if self._finished:
            raise RuntimeError("StreamLogWriter already finished/aborted")
        self.begin()                # an empty campaign still gets a file
        t_fin0 = time.perf_counter()
        self._q.put(None)
        self._thread.join()
        self._finished = True
        if self._exc is not None:
            self._cleanup()
            raise RuntimeError(
                f"stream log writer for {self.path!r} failed"
            ) from self._exc
        if res.collect != "dense":
            # Sparse streams carry exactly the interesting rows.
            rows = len(res.codes)
        else:
            rows = res.physical_n if res.physical_n is not None else res.n
        if rows != self._expected:
            self._cleanup()
            raise ValueError(
                f"stream received {self._expected} rows but the campaign "
                f"result records {rows}; refusing to write a log that "
                "does not match its summary")
        try:
            t_asm0 = time.perf_counter()
            self._assemble(res)
            asm = time.perf_counter() - t_asm0
        finally:
            self._cleanup()
        fin = time.perf_counter() - t_fin0
        blocking = self._blocked + fin
        work = self._bg_busy + asm
        if res.stages:
            res.record_stage("serialize", blocking)
            res.stages["overlap"] = (
                round(max(0.0, 1.0 - blocking / work), 4) if work > 0
                else 0.0)

    def abort(self) -> None:
        """Discard the stream (campaign failed / interrupted): stop the
        thread and remove the temp files.  The final path is never
        touched.  Safe to call at any point, including twice."""
        if self._thread is not None and self._thread.is_alive():
            self._q.put(None)
            self._thread.join()
        self._finished = True
        self._cleanup()

    def __enter__(self) -> "StreamLogWriter":
        self.begin()
        return self

    def __exit__(self, exc_type, *exc) -> None:
        # Context-manager convenience for error paths only: a normal exit
        # still requires an explicit finish(res) (the writer cannot know
        # the campaign result); an exceptional exit aborts.
        if exc_type is not None and not self._finished:
            self.abort()

    def _cleanup(self) -> None:
        if self._rows_f is not None:
            with contextlib.suppress(OSError):
                self._rows_f.close()
            self._rows_f = None
        with contextlib.suppress(OSError):
            os.unlink(self._rows_tmp)
        self._frags = {k: [] for k in _COLUMN_KEYS}

    # -- background serialization --------------------------------------------
    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._exc is not None:
                continue            # drain so feeders never deadlock
            t0 = time.perf_counter()
            try:
                self._serialize_batch(*item)
            except BaseException as e:  # noqa: BLE001 - surfaced at feed
                self._exc = e
            finally:
                self._bg_busy += time.perf_counter() - t0

    def _serialize_batch(self, num0: int, part, out) -> None:
        if self.fmt == "ndjson":
            if self._sparse:
                # Non-contiguous injection numbers: ``num0`` is the feed's
                # list of them, written as an explicit number column by the
                # Python formatter (interesting rows are few).
                col = _batch_columns(part, out)
                col["number"] = num0
                _ndjson_rows_py(col, self._sec_kind, self._sec_name,
                                self._ts, 0,
                                lambda s: self._rows_f.write(s.encode()))
                return
            if part.class_weight is not None:
                # Weighted rows: the Python formatter, as the one-shot
                # writer does.
                _ndjson_rows_py(_batch_columns(part, out), self._sec_kind,
                                self._sec_name, self._ts, num0,
                                lambda s: self._rows_f.write(s.encode()))
                return
            native.ndjson_stream_batch(num0, _batch_arrays(part, out),
                                       *self._tables, self._ts,
                                       self._rows_f.write)
        elif self.fmt == "columnar":
            col = _batch_columns(part, out)
            for k in col:           # _COLUMN_KEYS (+ weight when reduced)
                self._frags.setdefault(k, []).append(
                    ", ".join(map(str, col[k])))
        else:                                   # reference
            col = _batch_columns(part, out)
            rows = _injection_log_rows(col, self._sec_kind, self._sec_name,
                                       self._ts, num0)
            text = json.dumps(rows, indent=1)
            # json.dumps(rows, indent=1) == "[\n" + elements + "\n]";
            # strip the brackets and join batches with ",\n" so the
            # concatenation equals json.dump over the whole list.
            inner = text[2:-2]
            if num0 > 0:
                self._rows_f.write(b",\n")
            self._rows_f.write(inner.encode())

    def _splice_rows(self, f) -> None:
        """Copy the accumulated rows file into the final file at the
        current position -- kernel-side (``os.sendfile``) for plain
        binary targets, userspace for ``.gz`` (the bytes must pass
        through the compressor)."""
        self._rows_f.flush()
        with open(self._rows_tmp, "rb") as rf:
            if not self.path.endswith(".gz"):
                f.flush()
                size = os.fstat(rf.fileno()).st_size
                off = 0
                try:
                    while off < size:
                        sent = os.sendfile(f.fileno(), rf.fileno(), off,
                                           size - off)
                        if sent == 0:
                            break
                        off += sent
                except OSError:
                    pass              # cross-device/FS refusal: userspace
                if off >= size:
                    return
                rf.seek(off)
            shutil.copyfileobj(rf, f, 1 << 20)

    # -- final assembly ------------------------------------------------------
    def _assemble(self, res: CampaignResult) -> None:
        if self.fmt == "ndjson":
            with _atomic_write(self.path, "wb") as f:
                f.write((json.dumps({"summary": {**res.summary(),
                                                 "format": "ndjson"}})
                         + "\n").encode())
                self._splice_rows(f)
        elif self.fmt == "columnar":
            # Byte-for-byte the json.dump(...) of write_columnar: same
            # top-level key order, default separators, list items joined
            # ", " -- with the column bodies spliced from the per-batch
            # fragments instead of materialised lists.
            sections = [{"leaf_id": s.leaf_id, "name": s.name,
                         "kind": s.kind, "lanes": s.lanes,
                         "words": s.words} for s in self._secs.values()]
            keys = list(_COLUMN_KEYS)
            if "weight" in self._frags:
                keys.append("weight")   # _columns' insertion order
            with _atomic_write(self.path) as f:
                f.write('{"summary": ')
                json.dump({**res.summary(), "format": "columnar"}, f)
                f.write(', "sections": ')
                json.dump(sections, f)
                f.write(', "columns": {')
                for j, k in enumerate(keys):
                    f.write(('' if j == 0 else ', ') + f'"{k}": [')
                    f.write(", ".join(frag for frag in self._frags[k]))
                    f.write(']')
                f.write('}}')
        else:                                   # reference
            exec_path = self._exec_path
            if exec_path is None:
                from coast_tpu_torch.models import model_source
                exec_path = model_source(res.benchmark)
            exec_path = os.path.realpath(exec_path)
            if not os.path.exists(exec_path):
                raise FileNotFoundError(
                    f"exec_path {exec_path!r} does not exist; the "
                    "reference's readJsonFile exits on logs whose line-1 "
                    "path is missing")
            with _atomic_write(self.path, "wb") as f:
                f.write((exec_path + "\n").encode())
                if self._expected == 0:
                    f.write(b"[]")
                else:
                    f.write(b"[\n")
                    self._splice_rows(f)
                    f.write(b"\n]")


def write_columnar(res: CampaignResult, mmap: MemoryMap, path: str) -> None:
    """Columnar bulk log: the whole campaign as parallel arrays plus the
    section table -- O(1) Python objects regardless of campaign size, and
    the natural format for numpy-side analysis.  json_parser summarises it
    directly without materialising per-run dicts."""
    with _serialize_stage(res):
        col, secs = _columns(res, mmap)
        with _atomic_write(path) as f:
            json.dump({
                "summary": {**res.summary(), "format": "columnar"},
                "sections": [{"leaf_id": s.leaf_id, "name": s.name,
                              "kind": s.kind, "lanes": s.lanes,
                              "words": s.words}
                             for s in secs.values()],
                "columns": col,
            }, f)
