"""Durable campaign journal: a crash-safe record of every collected batch.

The counterpart of ``coast_tpu/inject/journal.py``, record for record: a
journal is an append-only ndjson file whose line 1 is the **header** --
the campaign's identity (benchmark, strategy, protection-config
fingerprint, seed, n, start_num, batch geometry, schedule fingerprint,
and the absent-means-default keys ``fault_model``, ``collect``, ``fuse``,
``stop_when``).  The port writes the reference's header key for key, so
on integer regions a journal written by either package resumes under the
other.  Every later line is one **record**, fsync'd as it is appended, so
a kill at any instant leaves at worst one torn trailing line, which
:meth:`CampaignJournal._load` drops (and ``open`` truncates before the
next append); a corrupt line anywhere else is a hard error:

  * ``batch``    -- one collected batch: its row range (``lo``, ``n``),
    the per-run ``codes``/``errors``/``corrected``/``steps`` columns, the
    cumulative class counts and the stage seconds so far.  Sparse-collect
    campaigns write the same kind with ``"sparse": true``: the batch's
    class histogram and invalid-draw count stand in for the columns,
    which then cover only its interesting rows, keyed by ``rows``.
  * ``chunk``    -- one completed chunk of a multi-chunk campaign
    (``run_until_errors`` / ``replay_chunks``).
  * ``geometry`` -- the runner halved ``batch_size`` after an
    out-of-memory failure (:mod:`coast_tpu_torch.inject.resilience`).
  * ``retry``    -- a transient or wedged batch was re-dispatched
    (forensics only; resume ignores it).
  * ``early_stop`` -- the ``stop_when`` condition tripped after ``rows``
    rows: the journal is complete at that prefix.

Resume (``CampaignJournal.open`` on an existing file) validates the header
against the current campaign and refuses a mismatch
(:class:`JournalMismatchError` and its typed subclasses); ``batch_prefix``
then returns the contiguous completed-batch prefix, so ``run_schedule``
restarts at the first missing batch and the resumed campaign's ``codes``
equal the uninterrupted run's.  Each open records a ``journal_open``
event in the flight recorder (``obs/flightrec.py``).
"""

from __future__ import annotations

import dataclasses
import errno
import hashlib
import json
import os
from typing import Dict, List, Optional

import numpy as np

from coast_tpu_torch.obs import flightrec
from coast_tpu_torch.inject.spec import (header_fault_model, header_fuse,
                                   header_placement)

try:
    import fcntl
except ImportError:                     # pragma: no cover - non-POSIX
    fcntl = None

__all__ = [
    "JournalError", "JournalExistsError", "JournalMismatchError",
    "FaultModelMismatchError", "PlacementMismatchError",
    "FuseStepMismatchError", "JournalLockedError", "CampaignJournal",
    "schedule_fingerprint", "config_fingerprint",
]


class JournalError(RuntimeError):
    """Base class for journal failures (corrupt file, misuse)."""


class JournalExistsError(JournalError):
    """A non-empty journal exists and the caller did not ask to resume."""


class JournalMismatchError(JournalError):
    """The journal's header does not describe the current campaign."""


class JournalLockedError(JournalError):
    """Another process holds the journal's exclusive append lock.

    Every journal takes a non-blocking ``flock`` on its append handle
    for as long as it is open, so two fleet workers (or a worker and a
    wrongly-requeued duplicate of itself) can never interleave appends
    into one journal -- the loser fails fast with this typed error
    instead of silently corrupting the batch stream.  The lock dies
    with the process, so a SIGKILL'd worker's journal is immediately
    claimable by its replacement."""


class FaultModelMismatchError(JournalMismatchError):
    """The journal records a different FAULT MODEL than the resuming
    campaign.  Raised before (and instead of) the generic header diff: a
    model change also changes the schedule fingerprint, and "schedule-sha
    mismatch" would bury the actual cause -- the operator changed what an
    injection *is*, not the seed."""


class PlacementMismatchError(JournalMismatchError):
    """The journal records a different VOTER PLACEMENT than the resuming
    campaign.  Same burying argument as the fault model: the placement
    changes the region itself (halo leaf shape, memory map, schedule and
    config fingerprints), and the generic diff would report those
    derived symptoms instead of the knob the operator flipped.  Absent
    header key == ``"compute"`` (the registry build; pre-placement
    journals resume unchanged -- the rule lives in
    :func:`coast_tpu_torch.inject.spec.header_placement`)."""


class FuseStepMismatchError(JournalMismatchError):
    """The journal records a different STEP ENGINE (fused vs. unfused)
    than the resuming campaign.  The fused path is pinned bit-identical,
    but the program the rows measured (op counts, kernel schedule, MFU
    attribution) is not the same program -- blending rows from both
    engines into one journal would corrupt any perf claim made from it.
    Absent header key == unfused (pre-fusion journals resume unchanged
    -- the rule lives in :func:`coast_tpu_torch.inject.spec.header_fuse`)."""


def schedule_fingerprint(sched) -> str:
    """sha256 over a FaultSchedule's columns + seed: the journal's proof
    that a resumed campaign will inject exactly the recorded faults.
    Multi-site schedules also hash the fault model and every extra
    flip-group row; single-site schedules hash exactly the historical
    columns, so pre-model journals still validate."""
    h = hashlib.sha256()
    h.update(str(int(sched.seed)).encode())
    for field in ("leaf_id", "lane", "word", "bit", "t"):
        col = np.ascontiguousarray(getattr(sched, field), dtype=np.int32)
        h.update(col.tobytes())
    extra = getattr(sched, "extra", None)
    if extra is not None:
        h.update(sched.model.spec().encode())
        for key in sorted(extra):
            h.update(np.ascontiguousarray(extra[key],
                                          dtype=np.int32).tobytes())
    weights = getattr(sched, "class_weight", None)
    if weights is not None:
        # Equivalence-reduced schedule: the weights are part of what a
        # resumed campaign must replay exactly (they multiply counts).
        h.update(b"equiv")
        h.update(np.ascontiguousarray(weights, dtype=np.int64).tobytes())
    return h.hexdigest()


def config_fingerprint(cfg) -> str:
    """Stable fingerprint of a ProtectionConfig: resuming under different
    protection flags would measure a different program."""
    fields = dataclasses.asdict(cfg)
    # Evolution rule: knobs added after journals existed must vanish
    # from the fingerprint at their default value, or every pre-knob
    # journal's config_sha would spuriously change and refuse to resume.
    if not fields.get("fuse_step", False):
        fields.pop("fuse_step", None)
    doc = json.dumps(fields, sort_keys=True, default=str)
    return hashlib.sha256(doc.encode()).hexdigest()[:16]


#: Header keys that may legitimately differ between the original run and
#: a resume (batch geometry is re-negotiable: OOM degradation changes it
#: mid-campaign, and the resumed process may choose another size -- the
#: per-row records make resume independent of batching).
#: ``section_fingerprints`` is the DELTA-campaign vocabulary, not resume
#: identity: journals written before the equivalence pass have no block
#: at all and must still open/resume cleanly (the absent-means-legacy
#: rule of the fault-model key), and any program change the fingerprints
#: could flag is already refused by config_sha/schedule_sha.
_VOLATILE_KEYS = frozenset({"batch_size", "created", "argv",
                            "section_fingerprints"})


class CampaignJournal:
    """Append-only fsync'd ndjson journal for one campaign."""

    VERSION = 1

    def __init__(self, path: str, header: Dict[str, object],
                 records: Optional[List[Dict[str, object]]] = None,
                 fsync: bool = True):
        self.path = path
        self.header = header
        self.fsync = fsync
        self._records: List[Dict[str, object]] = records or []
        self.resumed = records is not None
        self._fh = None

    # -- construction --------------------------------------------------------
    @classmethod
    def open(cls, path: str, header: Dict[str, object],
             resume: bool = True, fsync: bool = True) -> "CampaignJournal":
        """Create a fresh journal at ``path``, or resume the one already
        there.

        A fresh journal writes (and fsyncs) the header line immediately.
        An existing non-empty journal is validated: every header key
        except the volatile geometry ones must match ``header`` exactly,
        else :class:`JournalMismatchError` names the differing keys.
        ``resume=False`` refuses an existing non-empty journal outright
        (:class:`JournalExistsError`) -- the CLI's no-``--resume``
        safety."""
        header = {"format": "coast-journal", "version": cls.VERSION,
                  **header}
        if os.path.exists(path) and os.path.getsize(path) > 0:
            if not resume:
                raise JournalExistsError(
                    f"journal {path!r} already exists; pass --resume to "
                    "continue it or delete the file to start fresh")
            # Lock BEFORE loading: two resuming processes must not both
            # truncate a torn tail / replay the prefix and then race
            # their appends.
            fh = cls._locked_append_handle(path)
            try:
                found_header, records, valid_bytes = cls._load(path)
                cls._validate(found_header, header, path)
            except BaseException:
                fh.close()
                raise
            if valid_bytes < os.path.getsize(path):
                # Torn trailing line (kill mid-append): cut it off NOW,
                # before any new append would fuse onto the fragment and
                # corrupt the journal for the *next* resume.  (The
                # append handle is O_APPEND: it seeks to the new end on
                # every write, so truncating under it is safe.)
                with open(path, "rb+") as tfh:
                    tfh.truncate(valid_bytes)
            j = cls(path, found_header, records, fsync=fsync)
            j._fh = fh
            flightrec.record("journal_open", path=path, resumed=True,
                             records=len(records))
            return j
        j = cls(path, header, fsync=fsync)
        j.append({"kind": "header", **header})
        flightrec.record("journal_open", path=path, resumed=False)
        return j

    @staticmethod
    def _locked_append_handle(path: str):
        """Open ``path`` for append and take the exclusive non-blocking
        ``flock`` every open journal holds until close: the single-writer
        guarantee of the fleet (two workers can never interleave appends
        into one journal).  Raises :class:`JournalLockedError` if another
        process -- or another open handle in this one -- holds it."""
        fh = open(path, "a")
        if fcntl is not None:
            try:
                fcntl.flock(fh.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError as e:
                if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK,
                               errno.EACCES):
                    fh.close()
                    raise JournalLockedError(
                        f"journal {path!r} is locked by another process "
                        "(its campaign is still appending); a second "
                        "writer would interleave batch records.  Wait "
                        "for the holder to finish or requeue the work "
                        "item") from e
                if e.errno in (errno.ENOLCK, errno.ENOTSUP,
                               errno.EOPNOTSUPP, errno.EINVAL):
                    # Filesystem without flock support (some NFS
                    # mounts): degrade to unlocked, same as the
                    # no-fcntl platform path -- a bogus "locked" error
                    # here would make every fleet item ping-pong
                    # between workers forever.
                    return fh
                fh.close()
                raise
        return fh

    @staticmethod
    def _load(path: str):
        """Parse an existing journal, tolerating one truncated trailing
        line (the crash-mid-append case); corruption anywhere else is a
        hard error.  Returns (header, records, valid_bytes) where
        valid_bytes is the file length up to the last complete record --
        the caller truncates the torn tail before appending."""
        records: List[Dict[str, object]] = []
        valid_bytes = 0
        with open(path, "rb") as fh:
            lines = fh.readlines()
        for i, raw in enumerate(lines):
            line = raw.strip()
            if not line:
                valid_bytes += len(raw)
                continue
            try:
                rec = json.loads(line.decode("utf-8"))
            except (ValueError, UnicodeDecodeError) as e:
                if i == len(lines) - 1:
                    break           # torn tail: the record never landed
                raise JournalError(
                    f"journal {path!r} is corrupt at line {i + 1}: "
                    f"{e}") from e
            records.append(rec)
            valid_bytes += len(raw)
        if not records or records[0].get("kind") != "header":
            raise JournalError(
                f"journal {path!r} has no header record; not a campaign "
                "journal (or its header line was torn)")
        header = {k: v for k, v in records[0].items() if k != "kind"}
        return header, records[1:], valid_bytes

    @staticmethod
    def _validate(found: Dict[str, object], expect: Dict[str, object],
                  path: str) -> None:
        # Fault-model mismatch first, as its own typed error: the model
        # also perturbs the schedule fingerprint, and the generic diff
        # below would report that derived symptom instead of the cause.
        # Absent key == "single" (journals written before the model;
        # the rule lives in coast_tpu_torch.inject.spec with the rest of the
        # identity vocabulary).
        found_model = header_fault_model(found)
        expect_model = header_fault_model(expect)
        if found_model != expect_model:
            raise FaultModelMismatchError(
                f"journal {path!r} records fault model {found_model!r} but "
                f"this campaign runs {expect_model!r}; a resumed campaign "
                "must replay the recorded flip groups exactly.  Rerun with "
                "the original --fault-model, or start a fresh journal.")
        found_place = header_placement(found)
        expect_place = header_placement(expect)
        if found_place != expect_place:
            raise PlacementMismatchError(
                f"journal {path!r} records voter placement "
                f"{found_place!r} but this campaign runs "
                f"{expect_place!r}; the two placements are different "
                "programs (different halo leaf, different blast radius). "
                "Rerun with the original --placement, or start a fresh "
                "journal.")
        found_fuse = header_fuse(found)
        expect_fuse = header_fuse(expect)
        if found_fuse != expect_fuse:
            raise FuseStepMismatchError(
                f"journal {path!r} records "
                f"{'the fused' if found_fuse else 'the unfused'} step "
                f"engine but this campaign runs "
                f"{'the fused' if expect_fuse else 'the unfused'} one; "
                "the rows measured a different compiled program.  Rerun "
                "with the original fuse mode (-fuseStep/-noFuseStep), or "
                "start a fresh journal.")
        keys = (set(found) | set(expect)) - _VOLATILE_KEYS
        diffs = [k for k in sorted(keys) if found.get(k) != expect.get(k)]
        if diffs:
            detail = ", ".join(
                f"{k}: journal={found.get(k)!r} vs current="
                f"{expect.get(k)!r}" for k in diffs)
            raise JournalMismatchError(
                f"journal {path!r} records a different campaign; "
                f"refusing to resume ({detail}).  Delete the journal or "
                "rerun with the original program/seed/flags.")

    # -- appending -----------------------------------------------------------
    def append(self, record: Dict[str, object]) -> None:
        """Append one record and make it durable (flush + fsync) before
        returning, so a kill immediately after a batch is collected can
        never lose that batch.

        Appends are write-only: ``self._records`` holds what ``open``
        loaded from disk (the resume queries' input), never live
        appends -- a journaled 10^6-row campaign must not keep every
        batch's columns resident for its whole lifetime."""
        if self._fh is None:
            self._fh = self._locked_append_handle(self.path)
        self._fh.write(json.dumps(record, separators=(",", ":")) + "\n")
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())

    def append_batch(self, lo: int, out: Dict[str, np.ndarray],
                     counts: Dict[str, int],
                     stage_seconds: Dict[str, float],
                     spans: "Optional[list]" = None) -> None:
        """One fsync'd record per collected batch: row range, per-run
        columns, cumulative counts, stage seconds so far.  ``spans`` is
        the batch's own span timing -- ``(name, unix_start_s,
        duration_s)`` triples for its pad/dispatch/collect spans -- so a
        resumed campaign can re-materialise the crashed run's batches
        into one coherent exported trace (marked as replayed).  Optional
        and absent-tolerant: journals written before the key (or with
        telemetry disabled) replay without trace continuity, nothing
        else changes."""
        rec = {
            "kind": "batch", "lo": int(lo), "n": int(len(out["code"])),
            "codes": out["code"].tolist(),
            "errors": out["errors"].tolist(),
            "corrected": out["corrected"].tolist(),
            "steps": out["steps"].tolist(),
            "counts": counts,
            "stage_seconds": {k: round(v, 6)
                              for k, v in stage_seconds.items()},
        }
        if spans:
            rec["spans"] = [[str(name), float(t), float(dur)]
                            for name, t, dur in spans]
        self.append(rec)

    def append_batch_sparse(self, lo: int, n: int,
                            hist, invalid: int, rows,
                            out: Dict[str, np.ndarray],
                            counts: Dict[str, int],
                            stage_seconds: Dict[str, float],
                            spans: "Optional[list]" = None) -> None:
        """Sparse-collect batch record: the batch's class histogram +
        weighted invalid-draw count, and the per-row columns for only
        its interesting rows (absolute row numbers in ``rows``).  Same
        ``lo``/``n`` contract as the dense record, so ``batch_prefix``
        and the fleet merge's contiguity check read both shapes; the
        concatenated ``codes`` of a sparse journal are exactly the
        campaign's interesting-row codes (the fleet parity pin's
        subject in sparse mode)."""
        rec = {
            "kind": "batch", "sparse": True,
            "lo": int(lo), "n": int(n),
            "hist": [int(v) for v in hist],
            "invalid": int(invalid),
            "rows": [int(r) for r in rows],
            "codes": out["code"].tolist(),
            "errors": out["errors"].tolist(),
            "corrected": out["corrected"].tolist(),
            "steps": out["steps"].tolist(),
            "counts": counts,
            "stage_seconds": {k: round(v, 6)
                              for k, v in stage_seconds.items()},
        }
        if spans:
            rec["spans"] = [[str(name), float(t), float(dur)]
                            for name, t, dur in spans]
        self.append(rec)

    def append_chunk(self, res) -> None:
        """One completed chunk of a multi-chunk campaign (the CampaignResult
        of one ``run`` call inside ``run_until_errors``/``replay_chunks``)."""
        self.append({
            "kind": "chunk", "seed": int(res.seed), "n": int(res.n),
            "start_num": int(res.start_num),
            "codes": res.codes.tolist(),
            "errors": res.errors.tolist(),
            "corrected": res.corrected.tolist(),
            "steps": res.steps.tolist(),
            "counts": {k: int(v) for k, v in res.counts.items()},
            "seconds": round(float(res.seconds), 6),
            "stage_seconds": {k: round(v, 6)
                              for k, v in res.stages.items()},
        })

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "CampaignJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- resume queries (over the records loaded at open, not live
    # appends -- see append) -------------------------------------------------
    def records(self) -> List[Dict[str, object]]:
        return list(self._records)

    def batch_prefix(self, base: int, n_rows: int) -> List[Dict[str, object]]:
        """The contiguous completed-batch prefix of rows
        [``base``, ``base + n_rows``): batch records starting exactly at
        ``base`` with no gap.  ``run_schedule`` restarts at the first
        missing batch (``base + sum(n for rec in prefix)``).  Records
        below ``base`` belong to earlier chunks sharing this journal;
        a gap or out-of-range record ends the prefix (those rows were
        dispatched but never collected)."""
        out: List[Dict[str, object]] = []
        expected = int(base)
        for rec in self._records:
            if rec.get("kind") != "batch":
                continue
            lo = int(rec["lo"])
            if lo < base:
                continue
            if lo != expected or expected + int(rec["n"]) > base + n_rows:
                break
            out.append(rec)
            expected += int(rec["n"])
        return out

    def chunk_records(self) -> List[Dict[str, object]]:
        """Completed multi-chunk records, in append order."""
        return [r for r in self._records if r.get("kind") == "chunk"]
