"""CI baseline artifact: the committed ground truth a check diffs against.

The port's copy of ``coast_tpu/ci/baseline.py``.  One JSON document
(``artifacts/ci_baseline.json`` is the repo's own), format
``coast-ci-baseline`` version 1, loadable by either package:

  * top level -- ``format``/``version``, informational provenance
    (``created_unix``, and ``torch``/``device`` where the reference
    writes ``jax``/``backend``; neither package reads them back, so a
    document written by one loads in the other), and ``targets``;
  * ``targets`` -- one block per campaign, keyed by :func:`target_id`
    (``benchmark|opt_passes|section|s<seed>``), each carrying

      - ``spec``: the campaign's identity in the shared
        :class:`~coast_tpu_torch.inject.spec.CampaignSpec` queue-item
        encoding (what the check enqueues, delta_from added);
      - ``strategy`` / ``config_sha`` / ``partition`` /
        ``section_fingerprints``: the build the counts describe --
        the fingerprints are what the check diffs;
      - ``n`` / ``physical_n`` / ``counts``: the classification
        distribution (effective injections) the verdict compares
        Wilson intervals against;
      - ``journal``: the campaign's journal records as compact ndjson
        LINES (header + equiv representatives + batch rows, volatile
        span timing stripped).  Materialized back to a file at check
        time, this is the delta splice base -- the row-level ground
        truth that makes re-injecting only changed sections sound.

The journal rides INSIDE the artifact so ``check`` runs out of the box
from a fresh clone: no side-channel files, no object storage, one
committed JSON.  Size stays small because the stored rows are the
equivalence representatives (~10-26x fewer than effective injections).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

__all__ = ["BASELINE_FORMAT", "BASELINE_VERSION", "BaselineError",
           "target_id", "journal_lines", "materialize_journal",
           "load_baseline", "write_baseline", "target_block"]

BASELINE_FORMAT = "coast-ci-baseline"
BASELINE_VERSION = 1

#: Journal record kinds a baseline keeps: everything a delta base reader
#: (``load_delta_base``) consumes.  Retry/geometry/early_stop forensics
#: and per-batch span timing are run-time accidents, not ground truth.
_KEEP_KINDS = ("header", "equiv_schedule", "batch")
_STRIP_BATCH_KEYS = ("spans", "stage_seconds")


class BaselineError(RuntimeError):
    """An unreadable or malformed baseline artifact (CI infra failure)."""


def target_id(spec) -> str:
    """Human-readable stable key of one target: the build + campaign
    axes that distinguish baseline rows (n/batch ride in the spec)."""
    return (f"{spec.benchmark}|{spec.opt_passes}|{spec.section}"
            f"|s{spec.seed}")


def journal_lines(path: str) -> List[str]:
    """A journal file reduced to its baseline form: one compact JSON
    string per kept record, batch records stripped of volatile timing.
    Raises :class:`BaselineError` on anything unparseable -- a baseline
    must never embed a journal it cannot re-materialize."""
    out: List[str] = []
    try:
        with open(path) as fh:
            raw_lines = fh.read().splitlines()
    except OSError as e:
        raise BaselineError(f"cannot read journal {path!r}: {e}") from e
    for i, raw in enumerate(raw_lines):
        if not raw.strip():
            continue
        try:
            rec = json.loads(raw)
        except ValueError as e:
            raise BaselineError(
                f"journal {path!r} line {i + 1} is not JSON: {e}") from e
        if rec.get("kind") not in _KEEP_KINDS:
            continue
        if rec.get("kind") == "batch":
            rec = {k: v for k, v in rec.items()
                   if k not in _STRIP_BATCH_KEYS}
        out.append(json.dumps(rec, separators=(",", ":")))
    if not out:
        raise BaselineError(f"journal {path!r} has no records to keep")
    return out


def materialize_journal(lines: List[str], path: str) -> str:
    """Write baseline journal lines back to a file (the delta splice
    base ``check`` points items at).  Returns ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def target_block(spec, result: Dict[str, object],
                 journal_path: str) -> Dict[str, object]:
    """One baseline target from a fleet done-record ``result`` and the
    item's journal.  The build facts (strategy, config_sha, partition,
    section_fingerprints) come from the journal HEADER -- the one
    record that already pins them -- not from a second derivation."""
    lines = journal_lines(journal_path)
    header = json.loads(lines[0])
    if header.get("kind") != "header":
        raise BaselineError(
            f"journal {journal_path!r} does not start with a header")
    counts = {k: int(v)
              for k, v in (result.get("counts") or {}).items()}
    block: Dict[str, object] = {
        # The CALLER's spec, not the done record's: a check item's spec
        # carries its temp delta_from path and stop-when override, and a
        # refreshed baseline must store the clean campaign identity.
        "spec": spec.to_item(),
        "strategy": header.get("strategy"),
        "config_sha": header.get("config_sha"),
        "partition": (header.get("equiv") or {}).get("partition"),
        "section_fingerprints": dict(
            header.get("section_fingerprints") or {}),
        "n": int(result.get("injections", 0)),
        "physical_n": int(result.get("physical_injections",
                                     result.get("injections", 0))),
        "counts": counts,
        "journal": lines,
    }
    if not block["section_fingerprints"]:
        raise BaselineError(
            f"journal {journal_path!r} carries no section fingerprints "
            "(was the campaign run without equiv?); a baseline without "
            "fingerprints cannot seed delta checks")
    return block


def load_baseline(path: str) -> Dict[str, object]:
    """Read + validate a baseline artifact."""
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except OSError as e:
        raise BaselineError(f"cannot read baseline {path!r}: {e}") from e
    except ValueError as e:
        raise BaselineError(
            f"baseline {path!r} is not JSON: {e}") from e
    if doc.get("format") != BASELINE_FORMAT:
        raise BaselineError(
            f"baseline {path!r} has format {doc.get('format')!r}; "
            f"want {BASELINE_FORMAT!r}")
    if int(doc.get("version", 0)) > BASELINE_VERSION:
        raise BaselineError(
            f"baseline {path!r} is version {doc.get('version')}, newer "
            f"than this tool understands ({BASELINE_VERSION}); update "
            "the tree or rebuild the baseline")
    if not doc.get("targets"):
        raise BaselineError(f"baseline {path!r} has no targets")
    return doc


def write_baseline(doc: Dict[str, object], path: str) -> None:
    """Atomically write a baseline artifact.  ``indent=1`` keeps the
    committed file diffable per target/record (the journal records are
    pre-compacted strings, so the bulk stays one line each)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def assemble(targets: Dict[str, Dict[str, object]],
             device: Optional[str] = None,
             extra: Optional[Dict[str, object]] = None
             ) -> Dict[str, object]:
    """The top-level artifact document around a targets map.
    ``device`` is the device type the campaigns ran on (provenance
    only, like the torch version)."""
    import time

    import torch
    doc: Dict[str, object] = {
        "format": BASELINE_FORMAT, "version": BASELINE_VERSION,
        "created_unix": round(time.time(), 3),
        "targets": targets,
        "torch": torch.__version__,
    }
    if device is not None:
        doc["device"] = str(device)
    if extra:
        doc.update(extra)
    return doc
