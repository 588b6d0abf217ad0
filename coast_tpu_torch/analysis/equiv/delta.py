"""Delta campaigns: re-inject only the sections whose propagation changed.

The counterpart of ``coast_tpu/analysis/equiv/delta.py``.

FastFlip's compositional observation applied to the journal: a completed
campaign journal already records every site's outcome AND (since the
equivalence pass) a per-section propagation fingerprint.  After a code
change, sections whose fingerprint is unchanged have provably identical
dataflow cones -- their recorded outcomes remain valid, so a delta
campaign re-runs only the sites of changed sections and splices the
rest from the prior journal.

Splicing is by *site identity* (leaf, lane, word, bit, t), never by row
position: an equivalence-reduced schedule may gain/lose representatives
for the changed sections, and site-keyed lookup keeps the unchanged
rows aligned regardless.  A site that cannot be matched (new section,
drifted class weight) is conservatively re-injected.

Incompatible journals refuse with the typed :class:`DeltaMismatchError`
(a :class:`~coast_tpu_torch.inject.journal.JournalMismatchError`): a delta
can only be computed against a *completed* single-seed ``run`` journal
for the same benchmark/strategy/seed/n/fault-model whose header carries
the fingerprint block.  Journals written before the equivalence pass
have no fingerprint block and are refused loudly -- they still open and
resume normally (tests pin that), they just cannot seed a delta.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from coast_tpu_torch.inject.journal import CampaignJournal, JournalMismatchError
from coast_tpu_torch.inject.spec import CampaignSpec

#: Header-level keys that must match between the delta base and the
#: current campaign, beyond the shared spec vocabulary
#: (:meth:`CampaignSpec.delta_identity` -- benchmark / seed / n /
#: start_num / fault_model, with the absent-means-default rules decoded
#: in one place).  The protection-config fingerprint is deliberately in
#: NEITHER: the config (and the program) changing is the whole point of
#: a delta -- the per-section fingerprints decide what that change
#: invalidated.
_HEADER_IDENTITY_KEYS = ("mode", "strategy")


class DeltaMismatchError(JournalMismatchError):
    """The delta base journal cannot seed a delta campaign (wrong mode,
    different campaign identity, missing fingerprint block, or an
    incomplete row record)."""


@dataclasses.dataclass
class DeltaPlan:
    """What a delta campaign will (re-)do, before any dispatch."""

    changed_sections: List[str]
    reused_rows: int
    reinjected_rows: int
    run_mask: np.ndarray            # bool [n_rows] of the current schedule
    spliced: Dict[str, np.ndarray]  # per-run columns for reused rows

    def summary(self) -> Dict[str, object]:
        return {"changed_sections": list(self.changed_sections),
                "reused_rows": int(self.reused_rows),
                "reinjected_rows": int(self.reinjected_rows)}


def _site_keys(leaf_id, lane, word, bit, t) -> np.ndarray:
    return np.stack([np.asarray(c, np.int64)
                     for c in (leaf_id, lane, word, bit, t)], axis=1)


def load_delta_base(path: str):
    """Read a completed run journal: (header, site columns, outcome
    columns).  The site columns come from the journal's own
    ``equiv_schedule`` record when present (equivalence-reduced
    campaigns persist their representatives), else the caller
    reconstructs them from the seed and validates the schedule sha."""
    header, records, _ = CampaignJournal._load(path)
    if header.get("mode") != "run":
        raise DeltaMismatchError(
            f"delta base {path!r} records mode "
            f"{header.get('mode')!r}; only single-seed 'run' journals "
            "carry the row-aligned records a delta can splice")
    if "section_fingerprints" not in header:
        raise DeltaMismatchError(
            f"delta base {path!r} has no section-fingerprint block "
            "(written before the equivalence pass?); rerun the base "
            "campaign once to record fingerprints, then delta against "
            "that journal")
    batches = sorted((r for r in records if r.get("kind") == "batch"),
                     key=lambda r: int(r["lo"]))
    cols = {k: [] for k in ("codes", "errors", "corrected", "steps")}
    expected = 0
    for rec in batches:
        if int(rec["lo"]) != expected:
            raise DeltaMismatchError(
                f"delta base {path!r} is missing rows at {expected} "
                "(interrupted campaign?); finish or rerun the base "
                "campaign before computing a delta from it")
        for k in cols:
            cols[k].extend(rec[k])
        expected += int(rec["n"])
    out = {k: np.asarray(v, np.int32) for k, v in cols.items()}
    sched_rec = next((r for r in records
                      if r.get("kind") == "equiv_schedule"), None)
    sites = None
    if sched_rec is not None:
        sites = {k: np.asarray(sched_rec[k], np.int32)
                 for k in ("leaf_id", "lane", "word", "bit", "t")}
        sites["class_weight"] = np.asarray(
            sched_rec.get("class_weight",
                          np.ones(len(sites["t"]), np.int64)), np.int64)
        if len(sites["t"]) != expected:
            raise DeltaMismatchError(
                f"delta base {path!r}: equiv_schedule records "
                f"{len(sites['t'])} rows but {expected} row outcomes "
                "were journaled")
    return header, sites, out, expected


def plan_delta(base_header: Dict[str, object],
               base_sites: Optional[Dict[str, np.ndarray]],
               base_out: Dict[str, np.ndarray],
               base_rows: int,
               current_header: Dict[str, object],
               current_fps: Dict[str, str],
               sched,
               section_names: Dict[int, str],
               base_path: str = "<journal>") -> DeltaPlan:
    """Decide which rows of the CURRENT schedule must be re-injected.

    ``sched`` is the current campaign's (possibly equivalence-reduced)
    FaultSchedule; ``base_sites`` the base journal's recorded sites
    (None for non-reduced bases, whose sites are the regenerated
    ``sched`` itself, validated upstream by schedule sha)."""
    base_id = {k: base_header.get(k) for k in _HEADER_IDENTITY_KEYS}
    cur_id = {k: current_header.get(k) for k in _HEADER_IDENTITY_KEYS}
    base_id.update(CampaignSpec.from_header(base_header).delta_identity())
    cur_id.update(CampaignSpec.from_header(current_header)
                  .delta_identity())
    for key in base_id:
        a, b = base_id[key], cur_id[key]
        if a != b:
            raise DeltaMismatchError(
                f"delta base {base_path!r} records {key}={a!r} but this "
                f"campaign has {key}={b!r}; a delta splices outcomes "
                "across a CODE change, not a campaign change -- rerun "
                "with the base campaign's parameters or start fresh")
    base_fps = dict(base_header.get("section_fingerprints") or {})
    if set(base_fps) != set(current_fps):
        raise DeltaMismatchError(
            f"delta base {base_path!r} records sections "
            f"{sorted(base_fps)} but the current program has "
            f"{sorted(current_fps)}; the memory map changed, so the "
            "recorded schedule no longer addresses this program")
    changed = sorted(name for name in current_fps
                     if base_fps[name] != current_fps[name])
    changed_set = set(changed)

    n_rows = len(sched)
    leaf_names = np.array([section_names.get(int(l), "?")
                           for l in np.asarray(sched.leaf_id)])
    run_mask = np.isin(leaf_names, list(changed_set)) if changed_set \
        else np.zeros(n_rows, bool)

    cur_keys = _site_keys(sched.leaf_id, sched.lane, sched.word,
                          sched.bit, sched.t)
    cur_w = getattr(sched, "class_weight", None)
    if cur_w is None:
        cur_w = np.ones(n_rows, np.int64)
    if base_sites is not None:
        base_keys = _site_keys(*(base_sites[k] for k in
                                 ("leaf_id", "lane", "word", "bit", "t")))
        base_w = np.asarray(base_sites["class_weight"], np.int64)
        # Vectorized site-identity join (a no-op-rebuild delta against a
        # large journal must stay near-free): sort the base keys as a
        # structured view, binary-search every current key into it.
        void = [("", np.int64)] * cur_keys.shape[1]
        base_v = np.ascontiguousarray(base_keys).view(void).reshape(-1)
        cur_v = np.ascontiguousarray(cur_keys).view(void).reshape(-1)
        order = np.argsort(base_v)
        pos = np.searchsorted(base_v[order], cur_v)
        j = order[np.clip(pos, 0, len(order) - 1)] if len(order) \
            else np.zeros(n_rows, np.int64)
        matched = np.zeros(n_rows, bool) if not len(order) else (
            (pos < len(order)) & (base_v[j] == cur_v))
        # Unmatched site or drifted class weight: the partition moved
        # under this section even though its fingerprint matched --
        # conservatively re-inject.
        reuse = ~run_mask & matched & (base_w[j] == np.asarray(cur_w))
        run_mask |= ~reuse
        spliced = {k: np.zeros(n_rows, np.int32) for k in base_out}
        for k in base_out:
            spliced[k][reuse] = base_out[k][j[reuse]]
    else:
        # Positional splice: only sound when the regenerated schedule IS
        # the journaled one, row for row -- proven by the schedule sha,
        # not just the row count (a partition change can shift rows
        # while coincidentally preserving the total).
        from coast_tpu_torch.inject.journal import schedule_fingerprint
        if base_rows != n_rows:
            raise DeltaMismatchError(
                f"delta base {base_path!r} journaled {base_rows} rows "
                f"but the regenerated schedule has {n_rows}; the "
                "schedules no longer align")
        base_sha = base_header.get("schedule_sha")
        if base_sha != schedule_fingerprint(sched):
            raise DeltaMismatchError(
                f"delta base {base_path!r} has no equiv_schedule record "
                "and its schedule fingerprint does not match the "
                "regenerated schedule; rows cannot be spliced by "
                "position -- rerun the base campaign to record its "
                "representatives")
        spliced = {k: v.copy() for k, v in base_out.items()}
    reused = int(n_rows - run_mask.sum())
    return DeltaPlan(changed_sections=changed, reused_rows=reused,
                     reinjected_rows=int(run_mask.sum()),
                     run_mask=run_mask, spliced=spliced)
