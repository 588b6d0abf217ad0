"""Batched fault-injection campaigns over a protected program.

The counterpart of ``coast_tpu/inject/campaign.py``.  A seeded schedule is
cut into edge-padded batches; each batch runs as one
``ProtectedProgram.run_batch`` on the program's device and its rows are
classified there.  ``counts`` carries the reference's keys,
``cache_invalid`` included.  Two collection modes:

* ``collect="dense"``: the batch's fault columns go up, and the code,
  errors, corrected and steps columns of every row come back.
* ``collect="sparse"``: a seeded schedule's flip sites are regenerated on
  the device (``inject/device_gen.py``; a schedule the stream cannot
  reproduce, such as strata or a cache overlay, is uploaded once and
  sliced there), the class histogram and the compaction of the interesting
  rows (class outside success/corrected) are computed there, and only
  those come back: the histogram, a row bitmask and one packed word a row
  (:func:`_pack_layout`).  A batch whose interesting rows overflow the
  buffer falls back to a dense fetch.  Counts, interesting rows and their
  columns equal the dense path's; ``CampaignResult.codes`` then covers the
  interesting rows only, indexed by ``interesting_rows``.

Every batch is split as the reference splits it: the *dispatch* (the run
and the classification on the device, plus the sparse accounting) and the
*collect* (the device-to-host copy of the result columns).  Only the
collect runs under the retry policy's watchdog
(:func:`coast_tpu_torch.inject.resilience.watchdog_collect`), so a thread
it abandons holds a copy, not the engine; a re-dispatch allocates its own
tensors.  ``run_schedule`` takes the reference's ``progress``,
``journal``, ``journal_base``, ``stream`` and ``stop_when``: a journaled
campaign killed at any point resumes at its first missing batch with the
uninterrupted run's records, and a :class:`~coast_tpu_torch.inject.logs.
StreamLogWriter` serializes each batch as it lands.

``CampaignRunner(prog, equiv=True)`` reduces every seeded schedule to one
representative a propagation class (``analysis/equiv``): the reduced rows
run on the device like any others and each counts ``class_weight`` times,
so ``counts`` and ``n`` are over effective injections and ``physical_n``
is the rows that ran.  ``run_delta`` re-injects only the sections whose
propagation fingerprint changed since a journaled equivalence run and
splices the recorded outcomes of the rest.

``CampaignResult.transfer`` counts the host<->device bytes of every
campaign as the reference counts them, plus the one copy the port's engine
makes a batch and the reference's compiled loop does not: a bool a step,
and one a site column and a leaf, which steps and leaves the batch's flips
touch (``ProtectedProgram.fire_plan_bytes``).  Its ``reads`` counts the
campaign's blocking device-to-host reads: the engine's fire-plan copy and
halt reads (``ProtectedProgram.host_reads``) and the collect's copies.
``freeze_run`` and ``freeze_skipped`` count the engine's halt-freeze
selects of one leaf made and left out (``ProtectedProgram.freeze_run``,
``freeze_skipped``).

The runner's ``Telemetry`` times the campaign loop.  Top-level stages:
``sparse_setup``, ``pad``, ``dispatch``, ``collect``, ``account`` (a
collected batch's histogram, journal, stream, metrics and progress) and
``classify``; together they cover ``run_schedule``'s wall clock.  Nested
spans: ``setup.columns``, ``setup.weights`` and ``setup.upload`` under
``sparse_setup``; ``campaign.device_generator`` under ``pad``; the
engine's ``engine.upload``, ``engine.fire_read``, ``engine.halt_read``,
``step.region`` and ``engine.commit`` and ``campaign.sparse_accounting``
under ``dispatch``; ``collect.wait``
(the batch's first blocking copy) and ``collect.unpack`` (host decoding of
the rows) under ``collect``.  ``CampaignResult.stages`` holds each nested
span's seconds as ``"<stage>/<span>"``.
"""

from __future__ import annotations

import dataclasses
import gc
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from coast_tpu_torch import obs
from coast_tpu_torch.inject import classify as cls
from coast_tpu_torch.inject import resilience as resilience_mod
from coast_tpu_torch.inject.device_gen import DeviceGenError, DeviceScheduleGen
from coast_tpu_torch.inject.journal import (CampaignJournal,
                                            FaultModelMismatchError,
                                            FuseStepMismatchError,
                                            JournalError,
                                            JournalMismatchError,
                                            PlacementMismatchError,
                                            config_fingerprint,
                                            schedule_fingerprint)
from coast_tpu_torch.inject.mem import MemoryMap
from coast_tpu_torch.inject.schedule import (FaultModel, FaultSchedule,
                                             generate)
from coast_tpu_torch.inject.spec import (CampaignSpec, header_collect,
                                         header_fuse, header_placement)
from coast_tpu_torch.obs import flightrec

_COLUMNS = ("code", "errors", "corrected", "steps")
# Journal record key of each result column.
_RECORD_KEYS = (("code", "codes"), ("errors", "errors"),
                ("corrected", "corrected"), ("steps", "steps"))
# Spans around the sparse collect's own layers, once a batch
# (``breakdown.py`` reads their device time from a campaign's profile,
# recorded under ``Telemetry(profiler=True)``).
SPANS = ("campaign.device_generator", "campaign.sparse_accounting")

@dataclasses.dataclass
class CampaignResult:
    """Aggregate + per-run results of one campaign (host-side)."""

    benchmark: str
    strategy: str
    n: int
    counts: Dict[str, int]            # class name -> count
    seconds: float
    codes: np.ndarray                 # int32 class code per run
    errors: np.ndarray                # int32 E per run
    corrected: np.ndarray             # int32 F per run
    steps: np.ndarray                 # int32 T per run
    schedule: FaultSchedule
    seed: int
    # Multi-chunk campaigns (run_until_errors, replay_chunks): the (seed,
    # n, start_num) of every chunk, in order; replay_chunks(chunks)
    # reproduces ``codes``.  None for single-seed campaigns.
    chunks: Optional[List[Dict[str, int]]] = None
    # Wall-clock seconds per stage: the runner's Telemetry's top-level span
    # totals (schedule, sparse_setup, pad, dispatch, collect, account,
    # classify) and the nested spans' under "<stage>/<span>"
    # (``obs.spans.top_stages`` keeps the top level alone), plus serialize
    # (and the ``overlap`` fraction of a streamed log) once a log writer
    # ran; {} when telemetry is disabled.
    stages: Dict[str, float] = dataclasses.field(default_factory=dict)
    # First injection number of this campaign within its seed stream.
    start_num: int = 0
    # retry_transient / retry_wedged / oom_degrade counts when the runner
    # had a RetryPolicy, {} otherwise.
    resilience: Dict[str, int] = dataclasses.field(default_factory=dict)
    # Wilson intervals at the end and whether ``stop_when`` stopped the
    # campaign early; None unless it ran with ``stop_when``.
    convergence: Optional[Dict[str, object]] = None
    # Reliability-SLO verdicts (obs/slo.summary_block) when the runner
    # (or its metrics hub) carried an SLO set: per-objective attainment,
    # error-budget remaining, burn rate, worst verdict.  None otherwise.
    slo: Optional[Dict[str, object]] = None
    # "dense": the columns above cover all n rows; "sparse": only the
    # interesting rows, whose schedule-local indices (int64) are
    # ``interesting_rows``.
    collect: str = "dense"
    interesting_rows: Optional[np.ndarray] = None
    # Host<->device bytes, {"up", "down"}, and the blocking device-to-host
    # reads, "reads".
    transfer: Dict[str, int] = dataclasses.field(default_factory=dict)
    # The sharded runner's accounting (parallel/mesh.py): the mesh geometry
    # and the interesting rows each shard produced.  None on the
    # single-device runner, whose summary then has no "mesh" key.
    mesh: Optional[Dict[str, object]] = None
    # Equivalence-reduced campaigns: ``n`` and ``counts`` are over
    # effective injections (each representative times its class weight);
    # ``physical_n`` is the representatives that ran.  None when
    # exhaustive.
    physical_n: Optional[int] = None
    # A delta campaign's accounting (run_delta): the changed sections and
    # the reused and re-injected rows.  None otherwise.
    delta: Optional[Dict[str, object]] = None
    # Device-time attribution (CampaignRunner(profile=True)): the
    # obs.profiler block with its roofline "mfu" sub-block; None for an
    # unprofiled campaign.
    profile: Optional[Dict[str, object]] = None

    @property
    def injections_per_sec(self) -> float:
        """Rows the device ran a second."""
        phys = self.physical_n if self.physical_n is not None else self.n
        return phys / self.seconds if self.seconds > 0 else float("inf")

    def record_stage(self, name: str, seconds: float) -> None:
        """Add ``seconds`` to one stage (log writers bill 'serialize' here
        after the campaign object exists)."""
        self.stages[name] = self.stages.get(name, 0.0) + float(seconds)

    @property
    def due(self) -> int:
        """DUE bucket: aborts, timeouts and the DUE sub-buckets."""
        return sum(self.counts[k] for k in cls.DUE_CLASSES)

    @property
    def sdc_total(self) -> int:
        """Uncorrected silent corruption (``classify.SDC_CLASSES``)."""
        return sum(self.counts.get(k, 0) for k in cls.SDC_CLASSES)

    @property
    def fault_model(self) -> FaultModel:
        return self.schedule.model

    def summary(self) -> Dict[str, object]:
        """The reference's summary dict, key for key and in its order (the
        log writers' header and the supervisor's output line); its
        ``stages`` are the top-level ones."""
        stages = {k: round(v, 6)
                  for k, v in obs.spans.top_stages(self.stages).items()}
        stages.setdefault("overlap", 0.0)
        out = {
            "benchmark": self.benchmark,
            "strategy": self.strategy,
            "injections": self.n,
            **self.counts,
            "due": self.due,
            "seconds": round(self.seconds, 6),
            "injections_per_sec": round(self.injections_per_sec, 2),
            "seed": self.seed,
            "stages": stages,
        }
        if self.transfer:
            out["transfer_bytes"] = {
                "up": int(self.transfer.get("up", 0)),
                "down": int(self.transfer.get("down", 0))}
        if self.collect != "dense":
            out["collect"] = self.collect
            out["interesting_rows"] = int(len(self.codes))
        if self.fault_model.kind != "single":
            out["fault_model"] = self.fault_model.spec()
            out["fault_sites"] = self.fault_model.sites
        if self.physical_n is not None:
            out["physical_injections"] = int(self.physical_n)
            out["equiv_reduction"] = round(
                self.n / self.physical_n, 2) if self.physical_n else 0.0
        if self.delta is not None:
            out["delta"] = dict(self.delta)
        if self.profile is not None:
            # The device-time attribution, with the roofline accounting
            # split out as its own ``mfu`` key.
            prof = dict(self.profile)
            mfu = prof.pop("mfu", None)
            out["profile"] = prof
            if mfu is not None:
                out["mfu"] = mfu
        if self.convergence is not None:
            out["convergence"] = dict(self.convergence)
        if self.slo is not None:
            out["slo"] = dict(self.slo)
        if self.mesh is not None:
            out["mesh"] = dict(self.mesh)
        if self.chunks is not None:
            out["chunks"] = self.chunks
        if self.resilience:
            out["resilience"] = dict(self.resilience)
        return out


class _Degrade(Exception):
    """Internal signal: an out-of-memory failure; unwind to the batch loop,
    which halves the batch."""


def _release(exc: BaseException, device: torch.device) -> None:
    """Free what a failed batch still holds: the locals of the frames in
    its traceback (the engine's tensors of the batch), then the caching
    allocator's blocks, before a smaller batch is dispatched."""
    traceback.clear_frames(exc.__traceback__)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _pack_layout(out_words: int, max_steps: int) -> tuple:
    """Bit layout of the packed interesting-row word: code(4) | errors(e) |
    corrected(f) | steps(t), 32 bits in all.  ``steps`` is bounded by
    ``max_steps`` and ``errors`` by the output size for a valid run, so
    both always fit; ``corrected`` takes the rest, its all-ones value the
    sentinel of a row that does not pack, whose E/F/T ride the exact side
    buffer.  Returns (e_bits, f_bits, t_bits)."""
    t_bits = min(max(int(max_steps).bit_length(), 1), 20)
    e_bits = min(max(int(out_words + 1).bit_length(), 1), 27 - t_bits)
    f_bits = 28 - e_bits - t_bits
    return e_bits, f_bits, t_bits


def _as_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same low 32 bits
    (torch has no usable uint32; the host reads them back as uint32)."""
    return (words - ((words >> 31) << 32)).to(torch.int32)


def _sparse_device_outputs(out: Dict[str, torch.Tensor],
                           count_w: torch.Tensor, valid: torch.Tensor,
                           cap: int, pack: tuple) -> Dict[str, torch.Tensor]:
    """Device-side accounting of one batch: the weighted class histogram,
    the interesting-row bitmask and the fixed-capacity compaction buffers.

    Returns hist int32 [NUM_CLASSES], n_int/n_exact int32 scalars, mask
    [ceil(B/32)], packed [cap + 1] (both uint32 words as int32), exact
    int32 [cap + 1, 3] and ``head``, the histogram and the two counts in
    one int32 [NUM_CLASSES + 2] (one copy).  Slot ``cap`` is the overflow
    sink, dropped on the host."""
    e_bits, f_bits, t_bits = pack
    sentinel = (1 << f_bits) - 1
    code = out["code"].to(torch.int64)
    err, cor, steps = (out[k].to(torch.int64)
                       for k in ("errors", "corrected", "steps"))
    hist = torch.zeros(cls.NUM_CLASSES, dtype=torch.int64,
                       device=code.device).index_add_(
        0, code, count_w.to(torch.int64)).to(torch.int32)
    interesting = valid & (code > cls.CORRECTED)
    n_int = interesting.sum().to(torch.int32)
    packable = ((err >= 0) & (err < (1 << e_bits))
                & (cor >= 0) & (cor < sentinel)
                & (steps >= 0) & (steps < (1 << t_bits)))
    cu = code & 15
    word = (cu | ((err & ((1 << e_bits) - 1)) << 4)
            | ((cor & sentinel) << (4 + e_bits))
            | ((steps & ((1 << t_bits) - 1)) << (4 + e_bits + f_bits)))
    packed_word = _as_int32(torch.where(
        packable, word, cu | (sentinel << (4 + e_bits))))
    exact_sel = interesting & ~packable
    n_exact = exact_sel.sum().to(torch.int32)
    # Bit k of word w marks row w*32+k interesting: the host derives the
    # row numbers from it, so no index column crosses the link.
    n = code.shape[0]
    n_words = (n + 31) // 32
    bits = torch.zeros(n_words * 32, dtype=torch.int64, device=code.device)
    bits[:n] = interesting.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=code.device)
    mask = _as_int32((bits.view(n_words, 32) << shifts).sum(dim=1))
    # Stream compaction: position = running count of interesting rows,
    # clamped to the overflow sink.
    idx = torch.cumsum(interesting.to(torch.int64), 0) - 1
    pos = torch.where(interesting & (idx < cap), idx, cap)
    packed = torch.zeros(cap + 1, dtype=torch.int32, device=code.device
                         ).scatter_(0, pos, packed_word)
    eidx = torch.cumsum(exact_sel.to(torch.int64), 0) - 1
    epos = torch.where(exact_sel & (eidx < cap), eidx, cap)
    exact = torch.zeros((cap + 1, 3), dtype=torch.int32, device=code.device
                        ).index_copy_(0, epos, torch.stack(
                            [out["errors"], out["corrected"], out["steps"]],
                            dim=1).to(torch.int32))
    return {"hist": hist, "n_int": n_int, "n_exact": n_exact, "mask": mask,
            "packed": packed, "exact": exact,
            "head": torch.cat([hist, n_int[None], n_exact[None]])}


def _mask_rows(mask: np.ndarray, limit: int) -> np.ndarray:
    """Interesting-row positions in a bitmask (uint32 words): bit k of word
    w is row w*32+k, clipped to ``limit``."""
    bits = ((mask[:, None] >> np.arange(32, dtype=np.uint32)) & 1
            ).astype(bool).ravel()
    return np.flatnonzero(bits[:limit])


def _unpack_rows(packed: np.ndarray, exact: np.ndarray, pack: tuple):
    """Packed words (uint32) -> (code, E, F, T) int32 columns; sentinel
    rows take their E/F/T from the exact side buffer, in order."""
    e_bits, f_bits, t_bits = pack
    sentinel = (1 << f_bits) - 1
    code = (packed & 15).astype(np.int32)
    err = ((packed >> 4) & ((1 << e_bits) - 1)).astype(np.int32)
    cor = ((packed >> (4 + e_bits)) & sentinel).astype(np.int32)
    steps = (packed >> (4 + e_bits + f_bits)).astype(np.int32)
    is_sent = cor == sentinel
    n_sent = int(is_sent.sum())
    if n_sent:
        if len(exact) < n_sent:
            raise RuntimeError(
                "sparse collect: sentinel rows exceed the exact "
                "buffer prefix (device/host accounting diverged)")
        err[is_sent] = exact[:n_sent, 0]
        cor[is_sent] = exact[:n_sent, 1]
        steps[is_sent] = exact[:n_sent, 2]
    return code, err, cor, steps


def _rows_subset(sched: FaultSchedule, rows: np.ndarray) -> FaultSchedule:
    """The base sites of ``sched`` at arbitrary ``rows`` (the model and
    class weights kept, the extra flip-group sites dropped): what a per-row
    record names, and the delta paths' working shape."""
    idx = np.asarray(rows, np.int64)
    return FaultSchedule(
        *(np.ascontiguousarray(np.asarray(getattr(sched, f))[idx])
          for f in ("leaf_id", "lane", "word", "bit", "t", "section_idx")),
        seed=sched.seed, model=sched.model,
        class_weight=(sched.class_weight[idx]
                      if sched.class_weight is not None else None),
        equiv_sha=sched.equiv_sha)


def run_classified(prog, fault) -> Dict[str, torch.Tensor]:
    """``prog.run_batch(fault)`` with its rows classified on the program's
    device: the four result columns, int32, still on the device."""
    rec = prog.run_batch(fault)
    out = {k: rec[k].to(torch.int32) for k in _COLUMNS[1:]}
    out["code"] = cls.classify(rec, prog.output_words)
    return out


class CampaignRunner:
    """Runs seeded bit-flip campaigns against one protected program, on the
    program's device."""

    def __new__(cls, prog, *args, **kw):
        # ``mesh=`` promotes the runner to the sharded backend
        # (coast_tpu_torch.parallel.mesh.ShardedCampaignRunner), as the
        # reference's constructor does; Python then runs the subclass's
        # __init__.
        if cls is CampaignRunner and kw.get("mesh") is not None:
            from coast_tpu_torch.parallel.mesh import ShardedCampaignRunner
            return object.__new__(ShardedCampaignRunner)
        return object.__new__(cls)

    def __init__(self, prog, sections: Optional[Sequence[str]] = None,
                 strategy_name: Optional[str] = None, device=None,
                 fault_model: Optional[FaultModel] = None,
                 collect: str = "dense",
                 sparse_capacity: Optional[int] = None,
                 retry: Optional[resilience_mod.RetryPolicy] = None,
                 mesh=None, unroll: int = 1, preflight: "bool | str" = False,
                 equiv: "bool | object" = False,
                 telemetry: "Optional[obs.Telemetry]" = None,
                 metrics: "Optional[object]" = None,
                 profile: "bool | object" = False,
                 slo: "Optional[object]" = None,
                 slo_baseline: "Optional[Dict[str, float]]" = None):
        """``fault_model`` is what ``run`` draws (default single sites).
        ``collect`` is ``"dense"`` or ``"sparse"`` (see the module
        docstring); ``sparse_capacity`` bounds the interesting rows a
        sparse batch compacts on the device (default ``max(256,
        batch_size // 4)``); correctness never depends on it.

        ``retry`` (:class:`~coast_tpu_torch.inject.resilience.RetryPolicy`)
        classifies a failed batch: a transient error or a wedged collect
        re-dispatches it with backoff, an out-of-memory failure frees the
        allocator and halves ``batch_size``; anything else, a sticky CUDA
        error included, is re-raised.  None keeps every failure fatal.
        The retry loop never moves a batch off the program's device.

        ``mesh`` (a :class:`coast_tpu_torch.parallel.mesh.Mesh`) selects
        the sharded backend: ``CampaignRunner(prog, mesh=make_mesh(2))``
        builds a ``ShardedCampaignRunner``.  A bare ``link`` fault model
        takes the region's ``meta["link_window"]`` (its in-flight steps).

        ``unroll`` is the reference's early-exit loop unroll, clamped to
        ``max(1, int(unroll))``.  It changes no record: the port's step
        loop stops on the same trip whatever its value.

        ``equiv`` turns on fault-site equivalence reduction
        (``analysis/equiv``): ``True`` derives the partition of ``prog``
        (on the host, from the captured step), an ``EquivPartition`` is
        taken as it is.  Every seeded schedule is then reduced to one
        representative a class, the counts weighted back to the drawn
        ``n``, and journals record the partition and the per-section
        fingerprints ``run_delta`` reads.  Single-bit fault model only.

        ``preflight`` runs the replication-integrity linter
        (``analysis/lint``) before anything else and raises
        ``ReplicationLintError`` on an error finding, so a leaking build
        spends no device time: ``"static"`` runs the provenance rules,
        ``"propagation"`` adds the lane-isolation prover, ``True`` and
        ``"full"`` add the prover and the survival checks, any other
        truthy value the survival checks.

        ``telemetry`` is the runner's stage recorder (``obs.Telemetry``;
        default a fresh, enabled one unless ``COAST_TELEMETRY=0``): every
        campaign records its schedule/pad/dispatch/collect/classify spans
        there, ``CampaignResult.stages`` is their top-level totals, and
        ``obs.write_trace(runner.telemetry, path)`` exports the timeline.

        ``metrics`` is an ``obs.CampaignMetrics`` hub the campaign loop
        feeds once a collected batch (progress, rates, class intervals,
        stage totals, resilience and transfer counters); an
        ``obs.MetricsServer`` or its status file reads it live.

        ``profile`` arms per-dispatch device-time attribution
        (``obs.CampaignProfiler``, or ``True`` for one on this program):
        the device-busy / host-gap / host-other split, the per-dispatch
        histograms, ``device:<phase>`` spans on the trace's device track,
        and the roofline block in ``summary()["profile"]`` /
        ``["mfu"]``.  Records and counts are the same with it on or off.

        ``slo`` attaches a reliability SLO set (:mod:`coast_tpu_torch
        .obs.slo`): a spec string (``"sdc_rate<=0.002;min=4096"``) or an
        :class:`~coast_tpu_torch.obs.slo.SLOSet`.  The runner's metrics
        hub (created on demand when ``metrics`` is None) re-evaluates the
        error budgets every collected batch, and every finished campaign
        lands the verdicts in ``CampaignResult.slo`` /
        ``summary()["slo"]``.  ``slo_baseline`` feeds the ``mwtf``
        objective (``{"sdc_rate", "inj_per_sec"}`` from an unprotected
        run's recorded evidence)."""
        if mesh is not None:
            raise TypeError(
                "mesh= reached the base CampaignRunner constructor; pass "
                "it as a keyword to CampaignRunner(prog, mesh=...) or use "
                "coast_tpu_torch.parallel.mesh.ShardedCampaignRunner "
                "directly")
        if (device is not None
                and torch.device(device).type != prog.device.type):
            raise ValueError(
                f"CampaignRunner(device={device!r}) but the program was "
                f"built on {prog.device}; build it there instead")
        if collect not in ("dense", "sparse"):
            raise ValueError(
                f"unknown collect mode {collect!r}; one of 'dense', "
                "'sparse'")
        if preflight:
            from coast_tpu_torch.analysis import lint as lint_mod
            lint_mod.check(
                prog,
                survival=preflight not in ("static", "propagation"),
                propagation=preflight in (True, "full", "propagation"))
        self.unroll = max(1, int(unroll))
        self.prog = prog
        if slo is not None:
            from coast_tpu_torch.obs.metrics import CampaignMetrics
            from coast_tpu_torch.obs.slo import SLOSet
            slo_set = SLOSet.parse(slo) if isinstance(slo, str) else slo
            if metrics is None:
                metrics = CampaignMetrics(slo=slo_set,
                                          slo_baseline=slo_baseline)
            elif getattr(metrics, "slo_set", None) is None:
                metrics.slo_set = slo_set
                metrics.slo_baseline = (dict(slo_baseline)
                                        if slo_baseline else None)
        self.metrics = metrics
        self.telemetry = (telemetry if telemetry is not None
                          else obs.Telemetry())
        self.profiler = None
        if profile:
            from coast_tpu_torch.obs.profiler import CampaignProfiler
            self.profiler = (profile
                             if isinstance(profile, CampaignProfiler)
                             else CampaignProfiler(prog))
            if self.profiler.telemetry is None:
                self.profiler.telemetry = self.telemetry
        # A training region's counts always carry the train classes; every
        # other region keeps the base key set.
        self._train = prog.region.train_probe is not None
        self.retry = retry
        with self.telemetry.span("memory_map"):
            self.mmap = MemoryMap(prog, sections)
        self.strategy_name = strategy_name or f"N={prog.cfg.num_clones}"
        self.fault_model = (fault_model if fault_model is not None
                            else FaultModel())
        meta = prog.region.meta or {}
        # The voter placement of a sharded region: campaign identity,
        # journaled absent-means-compute.
        self.placement = str(meta.get("placement", "compute"))
        if (self.fault_model.kind == "link" and self.fault_model.t_period == 0
                and self.fault_model.t_offset == 0
                and meta.get("link_window")):
            # A bare "link" model on a region that declares its in-flight
            # window flips only at the steps the halo words are on the wire.
            off, per = meta["link_window"]
            self.fault_model = FaultModel.link(offset=int(off),
                                               period=int(per))
        if equiv and self.fault_model.kind != "single":
            raise ValueError(
                "equiv=True needs the single-bit fault model: a flip "
                f"group ({self.fault_model.spec()}) has no per-site "
                "propagation class to reduce over")
        self.equiv_partition = None
        if equiv:
            from coast_tpu_torch.analysis.equiv import (EquivPartition,
                                                        analyze_equivalence)
            with self.telemetry.activate():
                self.equiv_partition = (
                    equiv if isinstance(equiv, EquivPartition)
                    else analyze_equivalence(prog))
        self.collect = collect
        self._sparse_capacity = (int(sparse_capacity) if sparse_capacity
                                 else None)
        self._gens: Dict[tuple, DeviceScheduleGen] = {}
        self._pack = _pack_layout(prog.output_words, prog.region.max_steps)

    @staticmethod
    def _padded_fault(part: FaultSchedule, batch_size: int):
        """Fault columns for one batch, edge-padded to ``batch_size`` (the
        batch axis only).  Returns (fault, n_valid); the padded tail is
        dropped."""
        n_part = len(part)
        pad = batch_size - n_part if n_part < batch_size else 0
        fault = {k: np.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1),
                           mode="edge")
                 for k, v in part.device_arrays().items()}
        return fault, n_part

    # -- hooks of the sharded backend (parallel/mesh.py) ---------------------
    def _round_batch(self, batch_size: int) -> int:
        """The batch size a campaign runs at (at least one row)."""
        return max(1, batch_size)

    def _ledger_reset(self) -> None:
        """Start a campaign's per-shard ledger (none here)."""

    def _ledger_dense(self, out: Dict[str, np.ndarray],
                      batch_size: int) -> None:
        """Attribute a dense batch's interesting rows to shards (none
        here)."""

    def _mesh_block(self) -> Optional[Dict[str, object]]:
        """The result's ``mesh`` block; None on the single-device runner."""
        return None

    def _dispatch(self, fault) -> Dict[str, torch.Tensor]:
        """Run one batch and classify its rows on the device: the result
        columns, still on the device."""
        return run_classified(self.prog, fault)

    #: The engine's counters that ``transfer`` accumulates, by key.
    ENGINE_COUNTERS = {"reads": "host_reads", "freeze_run": "freeze_run",
                       "freeze_skipped": "freeze_skipped"}

    def _engine_counters(self) -> Dict[str, int]:
        """The engine's counters so far, under their ``transfer`` keys."""
        return {key: getattr(self.prog, attr)
                for key, attr in self.ENGINE_COUNTERS.items()}

    @staticmethod
    def _collect(pending: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        """Copy a dispatched batch's four result columns to the host, in
        one copy."""
        cols = torch.stack([pending[k] for k in _COLUMNS]).cpu().numpy()
        return {k: cols[i] for i, k in enumerate(_COLUMNS)}

    @staticmethod
    def _collect_reads(pending) -> int:
        """The blocking copies ``_collect`` makes of ``pending``."""
        return 1

    def _fire_plan_bytes(self, fault) -> int:
        t = fault["t"]
        return self.prog.fire_plan_bytes(t.shape[1] if t.ndim > 1 else 1)

    # -- sparse (device-resident) collection ---------------------------------
    def _sparse_cap(self, batch_size: int) -> int:
        cap = int(self._sparse_capacity or max(256, batch_size // 4))
        return max(1, min(cap, batch_size))

    def _sparse_setup(self, sched: FaultSchedule, batch_size: int,
                      transfer: Dict[str, int]) -> Dict[str, object]:
        """Per-campaign sparse state for one batch geometry (rebuilt when an
        out-of-memory failure halves it).  A seeded stream schedule takes
        the generated path (no fault columns go up); any other schedule,
        or a map of 2^32 bits or more, is uploaded once with
        ``batch_size`` rows of headroom, so a batch may start at any row,
        and sliced on the device (the resident path)."""
        state: Dict[str, object] = {"cap": self._sparse_cap(batch_size),
                                    "batch_size": batch_size}
        if sched.gen_stream_n is not None and sched.gen_steps is not None:
            key = (sched.model.spec(), int(sched.gen_steps))
            try:
                if key not in self._gens:
                    self._gens[key] = DeviceScheduleGen(
                        self.mmap, sched.gen_steps, sched.model,
                        self.prog.device)
                state.update(mode="gen", gen=self._gens[key],
                             seed=int(sched.seed),
                             stream_n=int(sched.gen_stream_n),
                             gen_lo=int(sched.gen_lo))
                return state
            except DeviceGenError:
                pass            # address space too large: resident path
        tel = self.telemetry
        with tel.span("setup.columns"):
            host = {k: np.pad(v, [(0, batch_size)] + [(0, 0)] * (v.ndim - 1),
                              mode="edge")
                    for k, v in sched.device_arrays().items()}
        with tel.span("setup.weights"):
            w = self._count_weights(sched, batch_size)
        with tel.span("setup.upload"):
            arrays = {k: torch.as_tensor(v, device=self.prog.device)
                      for k, v in host.items()}
            count_w = torch.as_tensor(w, device=self.prog.device)
        transfer["up"] += sum(int(v.nbytes) for v in host.values())
        transfer["up"] += int(w.nbytes)
        state.update(mode="resident", arrays=arrays, count_w=count_w)
        return state

    @staticmethod
    def _count_weights(sched: FaultSchedule, batch_size: int) -> np.ndarray:
        """Each row's count weight, int32, with ``batch_size`` rows of
        headroom: its class weight (1 when unreduced), 0 for a draw that
        never fires."""
        n = len(sched)
        if sched.class_weight is not None:
            w = sched.class_weight.astype(np.int64)
            # The device histogram of a batch goes back as int32: bound the
            # summed weights of the batch_size largest (an out-of-memory
            # degrade may start a batch at any row).
            top = (np.partition(w, n - batch_size)[n - batch_size:]
                   if n > batch_size else w)
            if n and int(top.sum()) >= 2 ** 31:
                raise ValueError(
                    "sparse collect: a batch's summed class weights "
                    f"(worst case {int(top.sum())}) could exceed the "
                    "device histogram's int32 range; run this campaign "
                    "dense (or with a smaller batch_size)")
        else:
            w = np.ones(n, np.int64)
        return np.pad(np.where(np.asarray(sched.t) < 0, 0, w
                               ).astype(np.int32), (0, batch_size))

    def _sparse_args(self, state: Dict[str, object], lo: int,
                     transfer: Dict[str, int]):
        """A batch's fault columns and count weights on the device (None:
        every valid row counts once).  The generated path's up-link is the
        scalars the reference sends (seed halves, stream length, offset,
        valid count: 20 bytes); the resident path's is the valid count."""
        b = int(state["batch_size"])
        if state["mode"] == "gen":
            transfer["up"] += 20
            rows = torch.arange(b, dtype=torch.int64,
                                device=self.prog.device)
            rows += int(state["gen_lo"]) + lo
            with self.telemetry.span(SPANS[0]):
                return (state["gen"].columns(state["seed"],
                                             state["stream_n"], rows), None)
        transfer["up"] += 4
        return ({k: v[lo:lo + b] for k, v in state["arrays"].items()},
                state["count_w"][lo:lo + b])

    def _sparse_dispatch(self, state: Dict[str, object], fault, count_w,
                         n_part: int) -> Dict[str, object]:
        """Run one sparse batch and account for it on the device: the
        pending batch (its device columns and accounting buffers)."""
        out = self._dispatch(fault)
        b = int(state["batch_size"])
        valid = torch.arange(b, device=self.prog.device) < n_part
        if count_w is None:
            count_w = valid.to(torch.int32)
        with self.telemetry.span(SPANS[1]):
            dev = _sparse_device_outputs(out, count_w, valid,
                                         int(state["cap"]), self._pack)
        return {"out": out, "dev": dev}

    def _sparse_fetch(self, state: Dict[str, object],
                      pending: Dict[str, object], n_part: int,
                      transfer: Dict[str, int],
                      marks: List[tuple]) -> Dict[str, np.ndarray]:
        """The sparse collect: the histogram head (``collect.wait`` in
        ``marks``), then the interesting rows (batch-local row numbers,
        decoded in ``collect.unpack``) -- or, when they overflow the
        buffer, the batch's dense columns."""
        out, dev = pending["out"], pending["dev"]
        cap = int(state["cap"])
        t0 = time.perf_counter()
        head = dev["head"].cpu().numpy()
        marks.append(("collect.wait", t0, time.perf_counter()))
        hist = head[:cls.NUM_CLASSES].astype(np.int64)
        k, ke = int(head[-2]), int(head[-1])
        transfer["down"] += int(head.nbytes)
        transfer["reads"] += 1
        if k > cap or ke > cap:
            # Overflow: correctness never depends on the capacity.
            cols = torch.stack([out[c] for c in _COLUMNS]).cpu().numpy()
            transfer["down"] += int(cols.nbytes)
            transfer["reads"] += 1
            rows = np.flatnonzero(cols[0, :n_part] > cls.CORRECTED)
            return {"hist": hist, "rows": rows.astype(np.int64),
                    **{c: cols[i, rows] for i, c in enumerate(_COLUMNS)}}
        words = torch.cat([dev["mask"], dev["packed"][:k],
                           dev["exact"][:ke].flatten()]).cpu().numpy()
        transfer["down"] += int(words.nbytes)
        transfer["reads"] += 1
        t0 = time.perf_counter()
        n_mask = dev["mask"].shape[0]
        mask = words[:n_mask].view(np.uint32)
        packed = words[n_mask:n_mask + k].view(np.uint32)
        exact = words[n_mask + k:].reshape(ke, 3)
        code, err, cor, steps = _unpack_rows(packed, exact, self._pack)
        rows = _mask_rows(mask, n_part)
        marks.append(("collect.unpack", t0, time.perf_counter()))
        if len(rows) != k:
            raise RuntimeError(
                f"sparse collect: bitmask names {len(rows)} interesting "
                f"rows but the device counted {k}")
        return {"hist": hist, "rows": rows.astype(np.int64), "code": code,
                "errors": err, "corrected": cor, "steps": steps}

    # -- journal identity ---------------------------------------------------
    def _check_identity(self, journal, sched: FaultSchedule,
                        stop_when) -> None:
        """Refuse, before anything runs, an open journal whose header names
        another fault model, collect mode, placement, step engine or stop
        condition than this campaign (the reference's typed errors)."""
        header_spec = journal.header.get("fault_model", "single")
        if header_spec != sched.model.spec():
            raise FaultModelMismatchError(
                f"journal {journal.path!r} header records fault model "
                f"{header_spec!r} but the schedule being run carries "
                f"{sched.model.spec()!r}; open the journal with the "
                "schedule's model (CampaignRunner(fault_model=...))")
        # Batch records are a row a representative: replayed under another
        # (or no) partition they would be weighted wrongly.
        header_part = (journal.header.get("equiv") or {}).get("partition")
        if header_part != sched.equiv_sha:
            raise JournalMismatchError(
                f"journal {journal.path!r} records equivalence partition "
                f"{header_part!r} but the schedule being run carries "
                f"{sched.equiv_sha!r}; refusing to mix reduced and "
                "exhaustive row records")
        header_stop = journal.header.get("stop_when")
        current_stop = stop_when.spec() if stop_when is not None else None
        if header_stop != current_stop:
            raise JournalMismatchError(
                f"journal {journal.path!r} records stop_when="
                f"{header_stop!r} but this campaign runs "
                f"stop_when={current_stop!r}; an early-stop condition is "
                "part of the campaign's identity -- rerun with the original "
                "--stop-when (or a fresh journal)")
        header_mode = header_collect(journal.header)
        if header_mode != self.collect:
            raise JournalMismatchError(
                f"journal {journal.path!r} records collect="
                f"{header_mode!r} but this runner collects "
                f"{self.collect!r}; rerun with the original --collect (or "
                "a fresh journal)")
        header_place = header_placement(journal.header)
        if header_place != self.placement:
            raise PlacementMismatchError(
                f"journal {journal.path!r} records voter placement "
                f"{header_place!r} but this runner's region is built "
                f"{self.placement!r}; rerun with the original --placement "
                "(or a fresh journal)")
        header_fused = header_fuse(journal.header)
        runner_fused = bool(self.prog.cfg.fuse_step)
        if header_fused != runner_fused:
            raise FuseStepMismatchError(
                f"journal {journal.path!r} records fuse={header_fused} but "
                f"this runner's program is built fuse={runner_fused}; rerun "
                "with the original fuse mode (-fuseStep/-noFuseStep, or a "
                "fresh journal)")

    # -- execution ----------------------------------------------------------
    def run_schedule(self, sched: FaultSchedule, batch_size: int = 4096,
                     progress: Optional[
                         Callable[[int, Dict[str, int]], None]] = None,
                     journal: Optional[CampaignJournal] = None,
                     journal_base: int = 0,
                     stream: "Optional[object]" = None,
                     stop_when: "Optional[object]" = None,
                     _telemetry_mark: Optional[int] = None
                     ) -> CampaignResult:
        """Run every row of ``sched`` in edge-padded batches.

        ``progress(done, counts_so_far)`` is called after each collected
        batch with the cumulative class histogram.  ``journal`` is an open
        :class:`~coast_tpu_torch.inject.journal.CampaignJournal`: each
        collected batch is appended as one fsync'd record before the loop
        moves on, and on entry the journal's contiguous completed-batch
        prefix is replayed from disk, so the loop restarts at the first
        missing batch.  ``journal_base`` offsets this schedule's rows
        within a larger journaled stream.  ``stream`` (a
        :class:`~coast_tpu_torch.inject.logs.StreamLogWriter`) is handed
        every collected batch, replayed ones included, numbered
        ``journal_base + lo``; the caller owns ``finish`` / ``abort``.
        ``stop_when`` (:class:`~coast_tpu_torch.obs.convergence.StopWhen`)
        stops dispatching once every target class's Wilson half-width is
        at or below its threshold; the result then covers the rows that
        ran, and a journal gets the terminal ``early_stop`` record.
        ``self.retry`` governs failures (see ``__init__``).  The stages
        are recorded into ``self.telemetry`` and ``_telemetry_mark`` lets
        ``run`` extend the stage window back over its schedule span."""
        batch_size = self._round_batch(batch_size)
        self._ledger_reset()
        if journal is not None:
            self._check_identity(journal, sched, stop_when)
        retry = self.retry
        metrics = self.metrics
        tracker = None
        if stop_when is not None:
            from coast_tpu_torch.obs.convergence import ConvergenceTracker
            tracker = ConvergenceTracker(stop_when)
        planned_n = sched.effective_n
        if metrics is not None:
            metrics.campaign_started(self.prog.region.name,
                                     self.strategy_name, len(sched),
                                     planned_n)
        tel = self.telemetry
        mark = tel.mark() if _telemetry_mark is None else _telemetry_mark
        tel.anchor()
        t0 = time.perf_counter()
        prof = self.profiler
        if prof is not None:
            prof.begin(t0)
        outs: List[Dict[str, np.ndarray]] = []
        done = 0
        live_counts = np.zeros(cls.NUM_CLASSES, np.int64)
        live_invalid = 0
        resilience: Dict[str, int] = (
            {"retry_transient": 0, "retry_wedged": 0, "oom_degrade": 0}
            if retry is not None else {})
        sched_t = np.asarray(sched.t)
        sched_w = sched.class_weight
        transfer: Dict[str, int] = {"up": 0, "down": 0,
                                    **dict.fromkeys(self.ENGINE_COUNTERS, 0)}
        state: Optional[Dict[str, object]] = None
        if self.collect == "sparse":
            with tel.span("sparse_setup"):
                state = self._sparse_setup(sched, batch_size, transfer)

        def counts_now() -> Dict[str, int]:
            counts = cls.counts_dict(live_counts, self._train)
            counts["cache_invalid"] = live_invalid
            return counts

        def batch_invalid(lo: int, n: int) -> int:
            """Never-fired (t < 0) draws of rows [lo, lo + n), weighted."""
            inv = sched_t[lo:lo + n] < 0
            if sched_w is None:
                return int(inv.sum())
            return int(sched_w[lo:lo + n][inv].sum())

        def account(out: Dict[str, np.ndarray], lo: int) -> Dict[str, int]:
            """Add a dense batch to the live histogram (rows with t < 0
            never fired: they count as cache_invalid); a reduced
            schedule's rows count their class weight."""
            nonlocal live_invalid
            n_out = len(out["code"])
            fired = sched_t[lo:lo + n_out] >= 0
            w = None if sched_w is None else sched_w[lo:lo + n_out][fired]
            live_counts[:] += cls.weighted_histogram(out["code"][fired], w)
            live_invalid += batch_invalid(lo, n_out)
            return counts_now()

        def account_sparse(out: Dict[str, object]) -> Dict[str, int]:
            nonlocal live_invalid
            live_counts[:] += np.asarray(out["hist"], np.int64)
            live_invalid += int(out["invalid"])
            return counts_now()

        def journal_early_stop(rows: int) -> None:
            if journal is not None:
                journal.append({
                    "kind": "early_stop",
                    "base": int(journal_base),
                    "rows": int(rows),
                    "lo": int(journal_base + rows),
                    "stop_when": stop_when.spec(),
                    "half_widths": {
                        k: round(v["half_width"], 8)
                        for k, v in tracker.intervals().items()},
                })

        # Resume: replay the journal's contiguous completed-batch prefix.
        stopped = False
        if journal is not None:
            for rec in journal.batch_prefix(journal_base, len(sched)):
                cols = {k: np.asarray(rec[src], np.int32)
                        for k, src in _RECORD_KEYS}
                if rec.get("sparse"):
                    out = {"hist": np.asarray(rec["hist"], np.int64),
                           "invalid": int(rec.get("invalid", 0)),
                           "rows": (np.asarray(rec["rows"], np.int64)
                                    - journal_base), **cols}
                    counts = account_sparse(out)
                    n_batch = int(rec["n"])
                    if stream is not None:
                        stream.feed_sparse(journal_base + out["rows"],
                                           _rows_subset(sched, out["rows"]),
                                           out)
                else:
                    out = cols
                    counts = account(out, done)
                    n_batch = len(out["code"])
                    if stream is not None:
                        stream.feed(journal_base + done,
                                    sched.slice(done, done + n_batch), out)
                outs.append(out)
                done += n_batch
                # The crashed run's batch spans, re-materialised (marked
                # replayed) at their wall-clock offsets: one exported
                # trace covers the whole campaign.
                for name, t_abs, dur in rec.get("spans") or []:
                    t0_local = tel.origin + (float(t_abs) - tel.epoch)
                    tel.span_at(str(name), t0_local,
                                t0_local + float(dur), replayed=True)
                if tracker is not None:
                    tracker.update(counts)
                if metrics is not None:
                    metrics.record_batch(done, n_batch, counts,
                                         tel.stage_totals(since=mark),
                                         resilience, replayed=True,
                                         transfer=transfer)
                if progress is not None:
                    progress(done, counts)
            if done:
                flightrec.record("journal_resume", rows=int(done))
            early = next(
                (r for r in journal.records()
                 if r.get("kind") == "early_stop"
                 and int(r.get("base", 0)) == int(journal_base)), None)
            if early is not None and done >= int(early["rows"]):
                stopped = True
            elif tracker is not None and tracker.converged:
                # The kill landed between the last batch record and the
                # early_stop record: stop here and write it.
                stopped = True
                journal_early_stop(done)

        def last_span(store: List) -> None:
            """The span that just closed, as (name, t0, t1), for the
            journal's per-batch span record (a disabled recorder records
            none)."""
            if tel.enabled and tel.events \
                    and tel.events[-1]["kind"] == "span":
                e = tel.events[-1]
                store.append((str(e["name"]), float(e["t0"]),
                              float(e["t1"])))

        def dispatch(flight: Dict[str, object]) -> None:
            lo, n_part = int(flight["lo"]), int(flight["n"])
            spans_rec = flight.setdefault("spans", [])
            if "fault" not in flight:
                with tel.span("pad", lo=lo):
                    if state is not None:
                        flight["fault"] = self._sparse_args(state, lo,
                                                            transfer)
                    else:
                        fault, _ = self._padded_fault(
                            sched.slice(lo, lo + n_part), batch_size)
                        transfer["up"] += sum(int(v.nbytes)
                                              for v in fault.values())
                        flight["fault"] = (fault, None)
                last_span(spans_rec)
                if batch_size - n_part:
                    tel.count("pad_waste_rows", batch_size - n_part)
            fault, count_w = flight["fault"]
            flightrec.record("dispatch", lo=lo, n=n_part,
                             batch_size=int(batch_size))
            args = ({"n": n_part} if int(flight["attempts"]) == 1 else
                    {"n": n_part, "retry": int(flight["attempts"])})
            td0 = time.perf_counter()
            engine0 = self._engine_counters()
            # The engine records its own spans on the ambient recorder.
            with tel.span("dispatch", **args), tel.activate():
                transfer["down"] += self._fire_plan_bytes(fault)
                if state is not None:
                    flight["pending"] = self._sparse_dispatch(
                        state, fault, count_w, n_part)
                else:
                    flight["pending"] = self._dispatch(fault)
                if prof is not None:
                    # The blocking marker: recorded after the batch's
                    # last launch, waited on at the collect.
                    flight["ready"] = (
                        torch.cuda.Event()
                        if self.prog.device.type == "cuda" else None)
                    if flight["ready"] is not None:
                        flight["ready"].record()
            for key, value in self._engine_counters().items():
                transfer[key] += value - engine0[key]
            last_span(spans_rec)
            if prof is not None:
                prof.dispatched(lo, n_part, td0, time.perf_counter())

        def collect(flight: Dict[str, object]):
            pending, n_part = flight["pending"], int(flight["n"])
            # The fetch's nested spans, as (name, t0, t1): a watchdog runs
            # it in another thread, so they are recorded here after it.
            marks: List[tuple] = []
            if state is not None:
                def fetch():
                    return self._sparse_fetch(state, pending, n_part,
                                              transfer, marks)
            else:
                def fetch():
                    t_wait = time.perf_counter()
                    got = self._collect(pending)
                    marks.append(("collect.wait", t_wait,
                                  time.perf_counter()))
                    transfer["reads"] += self._collect_reads(pending)
                    transfer["down"] += sum(int(v.nbytes)
                                            for v in got.values())
                    return got
            if prof is not None:
                # Device timing: wait for the batch on the card (no
                # copy), then the ordinary fetch; inside the fetch so the
                # watchdog guards the marker too.  ``_p`` pins the
                # attempt: an abandoned watchdog thread that wakes after
                # a re-dispatch reports no ready.
                def fetch(_inner=fetch, _fl=flight, _p=pending,
                          _ev=flight.get("ready")):
                    if _ev is not None:
                        _ev.synchronize()
                    if _fl.get("pending") is _p:
                        prof.ready(int(_fl["lo"]), int(_fl["n"]),
                                   time.perf_counter())
                    return _inner()
            with tel.span("collect", n=n_part):
                if retry is not None and retry.collect_timeout:
                    # The watchdog's own counter lands in this recorder.
                    with tel.activate():
                        got = resilience_mod.watchdog_collect(
                            fetch, retry.collect_timeout)
                else:
                    got = fetch()
                for name, a, b in marks:
                    tel.span_at(name, a, b, depth=tel.depth)
            last_span(flight.setdefault("spans", []))
            return got

        def handle(flight: Dict[str, object], exc: Exception) -> None:
            """Classify a failed dispatch or collect: re-raise, signal a
            degrade, or count a retry and back off (the caller then
            re-dispatches the same rows)."""
            flight.pop("pending", None)
            kind = retry.classify(exc) if retry is not None else "fatal"
            if kind == "fatal":
                raise exc
            if kind == "oom":
                raise _Degrade() from exc
            attempts = int(flight["attempts"])
            if attempts >= retry.max_attempts:
                raise exc
            key = "retry_wedged" if kind == "wedged" else "retry_transient"
            resilience[key] += 1
            lo = int(flight["lo"])
            flightrec.record("retry", lo=lo, attempt=attempts, kind=kind,
                             error=type(exc).__name__)
            if journal is not None:
                journal.append({"kind": "retry",
                                "lo": journal_base + lo,
                                "attempt": attempts, "class": kind,
                                "error": type(exc).__name__})
            time.sleep(retry.backoff(attempts))
            flight["attempts"] = attempts + 1

        def grab(flight: Dict[str, object], got) -> Dict[str, int]:
            """Account, journal, stream and report one collected batch (not
            retried: appending the same rows twice would corrupt the
            journal)."""
            nonlocal done
            lo, n_part = int(flight["lo"]), int(flight["n"])
            spans = [(name, round(tel.epoch + (a - tel.origin), 6),
                      round(b - a, 6))
                     for name, a, b in flight.get("spans") or []]
            if state is not None:
                out = got
                out["invalid"] = batch_invalid(lo, n_part)
                out["rows"] = out["rows"] + lo
                counts = account_sparse(out)
                done += n_part
                if journal is not None:
                    journal.append_batch_sparse(
                        journal_base + lo, n_part, out["hist"],
                        out["invalid"], journal_base + out["rows"],
                        {k: out[k] for k in _COLUMNS}, counts,
                        tel.stage_totals(since=mark), spans=spans)
                if stream is not None:
                    stream.feed_sparse(journal_base + out["rows"],
                                       _rows_subset(sched, out["rows"]), out)
            else:
                out = {k: v[:n_part] for k, v in got.items()}
                self._ledger_dense(out, batch_size)
                counts = account(out, done)
                done += n_part
                if journal is not None:
                    journal.append_batch(journal_base + lo, out, counts,
                                         tel.stage_totals(since=mark),
                                         spans=spans)
                if stream is not None:
                    stream.feed(journal_base + lo,
                                sched.slice(lo, lo + n_part), out)
            outs.append(out)
            if metrics is not None:
                metrics.record_batch(done, n_part, counts,
                                     tel.stage_totals(since=mark),
                                     resilience, transfer=transfer,
                                     profile=(prof.batch_sample()
                                              if prof is not None
                                              else None))
            if progress is not None:
                progress(done, counts)
            return counts

        try:
            while done < len(sched) and not stopped:
                flight = {"lo": done, "attempts": 1,
                          "n": min(done + batch_size, len(sched)) - done}
                try:
                    while True:
                        try:
                            dispatch(flight)
                            got = collect(flight)
                            break
                        except Exception as e:  # noqa: BLE001 - classified
                            handle(flight, e)
                except _Degrade as sig:
                    # Out of memory: free the failed batch, halve the batch
                    # and restart at the first uncollected row.
                    cause = sig.__cause__
                    flight.clear()
                    _release(cause, self.prog.device)
                    new_bs = retry.degraded_batch(batch_size)
                    if new_bs is None:
                        raise cause
                    new_bs = self._round_batch(new_bs)
                    if new_bs >= batch_size:
                        raise cause     # the shard count's floor is reached
                    resilience["oom_degrade"] += 1
                    flightrec.record("oom_degrade", batch_size=int(new_bs),
                                     lo=int(done))
                    batch_size = new_bs
                    if state is not None:
                        with tel.span("sparse_setup"):
                            state = self._sparse_setup(sched, batch_size,
                                                       transfer)
                    if journal is not None:
                        journal.append({"kind": "geometry",
                                        "batch_size": batch_size,
                                        "lo": journal_base + done})
                    continue
                with tel.span("account"):
                    counts = grab(flight, got)
                    if tracker is not None:
                        tracker.update(counts)
                        if tracker.converged:
                            stopped = True
                            journal_early_stop(done)
        except BaseException as e:
            # The campaign died: the live surfaces say so, and the flight
            # recorder dumps its bundle while the failing state exists.
            flightrec.record("campaign_crash", lo=int(done),
                             error=type(e).__name__)
            flightrec.current().dump(
                f"campaign_crash:{type(e).__name__}",
                extra={"error": f"{type(e).__name__}: {e}",
                       "done_rows": int(done)})
            if metrics is not None:
                metrics.campaign_finished(error=f"{type(e).__name__}: {e}")
            raise
        if stopped and done < len(sched):
            sched = sched.slice(0, done)
            sched_t = np.asarray(sched.t)
            sched_w = sched.class_weight
        interesting_rows = None
        with tel.span("classify"):
            if outs:
                merged = {k: np.concatenate([o[k] for o in outs])
                          for k in _COLUMNS}
            else:
                merged = {k: np.zeros(0, np.int32) for k in _COLUMNS}
            if state is not None:
                interesting_rows = (np.concatenate([o["rows"] for o in outs])
                                    if outs else np.zeros(0, np.int64))
                binc = (np.sum([o["hist"] for o in outs], axis=0) if outs
                        else np.zeros(cls.NUM_CLASSES, np.int64))
                invalid_total = int(sum(o["invalid"] for o in outs))
            else:
                # Draws with t < 0 never fire a flip: they get their own
                # bucket instead of inflating success.
                invalid_draw = sched_t < 0
                binc = cls.weighted_histogram(
                    merged["code"][~invalid_draw],
                    None if sched_w is None else sched_w[~invalid_draw])
                invalid_total = batch_invalid(0, len(sched))
            counts = cls.counts_dict(binc, self._train)
            counts["cache_invalid"] = invalid_total
        seconds = time.perf_counter() - t0
        profile = None
        if prof is not None:
            # device_busy + host_gap + host_other == seconds, exactly.
            profile = prof.finish(time.perf_counter(), wall_s=seconds)
        res = CampaignResult(
            benchmark=self.prog.region.name, strategy=self.strategy_name,
            n=sched.effective_n,
            physical_n=len(sched) if sched_w is not None else None,
            counts=counts, seconds=seconds,
            codes=merged["code"], errors=merged["errors"],
            corrected=merged["corrected"], steps=merged["steps"],
            schedule=sched, seed=sched.seed,
            stages=tel.stage_totals(since=mark),
            resilience=resilience, collect=self.collect,
            interesting_rows=interesting_rows, transfer=transfer,
            mesh=self._mesh_block(), profile=profile)
        if tracker is not None:
            res.convergence = tracker.report(stopped, planned_n=planned_n,
                                             done_n=sched.effective_n)
        if metrics is not None and \
                getattr(metrics, "slo_set", None) is not None:
            report = metrics.slo_status()
            if report is not None:
                from coast_tpu_torch.obs.slo import summary_block
                res.slo = summary_block(report)
        if metrics is not None:
            metrics.campaign_finished(res.summary(),
                                      convergence=res.convergence)
        return res

    def _campaign_spec(self, n: int, seed: int = 0, batch_size: int = 4096,
                       start_num: int = 0,
                       stop_when: "Optional[object]" = None) -> CampaignSpec:
        """This campaign's identity as the shared CampaignSpec."""
        return CampaignSpec(
            benchmark=self.prog.region.name, n=int(n), seed=int(seed),
            batch_size=int(batch_size), start_num=int(start_num),
            fault_model=self.fault_model.spec(),
            equiv=self.equiv_partition is not None,
            stop_when=(stop_when.spec() if stop_when is not None
                       else None),
            collect=self.collect, placement=self.placement)

    def _journal_header(self, mode: str, **fields) -> Dict[str, object]:
        """The identity block every journal header shares, in the
        reference's key order with its absent-means-default keys."""
        header = {"mode": mode,
                  "benchmark": self.prog.region.name,
                  "strategy": self.strategy_name,
                  "config_sha": config_fingerprint(self.prog.cfg)}
        if self.fault_model.kind != "single":
            header["fault_model"] = self.fault_model.spec()
        if self.collect != "dense":
            header["collect"] = self.collect
        if self.placement != "compute":
            # Absent-means-compute: journals of the registry build carry no
            # placement key.
            header["placement"] = self.placement
        if self.prog.cfg.fuse_step:
            header["fuse"] = True
        if self.equiv_partition is not None:
            # The partition is campaign identity (reduced rows mean nothing
            # under another); the per-section fingerprints are the delta
            # vocabulary, volatile on resume.
            header["equiv"] = {
                "partition": self.equiv_partition.fingerprint,
                "clean_steps": self.equiv_partition.clean_steps}
            header["section_fingerprints"] = {
                name: sig.fingerprint
                for name, sig in sorted(
                    self.equiv_partition.signatures.items())}
        header.update(fields)
        return header

    def _open_journal(self, journal, header: Dict[str, object]):
        """``journal`` as the run methods take it: None, a path (opened --
        and resume-validated -- here), or an open CampaignJournal
        (validated against this campaign's header).  Returns (journal,
        owned)."""
        if journal is None:
            return None, False
        if isinstance(journal, CampaignJournal):
            CampaignJournal._validate(journal.header,
                                      {**journal.header, **header},
                                      journal.path)
            return journal, False
        return CampaignJournal.open(str(journal), header), True

    def _seeded_part(self, n: int, seed: int,
                     start_num: int) -> FaultSchedule:
        """generate, the start_num slice, then the equivalence reduction:
        the one schedule ``run`` and ``run_delta`` share, so the reduced
        rows a delta splices against are the rows a run journals.  The
        reduction comes after the slice: its representatives and weights
        describe exactly the rows this campaign covers."""
        tel = self.telemetry
        with tel.activate(), tel.span("schedule", n=start_num + n,
                                      seed=seed):
            sched = generate(self.mmap, start_num + n, seed,
                             self.prog.region.nominal_steps,
                             model=self.fault_model)
        part = sched.slice(start_num, start_num + n)
        if self.equiv_partition is not None:
            with tel.activate(), tel.span("schedule_equiv"):
                part = self.equiv_partition.reduce(part)
        return part

    def run(self, n: int, seed: int = 0, batch_size: int = 4096,
            start_num: int = 0,
            progress: Optional[
                Callable[[int, Dict[str, int]], None]] = None,
            journal: "Optional[object]" = None,
            stream: "Optional[object]" = None,
            stop_when: "Optional[object]" = None) -> CampaignResult:
        """A seeded campaign of ``n`` injections of ``fault_model``.
        ``start_num`` resumes at injection #start_num of the (seed,
        start_num + n) stream.  ``journal`` (a path or an open
        CampaignJournal) makes it crash-safe: rerunning the same call
        against the same path resumes at the first missing batch after
        the header -- the regenerated schedule's fingerprint included --
        is validated (JournalMismatchError otherwise).  ``progress``,
        ``stream`` and ``stop_when`` as in ``run_schedule``."""
        mark = self.telemetry.mark()
        part = self._seeded_part(n, seed, start_num)
        j, owned = None, False
        if journal is not None:
            spec = self._campaign_spec(n, seed=seed, batch_size=batch_size,
                                       start_num=start_num,
                                       stop_when=stop_when)
            header = self._journal_header(
                "run", **spec.run_header_fields(),
                schedule_sha=schedule_fingerprint(part))
            if spec.stop_when:
                header["stop_when"] = spec.stop_when
            j, owned = self._open_journal(journal, header)
            if self.equiv_partition is not None and not j.resumed:
                # The representatives: run_delta splices by site identity,
                # which the seed alone cannot regenerate once the partition
                # moves.
                _journal_equiv_schedule(j, part)
        try:
            res = self.run_schedule(part, batch_size, progress=progress,
                                    journal=j, stream=stream,
                                    stop_when=stop_when,
                                    _telemetry_mark=mark)
        finally:
            if owned:
                j.close()
        res.start_num = start_num
        return res

    def run_delta(self, n: int, delta_from: str, seed: int = 0,
                  batch_size: int = 4096, start_num: int = 0,
                  progress: Optional[
                      Callable[[int, Dict[str, int]], None]] = None,
                  stop_when: "Optional[object]" = None,
                  static_budget: "bool | object" = False
                  ) -> CampaignResult:
        """Delta campaign: rerun the seeded campaign recorded in the journal
        at ``delta_from``, but re-inject on the device only the sections
        whose propagation fingerprint changed since that journal was
        written; every other row's outcome is spliced from the journal.  A
        no-op rebuild re-injects no row; a one-section edit re-injects
        exactly that section.

        ``stop_when`` (:class:`~coast_tpu_torch.obs.convergence.StopWhen`)
        arms early stop per re-injected section: each changed section's
        rows run as their own convergence-tracked campaign, in section name
        order, and the spliced rows never enter a tracker.  Rows a
        section's early stop dropped are left out of the result;
        ``convergence`` holds one report a section and
        ``delta["dropped_rows"]`` the rows cut.

        ``static_budget`` feeds the static vulnerability map
        (``analysis/propagation``) into the re-injection loop: sections
        verdicted ``sdc-possible`` run first, and sections it proves
        ``masked`` or ``detected-bounded`` run under a ``min_done`` floor
        quartered (at least 32), since the static proof already rules their
        silent classes out.  ``True`` derives the map from this runner's
        partition; a ``VulnerabilityMap`` is taken as it is.  Per-class
        thresholds are untouched.  ``delta["static_budget"]`` records the
        verdicts, and with ``stop_when`` the order and the relaxed floors.

        Needs ``equiv=True`` (the partition supplies the fingerprints) and a
        base journal written by an equivalence run; an incompatible base
        raises :class:`~coast_tpu_torch.analysis.equiv.DeltaMismatchError`.
        """
        from coast_tpu_torch.analysis.equiv import load_delta_base, plan_delta
        if self.equiv_partition is None:
            raise ValueError(
                "run_delta needs CampaignRunner(equiv=True): the "
                "equivalence partition supplies the per-section "
                "fingerprints a delta diffs")
        if self.collect != "dense":
            raise ValueError(
                "run_delta is dense by construction: the spliced rows "
                "are exact per-row journal records; build the runner "
                "with collect='dense'")
        base_header, base_sites, base_out, base_rows = load_delta_base(
            delta_from)
        tel = self.telemetry
        mark = tel.mark()
        part = self._seeded_part(n, seed, start_num)
        stages: Dict[str, float] = tel.stage_totals(since=mark)
        current_header = self._journal_header(
            "run", **self._campaign_spec(
                n, seed=seed, batch_size=batch_size,
                start_num=start_num).run_header_fields())
        signatures = self.equiv_partition.signatures
        section_names = {sig.leaf_id: name
                         for name, sig in signatures.items()}
        plan = plan_delta(
            base_header, base_sites, base_out, base_rows, current_header,
            {name: sig.fingerprint for name, sig in signatures.items()},
            part, section_names, base_path=delta_from)

        # Base-side section attribution, before any filtering: the recorded
        # sites, else the positional rows the schedule sha proved equal.
        base_leaf = (np.asarray(base_sites["leaf_id"])
                     if base_sites is not None
                     else np.asarray(part.leaf_id).copy())
        base_w_col = (np.asarray(base_sites["class_weight"], np.int64)
                      if base_sites is not None
                      else np.asarray(part.class_weight, np.int64).copy())
        base_codes_col = base_out["codes"]

        run_idx = np.flatnonzero(plan.run_mask)
        part0_leaf = np.asarray(part.leaf_id).copy()
        cols = {k: v.copy() for k, v in plan.spliced.items()}
        seconds = 0.0
        resilience: Dict[str, int] = {}
        # Progress covers the whole campaign: the splice lands as one
        # opening beat, the re-injected rows count up from it.
        splice_idx = np.flatnonzero(~plan.run_mask)
        splice_counts: Dict[str, int] = {}
        if progress is not None and len(splice_idx):
            splice_counts = cls.counts_dict(cls.weighted_histogram(
                cols["codes"][splice_idx], part.class_weight[splice_idx]),
                self._train)
            splice_counts["cache_invalid"] = 0
            progress(int(len(splice_idx)), dict(splice_counts))

        def take(sub_res: CampaignResult, sel: np.ndarray) -> None:
            nonlocal seconds
            for k in cols:
                cols[k][sel] = getattr(sub_res, k)
            seconds += sub_res.seconds
            for k, v in sub_res.stages.items():
                stages[k] = stages.get(k, 0.0) + v
            for k, v in sub_res.resilience.items():
                resilience[k] = resilience.get(k, 0) + v

        def with_base(base_done: int, base_counts: Dict[str, int]):
            if progress is None:
                return None

            def chunk_progress(done, counts):
                merged = dict(base_counts)
                for k, v in counts.items():
                    merged[k] = merged.get(k, 0) + v
                progress(base_done + done, merged)
            return chunk_progress

        keep = None
        convergence: Optional[Dict[str, object]] = None
        static_info: Optional[Dict[str, object]] = None
        static_verdicts: Dict[str, str] = {}
        if static_budget:
            from coast_tpu_torch.analysis.propagation import (
                VulnerabilityMap, analyze_propagation)
            vmap = (static_budget
                    if isinstance(static_budget, VulnerabilityMap)
                    else analyze_propagation(
                        self.prog, partition=self.equiv_partition))
            static_verdicts = vmap.section_verdicts()
            static_info = {"verdicts": dict(sorted(
                static_verdicts.items()))}
        if len(run_idx) and stop_when is None:
            sub = _rows_subset(part, run_idx)
            take(self.run_schedule(
                sub, batch_size=min(batch_size, len(sub)),
                progress=with_base(int(len(splice_idx)), splice_counts)),
                run_idx)
        elif len(run_idx):
            # One sub-campaign (and one tracker) a re-injected section, in
            # name order so the row layout is deterministic.
            keep = ~plan.run_mask
            groups: Dict[str, List[int]] = {}
            for i in run_idx:
                groups.setdefault(section_names.get(int(part0_leaf[i]), "?"),
                                  []).append(int(i))
            per_section: Dict[str, object] = {}
            agg_counts = dict(splice_counts)
            agg_done = int(len(splice_idx))
            ordered = sorted(groups)
            relaxed: Dict[str, int] = {}
            if static_info is not None:
                # The static prior: uncertain (sdc-possible) sections
                # first, and the min_done floor -- there so rare classes
                # get a chance to appear -- quartered on sections the map
                # proves cannot silently corrupt.
                from coast_tpu_torch.analysis.propagation import VERDICT_SDC
                ordered = sorted(groups, key=lambda nm: (
                    static_verdicts.get(nm) != VERDICT_SDC, nm))
                static_info["order"] = list(ordered)
            for name in ordered:
                idx = np.asarray(groups[name], np.int64)
                sub = _rows_subset(part, idx)
                sub_stop = stop_when
                if (static_info is not None and stop_when.min_done
                        and static_verdicts.get(name) not in (
                            None, VERDICT_SDC)):
                    floor = max(32, int(stop_when.min_done) // 4)
                    if floor < int(stop_when.min_done):
                        sub_stop = dataclasses.replace(stop_when,
                                                       min_done=floor)
                        relaxed[name] = floor
                sub_res = self.run_schedule(
                    sub, batch_size=min(batch_size, len(sub)),
                    progress=with_base(agg_done, dict(agg_counts)),
                    stop_when=sub_stop)
                ran = len(sub_res.codes)
                sel = idx[:ran]
                take(sub_res, sel)
                keep[sel] = True
                per_section[name] = sub_res.convergence
                agg_done += ran
                for k, v in sub_res.counts.items():
                    agg_counts[k] = agg_counts.get(k, 0) + v
            convergence = {
                "stopped": any(bool((c or {}).get("stopped"))
                               for c in per_section.values()),
                "stop_when": stop_when.spec(),
                "per_section": per_section,
            }
            if static_info is not None and relaxed:
                static_info["relaxed_min"] = dict(sorted(relaxed.items()))
        dropped = 0
        if keep is not None and not keep.all():
            # Early stop cut some sections short: the result describes
            # exactly the spliced and collected rows.
            keep_idx = np.flatnonzero(keep)
            dropped = int(len(part) - len(keep_idx))
            part = _rows_subset(part, keep_idx)
            cols = {k: v[keep_idx] for k, v in cols.items()}
        # As in run(): a t < 0 row never fired and counts cache_invalid.
        fired = np.asarray(part.t) >= 0
        w_col = np.asarray(part.class_weight, np.int64)
        counts = cls.counts_dict(cls.weighted_histogram(
            cols["codes"][fired], w_col[fired]), self._train)
        counts["cache_invalid"] = int(w_col[~fired].sum())
        delta_summary: Dict[str, object] = {**plan.summary(),
                                            "base": delta_from}
        if static_info is not None:
            delta_summary["static_budget"] = static_info
        if stop_when is not None:
            delta_summary["dropped_rows"] = dropped
        if len(run_idx):
            # Base-against-candidate distributions of every section that
            # re-injected anything (the spliced rows are equal by
            # construction, so a drift can only start here).
            def names_of(leaf_col):
                return np.array([section_names.get(int(l), "?")
                                 for l in np.asarray(leaf_col)])
            run_names = names_of(part0_leaf[run_idx])
            final_names = names_of(part.leaf_id)
            base_names = names_of(base_leaf)
            sections: Dict[str, object] = {}
            for name in sorted(set(run_names)):
                bsel = base_names == name
                csel = final_names == name
                sections[name] = {
                    "base_n": int(base_w_col[bsel].sum()),
                    "base_counts": cls.counts_dict(
                        cls.weighted_histogram(base_codes_col[bsel],
                                               base_w_col[bsel]),
                        self._train),
                    "n": int(w_col[csel].sum()),
                    "counts": cls.counts_dict(
                        cls.weighted_histogram(cols["codes"][csel],
                                               w_col[csel]),
                        self._train),
                }
            delta_summary["sections"] = sections
        res = CampaignResult(
            benchmark=self.prog.region.name, strategy=self.strategy_name,
            n=part.effective_n, physical_n=len(part), counts=counts,
            seconds=seconds, codes=cols["codes"], errors=cols["errors"],
            corrected=cols["corrected"], steps=cols["steps"],
            schedule=part, seed=part.seed, stages=stages,
            resilience=resilience, delta=delta_summary)
        res.convergence = convergence
        res.start_num = start_num
        return res

    def journal_result(self, res: CampaignResult, path: str,
                       n: Optional[int] = None,
                       batch_size: int = 4096) -> None:
        """Write a completed single-seed dense result as a ``mode: "run"``
        journal at ``path``: the header, the representatives of a reduced
        schedule, and one batch record per ``batch_size`` rows with
        cumulative counts (what ``load_delta_base`` reads).  Refuses an existing
        non-empty ``path`` (JournalExistsError) and raises JournalError if
        the re-derived counts do not reproduce ``res.counts``."""
        if res.collect != "dense":
            raise ValueError(
                "journal_result materializes dense per-row batch "
                "records; a sparse result has no full columns to write")
        part = res.schedule
        spec = self._campaign_spec(
            int(n) if n is not None else int(res.n), seed=res.seed,
            batch_size=batch_size, start_num=res.start_num)
        header = self._journal_header(
            "run", **spec.run_header_fields(),
            schedule_sha=schedule_fingerprint(part))
        j = CampaignJournal.open(path, header, resume=False)
        try:
            if part.class_weight is not None:
                _journal_equiv_schedule(j, part)
            live = np.zeros(cls.NUM_CLASSES, np.int64)
            live_invalid = 0
            t_col = np.asarray(part.t)
            w = part.class_weight
            counts: Dict[str, int] = {}
            for lo in range(0, len(part), batch_size):
                hi = min(lo + batch_size, len(part))
                out = {"code": res.codes[lo:hi], "errors": res.errors[lo:hi],
                       "corrected": res.corrected[lo:hi],
                       "steps": res.steps[lo:hi]}
                fired = t_col[lo:hi] >= 0
                ww = None if w is None else w[lo:hi]
                live += cls.weighted_histogram(
                    out["code"][fired], None if ww is None else ww[fired])
                live_invalid += int((~fired).sum() if ww is None
                                    else ww[~fired].sum())
                counts = cls.counts_dict(live, self._train)
                counts["cache_invalid"] = live_invalid
                j.append_batch(lo, out, counts, {})
            want = {k: int(v) for k, v in res.counts.items()}
            if len(part) and counts != want:
                raise JournalError(
                    f"journal_result parity failure at {path!r}: "
                    f"re-derived cumulative counts {counts} != result "
                    f"counts {want}")
        finally:
            j.close()

    def _result_from_chunk(self, rec: Dict[str, object]) -> CampaignResult:
        """One journaled chunk's CampaignResult, rebuilt without the device:
        the seeded schedule regenerates, the columns come from the
        record."""
        seed, n = int(rec["seed"]), int(rec["n"])
        start_num = int(rec.get("start_num", 0))
        sched = generate(self.mmap, start_num + n, seed,
                         self.prog.region.nominal_steps,
                         model=self.fault_model
                         ).slice(start_num, start_num + n)
        if self.equiv_partition is not None:
            sched = self.equiv_partition.reduce(sched)
        return CampaignResult(
            benchmark=self.prog.region.name, strategy=self.strategy_name,
            n=sched.effective_n,
            physical_n=(len(sched) if sched.class_weight is not None
                        else None),
            counts={k: int(v) for k, v in rec["counts"].items()},
            seconds=float(rec.get("seconds", 0.0)),
            codes=np.asarray(rec["codes"], np.int32),
            errors=np.asarray(rec["errors"], np.int32),
            corrected=np.asarray(rec["corrected"], np.int32),
            steps=np.asarray(rec["steps"], np.int32),
            schedule=sched, seed=seed,
            stages={k: float(v)
                    for k, v in (rec.get("stage_seconds") or {}).items()},
            start_num=start_num)

    def _chunk_runner(self, journal, header: Dict[str, object],
                      batch_size: int,
                      progress: Optional[
                          Callable[[int, Dict[str, int]], None]]):
        """The per-chunk machinery of ``run_until_errors`` and
        ``replay_chunks``: a ``next_chunk(n, seed, start_num)`` closure
        that replays completed chunks from the journal (checking each
        against the loop's expectation), runs and journals the rest, and
        threads ``progress`` across chunks.  Returns (next_chunk,
        finish)."""
        if self.collect != "dense":
            raise ValueError(
                "multi-chunk campaigns (run_until_errors / "
                "replay_chunks) record full per-chunk columns; run "
                "them with collect='dense' (sparse campaigns use "
                "run/run_schedule)")
        j, owned = self._open_journal(journal, header)
        replayed = j.chunk_records() if j is not None else []
        replay_idx = 0
        agg_counts: Dict[str, int] = {}
        agg_done = 0

        def next_chunk(n_req: int, seed: int,
                       start_num: int = 0) -> CampaignResult:
            nonlocal replay_idx, agg_done
            from_journal = replay_idx < len(replayed)
            if from_journal:
                rec = replayed[replay_idx]
                expect = (int(rec["seed"]), int(rec["n"]),
                          int(rec.get("start_num", 0)))
                if expect != (int(seed), int(n_req), int(start_num)):
                    raise JournalMismatchError(
                        f"journal chunk {replay_idx} records (seed, n, "
                        f"start_num)={expect} but the campaign loop "
                        f"expects {(int(seed), int(n_req), int(start_num))}"
                        "; refusing to resume")
                replay_idx += 1
                res = self._result_from_chunk(rec)
            else:
                chunk_progress = None
                if progress is not None:
                    def chunk_progress(done, counts, _base=agg_done,
                                       _agg=dict(agg_counts)):
                        merged = dict(_agg)
                        for k, v in counts.items():
                            merged[k] = merged.get(k, 0) + v
                        progress(_base + done, merged)
                res = self.run(n_req, seed=seed, batch_size=batch_size,
                               start_num=start_num,
                               progress=chunk_progress)
                if j is not None:
                    j.append_chunk(res)
            agg_done += res.n
            for k, v in res.counts.items():
                agg_counts[k] = agg_counts.get(k, 0) + v
            if progress is not None and from_journal:
                progress(agg_done, dict(agg_counts))
            return res

        def finish() -> None:
            if owned:
                j.close()

        return next_chunk, finish

    def run_until_errors(self, min_errors: int, seed: int = 0,
                         batch_size: int = 4096, round_to: int = 1000,
                         max_n: int = 1_000_000,
                         progress: Optional[
                             Callable[[int, Dict[str, int]], None]] = None,
                         journal: "Optional[object]" = None
                         ) -> CampaignResult:
        """The reference's sizing rule: inject until ``min_errors`` SDCs
        are seen, then round the campaign up to the next ``round_to``.
        Each chunk is one seeded ``run`` of ``batch_size`` rows (seed,
        seed + 1, ...); the result's ``chunks`` lets ``replay_chunks``
        reproduce it.  ``journal`` appends one fsync'd record a completed
        chunk, and a rerun replays the completed chunks from disk."""
        next_chunk, finish = self._chunk_runner(
            journal, self._journal_header(
                "until_errors", seed=int(seed), min_errors=int(min_errors),
                round_to=int(round_to), max_n=int(max_n),
                batch_size=int(batch_size)),
            batch_size, progress)
        try:
            results: List[CampaignResult] = []
            total = 0
            errors_seen = 0
            chunk_seed = seed
            while total < max_n:
                res = next_chunk(batch_size, chunk_seed)
                results.append(res)
                total += res.n
                errors_seen += res.sdc_total
                chunk_seed += 1
                if errors_seen >= min_errors:
                    break
            target = ((total + round_to - 1) // round_to) * round_to
            while total < target and total < max_n:
                res = next_chunk(min(batch_size, target - total), chunk_seed)
                results.append(res)
                total += res.n
                chunk_seed += 1
        finally:
            finish()
        return _merge_results(results, seed)

    def replay_chunks(self, chunks: Sequence[Dict[str, int]],
                      batch_size: int = 4096,
                      progress: Optional[
                          Callable[[int, Dict[str, int]], None]] = None,
                      journal: "Optional[object]" = None) -> CampaignResult:
        """Re-run a recorded multi-chunk campaign (``CampaignResult.chunks``)
        exactly; ``progress`` and ``journal`` as in ``run_until_errors``."""
        if not chunks:
            raise ValueError(
                "replay_chunks got an empty chunk list: the recorded "
                "campaign produced no chunks (nothing to replay)")
        next_chunk, finish = self._chunk_runner(
            journal, self._journal_header(
                "replay",
                chunks=[{"seed": int(c["seed"]), "n": int(c["n"]),
                         "start_num": int(c.get("start_num", 0))}
                        for c in chunks],
                batch_size=int(batch_size)),
            batch_size, progress)
        try:
            results = [next_chunk(int(c["n"]), int(c["seed"]),
                                  int(c.get("start_num", 0)))
                       for c in chunks]
        finally:
            finish()
        return _merge_results(results, int(chunks[0]["seed"]))


def _journal_equiv_schedule(journal: CampaignJournal,
                            part: FaultSchedule) -> None:
    """Append a reduced schedule's representatives and class weights: the
    ``equiv_schedule`` record ``load_delta_base`` splices by."""
    journal.append({
        "kind": "equiv_schedule",
        "class_weight": part.class_weight.tolist(),
        **{k: np.asarray(getattr(part, k)).tolist()
           for k in ("leaf_id", "lane", "word", "bit", "t")},
    })


def _merge_profiles(parts: List[CampaignResult]
                    ) -> Optional[Dict[str, object]]:
    """Merged device-time attribution of a multi-chunk campaign: the
    per-chunk buckets summed (each chunk's identity holds, so the sums'
    does too), histograms merged bucket-wise, fractions over the summed
    wall, and the mfu block re-derived from the summed rows and device
    seconds (its analytic inputs are per-run constants of the one
    program)."""
    profs = [p.profile for p in parts if p.profile]
    if not profs:
        return None
    out: Dict[str, object] = {
        "dispatches": sum(int(p["dispatches"]) for p in profs),
        "rows": sum(int(p["rows"]) for p in profs),
    }
    for key in ("wall_s", "device_busy_s", "host_gap_s", "host_other_s"):
        out[key] = round(sum(float(p[key]) for p in profs), 6)
    wall = float(out["wall_s"]) or 1.0
    out["device_busy_fraction"] = round(
        float(out["device_busy_s"]) / wall, 6)
    out["dispatch_gap_fraction"] = round(
        float(out["host_gap_s"]) / wall, 6)
    per_phase: Dict[str, float] = {}
    for p in profs:
        for name, s in (p.get("per_phase_device_s") or {}).items():
            per_phase[name] = per_phase.get(name, 0.0) + float(s)
    out["per_phase_device_s"] = {k: round(v, 6)
                                 for k, v in per_phase.items()}
    for key in ("device_seconds_histogram", "host_gap_seconds_histogram"):
        hists = [p.get(key) for p in profs if p.get(key)]
        if hists and all(h["le"] == hists[0]["le"] for h in hists):
            out[key] = {
                "le": list(hists[0]["le"]),
                "counts": [sum(h["counts"][i] for h in hists)
                           for i in range(len(hists[0]["le"]))],
                "count": sum(int(h["count"]) for h in hists),
                "sum": round(sum(float(h["sum"]) for h in hists), 6)}
    out["backend"] = profs[0].get("backend")
    mfus = [p.get("mfu") for p in profs if p.get("mfu")]
    if mfus:
        mfu = dict(mfus[0])            # per-run analytic constants
        mfu["runs"] = int(out["rows"])
        mfu["device_busy_s"] = out["device_busy_s"]
        mfu["dispatch_gap_fraction"] = out["dispatch_gap_fraction"]
        useful = float(mfu.get("useful_ops_per_run") or 0.0)
        busy = float(out["device_busy_s"])
        achieved = useful * mfu["runs"] / busy if busy > 0 else 0.0
        mfu["achieved_ops_per_s"] = round(achieved, 1)
        mfu["achieved_ops_per_s_wall"] = round(
            useful * mfu["runs"] / wall, 1)
        peak = mfu.get("peak_gflops")
        if peak:
            mfu["achieved_mfu"] = round(achieved / (peak * 1e9), 8)
            mfu["achieved_mfu_wall"] = round(
                useful * mfu["runs"] / wall / (peak * 1e9), 8)
        out["mfu"] = mfu
    return out


def _merge_results(parts: List[CampaignResult], seed: int) -> CampaignResult:
    """Concatenate chunk results into one campaign (rows in chunk order)."""
    if not parts:
        raise ValueError(
            "campaign produced no chunks: _merge_results got an empty "
            "parts list (the sizing loop never ran a batch -- check "
            "min_errors/max_n/target arithmetic)")
    first = parts[0]
    if len({p.collect for p in parts}) > 1:
        raise ValueError(
            "cannot merge campaigns with mixed collect modes "
            f"({sorted({p.collect for p in parts})})")
    counts = {k: sum(p.counts[k] for p in parts) for k in first.counts}
    stages: Dict[str, float] = {}
    resilience: Dict[str, int] = {}
    transfer: Dict[str, int] = {}
    for p in parts:
        for k, v in p.stages.items():
            stages[k] = stages.get(k, 0.0) + v
        for k, v in p.resilience.items():
            resilience[k] = resilience.get(k, 0) + v
        for k, v in p.transfer.items():
            transfer[k] = transfer.get(k, 0) + int(v)
    interesting = None
    if first.collect != "dense":
        offsets = np.cumsum([0] + [len(p.schedule) for p in parts[:-1]])
        interesting = np.concatenate(
            [p.interesting_rows + int(off)
             for p, off in zip(parts, offsets)])
    extra = None
    if first.schedule.extra is not None:
        # Each part's group column indexes its own injections: rebase.
        offsets = np.cumsum([0] + [p.n for p in parts[:-1]])
        extra = {k: np.concatenate([p.schedule.extra[k] for p in parts])
                 for k in first.schedule.extra if k != "group"}
        extra["group"] = np.concatenate(
            [p.schedule.extra["group"] + np.int32(off)
             for p, off in zip(parts, offsets)]).astype(np.int32)
    weights = None
    if first.schedule.class_weight is not None:
        weights = np.concatenate([p.schedule.class_weight for p in parts])
    sched = FaultSchedule(
        *(np.concatenate([getattr(p.schedule, f) for p in parts])
          for f in ("leaf_id", "lane", "word", "bit", "t", "section_idx")),
        seed=seed, extra=extra, model=first.schedule.model,
        class_weight=weights, equiv_sha=first.schedule.equiv_sha)
    physical = None
    if any(p.physical_n is not None for p in parts):
        physical = sum(p.physical_n if p.physical_n is not None else p.n
                       for p in parts)
    return CampaignResult(
        benchmark=first.benchmark, strategy=first.strategy,
        n=sum(p.n for p in parts), physical_n=physical, counts=counts,
        seconds=sum(p.seconds for p in parts),
        codes=np.concatenate([p.codes for p in parts]),
        errors=np.concatenate([p.errors for p in parts]),
        corrected=np.concatenate([p.corrected for p in parts]),
        steps=np.concatenate([p.steps for p in parts]),
        schedule=sched, seed=seed,
        chunks=[{"seed": p.seed, "n": p.n, "start_num": p.start_num}
                for p in parts],
        stages=stages, resilience=resilience, collect=first.collect,
        interesting_rows=interesting, transfer=transfer,
        profile=_merge_profiles(parts))
