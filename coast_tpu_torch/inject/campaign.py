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
  reproduce, such as strata, is uploaded once and sliced there), the class
  histogram and the compaction of the interesting rows (class outside
  success/corrected) are computed there, and only those come back: the
  histogram, a row bitmask and one packed word a row (:func:`_pack_layout`).
  A batch whose interesting rows overflow the buffer falls back to a dense
  fetch.  Counts, interesting rows and their columns equal the dense
  path's; ``CampaignResult.codes`` then covers the interesting rows only,
  indexed by ``interesting_rows``.

``CampaignResult.transfer`` counts the host<->device bytes of every
campaign as the reference counts them, plus the one copy the port's engine
makes a batch and the reference's compiled loop does not: a bool a step,
and one a site column and a leaf, which steps and leaves the batch's flips
touch (``ProtectedProgram.fire_plan_bytes``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from coast_tpu_torch.inject import classify as cls
from coast_tpu_torch.inject.device_gen import DeviceGenError, DeviceScheduleGen
from coast_tpu_torch.inject.mem import MemoryMap
from coast_tpu_torch.inject.schedule import (FaultModel, FaultSchedule,
                                             generate)

_COLUMNS = ("code", "errors", "corrected", "steps")
# Profiler spans around the sparse collect's own layers, once a batch
# (``breakdown.py`` reads their device time from a campaign's profile).
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
    # "dense": the columns above cover all n rows; "sparse": only the
    # interesting rows, whose schedule-local indices (int64) are
    # ``interesting_rows``.
    collect: str = "dense"
    interesting_rows: Optional[np.ndarray] = None
    # Host<->device bytes, {"up", "down"}.
    transfer: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def injections_per_sec(self) -> float:
        return self.n / self.seconds if self.seconds > 0 else float("inf")

    @property
    def fault_model(self) -> FaultModel:
        return self.schedule.model


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
    """The base sites of ``sched`` at arbitrary ``rows`` (the model kept,
    the extra flip-group sites dropped): what a per-row record names."""
    idx = np.asarray(rows, np.int64)
    return FaultSchedule(
        *(np.ascontiguousarray(np.asarray(getattr(sched, f))[idx])
          for f in ("leaf_id", "lane", "word", "bit", "t", "section_idx")),
        seed=sched.seed, model=sched.model)


class CampaignRunner:
    """Runs seeded bit-flip campaigns against one protected program, on the
    program's device."""

    def __init__(self, prog, sections: Optional[Sequence[str]] = None,
                 strategy_name: Optional[str] = None, device=None,
                 fault_model: Optional[FaultModel] = None,
                 collect: str = "dense",
                 sparse_capacity: Optional[int] = None):
        """``fault_model`` is what ``run`` draws (default single sites).
        ``collect`` is ``"dense"`` or ``"sparse"`` (see the module
        docstring); ``sparse_capacity`` bounds the interesting rows a
        sparse batch compacts on the device (default ``max(256,
        batch_size // 4)``); correctness never depends on it."""
        if (device is not None
                and torch.device(device).type != prog.device.type):
            raise ValueError(
                f"CampaignRunner(device={device!r}) but the program was "
                f"built on {prog.device}; build it there instead")
        if collect not in ("dense", "sparse"):
            raise ValueError(
                f"unknown collect mode {collect!r}; one of 'dense', "
                "'sparse'")
        self.prog = prog
        self.mmap = MemoryMap(prog, sections)
        self.strategy_name = strategy_name or f"N={prog.cfg.num_clones}"
        self.fault_model = (fault_model if fault_model is not None
                            else FaultModel())
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

    def _run_rows(self, fault, transfer: Dict[str, int]
                  ) -> Dict[str, torch.Tensor]:
        """One batch through the engine, classified on its device; counts
        the engine's fire-plan copy."""
        t = fault["t"]
        transfer["down"] += self.prog.fire_plan_bytes(
            t.shape[1] if t.ndim > 1 else 1)
        rec = self.prog.run_batch(fault)
        out = {k: rec[k].to(torch.int32) for k in _COLUMNS[1:]}
        out["code"] = cls.classify(rec, self.prog.output_words)
        return out

    def _dense_batch(self, sched: FaultSchedule, lo: int, n_part: int,
                     batch_size: int, transfer: Dict[str, int]
                     ) -> Dict[str, np.ndarray]:
        fault, _ = self._padded_fault(sched.slice(lo, lo + n_part),
                                      batch_size)
        transfer["up"] += sum(int(v.nbytes) for v in fault.values())
        out = self._run_rows(fault, transfer)
        cols = torch.stack([out[k] for k in _COLUMNS]).cpu().numpy()
        transfer["down"] += int(cols.nbytes)
        return {k: cols[i, :n_part] for i, k in enumerate(_COLUMNS)}

    # -- sparse (device-resident) collection ---------------------------------
    def _sparse_cap(self, batch_size: int) -> int:
        cap = int(self._sparse_capacity or max(256, batch_size // 4))
        return max(1, min(cap, batch_size))

    def _sparse_setup(self, sched: FaultSchedule, batch_size: int,
                      transfer: Dict[str, int]) -> Dict[str, object]:
        """Per-campaign sparse state.  A seeded stream schedule takes the
        generated path (no fault columns go up); any other schedule, or a
        map of 2^32 bits or more, is uploaded once with ``batch_size``
        rows of headroom, so a batch may start at any row, and sliced on
        the device (the resident path)."""
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
        arrays = {}
        for k, v in sched.device_arrays().items():
            v = np.pad(v, [(0, batch_size)] + [(0, 0)] * (v.ndim - 1),
                       mode="edge")
            arrays[k] = torch.as_tensor(v, device=self.prog.device)
            transfer["up"] += int(v.nbytes)
        w = np.pad(np.where(np.asarray(sched.t) < 0, 0, 1).astype(np.int32),
                   (0, batch_size))
        transfer["up"] += int(w.nbytes)
        state.update(mode="resident", arrays=arrays,
                     count_w=torch.as_tensor(w, device=self.prog.device))
        return state

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
            with torch.profiler.record_function(SPANS[0]):
                return (state["gen"].columns(state["seed"],
                                             state["stream_n"], rows), None)
        transfer["up"] += 4
        return ({k: v[lo:lo + b] for k, v in state["arrays"].items()},
                state["count_w"][lo:lo + b])

    def _sparse_batch(self, state: Dict[str, object], lo: int, n_part: int,
                      transfer: Dict[str, int]) -> Dict[str, np.ndarray]:
        """One sparse batch: run, account on the device, fetch the
        histogram and the interesting rows (batch-local row numbers)."""
        fault, count_w = self._sparse_args(state, lo, transfer)
        out = self._run_rows(fault, transfer)
        b = int(state["batch_size"])
        valid = torch.arange(b, device=self.prog.device) < n_part
        if count_w is None:
            count_w = valid.to(torch.int32)
        cap = int(state["cap"])
        with torch.profiler.record_function(SPANS[1]):
            dev = _sparse_device_outputs(out, count_w, valid, cap,
                                         self._pack)
        head = dev["head"].cpu().numpy()
        hist = head[:cls.NUM_CLASSES].astype(np.int64)
        k, ke = int(head[-2]), int(head[-1])
        transfer["down"] += int(head.nbytes)
        if k > cap or ke > cap:
            # Overflow: correctness never depends on the capacity.
            cols = torch.stack([out[c] for c in _COLUMNS]).cpu().numpy()
            transfer["down"] += int(cols.nbytes)
            rows = np.flatnonzero(cols[0, :n_part] > cls.CORRECTED)
            return {"hist": hist, "rows": rows.astype(np.int64),
                    **{c: cols[i, rows] for i, c in enumerate(_COLUMNS)}}
        words = torch.cat([dev["mask"], dev["packed"][:k],
                           dev["exact"][:ke].flatten()]).cpu().numpy()
        transfer["down"] += int(words.nbytes)
        n_mask = dev["mask"].shape[0]
        mask = words[:n_mask].view(np.uint32)
        packed = words[n_mask:n_mask + k].view(np.uint32)
        exact = words[n_mask + k:].reshape(ke, 3)
        code, err, cor, steps = _unpack_rows(packed, exact, self._pack)
        rows = _mask_rows(mask, n_part)
        if len(rows) != k:
            raise RuntimeError(
                f"sparse collect: bitmask names {len(rows)} interesting "
                f"rows but the device counted {k}")
        return {"hist": hist, "rows": rows.astype(np.int64), "code": code,
                "errors": err, "corrected": cor, "steps": steps}

    # -- execution ----------------------------------------------------------
    def run_schedule(self, sched: FaultSchedule,
                     batch_size: int = 4096) -> CampaignResult:
        """Run every row of ``sched`` in edge-padded batches."""
        batch_size = max(1, batch_size)
        t0 = time.perf_counter()
        transfer = {"up": 0, "down": 0}
        state = (self._sparse_setup(sched, batch_size, transfer)
                 if self.collect == "sparse" else None)
        # Draws with t < 0 never fire a flip: they get their own bucket
        # instead of inflating success (on the sparse path they carry zero
        # count weight, and their number comes from the host schedule).
        invalid_draw = np.asarray(sched.t) < 0
        outs = []
        for lo in range(0, len(sched), batch_size):
            n_part = min(lo + batch_size, len(sched)) - lo
            if state is None:
                outs.append(self._dense_batch(sched, lo, n_part, batch_size,
                                              transfer))
            else:
                out = self._sparse_batch(state, lo, n_part, transfer)
                out["rows"] += lo
                outs.append(out)
        interesting_rows = None
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
        else:
            binc = np.bincount(merged["code"][~invalid_draw],
                               minlength=cls.NUM_CLASSES)
        counts = cls.counts_dict(binc)
        counts["cache_invalid"] = int(invalid_draw.sum())
        seconds = time.perf_counter() - t0
        return CampaignResult(
            benchmark=self.prog.region.name, strategy=self.strategy_name,
            n=len(sched), counts=counts, seconds=seconds,
            codes=merged["code"], errors=merged["errors"],
            corrected=merged["corrected"], steps=merged["steps"],
            schedule=sched, seed=sched.seed, collect=self.collect,
            interesting_rows=interesting_rows, transfer=transfer)

    def run(self, n: int, seed: int = 0, batch_size: int = 4096,
            start_num: int = 0) -> CampaignResult:
        """A seeded campaign of ``n`` injections of ``fault_model``.
        ``start_num`` resumes at injection #start_num of the (seed,
        start_num + n) stream."""
        sched = generate(self.mmap, start_num + n, seed,
                         self.prog.region.nominal_steps,
                         model=self.fault_model)
        return self.run_schedule(sched.slice(start_num, start_num + n),
                                 batch_size)
