"""Batched fault-injection campaigns over a protected program.

The counterpart of the dense path of ``coast_tpu/inject/campaign.py``: a
seeded schedule is cut into edge-padded batches, each batch runs as one
``ProtectedProgram.run_batch`` on the program's device, and the rows are
classified there.  Only the per-row code, errors, corrected and steps
columns come back to the host.  ``counts`` carries the same keys as the
reference's, ``cache_invalid`` included.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from coast_tpu_torch.inject import classify as cls
from coast_tpu_torch.inject.mem import MemoryMap
from coast_tpu_torch.inject.schedule import FaultSchedule, generate

_COLUMNS = ("code", "errors", "corrected", "steps")


@dataclasses.dataclass
class CampaignResult:
    """Aggregate + per-run results of one campaign (host-side)."""

    benchmark: str
    strategy: str
    n: int
    counts: Dict[str, int]            # class name -> count
    seconds: float
    codes: np.ndarray                 # int32 [n] class code per run
    errors: np.ndarray                # int32 [n] E per run
    corrected: np.ndarray             # int32 [n] F per run
    steps: np.ndarray                 # int32 [n] T per run
    schedule: FaultSchedule
    seed: int

    @property
    def injections_per_sec(self) -> float:
        return self.n / self.seconds if self.seconds > 0 else float("inf")


class CampaignRunner:
    """Runs seeded bit-flip campaigns against one protected program, on the
    program's device."""

    def __init__(self, prog, sections: Optional[Sequence[str]] = None,
                 strategy_name: Optional[str] = None, device=None):
        if (device is not None
                and torch.device(device).type != prog.device.type):
            raise ValueError(
                f"CampaignRunner(device={device!r}) but the program was "
                f"built on {prog.device}; build it there instead")
        self.prog = prog
        self.mmap = MemoryMap(prog, sections)
        self.strategy_name = strategy_name or f"N={prog.cfg.num_clones}"

    @staticmethod
    def _padded_fault(part: FaultSchedule, batch_size: int):
        """Fault columns for one batch, edge-padded to ``batch_size``.
        Returns (fault, n_valid); the padded tail is dropped."""
        n_part = len(part)
        pad = batch_size - n_part if n_part < batch_size else 0
        fault = {k: np.pad(v, (0, pad), mode="edge")
                 for k, v in part.device_arrays().items()}
        return fault, n_part

    def run_schedule(self, sched: FaultSchedule,
                     batch_size: int = 4096) -> CampaignResult:
        """Run every row of ``sched`` in edge-padded batches."""
        batch_size = max(1, batch_size)
        prog = self.prog
        t0 = time.perf_counter()
        outs = []
        for lo in range(0, len(sched), batch_size):
            fault, n_part = self._padded_fault(
                sched.slice(lo, lo + batch_size), batch_size)
            rec = prog.run_batch(fault)
            rec["code"] = cls.classify(rec, prog.output_words)
            outs.append({k: rec[k][:n_part].to(torch.int32).cpu().numpy()
                         for k in _COLUMNS})
        if outs:
            merged = {k: np.concatenate([o[k] for o in outs])
                      for k in _COLUMNS}
        else:
            merged = {k: np.zeros(0, np.int32) for k in _COLUMNS}
        # Draws with t < 0 never fire a flip: they get their own bucket
        # instead of inflating success.
        invalid_draw = np.asarray(sched.t) < 0
        counts = cls.counts_dict(np.bincount(merged["code"][~invalid_draw],
                                             minlength=cls.NUM_CLASSES))
        counts["cache_invalid"] = int(invalid_draw.sum())
        seconds = time.perf_counter() - t0
        return CampaignResult(
            benchmark=prog.region.name, strategy=self.strategy_name,
            n=len(sched), counts=counts, seconds=seconds,
            codes=merged["code"], errors=merged["errors"],
            corrected=merged["corrected"], steps=merged["steps"],
            schedule=sched, seed=sched.seed)

    def run(self, n: int, seed: int = 0, batch_size: int = 4096,
            start_num: int = 0) -> CampaignResult:
        """A seeded campaign of ``n`` injections.  ``start_num`` resumes at
        injection #start_num of the (seed, start_num + n) stream."""
        sched = generate(self.mmap, start_num + n, seed,
                         self.prog.region.nominal_steps)
        return self.run_schedule(sched.slice(start_num, start_num + n),
                                 batch_size)
