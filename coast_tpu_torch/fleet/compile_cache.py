"""Compile cache of the port: pay the protected-program build once per
config across the fleet.

The port's counterpart of ``coast_tpu/fleet/compile_cache.py``, with its
event words, counters and key ledger.  The reference caches XLA compiles;
the port's eager engine has no compile step.  Its cold cost per config is:

  * the native build: ``nvcc`` of every ``csrc/*.cu`` kernel
    (:func:`coast_tpu_torch.build.build_all`), seconds, once per checkout
    and shared on disk by every process through ``build/kernels/``;
  * the program build: region resolve + protection transform, and for
    ``--equiv`` the capture of the step and the partition derived from it
    (done in the :class:`~coast_tpu_torch.inject.campaign.CampaignRunner`
    constructor).

Three layers, cheapest first:

  1. **Warm (in-process)**: one runner per cache key, memoized for the
     life of the worker -- a worker draining ten same-config items builds
     the program (and its partition) once (``warm_hit``).
  2. **Persistent (cross-process)**: the native kernels.  A cold runner
     build under a key some fleet process already ran is a
     ``persistent_hit``: its kernels are loaded from ``build/kernels/``
     without ``nvcc`` (a CUDA runner calls ``build_all`` before it is
     built, a no-op when the libraries exist).  The program itself and
     an equiv partition are rebuilt in the new process.
  3. **Key ledger**: ``<root>/keys/<key>.json`` records which configs some
     fleet process has already run.  The key is the journal's identity
     vocabulary -- the protection ``config_sha`` (the fingerprint the
     journal header pins) + mesh geometry + section / fault-model / equiv
     / unroll / collect + the torch version + the device type, where the
     reference keys on the jax version and backend -- so a cache hit can
     never hand back a program built for a different campaign identity.
     A key never seen anywhere is a ``miss``.

Hit/miss counters feed the ambient obs telemetry (``compile_cache_*``
counts), the per-worker status doc, and the fleet-level /metrics
aggregate.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional, Tuple

from coast_tpu_torch import device as device_mod
from coast_tpu_torch.obs.metrics import atomic_write_json

__all__ = ["CompileCache"]

#: Cache event vocabulary, in "best outcome first" order.
EVENTS = ("warm_hit", "persistent_hit", "miss")


class CompileCache:
    """Per-worker facade over the three cache layers, rooted at the
    queue's shared ``cache/`` directory.  Programs are built on
    ``device`` (the card unless the caller passes ``"cpu"``)."""

    def __init__(self, root: str, device=device_mod.DEFAULT,
                 program_hook=None):
        """``program_hook(prog)`` is applied (in place) to every freshly
        built protected program before any runner/key is derived from
        it -- the seam the protection-regression CI's tests and smoke
        driver use to seed a weakened build (e.g. dropping a commit
        vote) into an otherwise stock worker.  None in production."""
        self.root = str(root)
        os.makedirs(os.path.join(self.root, "keys"), exist_ok=True)
        self.device = device_mod.resolve(device)
        self.counters: Dict[str, int] = {name: 0 for name in EVENTS}
        self.last_event: Optional[str] = None
        self.program_hook = program_hook
        self._runners: Dict[str, Tuple[object, str]] = {}
        self._programs: Dict[Tuple[str, str, str], Tuple[object, str]] = {}
        # The persistent layer is the on-disk native build, there on any
        # device (the CPU path loads no kernel, so it has nothing to miss).
        self.persistent_enabled = True

    # -- keys ----------------------------------------------------------------
    @staticmethod
    def _mesh_geometry(mesh) -> Optional[Dict[str, int]]:
        if mesh is None:
            return None
        return {str(name): int(size)
                for name, size in zip(mesh.axis_names, mesh.devices.shape)}

    def key(self, prog, spec: Dict[str, object], mesh=None) -> str:
        """Cache key = journal config-sha + mesh geometry + the
        :class:`~coast_tpu_torch.inject.spec.CampaignSpec` fields that
        change what gets built.  ``delta_from``/``stop_when`` are
        deliberately absent: a delta or convergence-bounded item runs the
        same program as its plain campaign."""
        import torch
        from coast_tpu_torch.inject.journal import config_fingerprint
        from coast_tpu_torch.inject.spec import (PLACEMENT_DEFAULT,
                                                 CampaignSpec)
        cs = CampaignSpec.from_item(spec)
        doc = {
            "benchmark": prog.region.name,
            "config_sha": config_fingerprint(prog.cfg),
            "section": cs.section,
            "fault_model": cs.fault_model,
            "equiv": cs.equiv,
            "unroll": cs.unroll,
            # The collection mode fixes the runner's collect at
            # construction: a warm hit must never serve the other mode.
            "collect": cs.collect,
            "mesh": self._mesh_geometry(mesh),
            "torch": torch.__version__,
            "device": self.device.type,
        }
        if cs.placement != PLACEMENT_DEFAULT:
            doc["placement"] = cs.placement
        return hashlib.sha256(
            json.dumps(doc, sort_keys=True).encode()).hexdigest()[:16]

    def _key_path(self, key: str) -> str:
        return os.path.join(self.root, "keys", f"{key}.json")

    # -- build paths ---------------------------------------------------------
    def program(self, benchmark: str, opt_passes: str,
                placement: str = "compute"):
        """Memoized protected-program build (region resolve + protection
        transform), via the supervisor's own flag parser so semantics
        cannot drift from ``python -m coast_tpu_torch.opt``."""
        memo_key = (str(benchmark), str(opt_passes), str(placement))
        if memo_key not in self._programs:
            from coast_tpu_torch.inject.supervisor import build_program
            try:
                prog, strategy = build_program(
                    benchmark, opt_passes, str(self.device),
                    placement=placement)
                if self.program_hook is not None:
                    self.program_hook(prog)
                self._programs[memo_key] = (prog, strategy)
            except SystemExit as e:
                # build_program is a CLI helper: it reports to stderr and
                # exits.  A fleet worker must fail the ITEM, not itself.
                raise RuntimeError(
                    f"protected-program build failed for "
                    f"benchmark={benchmark!r} opt_passes={opt_passes!r} "
                    f"(exit {e.code}; see the worker's stderr)") from e
        return self._programs[memo_key]

    def runner(self, spec: Dict[str, object], mesh=None,
               metrics=None, retry=None):
        """The cached-runner entry point: returns ``(runner, strategy,
        key, event)`` where ``event`` is this call's cache outcome.

        The runner is fully constructed for the spec's campaign identity
        (sections, fault model, equiv partition, mesh backend); a warm
        hit returns the SAME object.  ``metrics`` is re-pointed per call
        -- the live hub belongs to the worker, not the cache entry."""
        from coast_tpu_torch import obs
        from coast_tpu_torch.inject.campaign import CampaignRunner
        from coast_tpu_torch.inject.spec import CampaignSpec
        cs = CampaignSpec.from_item(spec)
        prog, strategy = self.program(cs.benchmark, cs.opt_passes,
                                      cs.placement)
        key = self.key(prog, spec, mesh)
        if key in self._runners:
            event = "warm_hit"
            runner, strategy = self._runners[key]
        else:
            event = ("persistent_hit"
                     if os.path.exists(self._key_path(key)) else "miss")
            if self.device.type == "cuda":
                from coast_tpu_torch import build
                build.build_all()
            from coast_tpu_torch.inject.supervisor import section_filter
            try:
                sections = section_filter(prog, cs.section)
            except SystemExit as e:
                raise RuntimeError(
                    f"section {cs.section!r} has no injectable "
                    f"leaves in {prog.region.name} (exit {e.code})") from e
            runner = CampaignRunner(
                prog, sections=sections, strategy_name=strategy,
                unroll=cs.unroll,
                fault_model=cs.fault_model_parsed(),
                equiv=cs.equiv,
                collect=cs.collect,
                mesh=mesh, retry=retry)
            self._runners[key] = (runner, strategy)
        runner.metrics = metrics
        runner.retry = retry if retry is not None else runner.retry
        self.counters[event] += 1
        self.last_event = event
        obs.count(f"compile_cache_{event}", key=key)
        from coast_tpu_torch.obs import flightrec
        flightrec.record("compile_cache", outcome=event, key=key)
        return runner, strategy, key, event

    def mark_compiled(self, key: str, spec: Dict[str, object]) -> None:
        """Record that ``key``'s program ran (the first collected batch
        proves it): a later cold build under this key -- a restarted
        worker, another process -- is a persistent hit, served by the
        on-disk native build rather than ``nvcc``.  Idempotent."""
        path = self._key_path(key)
        if os.path.exists(path):
            return
        atomic_write_json(path, {
            "format": "coast-fleet-compile-key", "version": 1,
            "key": key,
            "benchmark": spec.get("benchmark"),
            "opt_passes": spec.get("opt_passes"),
            "section": spec.get("section"),
            "persistent_xla_cache": self.persistent_enabled,
        })

    # -- accounting ----------------------------------------------------------
    @property
    def hits(self) -> int:
        return self.counters["warm_hit"] + self.counters["persistent_hit"]

    @property
    def misses(self) -> int:
        return self.counters["miss"]

    def snapshot(self) -> Dict[str, object]:
        return {**self.counters, "hits": self.hits, "misses": self.misses,
                "persistent_enabled": self.persistent_enabled}
