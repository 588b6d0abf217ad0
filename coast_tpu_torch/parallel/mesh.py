"""Campaign scale-out over a mesh of devices: the sharded backend.

The counterpart of ``coast_tpu/parallel/mesh.py``, whose batch axis is
``shard_map``'d over a ``jax.sharding.Mesh`` and whose histogram is
``psum``'d.  Here a :class:`Mesh` is axis names over an array of
``torch.device`` (one entry a shard).  The batch splits contiguously over
the product of the axes -- row r of a batch runs on shard ``r // per``,
``per = batch // shards`` -- and each shard runs its block on its device;
shards on one device run one after another.  Histograms and counts sum
over the shards (the ``psum``); across processes (``parallel/
multihost.py``) the histogram is ``all_reduce``'d.

``CampaignRunner(prog, mesh=make_mesh(2))`` builds a
:class:`ShardedCampaignRunner`; every campaign surface -- ``run``,
``run_schedule`` dense and sparse, journals and resume, retry, streamed
logs, ``run_until_errors``, equivalence-reduced campaigns (each shard's
rows of the resident schedule carry their class weights as the sparse
histogram's count weights) -- runs on the sharded dispatch with the
single-device runner's codes and counts at the same schedule, and the
result's ``summary()["mesh"]`` names the geometry and the interesting rows
each shard produced.

Meshes:

* on the CPU, ``make_mesh(n, device="cpu")`` gives n logical shards of the
  one CPU device (the counterpart of the reference's virtual CPU devices);
* on CUDA, ``make_mesh(n)`` takes the first n cards and refuses more than
  ``torch.cuda.device_count()``;
* a ``Mesh`` built by hand may repeat a device: ``Mesh([cuda:0, cuda:0])``
  is a two-shard mesh on one card.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from coast_tpu_torch import device as device_mod
from coast_tpu_torch.inject import classify as cls
from coast_tpu_torch.inject.campaign import (
    _COLUMNS, CampaignRunner, _mask_rows, _sparse_device_outputs,
    _unpack_rows, run_classified)
from coast_tpu_torch.inject.device_gen import DeviceScheduleGen
from coast_tpu_torch.inject.schedule import FaultSchedule, generate


class Mesh:
    """``axis_names`` over an array of ``torch.device``, one entry a shard.

    A mesh that spans a ``torch.distributed`` group (``process_count >
    1``) holds every shard of the group; process ``p`` runs the contiguous
    ``size // process_count`` shards from ``p * size // process_count``,
    and an entry of another process's shard names a device of that
    process.  ``group`` is the process group of a mesh built over
    ``torch.distributed`` (``parallel/multihost.py``), whose histograms are
    ``all_reduce``'d over it, even with one process."""

    def __init__(self, devices, axis_names: Sequence[str] = ("data",),
                 process_count: int = 1, process_index: int = 0,
                 group=None):
        src = np.asarray(devices, dtype=object)
        flat = [torch.device(d) for d in src.reshape(-1)]
        if not flat:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in flat}) != 1:
            raise ValueError(
                f"a mesh's devices must be of one type, got {flat}")
        self.devices = np.empty(len(flat), dtype=object)
        self.devices[:] = flat
        self.devices = self.devices.reshape(src.shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(
                f"{len(self.axis_names)} axis names for a mesh of shape "
                f"{self.devices.shape}")
        if process_count < 1 or self.size % process_count:
            raise ValueError(
                f"{self.size} shards do not split over {process_count} "
                "processes")
        if not 0 <= process_index < process_count:
            raise ValueError(
                f"process index {process_index} outside [0, "
                f"{process_count})")
        self.process_count = int(process_count)
        self.process_index = int(process_index)
        self.group = group

    @property
    def distributed(self) -> bool:
        return self.process_count > 1 or self.group is not None

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(int(n) for n in self.devices.shape)

    @property
    def size(self) -> int:
        return int(math.prod(self.shape))

    @property
    def device_type(self) -> str:
        return self.devices.reshape(-1)[0].type

    def shard_devices(self) -> List[torch.device]:
        """Every shard's device, in shard order (row-major over the
        axes)."""
        return list(self.devices.reshape(-1))

    def local_shards(self) -> List[Tuple[int, torch.device]]:
        """``(shard index, device)`` of the shards this process runs."""
        per = self.size // self.process_count
        lo = self.process_index * per
        return [(s, self.devices.reshape(-1)[s]) for s in range(lo, lo + per)]

    def __repr__(self) -> str:
        return (f"Mesh(axes={dict(zip(self.axis_names, self.shape))}, "
                f"devices={[str(d) for d in self.shard_devices()]})")


def _key(dev) -> str:
    """A device's name with the current card's index made explicit, so
    ``cuda`` and ``cuda:0`` are one device."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data",),
              shape: Optional[Tuple[int, ...]] = None,
              device=device_mod.DEFAULT) -> Mesh:
    """A mesh of ``n_devices`` shards, default 1-D ``"data"``; pass
    ``shape`` and ``axis_names`` for a multi-axis layout (e.g. ``(hosts,
    chips)``).  On CUDA: the first ``n_devices`` cards (default all), and
    a ``ValueError`` for more than there are.  On the CPU: ``n_devices``
    logical shards (default 1) of the one CPU device."""
    dev = device_mod.resolve(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        n = n_devices or count
        if n > count:
            raise ValueError(
                f"make_mesh wants {n} devices, the card count is {count}")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        n = n_devices or 1
        devs = [torch.device("cpu")] * n
    shape = tuple(shape) if shape is not None else (n,)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not hold {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axis_names)


class ShardedCampaignRunner(CampaignRunner):
    """A CampaignRunner whose batch axis is split over a :class:`Mesh`.

    Reachable as ``CampaignRunner(prog, mesh=...)``.  Every shard runs the
    same protected program on its device (built there once from
    ``prog.region`` and ``prog.cfg``); codes and counts equal the
    single-device runner's at the same schedule."""

    def __init__(self, prog, mesh: Optional[Mesh] = None, **kw):
        if not isinstance(mesh, Mesh):
            raise TypeError(
                f"ShardedCampaignRunner needs a coast_tpu_torch.parallel."
                f"mesh.Mesh, got {type(mesh).__name__}; build one with "
                "make_mesh(n)")
        if mesh.device_type != prog.device.type:
            raise ValueError(
                f"the mesh's devices are {mesh.device_type} but the program "
                f"was built on {prog.device}; build both on one device type")
        super().__init__(prog, **kw)
        self.mesh = mesh
        # Geometry on the record: the trace names the mesh it ran on.
        self.telemetry.instant(
            "mesh_geometry", devices=int(mesh.devices.size),
            axes={name: int(n) for name, n
                  in zip(mesh.axis_names, mesh.devices.shape)})
        self._local = mesh.local_shards()
        self._progs = {_key(prog.device): prog}
        self._shard_ledger: Optional[np.ndarray] = None

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    def _prog_on(self, dev: torch.device):
        """The protected program on ``dev`` (the runner's own on its
        device)."""
        key = _key(dev)
        if key not in self._progs:
            self._progs[key] = type(self.prog)(self.prog.region,
                                               self.prog.cfg, dev)
        return self._progs[key]

    # -- the per-shard interesting-row ledger --------------------------------
    # The batch splits contiguously over the mesh, so attributing a batch's
    # interesting rows to shards is host arithmetic.  Journal-replayed
    # batches are not attributed: the ledger counts what this process ran.
    def _ledger_reset(self) -> None:
        self._shard_ledger = np.zeros(self.n_devices, np.int64)

    def _ledger_rows(self, rows: np.ndarray, per: int) -> None:
        if self._shard_ledger is None or not len(rows):
            return
        shard = np.minimum(rows // max(int(per), 1), self.n_devices - 1)
        np.add.at(self._shard_ledger, shard, 1)

    def _ledger_dense(self, out: Dict[str, np.ndarray],
                      batch_size: int) -> None:
        rows = np.flatnonzero(np.asarray(out["code"]) > cls.CORRECTED)
        self._ledger_rows(rows.astype(np.int64),
                          max(1, batch_size // self.n_devices))

    def _mesh_block(self) -> Dict[str, object]:
        ledger = self._shard_ledger
        if ledger is None:
            ledger = np.zeros(self.n_devices, np.int64)
        return {"devices": self.n_devices,
                "axes": dict(zip(self.mesh.axis_names, self.mesh.shape)),
                "per_shard_interesting": [int(v) for v in ledger]}

    # -- the batching hooks -----------------------------------------------
    def _round_batch(self, batch_size: int) -> int:
        """Floor to a multiple of the shard count, one row a shard at
        least."""
        nd = self.n_devices
        rounded = max(nd, (batch_size // nd) * nd)
        if rounded != batch_size:
            # The rounding forces the edge padding pad_waste_rows counts.
            self.telemetry.instant("batch_rounded", requested=batch_size,
                                   rounded=rounded, devices=nd)
        return rounded

    def _blocks(self, cols: Dict[str, object], per: int):
        """``(shard, device, that shard's rows of cols)`` for every local
        shard."""
        return [(s, dev, {k: v[s * per:(s + 1) * per]
                          for k, v in cols.items()})
                for s, dev in self._local]

    def _dispatch(self, fault) -> List[Dict[str, torch.Tensor]]:
        per = len(fault["t"]) // self.n_devices
        return [run_classified(self._prog_on(dev), block)
                for _, dev, block in self._blocks(fault, per)]

    def _collect(self, pending) -> Dict[str, np.ndarray]:
        """One copy a shard; the shards' columns joined in row order."""
        cols = np.concatenate(
            [torch.stack([out[k] for k in _COLUMNS]).cpu().numpy()
             for out in pending], axis=1)
        return {k: cols[i] for i, k in enumerate(_COLUMNS)}

    def _fire_plan_bytes(self, fault) -> int:
        first = fault[0][0] if isinstance(fault, list) else fault
        return super()._fire_plan_bytes(first) * len(self._local)

    def run_schedule(self, sched: FaultSchedule, *args, **kw):
        if self.mesh.process_count > 1:
            raise ValueError(
                "a mesh spanning processes runs run_histogram only: per-run "
                "records never cross processes")
        return super().run_schedule(sched, *args, **kw)

    # -- sparse (device-resident) collection, sharded -----------------------
    def _sparse_cap(self, batch_size: int) -> int:
        """The per-shard buffer capacity: the campaign's, ceil-divided over
        the shards and clamped to a shard's rows."""
        nd = self.n_devices
        per = max(1, batch_size // nd)
        cap = int(self._sparse_capacity or max(256, batch_size // 4))
        return max(1, min(-(-cap // nd), per))

    def _sparse_setup(self, sched: FaultSchedule, batch_size: int,
                      transfer: Dict[str, int]) -> Dict[str, object]:
        state = super()._sparse_setup(sched, batch_size, transfer)
        state["per_shard"] = max(1, batch_size // self.n_devices)
        if state["mode"] == "gen":
            state["gens"] = {_key(self.prog.device): state["gen"]}
            state["gen_args"] = (int(sched.gen_steps), sched.model)
        return state

    def _gen_on(self, state: Dict[str, object], dev: torch.device):
        gens, key = state["gens"], _key(dev)
        if key not in gens:
            steps, model = state["gen_args"]
            gens[key] = DeviceScheduleGen(self.mmap, steps, model, dev)
        return gens[key]

    def _sparse_args(self, state: Dict[str, object], lo: int,
                     transfer: Dict[str, int]):
        """Each local shard's fault columns and count weights on its
        device: regenerated there (gen mode) or its rows of the resident
        schedule."""
        per = int(state["per_shard"])
        shards = []
        if state["mode"] == "gen":
            transfer["up"] += 20
            for s, dev in self._local:
                rows = torch.arange(per, dtype=torch.int64, device=dev)
                rows += int(state["gen_lo"]) + lo + s * per
                shards.append((self._gen_on(state, dev).columns(
                    state["seed"], state["stream_n"], rows), None))
        else:
            transfer["up"] += 4
            for s, dev in self._local:
                a, b = lo + s * per, lo + (s + 1) * per
                shards.append(({k: v[a:b].to(dev)
                                for k, v in state["arrays"].items()},
                               state["count_w"][a:b].to(dev)))
        return shards, None

    def _sparse_dispatch(self, state: Dict[str, object], fault, count_w,
                         n_part: int) -> Dict[str, object]:
        """Each shard runs its block and accounts for it on its device: the
        histogram, the bitmask and the compaction buffers of its rows."""
        per, cap = int(state["per_shard"]), int(state["cap"])
        pending = []
        for (s, dev), (block, weights) in zip(self._local, fault):
            out = run_classified(self._prog_on(dev), block)
            valid = (torch.arange(per, device=dev) + s * per) < n_part
            if weights is None:
                weights = valid.to(torch.int32)
            pending.append((out, _sparse_device_outputs(
                out, weights, valid, cap, self._pack)))
        return {"shards": pending}

    def _sparse_fetch(self, state: Dict[str, object],
                      pending: Dict[str, object], n_part: int,
                      transfer: Dict[str, int]) -> Dict[str, np.ndarray]:
        """The heads of every shard (the histogram summed over shards),
        then each shard's interesting rows; a shard whose rows overflow its
        buffer makes the whole batch a dense fetch."""
        per, cap = int(state["per_shard"]), int(state["cap"])
        shards = pending["shards"]
        heads = [dev["head"].cpu().numpy() for _, dev in shards]
        transfer["down"] += sum(int(h.nbytes) for h in heads)
        hist = np.sum([h[:cls.NUM_CLASSES] for h in heads],
                      axis=0).astype(np.int64)
        if any(int(h[-2]) > cap or int(h[-1]) > cap for h in heads):
            cols = np.concatenate(
                [torch.stack([out[c] for c in _COLUMNS]).cpu().numpy()
                 for out, _ in shards], axis=1)
            transfer["down"] += int(cols.nbytes)
            rows = np.flatnonzero(cols[0, :n_part] > cls.CORRECTED)
            self._ledger_rows(rows, per)
            return {"hist": hist, "rows": rows.astype(np.int64),
                    **{c: cols[i, rows] for i, c in enumerate(_COLUMNS)}}
        parts = []
        for (s, _), (_, dev), head in zip(self._local, shards, heads):
            k, ke = int(head[-2]), int(head[-1])
            words = torch.cat([dev["mask"], dev["packed"][:k],
                               dev["exact"][:ke].flatten()]).cpu().numpy()
            transfer["down"] += int(words.nbytes)
            n_mask = dev["mask"].shape[0]
            code, err, cor, steps = _unpack_rows(
                words[n_mask:n_mask + k].view(np.uint32),
                words[n_mask + k:].reshape(ke, 3), self._pack)
            rows = _mask_rows(words[:n_mask].view(np.uint32), per)
            if len(rows) != k:
                raise RuntimeError(
                    f"sparse collect: shard {s}'s bitmask names {len(rows)} "
                    f"interesting rows but the device counted {k}")
            parts.append((rows.astype(np.int64) + s * per, code, err, cor,
                          steps))
        rows = np.concatenate([p[0] for p in parts])
        self._ledger_rows(rows, per)
        out = {"hist": hist, "rows": rows}
        for i, c in enumerate(_COLUMNS):
            out[c] = np.concatenate([p[i + 1] for p in parts])
        return out

    # -- counts-only campaign mode --------------------------------------------
    def run_histogram(self, n: int, seed: int = 0,
                      batch_size: int = 4096) -> Dict[str, int]:
        """Class counts of ``n`` seeded injections; per-run records never
        leave the devices.  Each shard's histogram of its valid rows is
        summed over the local shards, then ``all_reduce``'d over the
        mesh's process group when it spans processes."""
        sched = generate(self.mmap, n, seed, self.prog.region.nominal_steps,
                         model=self.fault_model)
        # One-shot campaign: clamp the batch to the schedule before the
        # shard rounding (which floors at one row a shard).
        batch_size = self._round_batch(min(batch_size, len(sched)))
        per = batch_size // self.n_devices
        total = np.zeros(cls.NUM_CLASSES, np.int64)
        home = self.prog.device
        for lo in range(0, len(sched), batch_size):
            fault, n_part = self._padded_fault(
                sched.slice(lo, min(lo + batch_size, len(sched))),
                batch_size)
            hist = torch.zeros(cls.NUM_CLASSES, dtype=torch.int64,
                               device=home)
            for s, dev, block in self._blocks(fault, per):
                code = run_classified(self._prog_on(dev), block)["code"]
                valid = (torch.arange(per, device=dev) + s * per) < n_part
                hist += torch.zeros(cls.NUM_CLASSES, dtype=torch.int64,
                                    device=dev).index_add_(
                    0, code.to(torch.int64), valid.to(torch.int64)).to(home)
            if self.mesh.distributed:
                import torch.distributed as dist
                dist.all_reduce(hist, group=self.mesh.group)
            total += hist.cpu().numpy()
        counts = cls.counts_dict(total, self._train)
        # Draws that never fire (t < 0) are their own bucket, as in the
        # records path; they classify success on the device.
        n_invalid = int((np.asarray(sched.t) < 0).sum())
        counts["success"] -= n_invalid
        counts["cache_invalid"] = n_invalid
        return counts
