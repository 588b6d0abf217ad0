"""Fault schedules regenerated on the program's device.

The counterpart of ``coast_tpu/inject/device_gen.py``.  Every seeded
schedule is counter-mode splitmix64 (``native.splitmix_fill``: value i is
the finalizer of ``seed + (i + 1) * golden``), so a schedule row is a pure
function of the seed, the stream length and the row index.  A campaign
with ``collect="sparse"`` therefore sends no fault columns to the device:
:meth:`DeviceScheduleGen.columns` rebuilds them there, bit for bit equal
to the host ``generate(...).device_arrays()`` at the same rows, for every
fault-model kind (the expansion streams of ``native.fault_expand`` too).

The u64 arithmetic runs in int64 tensors.  ``+``, ``*`` and ``^`` give the
low 64 bits as the unsigned operations do; ``>>`` is arithmetic on int64,
so a logical shift is masked; a remainder splits the word into 32-bit
halves (:func:`_mod64`), because ``%`` of a negative int64 is not the
unsigned remainder.  The host schedule stays the campaign's source of
truth; the device must inject exactly its sites.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from coast_tpu_torch import device as _device
from coast_tpu_torch.inject.mem import MemoryMap
from coast_tpu_torch.inject.schedule import FaultModel, link_steps
from coast_tpu_torch.native import FAULT_EXPAND_SALT, _splitmix_at

__all__ = ["DeviceGenError", "DeviceScheduleGen"]

_MASK32 = 0xFFFFFFFF


class DeviceGenError(ValueError):
    """The schedule cannot be regenerated on the device (an address space
    of 2^32 bits or more, as in the reference)."""


def _s64(value: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    value &= 0xFFFFFFFFFFFFFFFF
    return value - (1 << 64) if value >> 63 else value


_GOLDEN = _s64(0x9E3779B97F4A7C15)
_MIX1 = _s64(0xBF58476D1CE4E5B9)
_MIX2 = _s64(0x94D049BB133111EB)


def _shr(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of the u64 bits in ``z`` (1 <= k <= 63)."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def _splitmix64(seed: int, counter: torch.Tensor) -> torch.Tensor:
    """finalizer(seed + counter * golden) over an int64 counter tensor:
    ``native.splitmix_fill``'s value ``counter - 1``."""
    z = counter * _GOLDEN + _s64(seed)
    z = (z ^ _shr(z, 30)) * _MIX1
    z = (z ^ _shr(z, 27)) * _MIX2
    return z ^ _shr(z, 31)


def _mod64(z: torch.Tensor, m: int) -> torch.Tensor:
    """The u64 bits in ``z`` modulo a host constant ``1 <= m < 2^32``, as
    int64.  ``z = hi * 2^32 + lo``: every intermediate stays below 2^48,
    so the int64 products never overflow."""
    if not 1 <= m < (1 << 32):
        raise DeviceGenError(f"modulus {m} outside the u32 emulation range")
    hi = _shr(z, 32)
    lo = z & _MASK32
    r = hi % m
    r = (r << 16) % m
    r = (r << 16) % m
    return (r + lo % m) % m


class DeviceScheduleGen:
    """Regenerates a seeded ``generate()`` stream (any FaultModel kind) on
    ``device`` from (seed, stream length, row index).  The section layout,
    the step window and the model are fixed at construction."""

    def __init__(self, mmap: MemoryMap, nominal_steps: int,
                 model: Optional[FaultModel] = None, device=_device.DEFAULT):
        self.model = model if model is not None else FaultModel()
        self.device = _device.resolve(device)
        bits_end, sec_leaf, sec_lanes, sec_words = mmap.section_tables()
        self.total_bits = int(bits_end[-1])
        if self.total_bits >= (1 << 32):
            raise DeviceGenError(
                f"injectable address space is {self.total_bits} bits; "
                "the on-device generator's 32-bit address emulation "
                "covers < 2^32 bits -- run this campaign with "
                "collect='dense'")
        self.steps = max(int(nominal_steps), 1)
        sizes = np.asarray([s.bits for s in mmap.sections], np.int64)
        starts = bits_end - sizes

        def table(a):
            return torch.as_tensor(np.asarray(a, np.int64),
                                   device=self.device)

        self._edges = table(bits_end)
        self._starts = table(starts)
        self._leaf = table(sec_leaf)
        self._lanes = table(sec_lanes)
        self._words = table(sec_words)
        link = [s.kind == "link" for s in mmap.sections]
        # Restricted draws: the link model draws from the link sections
        # only; every other model, on a map that has link sections, from
        # the rest (schedule._generate_link and _nonlink_sites).
        self.draw_total: Optional[int] = None
        if self.model.kind == "link":
            pick = [i for i, lk in enumerate(link) if lk]
            if not pick:
                raise DeviceGenError(
                    "fault model 'link' has no link-kind sections to "
                    "regenerate draws for on this benchmark")
            self._link_k = link_steps(self.model, self.steps)
        else:
            pick = [i for i, lk in enumerate(link) if not lk]
            if not pick:
                raise DeviceGenError(
                    "every injectable section is link-kind: non-link "
                    "fault models have no surface to regenerate")
        if self.model.kind == "link" or len(pick) != len(link):
            dedges = np.cumsum(sizes[pick])
            self.draw_total = int(dedges[-1])
            self._draw_edges = table(dedges)
            self._draw_local_starts = table(dedges - sizes[pick])
            self._draw_global_starts = table(starts[pick])

    def _decode(self, flat: torch.Tensor):
        """``MemoryMap.decode`` on the device: (leaf, lane, word, bit,
        section)."""
        sec = torch.searchsorted(self._edges, flat, right=True)
        off = flat - self._starts[sec]
        wpl = self._words[sec] * 32
        return (self._leaf[sec], off // wpl, (off % wpl) >> 5, off & 31, sec)

    def columns(self, seed: int, stream_n: int,
                rows: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Fault columns for stream rows ``rows`` (an integer tensor on the
        device): int32 [B] a key for a single site, [B, sites] for flip
        groups (column 0 the base site) -- exactly ``generate(mmap,
        stream_n, seed, steps, model).device_arrays()`` at those rows.
        ``stream_n`` is generate()'s n: the t draws start at stream index
        n."""
        seed &= 0xFFFFFFFFFFFFFFFF
        rows = rows.to(device=self.device, dtype=torch.int64)
        c_site = rows + 1
        c_t = c_site + int(stream_n)
        model = self.model
        if self.draw_total is not None:
            local = _mod64(_splitmix64(seed, c_site), self.draw_total)
            dsec = torch.searchsorted(self._draw_edges, local, right=True)
            flat = (self._draw_global_starts[dsec]
                    + (local - self._draw_local_starts[dsec]))
        else:
            flat = _mod64(_splitmix64(seed, c_site), self.total_bits)
        leaf, lane, word, bit, sec = self._decode(flat)
        if model.kind == "link":
            draw = _mod64(_splitmix64(seed, c_t), self._link_k)
            t = (model.t_offset + draw * model.t_period
                 if model.t_period > 0 else draw)
        else:
            t = _mod64(_splitmix64(seed, c_t), self.steps)
        base = {"leaf_id": leaf, "lane": lane, "word": word, "bit": bit,
                "t": t}
        if model.sites == 1:
            return {k: v.to(torch.int32) for k, v in base.items()}
        # The expansion stream: exp_seed = splitmix_at(seed, SALT).
        exp_seed = _splitmix_at(seed, FAULT_EXPAND_SALT)
        cols = {k: [v] for k, v in base.items()}
        for j in range(1, model.sites):
            site = self._extra_site(exp_seed, rows, j, base, sec)
            for k in cols:
                cols[k].append(site[k])
        return {k: torch.stack(v, dim=1).to(torch.int32)
                for k, v in cols.items()}

    def _extra_site(self, exp_seed: int, rows: torch.Tensor, j: int,
                    base: Dict[str, torch.Tensor], sec: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
        """Site ``j`` (1-based) of each row's flip group: the body of
        ``native.fault_expand`` for one site column."""
        model = self.model
        if model.kind == "multibit":
            u = _splitmix64(exp_seed, rows + 1)
            stride = 1 + 2 * (u & 15)
            return {**base, "bit": (base["bit"] + j * stride) & 31}
        # cluster/burst: extra row r = i*extras + (j-1) takes the derived
        # stream's draws 2r and 2r+1 (counters 2r+1 and 2r+2).
        c0 = 2 * (rows * (model.sites - 1) + (j - 1)) + 1
        u0 = _splitmix64(exp_seed, c0)
        u1 = _splitmix64(exp_seed, c0 + 1)
        if model.kind == "cluster":
            words = self._words[sec]
            lw = self._lanes[sec] * words
            phys = (base["lane"] * words + base["word"] + 1
                    + _mod64(u0, model.span)) % lw
            return {"leaf_id": base["leaf_id"], "lane": phys // words,
                    "word": phys % words, "bit": u1 & 31, "t": base["t"]}
        # burst: a fresh uniform location over the whole map, clustered
        # time.
        leaf, lane, word, bit, _ = self._decode(_mod64(u0, self.total_bits))
        tj = torch.clamp(base["t"] + _mod64(u1, model.window),
                         max=self.steps - 1)
        return {"leaf_id": leaf, "lane": lane, "word": word, "bit": bit,
                "t": torch.where(base["t"] < 0, base["t"], tj)}

    def rows_np(self, seed: int, stream_n: int,
                rows) -> Dict[str, np.ndarray]:
        """:meth:`columns` at host row numbers, fetched as numpy (the
        parity tests' subject)."""
        rows = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        return {k: v.cpu().numpy()
                for k, v in self.columns(seed, stream_n, rows).items()}
