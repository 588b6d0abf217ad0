"""Plain re-execution of a TMR-protected stepped program under its faults.

This is the yardstick's own model of what COAST's ``-TMR`` pass makes of a
stepped program, written from COAST's sync-point rules and not from the
code under test: it imports neither the program nor JAX.  A program is a
:class:`Region` (``perfbench/reference/<region>.py``): leaves with a kind,
the step, the exit test and the self check.  ``run`` executes a block of
campaign rows, each under its own flip group, and returns every row's
record: class code, errors E, corrected F and steps T.

Semantics, per COAST's TMR:

* Every leaf but a read-only one has three replicas (lanes); a read-only
  leaf (the golden copy) is one shared word array.
* Sync points, per step: before the step, the control leaves that form a
  load address are voted and every lane repaired (load sync); after it,
  the control leaves that form a store address or only steer control
  (terminator sync) and the memory leaves the step writes (store-data
  sync) are voted and repaired.  A leaf with a store window votes and
  repairs only the rows the step stored, and only in rows that stored.
  Register leaves are not voted per step.  At the region's exit every
  replicated leaf is voted once (boundary), and that voted view is the
  result.
* A vote is ``l0 if l0 == l1 else l2`` word by word; it miscompares when
  any two lanes differ anywhere in it.  Float words compare as IEEE
  floats with subnormal operands read as zero.  Every miscompare of a
  live row adds one to its corrected count F; the boundary's count adds
  to F where the row completed.
* The exit test reads the voted view after the commit votes; a row that
  completed is frozen.  T counts the steps a row ran while live; a row
  still live after ``max_steps`` steps timed out.
* A flip XORs one bit of one 32-bit word: word ``lane * words + word``
  of a replicated leaf, ``word`` of the shared one; it fires before the
  step ``t`` of a live row.  A group's sites fire in column order.
* Classes, by precedence: INVALID (E outside [0, output words]) >
  DUE_TIMEOUT > SDC (E > 0) > CORRECTED (F > 0) > SUCCESS.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple

import numpy as np
import torch

SUCCESS, CORRECTED, SDC, DUE_ABORT, DUE_TIMEOUT, INVALID = range(6)
NUM_CLASSES = 10
CLASS_NAMES = ("success", "corrected", "sdc", "due_abort", "due_timeout",
               "invalid", "due_stack_overflow", "due_assert",
               "train_self_heal", "train_sdc")
COLUMNS = ("code", "errors", "corrected", "steps")
FAULT_KEYS = ("leaf_id", "lane", "word", "bit", "t")

KIND_MEM, KIND_REG, KIND_CTRL, KIND_RO = "mem", "reg", "ctrl", "ro"
LANES = 3
_EXPONENT = 0x7F800000


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One state leaf: its kind and its per-lane shape."""

    name: str
    kind: str
    shape: Tuple[int, ...]

    @property
    def replicated(self) -> bool:
        return self.kind != KIND_RO

    @property
    def lanes(self) -> int:
        return LANES if self.replicated else 1

    @property
    def words(self) -> int:
        return max(math.prod(self.shape), 1)


@dataclasses.dataclass
class Region:
    """A stepped program as the reference runs it.

    ``image`` is the initial state (numpy, 32-bit words).  ``step(state,
    t)`` sees each leaf with a leading row axis and returns the leaves it
    writes.  ``windows`` maps a memory leaf to ``fn(view) -> (first row,
    rows, active)``: the rows a step stores, read on the pre-step view
    (control leaves voted), and whether the row stores at all; a window
    is ``window_rows`` rows, and ``store_trips(T)`` is how many of a row's
    first ``T`` steps store."""

    name: str
    leaves: List[Leaf]
    image: Dict[str, np.ndarray]
    step: Callable
    done: Callable
    check: Callable
    output_words: int
    nominal_steps: int
    max_steps: int
    load_addr: FrozenSet[str]
    store_addr: FrozenSet[str]
    written: FrozenSet[str]
    done_leaves: Tuple[str, ...] = ()
    windows: Dict[str, Callable] = dataclasses.field(default_factory=dict)
    window_rows: int = 0
    store_trips: Optional[Callable] = None

    @property
    def leaf_names(self) -> List[str]:
        return [leaf.name for leaf in self.leaves]

    def leaf(self, name: str) -> Leaf:
        return next(leaf for leaf in self.leaves if leaf.name == name)


@dataclasses.dataclass(frozen=True)
class SyncPlan:
    """Which replicated leaves each sync point votes (COAST's rules)."""

    pre: Tuple[str, ...]       # load sync, voted and repaired before a step
    commit: Tuple[str, ...]    # store-address, terminator, store-data syncs
    boundary: Tuple[str, ...]  # every replicated leaf, once at the exit


def sync_plan(region: Region) -> SyncPlan:
    pre, commit = [], []
    for leaf in region.leaves:
        if not leaf.replicated:
            continue
        if leaf.kind == KIND_CTRL:
            in_load = leaf.name in region.load_addr
            in_store = leaf.name in region.store_addr
            if in_load:
                pre.append(leaf.name)
            if in_store or not (in_load or in_store):
                commit.append(leaf.name)
        elif leaf.kind == KIND_MEM and leaf.name in region.written:
            commit.append(leaf.name)
    return SyncPlan(tuple(pre), tuple(commit),
                    tuple(leaf.name for leaf in region.leaves
                          if leaf.replicated))


def _flush(x: torch.Tensor) -> torch.Tensor:
    return torch.where((x.view(torch.int32) & _EXPONENT) == 0,
                       torch.zeros_like(x), x)


def same(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Word-wise equality: integers exactly, float32 as IEEE floats with
    subnormal operands read as zero."""
    if a.dtype.is_floating_point:
        return _flush(a) == _flush(b)
    return a == b


def _all_rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).all(dim=1)


def vote(lanes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[R, 3, ...]`` -> (voted ``[R, ...]``, miscompare bool ``[R]``)."""
    l0, l1, l2 = lanes[:, 0], lanes[:, 1], lanes[:, 2]
    agree01 = same(l0, l1)
    voted = torch.where(agree01, l0, l2)
    mis = ~(_all_rows(agree01) & _all_rows(same(l1, l2)))
    return voted, mis


def _repair(voted: torch.Tensor) -> torch.Tensor:
    return voted.unsqueeze(1).expand(-1, LANES, *voted.shape[1:]).clone()


def _bit_word(bit: torch.Tensor) -> torch.Tensor:
    """``1 << bit`` as an int32 word (0 outside [0, 32))."""
    bit = bit.to(torch.int64)
    ok = (bit >= 0) & (bit < 32)
    one = torch.where(ok, torch.ones_like(bit) << bit.clamp(0, 31),
                      torch.zeros_like(bit))
    return torch.where(one >= 2 ** 31, one - 2 ** 32, one).to(torch.int32)


class Reference:
    """One region under TMR, run in blocks of rows on ``device``."""

    def __init__(self, region: Region, device):
        self.region = region
        self.device = torch.device(device)
        self.plan = sync_plan(region)
        self._image = {name: torch.as_tensor(
            np.ascontiguousarray(arr).view(np.int32)
            if np.asarray(arr).dtype == np.uint32 else np.asarray(arr),
            device=self.device) for name, arr in region.image.items()}

    # -- state --------------------------------------------------------------
    def _init(self, rows: int) -> Dict[str, torch.Tensor]:
        state = {}
        for leaf in self.region.leaves:
            arr = self._image[leaf.name]
            lead = (rows, LANES) if leaf.replicated else (rows,)
            state[leaf.name] = arr.expand(*lead, *arr.shape).clone()
        return state

    def _flip(self, state, leaf_id, lane, word, bit, enable) -> None:
        mask = _bit_word(bit)
        for k, leaf in enumerate(self.region.leaves):
            hit = enable & (leaf_id == k)
            if not bool(hit.any()):
                continue
            idx = lane * leaf.words + word if leaf.replicated else word
            hit = hit & (idx >= 0) & (idx < leaf.lanes * leaf.words)
            arr = state[leaf.name]
            flat = arr.view(torch.int32).reshape(arr.shape[0], -1)
            col = torch.where(hit, idx, torch.zeros_like(idx))[:, None]
            cur = flat.gather(1, col)
            new = cur ^ torch.where(hit, mask, torch.zeros_like(mask))[:, None]
            flat.scatter_(1, col, new)
            state[leaf.name] = flat.view(arr.shape).view(arr.dtype)

    def _lane_rows(self, state) -> Dict[str, torch.Tensor]:
        """The step's rows: campaign row major, lane minor."""
        out = {}
        for leaf in self.region.leaves:
            arr = state[leaf.name]
            if leaf.replicated:
                out[leaf.name] = arr.reshape(-1, *arr.shape[2:])
            else:
                out[leaf.name] = (arr.unsqueeze(1).expand(-1, LANES,
                                                          *arr.shape[1:])
                                  .reshape(-1, *arr.shape[1:]))
        return out

    def _view(self, state) -> Dict[str, torch.Tensor]:
        """Control leaves voted, other replicated leaves lane 0."""
        out = {}
        for leaf in self.region.leaves:
            arr = state[leaf.name]
            if not leaf.replicated:
                out[leaf.name] = arr
            elif leaf.kind == KIND_CTRL:
                out[leaf.name] = vote(arr)[0]
            else:
                out[leaf.name] = arr[:, 0]
        return out

    # -- one step -------------------------------------------------------------
    def _step(self, state, done, cnt, steps, t):
        region = self.region
        rows = done.shape[0]
        halted = done
        mis = torch.zeros(rows, dtype=torch.int32, device=self.device)
        state = dict(state)
        for name in self.plan.pre:
            voted, m = vote(state[name])
            state[name] = _repair(voted)
            mis += m.to(torch.int32)
        pre_view = self._view(state) if region.windows else None
        out = region.step(self._lane_rows(state), t)
        new = dict(state)
        for name, value in out.items():
            if not region.leaf(name).replicated:
                raise NotImplementedError(
                    f"{region.name}: the step writes the shared leaf {name}")
            new[name] = value.reshape(rows, LANES, *value.shape[1:])
        for name in self.plan.commit:
            window = region.windows.get(name)
            if window is None:
                voted, m = vote(new[name])
                new[name] = _repair(voted)
            else:
                new[name], m = self._window_vote(new[name], window(pre_view))
            mis += m.to(torch.int32)
        cnt = cnt + torch.where(halted, torch.zeros_like(mis), mis)
        done_now = region.done({name: vote(new[name])[0]
                                for name in region.done_leaves})
        done = done | (~halted & done_now)
        steps = steps + (~halted).to(torch.int32)
        for name in new:
            if new[name] is not state[name]:
                keep = halted.view(-1, *([1] * (new[name].dim() - 1)))
                new[name] = torch.where(keep, state[name], new[name])
        return new, done, cnt, steps

    @staticmethod
    def _window_vote(lanes, window):
        """Vote and repair rows ``[first, first + rows)`` of every lane in
        the campaign rows that stored; the others keep their lanes."""
        first, size, active = window
        rows = lanes.shape[0]
        rest = math.prod(lanes.shape[3:])
        blocks = lanes.reshape(rows, LANES, lanes.shape[2], rest)
        index = (first.to(torch.int64)[:, None]
                 + torch.arange(size, device=lanes.device))
        index = index[:, None, :, None].expand(rows, LANES, size, rest)
        part = blocks.gather(2, index)
        voted, mis = vote(part)
        repaired = voted.unsqueeze(1).expand_as(part)
        keep = active.view(rows, 1, 1, 1)
        out = blocks.clone()
        out.scatter_(2, index, torch.where(keep, repaired, part))
        return out.view(lanes.shape), mis & active

    # -- a block of rows ------------------------------------------------------
    def run(self, faults: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``faults``: int64 ``[rows, sites]`` columns ``FAULT_KEYS`` on the
        device.  Returns int32 ``[rows]`` columns ``COLUMNS``."""
        region = self.region
        cols = {k: faults[k].to(device=self.device, dtype=torch.int64)
                for k in FAULT_KEYS}
        rows, sites = cols["t"].shape
        state = self._init(rows)
        zero = torch.zeros(rows, dtype=torch.int32, device=self.device)
        done = torch.zeros(rows, dtype=torch.bool, device=self.device)
        cnt, steps = zero.clone(), zero.clone()
        for t in range(region.max_steps):
            live = ~done
            if not bool(live.any()):
                break
            for g in range(sites):
                self._flip(state, cols["leaf_id"][:, g], cols["lane"][:, g],
                           cols["word"][:, g], cols["bit"][:, g],
                           live & (cols["t"][:, g] == t))
            state, done, cnt, steps = self._step(state, done, cnt, steps, t)
        view = {}
        boundary_mis = zero.clone()
        for leaf in region.leaves:
            if leaf.replicated:
                view[leaf.name], m = vote(state[leaf.name])
                boundary_mis += m.to(torch.int32)
            else:
                view[leaf.name] = state[leaf.name]
        cnt = cnt + torch.where(done, boundary_mis, zero)
        errors = region.check(view).to(torch.int32)
        code = torch.where(cnt > 0, CORRECTED, SUCCESS)
        code = torch.where(errors > 0, SDC, code)
        code = torch.where(~done, DUE_TIMEOUT, code)
        code = torch.where((errors < 0) | (errors > region.output_words),
                           INVALID, code)
        return {"code": code.to(torch.int32), "errors": errors,
                "corrected": cnt, "steps": steps}

    def run_blocks(self, faults: Dict[str, np.ndarray],
                   block_rows: int) -> Dict[str, np.ndarray]:
        """:meth:`run` over numpy fault columns ``[n, sites]``, in blocks of
        ``block_rows`` rows; the records come back as numpy columns."""
        n = faults["t"].shape[0]
        parts: List[Dict[str, np.ndarray]] = []
        for lo in range(0, n, block_rows):
            block = {k: torch.as_tensor(np.asarray(v[lo:lo + block_rows]),
                                        device=self.device)
                     for k, v in faults.items()}
            rec = self.run(block)
            parts.append({k: v.cpu().numpy() for k, v in rec.items()})
            del rec, block
        return {k: np.concatenate([p[k] for p in parts]) for k in COLUMNS}


def histogram(codes: np.ndarray) -> np.ndarray:
    return np.bincount(np.asarray(codes, np.int64), minlength=NUM_CLASSES)


def layout(region: Region) -> List[Tuple[str, str, int, int]]:
    """``(name, kind, lanes, words)`` of every injectable leaf, in order:
    the fault space the traffic draws from."""
    return [(leaf.name, leaf.kind, leaf.lanes, leaf.words)
            for leaf in region.leaves]
