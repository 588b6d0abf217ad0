"""dataflowProtection: the replication engine, on torch tensors.

The counterpart of ``coast_tpu/passes/dataflow_protection.py``:

  * cloning -> replicated leaves carry a lane axis: ``[B, n, *leaf]`` for a
    batch of B campaign rows; shared leaves are ``[B, *leaf]``;
  * instruction replication -> the region's step runs once over a leading
    axis of ``R = B * n`` rows (replicated leaves are viewed, shared leaves
    expanded on first read);
  * insertVoters -> the pre-step load vote, the commit votes (store data,
    control, SoR crossing) and the region-boundary vote, every one through
    the K1 wrapper ``ops/hopper_voters.py`` (the kernel on the card, its
    plain version for a CPU tensor);
  * error handling -> DWC's abort is a latched per-row flag that freezes
    the row; TMR's correction counter and ``-countSyncs`` are per-row int32
    counters.

The step loop runs while any row is live and at most ``max_steps`` trips;
a halted row is frozen, so a trip after it halts changes nothing.  A vote
is pure, so votes nothing reads are not made: the views ``done()`` and the
store-slice hint read are voted leaf by leaf on first read, and the final
view reuses the boundary votes.

``fuse_step=True`` builds the fused engine (``ops/fused_step.py``) when
every leaf is integer: the latches packed into one word per row, the
``done()`` view voted only on the leaves it reads, the freeze only on
leaves a step can change, the bounded loop when ``max_steps ==
nominal_steps``, and every TMR vote a repair follows (the pre-step load
sync, the whole-leaf commit vote) as one fused commit, K2 on the card.
Its run records equal the unfused engine's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Callable, Dict, FrozenSet, Iterator, Mapping, Optional,
                    Tuple)

import numpy as np
import torch

from coast_tpu_torch import device as device_mod
from coast_tpu_torch.interop import fault_from_numpy
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_RO, Region,
                                       State, rows)
from coast_tpu_torch.ops import bitflip, fused_step, hopper_voters
from coast_tpu_torch.passes.verification import analyze, verify_options

Flags = Dict[str, torch.Tensor]

# Reference config fields whose engine paths later slices port, with the
# ROADMAP Queue A item that brings each.  A non-default value raises.
_LATER_FIELDS = {
    "segmented": "item 13 (segmented -s scheduling)",
    "protect_stack": "item 13 (-protectStack)",
    "ignore_fns": "item 13 (function-scope wrappers)",
    "skip_lib_calls": "item 13 (function-scope wrappers)",
    "replicate_fn_calls": "item 13 (function-scope wrappers)",
    "clone_fns": "item 13 (function-scope wrappers)",
    "clone_return_fns": "item 13 (function-scope wrappers)",
    "clone_after_call_fns": "item 13 (function-scope wrappers)",
    "protected_lib_fns": "item 13 (function-scope wrappers)",
    "runtime_init_globals": "item 13 (the rest of passes/)",
    "cfcss": "item 13 (CFCSS)",
    "pallas_voters": "item 7: every vote on the card already runs the "
                     "Hopper K1 kernel; the TPU kernel switch has no "
                     "counterpart",
    "isr_functions": "(refused by the reference too: a stepped region has "
                     "no interrupts)",
}


@dataclasses.dataclass(frozen=True)
class ProtectionConfig:
    """Mirror of the reference's ProtectionConfig.

    num_clones: 3 = TMR, 2 = DWC, 1 = unprotected passthrough."""

    num_clones: int = 3
    no_mem_replication: bool = False
    no_store_data_sync: bool = False
    no_load_sync: bool = False
    no_store_addr_sync: bool = False
    count_errors: bool = True
    count_syncs: bool = False
    ignore_globals: Tuple[str, ...] = ()
    xmr_globals: Tuple[str, ...] = ()
    # Fields of later slices (see _LATER_FIELDS): defaults only.
    segmented: bool = False
    protect_stack: bool = False
    ignore_fns: Tuple[str, ...] = ()
    skip_lib_calls: Tuple[str, ...] = ()
    replicate_fn_calls: Tuple[str, ...] = ()
    clone_fns: Tuple[str, ...] = ()
    clone_return_fns: Tuple[str, ...] = ()
    clone_after_call_fns: Tuple[str, ...] = ()
    protected_lib_fns: Tuple[str, ...] = ()
    pallas_voters: "bool | None" = None
    fuse_step: bool = False
    isr_functions: Tuple[str, ...] = ()
    runtime_init_globals: Tuple[str, ...] = ()
    cfcss: bool = False

    def __post_init__(self):
        for f in dataclasses.fields(self):
            if (f.name in _LATER_FIELDS
                    and getattr(self, f.name) != f.default):
                raise NotImplementedError(
                    f"ProtectionConfig.{f.name} is not ported yet; see "
                    f"ROADMAP Queue A {_LATER_FIELDS[f.name]}")

    def resolve_xmr(self, region: Region, name: str) -> bool:
        if self.num_clones == 1:
            return False
        if name in self.ignore_globals:
            return False
        if name in self.xmr_globals:
            return True
        if self.no_mem_replication and region.spec[name].kind in (KIND_MEM,
                                                                  KIND_RO):
            return False
        if region.spec[name].kind == KIND_RO:
            return False
        return region.leaf_is_xmr(name)


class _LazyView(Mapping):
    """A state view whose leaves are computed (voted) on first read."""

    def __init__(self, source: Mapping[str, torch.Tensor],
                 leaf: Callable[[str, torch.Tensor], torch.Tensor]):
        self._source = source
        self._leaf = leaf
        self._memo: Dict[str, torch.Tensor] = {}

    def __getitem__(self, name: str) -> torch.Tensor:
        if name not in self._memo:
            self._memo[name] = self._leaf(name, self._source[name])
        return self._memo[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._source)

    def __len__(self) -> int:
        return len(self._source)


def _repair(voted: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """The TMR repair: the voted value in every lane, materialised (a
    later in-place flip must hit one lane, not all three)."""
    return voted.unsqueeze(1).expand(shape).contiguous()


class ProtectedProgram:
    """A region after dataflowProtection: an n-lane stepped program plus
    per-row flags, run as a batch of campaign rows on ``device``."""

    def __init__(self, region: Region, cfg: ProtectionConfig,
                 device=device_mod.DEFAULT):
        self.device = device_mod.resolve(device)
        image = region.validate()
        self.forced_sync = verify_options(region, cfg)
        self.region = region
        self.cfg = cfg
        self.replicated: Dict[str, bool] = {
            name: cfg.resolve_xmr(region, name) for name in region.spec}
        self._any_replicated = any(self.replicated.values())
        self._shapes = {k: tuple(v.shape) for k, v in image.items()}
        flow = analyze(region)
        self.flow = flow
        # Sync-point tables: which replicated leaves get a commit vote each
        # step (post-step), and which a pre-step vote.
        self.step_sync: Dict[str, bool] = {}
        self.pre_sync: Dict[str, bool] = {}
        for name, spec in region.spec.items():
            if not self.replicated[name]:
                continue
            self.pre_sync[name] = False
            if spec.kind == KIND_CTRL:
                in_load = name in flow.load_addr
                in_store = name in flow.store_addr
                # Pure predicates (neither address role) are terminator-sync
                # state, always voted at the commit boundary.
                self.step_sync[name] = ((in_store
                                         and not cfg.no_store_addr_sync)
                                        or not (in_load or in_store))
                self.pre_sync[name] = in_load and not cfg.no_load_sync
            elif spec.kind == KIND_MEM:
                # Store-data sync exists where stores exist: a leaf the
                # step never writes is not voted per step.
                self.step_sync[name] = (not cfg.no_store_data_sync
                                        and name in flow.written)
            else:  # reg: voted only where a sync point uses it
                self.step_sync[name] = False
        # Store-slice hints: vote only the rows a step stored.
        self._store_slice = dict(region.meta.get("store_slice") or {})
        if cfg.num_clones > 1:
            for name in self._store_slice:
                if name not in region.spec:
                    raise ValueError(
                        f"store_slice hint for unknown leaf {name!r}")
                if not self.replicated.get(name):
                    raise ValueError(
                        f"store_slice hint for {name!r}: not a replicated "
                        "leaf")
                if not self.step_sync.get(name):
                    raise ValueError(
                        f"store_slice hint for {name!r}: leaf has no step "
                        "store sync (register-class, never written, or "
                        "store-data sync disabled) -- the hint would be "
                        "dead code")
        else:
            self._store_slice = {}
        self._vote = hopper_voters.vote
        self.leaf_order = [n for n in region.spec if region.spec[n].inject]
        one = {k: v.unsqueeze(0) for k, v in image.items()}
        self.output_words = int(region.output(one).shape[1])
        # Fused-step plan, made last so it sees the final sync tables.  It
        # activates only for exact (integer) dataflow; a float region keeps
        # the unfused program while cfg.fuse_step stays set.
        self._fuse_plan: Optional[fused_step.FusePlan] = None
        self.fuse_plan_info: Optional[fused_step.FusePlan] = None
        if cfg.fuse_step:
            self.fuse_plan_info = fused_step.build_plan(self)
            if self.fuse_plan_info.exact_dataflow:
                self._fuse_plan = self.fuse_plan_info

    def unfused_twin(self) -> "ProtectedProgram":
        """The same build with ``fuse_step`` off (itself when it is off).
        The fused engine's records equal this twin's."""
        if not self.cfg.fuse_step:
            return self
        return ProtectedProgram(
            self.region, dataclasses.replace(self.cfg, fuse_step=False),
            self.device)

    # -- the memory map's view ---------------------------------------------
    def lanes_of(self, name: str) -> int:
        return self.cfg.num_clones if self.replicated[name] else 1

    def lane_words(self, name: str) -> int:
        return math.prod(self._shapes[name])

    def injectable_sections(self):
        """(name, kind, lanes, words_per_lane) rows for the memory map."""
        return [(name, self.region.spec[name].kind, self.lanes_of(name),
                 self.lane_words(name)) for name in self.leaf_order]

    # -- state construction -------------------------------------------------
    def init_pstate(self, batch: int) -> Tuple[State, Flags]:
        """Every row's own copy of the image (a flip writes one row's word
        in place, so nothing may be a broadcast view)."""
        n = self.cfg.num_clones
        pstate = {}
        for name, arr in self.region.init(self.device).items():
            lead = (batch, n) if self.replicated[name] else (batch,)
            pstate[name] = arr.expand(*lead, *arr.shape).clone(
                memory_format=torch.contiguous_format)

        if self._fuse_plan is not None:
            return pstate, fused_step.flags_init(batch, self.device)

        def zeros(dtype):
            return torch.zeros(batch, dtype=dtype, device=self.device)

        flags = {"dwc_fault": zeros(torch.bool), "tmr_cnt": zeros(torch.int32),
                 "sync_cnt": zeros(torch.int32), "steps": zeros(torch.int32),
                 "done": zeros(torch.bool)}
        return pstate, flags

    # -- lane execution -----------------------------------------------------
    def _run_lanes(self, region_state: State, t: int, batch: int) -> State:
        """The region step once per lane.  Returns the written leaves, with
        a lane axis ``[B, n, ...]`` when the program has lanes."""
        n = self.cfg.num_clones
        if n == 1 or not self._any_replicated:
            return self.region.step(region_state, t)

        def lane_rows(name, arr):
            if self.replicated[name]:
                return arr.reshape(batch * n, *arr.shape[2:])
            return (arr.unsqueeze(1).expand(batch, n, *arr.shape[1:])
                    .reshape(batch * n, *arr.shape[1:]))

        out = self.region.step(_LazyView(region_state, lane_rows), t)
        # Contiguous: K1 reads a replica set as [B, n, words].
        return {k: v.reshape(batch, n, *v.shape[1:]).contiguous()
                for k, v in out.items()}

    def _slice_view(self, region_state: State) -> _LazyView:
        """The pre-step view a store-slice hint reads: ctrl leaves voted
        (TMR) or lane 0 (DWC), shared leaves as they are, other replicated
        leaves lane 0."""
        tmr = self.cfg.num_clones == 3

        def leaf(name, arr):
            if not self.replicated[name]:
                return arr
            if self.region.spec[name].kind == KIND_CTRL and tmr:
                return self._vote(arr, 3)[0]
            return arr[:, 0]

        return _LazyView(region_state, leaf)

    def _vote_slice(self, name: str, out: torch.Tensor, fresh: bool,
                    hint, view: Mapping, t: int, batch: int):
        """The store-slice vote of one leaf: vote the window each row
        stored, repair it in every lane (TMR).  Returns ``(out, mis,
        active)`` with ``active`` None for a 2-tuple hint."""
        n = self.cfg.num_clones
        hint_out = hint(view, t)
        if len(hint_out) == 3:
            starts, sizes, active = hint_out
        else:
            (starts, sizes), active = hint_out, None
        shape = self._shapes[name]
        if tuple(sizes[1:]) != shape[1:]:
            raise NotImplementedError(
                f"store_slice window {tuple(sizes)} of {name!r} {shape}: "
                "only windows of whole trailing rows are ported")
        rest = math.prod(shape[1:])
        size0 = int(sizes[0])
        # lax.dynamic_slice semantics: one negative wrap, then the start
        # clamps so the window fits.
        start0 = torch.as_tensor(starts[0], device=self.device)
        start0 = start0.to(torch.int64).expand(batch)
        start0 = torch.clamp(torch.where(start0 < 0, start0 + shape[0],
                                         start0), 0, shape[0] - size0)
        flat = out.view(batch, n, -1)
        voted, mis = hopper_voters.vote_window(
            flat, (start0 * rest).to(torch.int32), size0 * rest, n)
        if n == 3:
            if not fresh:
                out = out.clone()
            blocks = out.view(batch, n, shape[0], rest)
            index = (start0[:, None] + torch.arange(size0, device=self.device)
                     )[:, None, :, None].expand(batch, n, size0, rest)
            new = voted.view(batch, 1, size0, rest).expand(batch, n, size0,
                                                           rest)
            if active is not None:
                new = torch.where(rows(active, new), new,
                                  blocks.gather(2, index))
            blocks.scatter_(2, index, new)
        if active is not None:
            mis = mis & active
        return out, mis, active

    # -- one protected step -------------------------------------------------
    def _halted(self, flags: Flags) -> torch.Tensor:
        """Rows that stopped evolving: completed or aborted."""
        if "latch" in flags:
            return flags["latch"] != 0
        return flags["done"] | flags["dwc_fault"]

    def _vote_repair(self, lanes: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """A TMR vote and the repair after it -> ``(repaired lanes, voted,
        miscompare)``.  The fused engine makes both one fused commit (K2
        on the card)."""
        if self._fuse_plan is None:
            voted, mis = self._vote(lanes, 3)
            return _repair(voted, lanes.shape), voted, mis
        return fused_step.vote_flip_commit(lanes, None, 3)

    def step(self, pstate: State, flags: Flags, t: int) -> Tuple[State, Flags]:
        cfg = self.cfg
        n = cfg.num_clones
        plan = self._fuse_plan
        batch = flags["steps"].shape[0]
        halted = self._halted(flags)
        region_state = dict(pstate)
        miscompares = []
        syncs = torch.zeros(batch, dtype=torch.int32, device=self.device)
        # Voted values of this step's commit votes (the fused done() view
        # reuses them).
        commits: Dict[str, torch.Tensor] = {}

        # Pre-step load sync: vote address-forming ctrl state before any
        # load in this step reads it; TMR repairs the lanes.
        if n > 1:
            for name in self.region.spec:
                if self.pre_sync.get(name, False):
                    if n == 3:
                        region_state[name], _, mis = self._vote_repair(
                            region_state[name])
                    else:
                        _, mis = self._vote(region_state[name], n)
                    miscompares.append(mis)
                    syncs += 1

        laned = self._run_lanes(region_state, t, batch)
        slice_view = (self._slice_view(region_state)
                      if self._store_slice and n > 1 else None)

        new_state: State = {}
        for name in self.region.spec:
            written = name in laned
            if self.replicated[name]:
                out = laned[name] if written else region_state[name]
                if self.step_sync[name] and n > 1:
                    hint = self._store_slice.get(name)
                    if hint is not None:
                        out, mis, active = self._vote_slice(
                            name, out, written, hint, slice_view, t, batch)
                        syncs += (1 if active is None
                                  else active.to(torch.int32))
                    elif n == 3:
                        out, commits[name], mis = self._vote_repair(out)
                        syncs += 1
                    else:
                        _, mis = self._vote(out, n)
                        syncs += 1
                    miscompares.append(mis)
                new_state[name] = out
            elif not written:
                # Unwritten shared leaf: all lanes see the same value, so
                # its SoR-crossing vote (below) agrees by construction.
                new_state[name] = region_state[name]
                if (self.region.spec[name].kind != KIND_RO and n > 1
                        and self._any_replicated):
                    syncs += 1
            elif n == 1 or not self._any_replicated:
                new_state[name] = laned[name]
            elif self.region.spec[name].kind == KIND_RO:
                new_state[name] = laned[name][:, 0]
            else:
                # A store crossing the sphere of replication: vote before
                # the single store.
                voted, mis = self._vote(laned[name], n)
                miscompares.append(mis)
                syncs += 1
                new_state[name] = voted

        # Latch fault/correction accounting.  DWC checks before the store
        # commits: a miscompare this step freezes the row at its pre-step
        # image.
        fault_now = torch.zeros_like(halted)
        flags = dict(flags)
        if miscompares and n == 2:
            fault_now = ~halted & torch.stack(miscompares).any(dim=0)
            if plan is not None:
                flags["latch"] = fused_step.latch_or(
                    flags["latch"], fused_step.LATCH_DWC, fault_now)
            else:
                flags["dwc_fault"] = flags["dwc_fault"] | fault_now
        elif miscompares and n == 3 and cfg.count_errors:
            mis_cnt = torch.stack(miscompares).to(torch.int32).sum(dim=0)
            flags["tmr_cnt"] = flags["tmr_cnt"] + torch.where(
                halted, 0, mis_cnt).to(torch.int32)
        if cfg.count_syncs:
            flags["sync_cnt"] = flags["sync_cnt"] + torch.where(
                halted, 0, syncs).to(torch.int32)

        # Terminator: done() on the voted view, before committing, so one
        # corrupted lane cannot steer control flow.  The fused view votes
        # only the leaves done() reads and takes a fused commit's voted
        # value as it is (a vote of the repaired lanes gives those bits).
        commit_halt = halted | fault_now
        if plan is None:
            done_now = self.region.done(self.voted_view(new_state))
            flags["done"] = flags["done"] | (~commit_halt & done_now)
        else:
            done_now = self.region.done(self.voted_view(
                new_state, only=plan.done_leaves, votes=commits))
            flags["latch"] = fused_step.latch_or(
                flags["latch"], fused_step.LATCH_DONE, ~commit_halt & done_now)
        flags["steps"] = flags["steps"] + (~commit_halt).to(torch.int32)

        # Freeze halted rows: the row's image stops evolving the step it
        # halts (and a DWC fault step never commits).  The fused build
        # freezes only the leaves a step can change and commits the rest's
        # pre-step tensors.
        for name, new in new_state.items():
            if plan is not None and name not in plan.frozen_leaves:
                new_state[name] = pstate[name]
            elif new is not pstate[name]:
                new_state[name] = torch.where(rows(commit_halt, new),
                                              pstate[name], new)
        return new_state, flags

    # -- whole-program runners ---------------------------------------------
    def voted_view(self, pstate: State,
                   only: Optional[FrozenSet[str]] = None,
                   votes: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> _LazyView:
        """Lanes collapsed for the unprotected consumer of the state: TMR
        votes, DWC reads lane 0.  Leaves are voted on first read.  ``only``
        (fused builds): leaves outside it read lane 0.  ``votes``: voted
        values already made for these lanes, taken as they are."""
        def leaf(name, arr):
            if not self.replicated[name]:
                return arr
            if self.cfg.num_clones == 3 and (only is None or name in only):
                if votes and name in votes:
                    return votes[name]
                return self._vote(arr, 3)[0]
            return arr[:, 0]

        return _LazyView(pstate, leaf)

    def _all_halted(self, flags: Flags) -> bool:
        return bool(self._halted(flags).all())

    def run_batch(self, fault: Optional[Mapping[str, np.ndarray]] = None,
                  batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Run ``B`` campaign rows to completion, row ``r`` flipping its
        fault site at step ``fault['t'][r]`` (host int32 columns
        leaf_id/lane/word/bit/t).  ``fault=None`` runs ``batch`` fault-free
        rows.  Returns the run record, one entry per row."""
        if fault is None:
            if batch is None:
                raise ValueError("run_batch needs fault columns or a batch")
        else:
            fault = {k: np.asarray(v, np.int32) for k, v in fault.items()}
            if any(v.ndim != 1 for v in fault.values()):
                raise NotImplementedError(
                    "multi-site fault groups are ROADMAP Queue A item 10; "
                    "this slice runs single-site fault columns [B]")
            batch = len(fault["t"])
        pstate, flags = self.init_pstate(batch)
        site, fire_at, fault_t = {}, set(), None
        if fault is not None:
            lane_words = {k: self.lane_words(k) for k in self.leaf_order}
            lanes = {k: self.lanes_of(k) for k in self.leaf_order}
            site = bitflip.build_site(self.leaf_order, lane_words, lanes,
                                      fault, self.device)
            fire_at = set(int(v) for v in fault["t"])
            fault_t = fault_from_numpy({"t": fault["t"]}, self.device)["t"]

        # The bounded loop (fused, max_steps == nominal_steps) runs every
        # trip with no host sync; the others stop once every row halted.
        bounded = self._fuse_plan is not None and self._fuse_plan.bounded_scan
        for t in range(self.region.max_steps):
            if site and t in fire_at:
                # No injection once halted: a flip into a finished or
                # aborted row's frozen image would mis-classify it.
                live = ~self._halted(flags)
                bitflip.apply_site(pstate, site, (fault_t == t) & live)
            pstate, flags = self.step(pstate, flags, t)
            if not bounded and self._all_halted(flags):
                break

        # Region-boundary sync: every replicated leaf is compared/voted
        # once when the result escapes the SoR; only a row that completed
        # without a detected fault reaches it.  Its votes are the final
        # view.
        n = self.cfg.num_clones
        fused = self._fuse_plan is not None
        view: Mapping[str, torch.Tensor] = pstate
        if n > 1:
            view = dict(pstate)
            mis_cnt = torch.zeros(batch, dtype=torch.int32, device=self.device)
            for name, arr in pstate.items():
                if self.replicated[name]:
                    view[name], m = self._vote(arr, n)
                    mis_cnt += m.to(torch.int32)
            # The packed latch makes the gate one compare: done set and no
            # fault bit.
            reached_call = (flags["latch"] == fused_step.LATCH_DONE_ONLY
                            if fused else flags["done"] & ~flags["dwc_fault"])
            if n == 2:
                bad = reached_call & (mis_cnt > 0)
                if fused:
                    flags["latch"] = fused_step.latch_or(
                        flags["latch"], fused_step.LATCH_DWC, bad)
                else:
                    flags["dwc_fault"] = flags["dwc_fault"] | bad
            elif self.cfg.count_errors:
                flags["tmr_cnt"] = flags["tmr_cnt"] + torch.where(
                    reached_call, mis_cnt, 0).to(torch.int32)
        if fused:
            flags = fused_step.unpack_latch(flags)

        no = torch.zeros(batch, dtype=torch.bool, device=self.device)
        return {
            "errors": self.region.check(view),
            "corrected": flags["tmr_cnt"],
            "steps": flags["steps"],
            "sync_count": flags["sync_cnt"],
            "done": flags["done"],
            "dwc_fault": flags["dwc_fault"],
            "cfc_fault": flags.get("cfc_fault", no),
            "stack_fault": flags.get("stack_fault", no),
            "assert_fault": flags.get("assert_fault", no),
            "output": self.region.output(view),
        }

    def run(self, fault: Optional[Mapping[str, object]] = None
            ) -> Dict[str, torch.Tensor]:
        """Run one injection to completion; a batch of one.  ``fault`` keys:
        leaf_id, lane, word, bit, t (ints or 0-d arrays/tensors)."""
        cols = None
        if fault is not None:
            cols = {}
            for k, v in fault.items():
                if isinstance(v, torch.Tensor):
                    v = v.cpu().numpy()
                v = np.asarray(v, np.int32)
                if v.ndim:
                    raise NotImplementedError(
                        "multi-site fault groups are ROADMAP Queue A item "
                        "10; run() takes one site")
                cols[k] = v.reshape(1)
        rec = self.run_batch(cols, batch=1)
        return {k: v[0] for k, v in rec.items()}


def protect(region: Region, cfg: ProtectionConfig,
            device=device_mod.DEFAULT) -> ProtectedProgram:
    """``opt -load DataflowProtection.so`` equivalent: apply the engine."""
    return ProtectedProgram(region, cfg, device)
