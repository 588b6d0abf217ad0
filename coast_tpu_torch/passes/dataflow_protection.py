"""dataflowProtection: the replication engine, on torch tensors.

The counterpart of ``coast_tpu/passes/dataflow_protection.py``:

  * cloning -> replicated leaves carry a lane axis: ``[B, n, *leaf]`` for a
    batch of B campaign rows; shared leaves are ``[B, *leaf]``;
  * instruction replication -> the region's step runs once over a leading
    axis of ``R = B * n`` rows (replicated leaves are viewed, shared leaves
    expanded on first read);
  * insertVoters -> the pre-step load vote, the commit votes (store data,
    control, SoR crossing) and the region-boundary vote, each sync point
    one grouped call of the K1 wrapper ``ops/hopper_voters.py``
    ``vote_sites`` over all its leaves (one kernel launch on the card, its
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
nominal_steps``, and the TMR votes a repair follows (the pre-step load
sync, the whole-leaf commit votes) as one fused commit per sync point,
one K2 launch on the card.  Its run records equal the unfused engine's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Callable, Dict, FrozenSet, Iterator, List, Mapping,
                    NamedTuple, Optional, Tuple)

import numpy as np
import torch

from coast_tpu_torch import device as device_mod
from coast_tpu_torch.interop import fault_from_numpy
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_RO, Region,
                                       State, rows)
from coast_tpu_torch.ops import bitflip, fused_step, hopper_voters, site_table
from coast_tpu_torch.ops.voters import Site
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


def _vote_one(lanes: torch.Tensor) -> torch.Tensor:
    """The TMR voted value of one replica set (a group of one)."""
    return hopper_voters.vote_sites([Site(lanes)], 3)[0][0]


def _grouped(fn, sites: list, num_clones: int):
    """``fn(sites, num_clones)`` (a grouped K1 or K2 call), in launches of
    at most ``MAX_SITES`` sites: every output list joined, the flag blocks
    stacked as one ``[S, R]``."""
    if len(sites) <= site_table.MAX_SITES:
        return fn(sites, num_clones)
    parts = [fn(sites[i:i + site_table.MAX_SITES], num_clones)
             for i in range(0, len(sites), site_table.MAX_SITES)]
    lists = [[x for part in parts for x in part[k]]
             for k in range(len(parts[0]) - 1)]
    return (*lists, torch.cat([part[-1] for part in parts]))


class _Window(NamedTuple):
    """A store-slice window: per-row start block, block count, words a
    block and the per-row ``active`` flag (None: every row stored)."""

    start0: torch.Tensor
    size0: int
    rest: int
    active: Optional[torch.Tensor]


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
        # The pre-step load sync's leaves, in spec order.
        self._pre_names = [name for name in region.spec
                           if cfg.num_clones > 1 and self.pre_sync.get(name)]
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
                return _vote_one(arr)
            return arr[:, 0]

        return _LazyView(region_state, leaf)

    def _slice_site(self, name: str, out: torch.Tensor, hint, view: Mapping,
                    t: int, batch: int) -> Tuple[Site, _Window]:
        """The store-slice vote of one leaf as a K1 site: the window each
        row stored, read in place at per-row word offsets.  The offsets
        come from the hint on the pre-step view, so they are made before
        the sync point's vote."""
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
        site = Site(out.view(batch, n, -1), (start0 * rest).to(torch.int32),
                    size0 * rest)
        return site, _Window(start0, size0, rest, active)

    def _slice_repair(self, name: str, out: torch.Tensor, fresh: bool,
                      window: _Window, voted: torch.Tensor
                      ) -> torch.Tensor:
        """TMR: the window's voted words into every lane of the rows that
        stored (all rows without an ``active`` flag)."""
        batch, n = out.shape[:2]
        start0, size0, rest, active = window
        if not fresh:
            out = out.clone()
        blocks = out.view(batch, n, self._shapes[name][0], rest)
        index = (start0[:, None] + torch.arange(size0, device=self.device)
                 )[:, None, :, None].expand(batch, n, size0, rest)
        new = voted.view(batch, 1, size0, rest).expand(batch, n, size0, rest)
        if active is not None:
            new = torch.where(rows(active, new), new, blocks.gather(2, index))
        blocks.scatter_(2, index, new)
        return out

    # -- one protected step -------------------------------------------------
    def _halted(self, flags: Flags) -> torch.Tensor:
        """Rows that stopped evolving: completed or aborted."""
        if "latch" in flags:
            return flags["latch"] != 0
        return flags["done"] | flags["dwc_fault"]

    def _vote_repair(self, lanes: List[torch.Tensor]
                     ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                                torch.Tensor]:
        """TMR votes of one sync point and the repairs after them ->
        ``(repaired lanes, voted, flags [S, R])``.  The fused engine makes
        them one fused commit (one K2 launch on the card)."""
        if self._fuse_plan is None:
            voted, mis = _grouped(hopper_voters.vote_sites,
                                  [Site(x) for x in lanes], 3)
            return ([_repair(v, x.shape) for v, x in zip(voted, lanes)],
                    voted, mis)
        return _grouped(fused_step.commit_sites, [(x, None) for x in lanes], 3)

    def step(self, pstate: State, flags: Flags, t: int) -> Tuple[State, Flags]:
        cfg = self.cfg
        n = cfg.num_clones
        plan = self._fuse_plan
        batch = flags["steps"].shape[0]
        halted = self._halted(flags)
        region_state = dict(pstate)
        # One int32 [S, R] flag block per grouped vote, a row per site.
        miscompares: List[torch.Tensor] = []
        # Sync points every row passes, and the per-row ones (a store-slice
        # window with an ``active`` flag).
        syncs = 0
        sync_rows: List[torch.Tensor] = []
        # Voted values of this step's commit votes (the fused done() view
        # reuses them).
        commits: Dict[str, torch.Tensor] = {}

        # Pre-step load sync: vote address-forming ctrl state before any
        # load in this step reads it; TMR repairs the lanes.  One grouped
        # vote for every such leaf.
        if self._pre_names:
            lanes = [region_state[name] for name in self._pre_names]
            if n == 3:
                repaired, _, mis = self._vote_repair(lanes)
                region_state.update(zip(self._pre_names, repaired))
            else:
                _, mis = _grouped(hopper_voters.vote_sites,
                                  [Site(x) for x in lanes], n)
            miscompares.append(mis)
            syncs += len(self._pre_names)

        laned = self._run_lanes(region_state, t, batch)
        slice_view = (self._slice_view(region_state)
                      if self._store_slice and n > 1 else None)

        # The commit sync point: gather its sites, then vote them in one
        # grouped call (two on the fused engine when K1 sites remain beside
        # its K2 commit: store-slice windows, SoR crossings).
        new_state: State = {}
        repair: List[str] = []      # whole-leaf TMR votes a repair follows
        sites: List[Site] = []      # the other votes, on K1
        roles: List[Tuple[str, Optional[_Window]]] = []
        for name in self.region.spec:
            written = name in laned
            if self.replicated[name]:
                out = laned[name] if written else region_state[name]
                new_state[name] = out
                if self.step_sync[name] and n > 1:
                    hint = self._store_slice.get(name)
                    if hint is not None:
                        site, window = self._slice_site(
                            name, out, hint, slice_view, t, batch)
                        sites.append(site)
                        roles.append((name, window))
                        if window.active is None:
                            syncs += 1
                        else:
                            sync_rows.append(window.active)
                    elif n == 3 and plan is not None:
                        repair.append(name)
                        syncs += 1
                    else:
                        # TMR: the repair follows the grouped vote; DWC: a
                        # flags-only check.
                        sites.append(Site(out))
                        roles.append((name, None))
                        syncs += 1
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
                # the single store.  Its value becomes committed state, so
                # DWC writes lane 0 out: an in-place flip must not reach
                # into the lanes' storage.
                sites.append(Site(laned[name], copy=True))
                roles.append((name, None))
                syncs += 1
        if repair:
            repaired, voted, mis = self._vote_repair(
                [new_state[name] for name in repair])
            for name, lanes, value in zip(repair, repaired, voted):
                new_state[name] = lanes
                commits[name] = value
            miscompares.append(mis)
        if sites:
            voted, mis = _grouped(hopper_voters.vote_sites, sites, n)
            for j, ((name, window), value) in enumerate(zip(roles, voted)):
                if window is not None:
                    if n == 3:
                        new_state[name] = self._slice_repair(
                            name, new_state[name], name in laned, window,
                            value)
                    if window.active is not None:
                        mis[j] &= window.active
                elif not self.replicated[name]:
                    new_state[name] = value
                elif n == 3:
                    new_state[name] = _repair(value, new_state[name].shape)
                    commits[name] = value
            miscompares.append(mis)

        # Latch fault/correction accounting.  DWC checks before the store
        # commits: a miscompare this step freezes the row at its pre-step
        # image.
        fault_now = torch.zeros_like(halted)
        flags = dict(flags)
        if miscompares:
            mis = (miscompares[0] if len(miscompares) == 1
                   else torch.cat(miscompares))
        if miscompares and n == 2:
            fault_now = ~halted & mis.any(dim=0)
            if plan is not None:
                flags["latch"] = fused_step.latch_or(
                    flags["latch"], fused_step.LATCH_DWC, fault_now)
            else:
                flags["dwc_fault"] = flags["dwc_fault"] | fault_now
        elif miscompares and n == 3 and cfg.count_errors:
            flags["tmr_cnt"] = flags["tmr_cnt"] + torch.where(
                halted, 0, mis.sum(dim=0)).to(torch.int32)
        if cfg.count_syncs:
            per_row = torch.full((batch,), syncs, dtype=torch.int32,
                                 device=self.device)
            for active in sync_rows:
                per_row += active.to(torch.int32)
            flags["sync_cnt"] = flags["sync_cnt"] + torch.where(
                halted, 0, per_row).to(torch.int32)

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
                return _vote_one(arr)
            return arr[:, 0]

        return _LazyView(pstate, leaf)

    def boundary_votes(self, pstate: State
                       ) -> Tuple[State, Optional[torch.Tensor]]:
        """The region-boundary sync: every replicated leaf voted (TMR) or
        compared (DWC, flags only: its value is the lane-0 view of
        ``pstate``) in one grouped vote.  Returns ``(view, miscompares a
        row)``, the count None when nothing is replicated."""
        names = [name for name in pstate if self.replicated[name]]
        if self.cfg.num_clones == 1 or not names:
            return pstate, None
        voted, mis = _grouped(hopper_voters.vote_sites,
                              [Site(pstate[name]) for name in names],
                              self.cfg.num_clones)
        view = dict(pstate)
        view.update(zip(names, voted))
        return view, mis.sum(dim=0)

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
        view, mis_cnt = self.boundary_votes(pstate)
        if n > 1:
            if mis_cnt is None:
                mis_cnt = torch.zeros(batch, dtype=torch.int32,
                                      device=self.device)
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
