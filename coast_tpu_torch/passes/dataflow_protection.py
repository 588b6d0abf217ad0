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

``cfcss=True`` stacks CFCSS (``passes/cfcss.py``): two injectable
runtime leaves a lane and a signature check at every block entry, which
latches ``cfc_fault``.  A region with named sub-functions runs them
through the function-scope wrappers of ``interface/wrappers.py``, whose
call-boundary votes are K1 launches latched like the engine's own.
``segmented=True`` (``-s``) runs the region step once per lane on
``[B, ...]`` slices instead of once over the ``[B * n]`` rows; its
records equal the interleaved engine's.

A region's ``stack_guard`` / ``assert_guard`` (the rtos kernel's own
checks) are evaluated on every lane's stepped, pre-vote state; a trip in
any lane latches ``stack_fault`` / ``assert_fault`` and halts the row after
its step commits.  A training region's ``train_probe`` reads the voted
final view into the record's ``train_probe``.

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
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_OPT_STATE,
                                       KIND_PARAM, KIND_RO, KIND_STACK,
                                       FnNamespace, Region, State, rows)
from coast_tpu_torch.ops import (bitflip, fused_step, hopper_voters,
                                 site_table, voters)
from coast_tpu_torch.ops.voters import Site
from coast_tpu_torch.passes.verification import analyze, verify_options

Flags = Dict[str, torch.Tensor]

# The function-scope classes whose wrappers cross lanes: segmented
# scheduling cannot express their call-boundary sync.
_CROSS_LANE = ("ignored", "skip_lib", "protected_lib", "clone_after_call")
# Kinds with memory semantics: store-data sync where the step writes them,
# single-copy under -noMemReplication.
_STORE_KINDS = (KIND_MEM, KIND_STACK, KIND_PARAM, KIND_OPT_STATE)
# The unfused engine's optional terminal latches (CFCSS, the kernel guards).
_OPTIONAL_FAULTS = ("cfc_fault", "stack_fault", "assert_fault")


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
    # -protectStack: vote the call-stack leaves (LeafSpec.stack) every
    # step, the analogue of voting the saved return-address copies.
    protect_stack: bool = False
    # -s (segmented) instead of -i (interleaved) replica scheduling.
    segmented: bool = False
    # Function-scope lists, applied to the region's named sub-functions
    # (Region.functions); fn_scope_of gives the reference's precedence.
    ignore_fns: Tuple[str, ...] = ()
    skip_lib_calls: Tuple[str, ...] = ()
    replicate_fn_calls: Tuple[str, ...] = ()
    clone_fns: Tuple[str, ...] = ()
    clone_return_fns: Tuple[str, ...] = ()
    clone_after_call_fns: Tuple[str, ...] = ()
    protected_lib_fns: Tuple[str, ...] = ()
    # The reference's voter lowering switch (-pallasVoters /
    # -noPallasVoters): None, True or False, kept for the journal's
    # config_sha.  It changes no record here: a vote on a CUDA tensor
    # always launches K1 (ops/hopper_voters.py), one on a CPU tensor runs
    # the plain voter, as the reference's switch only picks the lowering.
    pallas_voters: "bool | None" = None
    fuse_step: bool = False
    # -isrFunctions: refused by verify_options (a stepped region has no
    # interrupts), as the reference refuses it.
    isr_functions: Tuple[str, ...] = ()
    # -runtimeInitGlobals: every replicated leaf is initialised from the
    # init() image (init_pstate), so the semantics hold for all leaves;
    # the names are checked to exist.
    runtime_init_globals: Tuple[str, ...] = ()
    # -CFCSS stacking (passes/cfcss.py).
    cfcss: bool = False

    def fn_scope_of(self, name: str) -> str:
        """A sub-function's scope class, by the reference's precedence:
        cloneAfterCall > protectedLibFn > cloneReturn > cloneFns >
        ignoreFns > replicateFnCalls > skipLibCalls > replicated."""
        if name in self.clone_after_call_fns:
            return "clone_after_call"
        if name in self.protected_lib_fns:
            return "protected_lib"
        if name in self.clone_return_fns:
            return "replicated_return"
        if name in self.clone_fns:
            return "replicated"
        if name in self.ignore_fns:
            return "ignored"
        if name in self.replicate_fn_calls:
            return "replicated"
        if name in self.skip_lib_calls:
            return "skip_lib"
        return "replicated"

    def fn_lists(self) -> Dict[str, Tuple[str, ...]]:
        return {"ignoreFns": self.ignore_fns,
                "skipLibCalls": self.skip_lib_calls,
                "replicateFnCalls": self.replicate_fn_calls,
                "cloneFns": self.clone_fns,
                "cloneReturn": self.clone_return_fns,
                "cloneAfterCall": self.clone_after_call_fns,
                "protectedLibFn": self.protected_lib_fns}

    def resolve_xmr(self, region: Region, name: str) -> bool:
        if self.num_clones == 1:
            return False
        if name in self.ignore_globals:
            return False
        if name in self.xmr_globals:
            return True
        if self.no_mem_replication and region.spec[name].kind in (
                *_STORE_KINDS, KIND_RO):
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
        for name, spec in region.spec.items():
            if spec.unvoted_crossing and self.replicated[name]:
                raise ValueError(
                    f"leaf {name!r} declares unvoted_crossing but resolves "
                    "to a replicated scope: the declaration is only "
                    "meaningful on shared (non-xMR) leaves whose SoR-"
                    "crossing vote the region replaces with its own "
                    "receive-side voter")
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
            elif spec.kind in _STORE_KINDS:
                # Store-data sync exists where stores exist: a leaf the
                # step never writes is not voted per step.  Kernel stacks,
                # parameters and optimizer state follow the same rule
                # under their own sync classes.
                self.step_sync[name] = (not cfg.no_store_data_sync
                                        and name in flow.written)
            else:  # reg: voted only where a sync point uses it
                self.step_sync[name] = False
            if cfg.protect_stack and spec.stack:
                # Stack protection stacks on the sync taxonomy: the frames
                # are voted even where store/ctrl syncs are off.
                self.step_sync[name] = True
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
        # Function-scope resolution: each named sub-function's class.  The
        # raw-bound step serves one lane, -s and the unprotected build.
        self._wants_fns = region.wants_fns()
        self._raw_step = region.bound_step()
        self.fn_scope: Dict[str, str] = {
            name: cfg.fn_scope_of(name) for name in region.functions}
        cross_lane = [n for n, c in self.fn_scope.items() if c in _CROSS_LANE]
        if cfg.segmented and cross_lane and cfg.num_clones > 1:
            raise ValueError(
                "segmented (-s) replica scheduling cannot express the "
                "cross-lane call-boundary sync of function scope classes "
                f"for {sorted(cross_lane)}; use interleaved (-i) scheduling")
        self.leaf_order = [n for n in region.spec if region.spec[n].inject]
        self._guarded = (region.stack_guard is not None
                         or region.assert_guard is not None)
        one = {k: v.unsqueeze(0) for k, v in image.items()}
        self.output_words = int(region.output(one).shape[1])
        # The CFCSS runtime, installed by passes.cfcss.apply_cfcss.
        self._cfcss_init = None
        self._cfcss_step = None
        if cfg.cfcss:
            from coast_tpu_torch.passes.cfcss import apply_cfcss
            apply_cfcss(self)
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

    # -- CFCSS stacking (passes/cfcss.py) ------------------------------------
    def install_cfcss(self, init_fn, step_fn) -> None:
        """Register the CFCSS runtime: its leaves (``init_fn(batch)`` gives
        them laned, ``[B, n]``) become injectable replicated leaves after
        the region's, in name order (the reference's pytree order), and
        ``step_fn`` runs at every block entry."""
        self._cfcss_init = init_fn
        self._cfcss_step = step_fn
        for name, arr in sorted(init_fn(1).items()):
            self.replicated[name] = True
            self._shapes[name] = tuple(arr.shape[2:])
            if name not in self.leaf_order:
                self.leaf_order.append(name)

    def _sync_class_of(self, name: str) -> str:
        """The sync class of a commit vote on ``name``: the reference's
        ``coast:sync:<class>:<leaf>`` tag class."""
        spec = self.region.spec[name]
        if self.cfg.protect_stack and spec.stack:
            return "stack"
        if spec.kind == KIND_MEM:
            return "store_data"
        if spec.kind == KIND_CTRL:
            return "ctrl"
        if spec.kind in (KIND_PARAM, KIND_OPT_STATE):
            return spec.kind
        return "stack"

    def sync_tags(self) -> FrozenSet[Tuple[str, str]]:
        """``(class, leaf)`` of every vote one step makes: the pre-step
        ``load_addr`` votes, the commit votes by :meth:`_sync_class_of`,
        the ``sor_crossing`` votes of shared leaves (none on an
        ``unvoted_crossing`` leaf, which commits raw), the CFCSS check and
        the ``call_boundary`` votes (by function) and, on a guarded
        region, the ``guard`` reads of every leaf -- the reference's
        ``coast:sync:`` tags of its step."""
        tags = set()
        if self._guarded:
            tags.update(("guard", name) for name in self.region.spec)
        if self._cfcss_step is not None:
            from coast_tpu_torch.passes.cfcss import G_LEAF
            tags.add(("cfcss", G_LEAF))
        if self.cfg.num_clones == 1 or not self._any_replicated:
            return frozenset(tags)
        tags.update(("load_addr", name) for name in self._pre_names)
        for name, spec in self.region.spec.items():
            if self.replicated[name]:
                if self.step_sync[name]:
                    tags.add((self._sync_class_of(name), name))
            elif spec.kind != KIND_RO and not spec.unvoted_crossing:
                tags.add(("sor_crossing", name))
        tags.update(("call_boundary", name)
                    for name, cls in self.fn_scope.items()
                    if cls in ("ignored", "protected_lib"))
        return frozenset(tags)

    # -- the memory map's view ---------------------------------------------
    def lanes_of(self, name: str) -> int:
        return self.cfg.num_clones if self.replicated[name] else 1

    def lane_words(self, name: str) -> int:
        return math.prod(self._shapes[name])

    def injectable_sections(self):
        """(name, kind, lanes, words_per_lane) rows for the memory map; the
        CFCSS runtime leaves have kind 'cfcss'."""
        return [(name, self.region.spec[name].kind
                 if name in self.region.spec else "cfcss",
                 self.lanes_of(name), self.lane_words(name))
                for name in self.leaf_order]

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

        if self._cfcss_init is not None:
            pstate.update(self._cfcss_init(batch))

        if self._fuse_plan is not None:
            return pstate, fused_step.flags_init(batch, self.device)

        def zeros(dtype):
            return torch.zeros(batch, dtype=dtype, device=self.device)

        flags = {"dwc_fault": zeros(torch.bool), "tmr_cnt": zeros(torch.int32),
                 "sync_cnt": zeros(torch.int32), "steps": zeros(torch.int32),
                 "done": zeros(torch.bool)}
        if self._cfcss_step is not None:
            flags["cfc_fault"] = zeros(torch.bool)
        if self._guarded:
            flags["stack_fault"] = zeros(torch.bool)
            flags["assert_fault"] = zeros(torch.bool)
        return pstate, flags

    # -- lane execution -----------------------------------------------------
    def row_view(self, region_state: Mapping[str, torch.Tensor],
                 batch: int) -> Mapping[str, torch.Tensor]:
        """The state as the step's rows: ``[B * n, ...]`` (campaign row
        major, lane minor; shared leaves expanded on first read) when the
        program has lanes, else the ``[B, ...]`` state itself."""
        n = self.cfg.num_clones
        if n == 1 or not self._any_replicated:
            return region_state

        def lane_rows(name, arr):
            if self.replicated[name]:
                return arr.reshape(batch * n, *arr.shape[2:])
            return (arr.unsqueeze(1).expand(batch, n, *arr.shape[1:])
                    .reshape(batch * n, *arr.shape[1:]))

        return _LazyView(region_state, lane_rows)

    def _fn_env(self, batch: int) -> FnNamespace:
        """The step's function namespace: each named sub-function wrapped
        per its scope class; call-boundary flags go to its log."""
        from coast_tpu_torch.interface import wrappers as W
        env = FnNamespace({})
        env.batch, env.device = batch, self.device
        n = self.cfg.num_clones
        wrapped = {}
        for name, fn in self.region.functions.items():
            cls = self.fn_scope[name]
            if n == 1 or cls in ("replicated", "replicated_return"):
                # The per-lane call: a .RR return skips the boundary sync,
                # which is the per-lane default too.
                wrapped[name] = fn
            elif cls == "ignored":
                wrapped[name] = W.lane_ignored(fn, n, env, name=name)
            elif cls == "skip_lib":
                wrapped[name] = W.lane_skip_lib(fn, n, name=name)
            elif cls == "protected_lib":
                wrapped[name] = W.lane_protected_lib(fn, n, env, name=name)
            else:  # clone_after_call
                wrapped[name] = W.lane_clone_after_call(fn, n, name=name)
        env._fns = wrapped
        return env

    def _run_lanes(self, region_state: State, t: int, batch: int
                   ) -> Tuple[State, List[torch.Tensor]]:
        """The region step once per lane -> ``(written leaves, call-boundary
        flag blocks)``; the leaves carry a lane axis ``[B, n, ...]`` when
        the program has lanes.  Interleaved: one step over the ``[B * n]``
        rows.  Segmented (``-s``): one step a lane on its ``[B, ...]``
        slices, each lane's whole step before the next."""
        n = self.cfg.num_clones
        if n == 1 or not self._any_replicated:
            return self._raw_step(region_state, t), []
        if self.cfg.segmented:
            outs = [self._raw_step({k: v[:, lane] if self.replicated[k]
                                    else v for k, v in region_state.items()},
                                   t)
                    for lane in range(n)]
            return {k: torch.stack([o[k] for o in outs], dim=1)
                    for k in outs[0]}, []
        env = self._fn_env(batch) if self._wants_fns else None
        out = self.region.bound_step(env)(
            self.row_view(region_state, batch), t)
        # Contiguous: K1 reads a replica set as [B, n, words].
        return ({k: v.reshape(batch, n, *v.shape[1:]).contiguous()
                 for k, v in out.items()},
                env.miscompares if env is not None else [])

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
            return voters.lane_view(arr)

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
                    size0 * rest, tag=f"{self._sync_class_of(name)}:{name}")
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
        """Rows that stopped evolving: completed, aborted (DWC or CFCSS) or
        tripped by a kernel guard."""
        if "latch" in flags:
            return flags["latch"] != 0
        halted = flags["done"] | flags["dwc_fault"]
        for name in _OPTIONAL_FAULTS:
            if name in flags:
                halted = halted | flags[name]
        return halted

    def _guard_trips(self, region_state: State, laned: State, batch: int,
                     halted: torch.Tensor) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
        """The kernel guards on every lane's stepped, pre-vote state (the
        replicated kernel's own checks, which run before any vote repairs
        what they see): ``(stack trip, assert trip)``, bool ``[B]``, a row
        tripping when any of its lanes does and it has not halted."""
        n = self.cfg.num_clones
        laned_rows = n > 1 and self._any_replicated

        def leaf(name, arr):
            # Every leaf a guard reads is tagged a guard sync (the
            # reference's coast:sync:guard:<leaf>): its any() over the
            # lanes is a sanctioned collapse.
            out = laned.get(name)
            if out is None:
                return self.row_view(
                    {name: voters.sync_tag(arr, "guard", name)}, batch)[name]
            out = voters.sync_tag(out, "guard", name)
            return out.reshape(batch * n, *out.shape[2:]) if laned_rows \
                else out

        view = _LazyView(region_state, leaf)
        trips = []
        for guard in (self.region.stack_guard, self.region.assert_guard):
            if guard is None:
                trips.append(torch.zeros_like(halted))
                continue
            hit = guard(view)
            if laned_rows:
                hit = hit.view(batch, n).any(dim=1)
            trips.append(~halted & hit)
        return trips[0], trips[1]

    def _vote_repair(self, lanes: List[torch.Tensor], tags: List[str]
                     ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                                torch.Tensor]:
        """TMR votes of one sync point and the repairs after them ->
        ``(repaired lanes, voted, flags [S, R])``; ``tags`` are the votes'
        sync classes (:attr:`Site.tag`).  The fused engine makes them one
        fused commit (one K2 launch on the card)."""
        if self._fuse_plan is None:
            voted, mis = _grouped(hopper_voters.vote_sites,
                                  [Site(x, tag=k)
                                   for x, k in zip(lanes, tags)], 3)
            return ([_repair(v, x.shape) for v, x in zip(voted, lanes)],
                    voted, mis)
        return _grouped(fused_step.commit_sites,
                        [(voters.tag_lanes(x, k), None)
                         for x, k in zip(lanes, tags)], 3)

    def step(self, pstate: State, flags: Flags, t: int) -> Tuple[State, Flags]:
        cfg = self.cfg
        n = cfg.num_clones
        plan = self._fuse_plan
        batch = flags["steps"].shape[0]
        halted = self._halted(flags)
        region_state = {name: pstate[name] for name in self.region.spec}
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
            tags = [f"load_addr:{name}" for name in self._pre_names]
            if n == 3:
                repaired, _, mis = self._vote_repair(lanes, tags)
                region_state.update(zip(self._pre_names, repaired))
            else:
                _, mis = _grouped(hopper_voters.vote_sites,
                                  [Site(x, tag=k)
                                   for x, k in zip(lanes, tags)], n)
            miscompares.append(mis)
            syncs += len(self._pre_names)

        flags = dict(flags)
        if self._cfcss_step is not None:
            # The CFCSS check at block entry, each lane classified from the
            # state the step runs with (after the pre-step repairs).  A
            # mismatch halts the row before the block body commits.  Only
            # the runtime leaves carry the hook's update: the repairs stay
            # local to this step, so a frozen row keeps its pre-step image.
            tracker = {name: pstate[name] for name in pstate
                       if name not in self.region.spec}
            if plan is not None:
                cfc = fused_step.latch_get(flags["latch"],
                                           fused_step.LATCH_CFC)
                updates, cfc = self._cfcss_step(region_state, tracker, cfc,
                                                halted)
                flags["latch"] = fused_step.latch_or(
                    flags["latch"], fused_step.LATCH_CFC, cfc)
            else:
                updates, cfc = self._cfcss_step(
                    region_state, tracker, flags["cfc_fault"], halted)
                flags["cfc_fault"] = cfc
            halted = halted | cfc
            pstate = {**pstate, **updates}

        laned, call_mis = self._run_lanes(region_state, t, batch)
        trip_now = None
        if self._guarded:
            trip_stack, trip_assert = self._guard_trips(region_state, laned,
                                                        batch, halted)
            if plan is not None:
                flags["latch"] = fused_step.latch_or(fused_step.latch_or(
                    flags["latch"], fused_step.LATCH_STACK, trip_stack),
                    fused_step.LATCH_ASSERT, trip_assert)
            else:
                flags["stack_fault"] = flags["stack_fault"] | trip_stack
                flags["assert_fault"] = flags["assert_fault"] | trip_assert
            trip_now = trip_stack | trip_assert
        if call_mis and n > 1:
            # Call-boundary syncs of the function-scope wrappers: each
            # voted leaf is one sync and one miscompare row.
            miscompares.extend(call_mis)
            syncs += sum(block.shape[0] for block in call_mis)
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
                        sites.append(Site(
                            out, tag=f"{self._sync_class_of(name)}:{name}"))
                        roles.append((name, None))
                        syncs += 1
            elif not written:
                # Unwritten shared leaf: all lanes see the same value, so
                # its SoR-crossing vote (below) agrees by construction.
                new_state[name] = region_state[name]
                spec = self.region.spec[name]
                if (spec.kind != KIND_RO and not spec.unvoted_crossing
                        and n > 1 and self._any_replicated):
                    syncs += 1
            elif n == 1 or not self._any_replicated:
                new_state[name] = laned[name]
            elif self.region.spec[name].kind == KIND_RO:
                new_state[name] = laned[name][:, 0]
            elif self.region.spec[name].unvoted_crossing:
                # A declared unvoted crossing: the region ships replica
                # copies through this shared leaf and votes them on the
                # receive side, so lane 0's value commits raw (the single
                # point of failure that placement accepts).  A copy: an
                # in-place flip must not reach into the lanes' storage.
                new_state[name] = laned[name][:, 0].contiguous()
            else:
                # A store crossing the sphere of replication: vote before
                # the single store.  Its value becomes committed state, so
                # DWC writes lane 0 out: an in-place flip must not reach
                # into the lanes' storage.
                sites.append(Site(laned[name], copy=True,
                                  tag=f"sor_crossing:{name}"))
                roles.append((name, None))
                syncs += 1
        if repair:
            repaired, voted, mis = self._vote_repair(
                [new_state[name] for name in repair],
                [f"{self._sync_class_of(name)}:{name}" for name in repair])
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
        # A step whose guard tripped commits (the image the hook saw) but
        # cannot complete.
        commit_halt = halted | fault_now
        done_gate = ~commit_halt if trip_now is None else ~(commit_halt
                                                             | trip_now)
        if plan is None:
            done_now = self.region.done(self.voted_view(new_state))
            flags["done"] = flags["done"] | (done_gate & done_now)
        else:
            done_now = self.region.done(self.voted_view(
                new_state, only=plan.done_leaves, votes=commits))
            flags["latch"] = fused_step.latch_or(
                flags["latch"], fused_step.LATCH_DONE, done_gate & done_now)
        flags["steps"] = flags["steps"] + (~commit_halt).to(torch.int32)

        # The CFCSS runtime leaves, as the entry hook left them.
        for name in pstate:
            if name not in new_state:
                new_state[name] = pstate[name]

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
            return voters.lane_view(arr)

        return _LazyView(pstate, leaf)

    def boundary_votes(self, pstate: State
                       ) -> Tuple[State, Optional[torch.Tensor]]:
        """The region-boundary sync: every replicated leaf voted (TMR) or
        compared (DWC, flags only: its value is the lane-0 view of
        ``pstate``) in one grouped vote.  Returns ``(view, miscompares a
        row)``, the count None when nothing is replicated."""
        names = [name for name in pstate if self.replicated[name]]
        if self.cfg.num_clones == 1 or not names:
            # One lane: only the CFCSS runtime leaves carry a lane axis.
            return {k: v[:, 0] if self.replicated[k] else v
                    for k, v in pstate.items()}, None
        voted, mis = _grouped(hopper_voters.vote_sites,
                              [Site(pstate[name], tag=f"boundary:{name}")
                               for name in names],
                              self.cfg.num_clones)
        view = dict(pstate)
        view.update(zip(names, voted))
        return view, mis.sum(dim=0)

    def _all_halted(self, flags: Flags) -> bool:
        return bool(self._halted(flags).all())

    def fire_plan_bytes(self, sites: int = 1) -> int:
        """Bytes of the one device-to-host copy :meth:`run_batch` makes a
        batch: a bool a step, and one a site column and a leaf."""
        return self.region.max_steps + sites * len(self.leaf_order)

    def _flip_plan(self, fault: Mapping[str, object]
                   ) -> Tuple[List[bitflip.Site], FrozenSet[int],
                              torch.Tensor]:
        """The flip sites of a batch, one per site column, the steps at
        which any row fires and the t columns ``[B, sites]`` on the device.
        Host columns are uploaded first; the columns are then read through
        one small copy (:meth:`fire_plan_bytes`): which steps any row
        fires at, and which leaves each site column targets."""
        cols = {k: fault[k] for k in ("leaf_id", "lane", "word", "bit", "t")}
        cols.update(fault_from_numpy(
            {k: v for k, v in cols.items() if not isinstance(v, torch.Tensor)},
            self.device))
        cols = {k: v.to(device=self.device, dtype=torch.int32
                        ).reshape(v.shape[0], -1) for k, v in cols.items()}
        n_sites = cols["t"].shape[1]
        n_leaves = len(self.leaf_order)
        steps = self.region.max_steps
        t = cols["t"].flatten().to(torch.int64)
        leaf = cols["leaf_id"].to(torch.int64)
        # Slot t for a step, steps + g * n_leaves + i for leaf i of site
        # column g; out-of-range draws mark a sink slot past them, which is
        # not copied.
        sink = self.fire_plan_bytes(n_sites)
        flags = torch.zeros(sink + 1, dtype=torch.bool, device=self.device)
        flags.scatter_(0, torch.where((t >= 0) & (t < steps), t, sink), True)
        column = torch.arange(n_sites, device=self.device) * n_leaves
        flags.scatter_(0, torch.where((leaf >= 0) & (leaf < n_leaves),
                                      steps + column + leaf, sink).flatten(),
                       True)
        flags = flags[:sink].cpu().numpy()
        fire_at = frozenset(np.flatnonzero(flags[:steps]).tolist())
        targeted = flags[steps:].reshape(n_sites, n_leaves)
        lane_words = {k: self.lane_words(k) for k in self.leaf_order}
        lanes = {k: self.lanes_of(k) for k in self.leaf_order}
        sites = [bitflip.build_site(
                     self.leaf_order, lane_words, lanes,
                     {k: v[:, g] for k, v in cols.items()}, self.device,
                     np.flatnonzero(targeted[g]).tolist())
                 for g in range(n_sites)]
        return sites, fire_at, cols["t"]

    def run_batch(self, fault: Optional[Mapping[str, object]] = None,
                  batch: Optional[int] = None, trace: bool = False,
                  return_state: bool = False) -> Dict[str, torch.Tensor]:
        """Run ``B`` campaign rows to completion.  ``fault`` holds int32
        columns leaf_id/lane/word/bit/t: numpy arrays on the host, or
        tensors already on the program's device (the device generator's,
        ``inject/device_gen.py``).  A column of shape ``[B]`` is one site
        a row; ``[B, sites]`` is a flip group, site ``g`` firing at its own
        ``t[:, g]``, the sites applied in order ``g = 0..sites-1``.
        ``fault=None`` runs ``batch`` fault-free rows.  Returns the run
        record, one entry per row.

        ``trace=True`` runs all ``max_steps`` trips and adds, per row and
        step, the block about to execute (``block_of`` of the voted view,
        after the step's flip; 0 without a graph) and whether the row was
        live: ``trace_block`` and ``trace_live``, ``[B, max_steps]``, the
        raw material of ``passes/instrument.py``.  ``return_state=True``
        adds ``final_state``, the voted final view (what a debugger reads
        at the exit marker)."""
        sites, fire_at, fault_t = [], frozenset(), None
        if fault is not None:
            sites, fire_at, fault_t = self._flip_plan(fault)
            batch = fault_t.shape[0]
        elif batch is None:
            raise ValueError("run_batch needs fault columns or a batch")
        pstate, flags = self.init_pstate(batch)

        # The bounded loop (fused, max_steps == nominal_steps) runs every
        # trip with no host sync; the others stop once every row halted.
        bounded = (trace or self._fuse_plan is not None
                   and self._fuse_plan.bounded_scan)
        blocks, lives = [], []
        for t in range(self.region.max_steps):
            if t in fire_at or trace:
                live = ~self._halted(flags)
            if t in fire_at:
                # No injection once halted: a flip into a finished or
                # aborted row's frozen image would mis-classify it.
                for g, site in enumerate(sites):
                    bitflip.apply_site(pstate, site,
                                       (fault_t[:, g] == t) & live)
            if trace:
                blocks.append(self._trace_block(pstate, batch))
                lives.append(live)
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
            if fused:
                reached_call = flags["latch"] == fused_step.LATCH_DONE_ONLY
            else:
                reached_call = flags["done"] & ~flags["dwc_fault"]
                for name in _OPTIONAL_FAULTS:
                    if name in flags:
                        reached_call = reached_call & ~flags[name]
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
        rec = {
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
        if self.region.train_probe is not None:
            rec["train_probe"] = self.region.train_probe(view).to(
                torch.int32)
        if trace:
            rec["trace_block"] = torch.stack(blocks, dim=1)
            rec["trace_live"] = torch.stack(lives, dim=1)
        if return_state:
            rec["final_state"] = view
        return rec

    def _trace_block(self, pstate: State, batch: int) -> torch.Tensor:
        """The block the next step executes, from the voted view of the
        region's leaves: int32 ``[B]``."""
        if self.region.graph is None:
            return torch.zeros(batch, dtype=torch.int32, device=self.device)
        return self.region.graph.block_of(self.voted_view(
            {name: pstate[name] for name in self.region.spec}))

    def run(self, fault: Optional[Mapping[str, object]] = None,
            trace: bool = False, return_state: bool = False,
            unroll: int = 1) -> Dict[str, torch.Tensor]:
        """Run one injection to completion; a batch of one.  ``fault`` keys:
        leaf_id, lane, word, bit, t: ints or 0-d arrays for one site,
        vectors of shape [sites] for a flip group.  ``trace`` and
        ``return_state`` as in :meth:`run_batch`.  ``unroll`` is the
        reference's early-exit loop unroll, clamped to ``max(1, int(
        unroll))``; the loop stops on the same trip whatever its value, so
        it changes no record."""
        max(1, int(unroll))         # validated as the reference clamps it
        cols = None
        if fault is not None:
            cols = {}
            for k, v in fault.items():
                if isinstance(v, torch.Tensor):
                    v = v.cpu().numpy()
                cols[k] = np.asarray(v, np.int32)[None]
        rec = self.run_batch(cols, batch=1, trace=trace,
                             return_state=return_state)
        out = {k: v[0] for k, v in rec.items() if k != "final_state"}
        if return_state:
            out["final_state"] = {k: v[0]
                                  for k, v in rec["final_state"].items()}
        return out


def protect(region: Region, cfg: ProtectionConfig,
            device=device_mod.DEFAULT) -> ProtectedProgram:
    """``opt -load DataflowProtection.so`` equivalent: apply the engine."""
    return ProtectedProgram(region, cfg, device)
