"""Region IR: the protected-dataflow-region contract, on torch tensors.

The counterpart of ``coast_tpu/ir/region.py``.  A region is a stepped
program over an explicit state dict:

    state = init(device)
    for t in range(max_steps):
        if not done(state):
            state = step(state, t)
    errors = check(state)

Each leaf carries a :class:`LeafSpec` naming its sync-point class
(``kind``), its replication scope (``xmr``) and whether the memory map may
flip it (``inject``).

Tensor contract (the port writes the batch axis out, there is no ``vmap``):

  * ``init(device)`` returns ONE image: unbatched int32 / float32 tensors.
  * ``step(state, t)`` sees every leaf with a leading row axis ``R`` (the
    engine flattens campaign rows x replica lanes into it) and ``t`` as a
    Python int.  It returns a dict of the leaves it writes, as new
    tensors; a leaf it leaves out is unchanged.  It never writes its
    inputs in place.
  * ``done(state)`` -> bool ``[R]``; ``check(state)`` -> int32 ``[R]``;
    ``output(state)`` -> int32 or float32 ``[R, words]``.

A region with named sub-functions (``functions``) has the three-argument
step ``step(state, t, fns)`` and calls them through ``fns``
(:class:`FnNamespace`); the engine rewraps each per its scope class
(``interface/wrappers.py``).  ``graph`` is the block graph CFCSS reads
(``ir/graph.py``).

Words are 32-bit.  A leaf the reference holds as uint32 is an int32 tensor
here with ``LeafSpec.unsigned`` set (``torch.uint32`` has no add, compare
or shift).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, List, Optional

import torch

from coast_tpu_torch import device as device_mod

State = Dict[str, torch.Tensor]

KIND_MEM = "mem"    # written memory (store sync points)
KIND_REG = "reg"    # loop-carried data registers
KIND_CTRL = "ctrl"  # loop counters, predicates (terminator sync)
KIND_RO = "ro"      # read-only inputs; never written by step()
# Per-task kernel stacks (rtos/): memory semantics, voted where written
# under the 'stack' sync class.
KIND_STACK = "stack"
# Training regions (train/): parameters and optimizer state, memory
# semantics under their own sync classes.
KIND_PARAM = "param"
KIND_OPT_STATE = "opt_state"
# Sharded regions (models/stencil.py): the in-flight halo buffer of a
# cross-shard exchange, the words on the link between a send and its
# receive.  Memory semantics for the engine (a shared leaf); its own kind
# so the ``link`` fault model targets exactly the interconnect.
KIND_LINK = "link"

_PORTED_KINDS = (KIND_MEM, KIND_REG, KIND_CTRL, KIND_RO, KIND_STACK,
                 KIND_PARAM, KIND_OPT_STATE, KIND_LINK)
WORD_DTYPES = (torch.int32, torch.float32)


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Replication/injection metadata for one state leaf.

    ``xmr=None`` defers to the region default.  ``unsigned`` records that
    the reference holds the leaf as uint32 (the port carries the same bits
    as int32).  ``stack`` marks call-stack state on any ported kind: under
    ``ProtectionConfig.protect_stack`` it is voted every step, whatever
    the per-kind sync flags say, and the supervisor's ``-s stack`` picks
    it.  ``canary_word`` (``KIND_STACK`` leaves only) is the flat word
    index, within a lane, of the canary word guarding the stack: metadata,
    the region's ``stack_guard`` owns the check.  ``unvoted_crossing``
    (shared leaves only) declares that the engine's SoR-crossing vote is
    left out on this leaf: the region carries per-replica copies through
    it and votes them itself on the receive side, so the engine commits
    lane 0's value raw.  On a replicated leaf it is a build error."""

    kind: str = KIND_MEM
    xmr: Optional[bool] = None
    inject: bool = True
    no_verify: bool = False
    unsigned: bool = False
    stack: bool = False
    unvoted_crossing: bool = False
    canary_word: Optional[int] = None

    def __post_init__(self):
        if self.kind not in _PORTED_KINDS:
            raise ValueError(
                f"bad leaf kind {self.kind!r}; one of {_PORTED_KINDS}")
        if self.canary_word is not None and self.kind != KIND_STACK:
            raise ValueError(
                f"canary_word is only meaningful on {KIND_STACK!r} leaves, "
                f"not {self.kind!r}")


class FnNamespace:
    """Attribute/by-name access to a region's sub-functions, plus the log
    of call-boundary miscompares the engine's wrappers append to: int32
    ``[S, B]`` flag blocks, one row per voted leaf (the per-call compares
    of processCallSync)."""

    def __init__(self, fns: Dict[str, Callable]):
        self._fns = fns
        self.miscompares: List = []

    def __getattr__(self, name: str) -> Callable:
        try:
            return self.__dict__["_fns"][name]
        except KeyError:
            raise AttributeError(
                f"region has no function {name!r} "
                f"(have: {', '.join(sorted(self.__dict__['_fns']))})"
            ) from None

    def __getitem__(self, name: str) -> Callable:
        return getattr(self, name)


@dataclasses.dataclass
class Region:
    """A protected dataflow region (the unit ``TMR``/``DWC`` operate on).

    ``nominal_steps`` is the fault-free runtime in steps (the injection
    window); ``max_steps`` the watchdog bound past which a run is a
    timeout."""

    name: str
    init: Callable[[Any], State]
    step: Callable[[State, int], State]
    done: Callable[[State], torch.Tensor]
    check: Callable[[State], torch.Tensor]
    output: Callable[[State], torch.Tensor]
    nominal_steps: int
    max_steps: int
    spec: Dict[str, LeafSpec]
    default_xmr: bool = True
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # The block graph CFCSS reads (ir/graph.BlockGraph); None: no CFCSS.
    graph: Any = None
    # Named sub-functions the three-argument step calls through ``fns``:
    # the unit the function-scope lists name.
    functions: Dict[str, Callable] = dataclasses.field(default_factory=dict)
    # The kernel's own checks (rtos/): ``state`` rows -> bool ``[R]``
    # (True: tripped), evaluated by the engine on every lane's stepped,
    # pre-vote state.  ``stack_guard`` latches DUE_STACK_OVERFLOW,
    # ``assert_guard`` DUE_ASSERT.
    stack_guard: Optional[Callable] = None
    assert_guard: Optional[Callable] = None
    # Training regions (train/): the voted final view -> int32 ``[R]``, 0
    # the loss trajectory stayed within tolerance, 1 it deviated and
    # re-converged, 2 it stayed diverged; classify splits SDC on it.
    train_probe: Optional[Callable] = None

    def leaf_is_xmr(self, name: str) -> bool:
        """Resolve the replication scope of a leaf (annotation > default)."""
        s = self.spec[name]
        return self.default_xmr if s.xmr is None else s.xmr

    def wants_fns(self) -> bool:
        """True when step has the three-argument form ``step(state, t,
        fns)``."""
        try:
            return len(inspect.signature(self.step).parameters) >= 3
        except (TypeError, ValueError):
            return False

    def bound_step(self, fns: Any = None) -> Callable:
        """The two-argument step with the function namespace bound: with
        ``fns=None`` the raw sub-functions (the module before cloning);
        the engine passes its namespace of wrapped functions."""
        if not self.wants_fns():
            return self.step
        if fns is None:
            fns = FnNamespace(dict(self.functions))
        return lambda state, t: self.step(state, t, fns)

    def validate(self) -> State:
        """Spec/state and dtype sanity check; returns the CPU init image."""
        state = self.init("cpu")
        missing = set(state) - set(self.spec)
        extra = set(self.spec) - set(state)
        if missing or extra:
            raise ValueError(
                f"region {self.name}: spec/state mismatch "
                f"(missing specs {sorted(missing)}, dangling specs "
                f"{sorted(extra)})")
        for name, arr in state.items():
            if arr.dtype not in WORD_DTYPES:
                raise TypeError(
                    f"leaf {name!r} has dtype {arr.dtype}; injectable state "
                    "must be 32-bit (word-addressed memory map)")
        if self.max_steps < self.nominal_steps:
            raise ValueError("max_steps must be >= nominal_steps")
        return state

    def run_unprotected(self, device=device_mod.DEFAULT) -> State:
        """Fault-free unprotected execution; the final state (unbatched)."""
        dev = device_mod.resolve(device)
        state = {k: v.unsqueeze(0) for k, v in self.init(dev).items()}
        halted = torch.zeros(1, dtype=torch.bool, device=dev)
        step = self.bound_step()
        for t in range(self.max_steps):
            new = {**state, **step(state, t)}
            state = {k: torch.where(rows(halted, v), state[k], v)
                     for k, v in new.items()}
            halted = halted | self.done(state)
            if bool(halted.all()):
                break     # later trips of a halted run change nothing
        return {k: v[0] for k, v in state.items()}


def rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-row mask ``[R]`` shaped to broadcast against ``like``."""
    return mask.view(-1, *([1] * (like.dim() - 1)))
