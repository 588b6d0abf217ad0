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

Words are 32-bit.  A leaf the reference holds as uint32 is an int32 tensor
here with ``LeafSpec.unsigned`` set (``torch.uint32`` has no add, compare
or shift).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from coast_tpu_torch import device as device_mod

State = Dict[str, torch.Tensor]

KIND_MEM = "mem"    # written memory (store sync points)
KIND_REG = "reg"    # loop-carried data registers
KIND_CTRL = "ctrl"  # loop counters, predicates (terminator sync)
KIND_RO = "ro"      # read-only inputs; never written by step()
KIND_STACK = "stack"
KIND_PARAM = "param"
KIND_OPT_STATE = "opt_state"
KIND_LINK = "link"

_PORTED_KINDS = (KIND_MEM, KIND_REG, KIND_CTRL, KIND_RO)
# Kinds of the reference that later slices bring over (ROADMAP Queue A).
_LATER_KINDS = {
    KIND_STACK: "Queue A item 15 (rtos/)",
    KIND_PARAM: "Queue A item 14 (train/mlp.py)",
    KIND_OPT_STATE: "Queue A item 14 (train/mlp.py)",
    KIND_LINK: "Queue A item 16 (the sharded backend)",
}
WORD_DTYPES = (torch.int32, torch.float32)


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Replication/injection metadata for one state leaf.

    ``xmr=None`` defers to the region default.  ``unsigned`` records that
    the reference holds the leaf as uint32 (the port carries the same bits
    as int32)."""

    kind: str = KIND_MEM
    xmr: Optional[bool] = None
    inject: bool = True
    no_verify: bool = False
    unsigned: bool = False

    def __post_init__(self):
        if self.kind in _LATER_KINDS:
            raise NotImplementedError(
                f"leaf kind {self.kind!r} is not ported yet; see ROADMAP "
                f"{_LATER_KINDS[self.kind]}")
        if self.kind not in _PORTED_KINDS:
            raise ValueError(
                f"bad leaf kind {self.kind!r}; one of {_PORTED_KINDS}")


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
    # Reference fields whose engine support comes in later slices.
    functions: Dict[str, Callable] = dataclasses.field(default_factory=dict)
    stack_guard: Optional[Callable] = None
    assert_guard: Optional[Callable] = None
    train_probe: Optional[Callable] = None

    def __post_init__(self):
        later = {"functions": "Queue A item 13 (function-scope wrappers)",
                 "stack_guard": "Queue A item 15 (rtos/)",
                 "assert_guard": "Queue A item 15 (rtos/)",
                 "train_probe": "Queue A item 14 (train/mlp.py)"}
        for field, item in later.items():
            if getattr(self, field):
                raise NotImplementedError(
                    f"region {self.name}: {field} is not ported yet; see "
                    f"ROADMAP {item}")

    def leaf_is_xmr(self, name: str) -> bool:
        """Resolve the replication scope of a leaf (annotation > default)."""
        s = self.spec[name]
        return self.default_xmr if s.xmr is None else s.xmr

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
        for t in range(self.max_steps):
            new = {**state, **self.step(state, t)}
            state = {k: torch.where(rows(halted, v), state[k], v)
                     for k, v in new.items()}
            halted = halted | self.done(state)
            if bool(halted.all()):
                break     # later trips of a halted run change nothing
        return {k: v[0] for k, v in state.items()}


def rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-row mask ``[R]`` shaped to broadcast against ``like``."""
    return mask.view(-1, *([1] * (like.dim() - 1)))
