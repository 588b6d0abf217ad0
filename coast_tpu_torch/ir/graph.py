"""Block graphs: the control-flow-graph view of a region, for CFCSS.

The counterpart of ``coast_tpu/ir/graph.py``.  A region declares its
logical blocks and legal transitions, plus ``block_of(state)``: which
block the next step executes, given the current control state.  Node 0
is the entry pseudo-block (the state before step 0).

``block_of`` takes the engine's row view (every leaf with a leading row
axis ``R``) and returns int32 ``[R]``.  :func:`pick` is the int32
``where`` the models build it from (``torch.where`` of two Python ints
gives int64).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple, Union

import torch

from coast_tpu_torch.ir.region import State


@dataclasses.dataclass
class BlockGraph:
    """``names[0]`` is the entry pseudo-block; ``edges`` are ``(u, v)``
    node indices; ``block_of`` maps the row view to int32 ``[R]``."""

    names: List[str]
    edges: List[Tuple[int, int]]
    block_of: Callable[[State], torch.Tensor]

    @property
    def n(self) -> int:
        return len(self.names)

    def validate(self) -> None:
        for u, v in self.edges:
            if not (0 <= u < self.n and 0 <= v < self.n):
                raise ValueError(
                    f"edge ({u},{v}) out of range for {self.n} blocks")
        targets = {v for _, v in self.edges}
        for v in range(1, self.n):
            if v not in targets:
                raise ValueError(
                    f"block {v} ({self.names[v]}) is unreachable")


Block = Union[int, torch.Tensor]


def pick(cond: torch.Tensor, a: Block, b: Block) -> torch.Tensor:
    """``jnp.where(cond, a, b)`` of block numbers, as int32 ``[R]``."""
    return torch.where(cond, a, b).to(torch.int32)


def loop_graph(body: str, counter: str, n: int) -> BlockGraph:
    """entry -> body (self loop) -> exit, the body running while
    ``state[counter] < n``: the graph of most of the reference's models."""
    return BlockGraph(
        names=["entry", body, "exit"],
        edges=[(0, 1), (1, 1), (1, 2)],
        block_of=lambda s: pick(s[counter] >= n, 2, 1))
