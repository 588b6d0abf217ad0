"""Instrumentation passes: tracing, profiling and the exit-marker hook.

The counterpart of ``coast_tpu/passes/instrument.py``, over the engine's
``run(trace=True)`` / ``run(return_state=True)``:

  * ``debugStatements`` prints ``fn-->bb`` at every basic-block entry:
    :func:`trace_run` records the per-step (block, live) trace on the
    device (one copy to the host at the end) and :func:`format_trace`
    makes the same lines on the host;
  * ``smallProfile`` keeps a counter per function and prints
    ``<name>: <count>``: :func:`profile_run` counts the live steps a block
    ran (a histogram of the same trace) plus the whole region under its
    own name (:func:`format_profile_stats`);
  * ``exitMarker`` calls ``EXIT_MARKER(ret)`` before main returns so the
    fault injector can read the final state: :func:`run_to_exit_marker`
    returns the voted final view with the run record, and
    :func:`state_digest` its per-leaf XOR fold.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from coast_tpu_torch.passes.cfcss import G_LEAF


def _block_names(prog) -> List[str]:
    graph = prog.region.graph
    if graph is None:
        # A region without a block graph is one logical block.
        return [prog.region.name]
    return list(graph.names)


def _host(rec: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in rec.items()}


def trace_run(prog, fault: Optional[Mapping[str, object]] = None
              ) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """Run with tracing -> (record, ``fn-->bb`` lines): one
    ``<region>--><block>`` per executed step, in execution order."""
    rec = _host(prog.run(fault, trace=True))
    return rec, format_trace(prog, rec)


def format_trace(prog, rec: Mapping[str, np.ndarray],
                 fn_print_list: Sequence[str] = ()) -> List[str]:
    """Trace -> printf lines; ``fn_print_list`` filters by block name (the
    -fnPrintList CL list)."""
    names = _block_names(prog)
    lines = []
    for blk, ok in zip(np.asarray(rec["trace_block"]),
                       np.asarray(rec["trace_live"])):
        if not ok:
            continue
        name = names[int(blk)] if 0 <= int(blk) < len(names) else f"bb{blk}"
        if fn_print_list and name not in fn_print_list:
            continue
        lines.append(f"{prog.region.name}-->{name}")
    return lines


def profile_run(prog, fault: Optional[Mapping[str, object]] = None
                ) -> Tuple[Dict[str, np.ndarray], Dict[str, int]]:
    """Run with profiling -> (record, counters): one per block (live steps
    that block ran) plus the region under its own name (all live
    steps)."""
    rec = _host(prog.run(fault, trace=True))
    return rec, profile_counts(prog, rec)


def profile_counts(prog, rec: Mapping[str, np.ndarray]) -> Dict[str, int]:
    names = _block_names(prog)
    blocks = np.asarray(rec["trace_block"])
    live = np.asarray(rec["trace_live"])
    hist = np.bincount(blocks[live], minlength=len(names))
    counts = {name: int(hist[i]) for i, name in enumerate(names)}
    counts[prog.region.name] = int(live.sum())
    return counts


def format_profile_stats(counts: Dict[str, int]) -> List[str]:
    """``PRINT_PROFILE_STATS`` output: ``<name>: <count>`` per counter."""
    return [f"{name}: {cnt}" for name, cnt in counts.items()]


def run_to_exit_marker(prog, fault: Optional[Mapping[str, object]] = None
                       ) -> Tuple[Dict[str, np.ndarray],
                                  Dict[str, np.ndarray]]:
    """Run to the exit marker -> (final_state, record): ``final_state`` is
    the voted view of the final memory image, leaf by leaf, uint32 where
    the reference holds the leaf as uint32."""
    rec = prog.run(fault, return_state=True)
    final = {}
    for name, arr in rec.pop("final_state").items():
        arr = arr.cpu().numpy()
        spec = prog.region.spec.get(name)
        if (spec.unsigned if spec is not None else name == G_LEAF):
            arr = arr.view(np.uint32)
        final[name] = arr
    return final, _host(rec)


def state_digest(final_state: Mapping[str, np.ndarray]) -> Dict[str, int]:
    """Per-leaf XOR fold of the final image (what the opt CLI prints under
    -ExitMarker)."""
    out = {}
    for name in sorted(final_state):
        arr = np.asarray(final_state[name]).astype(np.uint32, copy=False)
        out[name] = int(np.bitwise_xor.reduce(arr.reshape(-1) & 0xFFFFFFFF))
    return out
