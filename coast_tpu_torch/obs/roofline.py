"""Roofline / MFU accounting: analytic op counts + measured device time.

The port's counterpart of ``coast_tpu/obs/roofline.py``.  The reference
counts a jaxpr; the port's step is eager torch, so it counts the aten
operations of the graph capture (``analysis/lint/capture.py``), by the
reference's rules:

  * :func:`count_graph_ops` counts the arithmetic ops of captured trips:
    2mnk per matrix product (``mm``, ``bmm``, ``addmm``, ``mv``, ``dot``),
    one per output element for elementwise operators, one per input
    element for reductions; pure data movement (views, slices, copies,
    gathers, scatters, concatenation, dtype conversion) counts zero.  The
    port's step has no traced loop: each captured trip is one branch that
    ran, and a trip count prices the loop (see below).
  * Where the port spells a function with other operators than the
    reference's primitive, the count is the primitive's, so that a
    region's useful work does not depend on how it is lowered: the
    uint32 emulation costs nothing (``& 0xFFFFFFFF`` of an int64 value,
    and ``ops/u32``'s ``word``/``wide``; its shifts and compares count
    one op a word); an index helper of ``ops/indexing`` costs its
    negative wrap (three ops, as ``dynamic_slice``'s) while its clamp,
    its fill/drop bounds test and select cost nothing, as inside
    ``gather``/``scatter``; a two-sided ``clamp`` is ``jnp.clip``'s max
    and min; ``%`` is ``jnp.remainder``'s rem and sign fix-up.  Helpers
    declare their price with ``ops.voters.priced`` (the capture records
    it on their nodes).
  * The capture runs on the host, where the grouped voters (K1) and the
    fused commit (K2) run their plain versions as ordinary aten
    operations, so their per-element work is counted element for element
    -- a fused program is never undercounted by a kernel body counted
    once.
  * :func:`region_ops_per_run` is the USEFUL work of one fault-free run,
    a property of the region: the widest of the bare step's first trips
    (one image) x ``nominal_steps`` -- the MFU numerator, equal to the
    reference's wherever the two steps are the same function spelled
    the same way (``tests/test_torch_profiler.py`` pins the others with
    the construct that differs).  :func:`program_ops_per_run` counts the
    port's PROTECTED engine (lanes, voters, CFCSS, guards), the widest of
    its distinct captured trips x ``steps``; their ratio is
    :func:`flops_overhead`.  The reference's fused engine cuts that ratio
    by removing its unfused engine's dense full-state flip masks; the
    port's unfused engine writes a flip once at its fire step and never
    had those masks, so the port's fused cut is under 1 % (ROADMAP Queue
    C, C5 (ii)).
  * :func:`mfu_block` combines those counts with the profiler's measured
    device-busy seconds into the ``summary()["mfu"]`` block, with the
    reference's keys: achieved ops/s, achieved MFU against a resolved
    peak, the roofline ceiling of the voter-traffic model (state x lanes
    bytes per commit step over the card's memory rate), the voter bytes
    share and the dispatch-gap fraction.

Counts are ARITHMETIC ops, not IEEE FLOPs: the integer benchmarks do
integer work, and a consistent count is what an A/B needs.  The peak is
keyed on the card's name (:func:`resolve_peak`).
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Tuple

__all__ = ["count_graph_ops", "region_ops_per_run", "program_ops_per_run",
           "flops_overhead", "phase_split", "resolve_peak", "mfu_block",
           "region_state_bytes"]

#: One op per output element (aten operator names, in-place forms folded
#: onto their out-of-place name).
_ELEMENTWISE = frozenset((
    "add", "sub", "rsub", "mul", "div", "remainder", "fmod", "pow", "neg",
    "sign", "abs", "maximum", "minimum", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "bitwise_left_shift",
    "bitwise_right_shift", "__and__", "__or__", "__xor__", "__lshift__",
    "__rshift__", "logical_and", "logical_or", "logical_xor",
    "logical_not", "eq", "ne", "lt", "le", "gt", "ge", "where",
    "masked_fill", "clamp", "clamp_min", "clamp_max", "exp", "log",
    "log1p", "expm1", "tanh", "sigmoid", "erf", "erfc", "erfinv", "sin",
    "cos", "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh", "sqrt",
    "rsqrt", "reciprocal", "square", "floor", "ceil", "round", "trunc",
    "nextafter", "isfinite", "isnan", "floor_divide",
))

#: One op per INPUT element (the reduction tree).
_REDUCTIONS = frozenset((
    "sum", "prod", "amax", "amin", "any", "all", "argmax", "argmin",
    "cumsum", "cumprod", "cummax", "cummin", "logcumsumexp", "mean",
    "count_nonzero",
))

#: Matrix products: (operand index of the left matrix, of the right).
_PRODUCTS = {"mm": (0, 1), "bmm": (0, 1), "addmm": (1, 2),
             "baddbmm": (1, 2), "mv": (0, 1), "dot": (0, 1),
             "vdot": (0, 1)}

#: Trips a count captures at most: every distinct trip graph of the
#: registry's fault-free runs appears by then (``capture.MAX_TRIPS``).
COUNT_TRIPS = 8


def _numel(shape) -> int:
    return int(math.prod(int(d) for d in shape))


#: The uint32 word mask: on an int64 value it is the port's emulation of
#: the reference's wrapping uint32 arithmetic, which costs nothing there.
_MASK32 = 0xFFFFFFFF


def _node_ops(node, trip) -> float:
    """Arithmetic ops of one captured node of ``trip``."""
    import torch

    from coast_tpu_torch.analysis.lint.capture import Ref
    shapes = trip.shapes
    name = node.packet.rstrip("_") if node.packet.endswith("_") and \
        not node.packet.startswith("__") else node.packet
    out = _numel(node.out_shapes[0]) if node.out_shapes else 0
    if node.price is not None:
        # A ``voters.priced`` helper: its result at the reference's cost.
        return node.price * out
    if name in ("bitwise_and", "__and__") and len(node.args) == 2 and \
            _MASK32 in node.args and any(
                isinstance(a, Ref) and trip.dtypes.get(int(a))
                == torch.int64 for a in node.args):
        return 0.0
    if name == "clamp" and len(node.args) > 2 and \
            node.args[1] is not None and node.args[2] is not None:
        # Both bounds: the reference's ``jnp.clip``, a max and a min.
        return 2.0 * out
    if name == "remainder":
        # The reference's ``jnp.remainder``: the rem and its sign fix-up
        # (7 ops an element), then on the divisor's elements its sign
        # test and, for integers, the zero-divisor guard (a compare and a
        # select).
        div = node.args[1] if len(node.args) > 1 else None
        div_n = _numel(shapes[int(div)]) if isinstance(div, Ref) else 1
        first = node.args[0] if node.args else None
        integer = (isinstance(first, Ref) and not trip.dtypes.get(
            int(first), torch.int64).is_floating_point)
        return 7.0 * out + (3.0 if integer else 1.0) * div_n
    if name in _PRODUCTS:
        li, _ri = _PRODUCTS[name]
        lhs = node.args[li] if len(node.args) > li else None
        if not isinstance(lhs, Ref):
            return 0.0
        k = int(shapes[int(lhs)][-1]) if shapes[int(lhs)] else 1
        total = 2.0 * k * max(out, 1)
        if name in ("addmm", "baddbmm"):
            total += out
        return total
    if name in ("max", "min"):
        # Binary max/min is elementwise; the others reduce.
        if node.op.endswith((".other", ".Tensor")) or (
                len(node.args) > 1 and isinstance(node.args[1], Ref)):
            return float(out)
        name = "amax"
    if name in _ELEMENTWISE:
        return float(out)
    if name in _REDUCTIONS:
        first = node.args[0] if node.args else None
        return (float(_numel(shapes[int(first)]))
                if isinstance(first, Ref) else 0.0)
    return 0.0


def count_graph_ops(trips, while_trip: int = 1) -> float:
    """Arithmetic ops of captured trips (see module docstring).

    ``trips`` is one :class:`~coast_tpu_torch.analysis.lint.capture.Trip`
    or a sequence of them: the distinct branches one loop body took.  The
    loop is priced at ``while_trip`` iterations of its widest trip, as
    the reference prices a ``while`` by its trip count and a ``cond`` by
    its widest branch."""
    if not isinstance(trips, (list, tuple)):
        trips = [trips]
    widest = 0.0
    for trip in trips:
        widest = max(widest, sum(_node_ops(n, trip) for n in trip.nodes))
    return widest * max(1, int(while_trip))


def _image(region) -> Dict[str, object]:
    import torch
    return {k: v.cpu() for k, v in region.init(torch.device("cpu")).items()}


def region_ops_per_run(region) -> float:
    """Useful arithmetic ops of one fault-free run: the widest of the
    unprotected step's first trips, on one image, x ``nominal_steps``.
    The MFU numerator."""
    import torch

    from coast_tpu_torch.analysis.lint.capture import capture_fn
    rows = {k: v.expand(1, *v.shape).clone()
            for k, v in _image(region).items()}
    step = region.bound_step()
    trips = []
    with torch.no_grad():
        for t in range(min(COUNT_TRIPS, max(1, region.nominal_steps))):
            trips.append(capture_fn(step, rows, t))
            rows = {**rows, **step(dict(rows), t)}
            if bool(region.done(rows).all()):
                break
    return count_graph_ops(trips, region.nominal_steps)


def program_ops_per_run(prog, steps: Optional[int] = None) -> float:
    """Arithmetic ops of one PROTECTED run (lanes + voters + signatures +
    guards): the widest of the program's distinct captured trips on one
    row, priced at ``steps`` trips (default the region's
    ``nominal_steps``, what a fault-free run executes)."""
    from coast_tpu_torch.analysis.lint.capture import capture_run
    trip = int(steps) if steps is not None else prog.region.nominal_steps
    return count_graph_ops(capture_run(prog, batch=1,
                                       max_trips=COUNT_TRIPS), trip)


def flops_overhead(prog) -> float:
    """Protected / unprotected op ratio, from the captured graphs."""
    useful = region_ops_per_run(prog.region)
    return program_ops_per_run(prog) / useful if useful else float("nan")


def region_state_bytes(region) -> int:
    """Per-lane persistent state footprint from the region's own init
    shapes."""
    return int(sum(v.numel() * v.element_size()
                   for v in _image(region).values()))


def phase_split(region) -> List[Tuple[str, float]]:
    """The protected-region phases and their analytic work shares, for
    attributing measured device time: train regions split fwd/bwd/commit
    by their ``meta`` FLOPs table; every other region gets one ``step``
    span covering the whole dispatch."""
    flops = ((region.meta or {}).get("train") or {}).get("flops")
    if flops:
        total = float(flops["fwd"] + flops["bwd"] + flops["update"]) or 1.0
        return [("fwd", flops["fwd"] / total),
                ("bwd", flops["bwd"] / total),
                ("commit", flops["update"] / total)]
    return [("step", 1.0)]


#: Known per-card peaks (GFLOP/s, source), keyed on
#: ``torch.cuda.get_device_name()``: the H100 SXM5's published dense
#: BF16 tensor-core peak.  The CPU has no honest published peak, so MFU
#: stays None there unless the operator pins one (COAST_PEAK_GFLOPS, or
#: the profile CLI's --peak-gflops).
_DEVICE_PEAK_GFLOPS = {
    "NVIDIA H100 80GB HBM3": (989_400.0,
                              "H100 SXM5 dense BF16, NVIDIA data sheet"),
}

#: H100 SXM5 memory rate (GB/s), the roofline's byte axis (the bytes
#: bound of the port's kernel table).
DEFAULT_HBM_GBPS = 3350.0


def _backend(prog=None) -> str:
    """``"gpu"`` for a program (or, with none, a process) on the card,
    else ``"cpu"`` -- what ``jax.default_backend()`` says in the
    reference."""
    import torch
    if prog is not None:
        return "gpu" if prog.device.type == "cuda" else "cpu"
    return "gpu" if torch.cuda.is_available() else "cpu"


def resolve_peak(backend: Optional[str] = None,
                 peak_gflops: Optional[float] = None
                 ) -> Tuple[Optional[float], str]:
    """(peak FLOP/s or None, source tag).  Priority: explicit argument >
    COAST_PEAK_GFLOPS env > the card table.  ``backend`` is ``"cpu"``,
    ``"gpu"`` (the current card) or a card's name; None reads the
    current card when there is one."""
    if peak_gflops:
        return float(peak_gflops) * 1e9, "explicit"
    env = os.environ.get("COAST_PEAK_GFLOPS")
    if env:
        return float(env) * 1e9, "env:COAST_PEAK_GFLOPS"
    name = backend
    if name is None:
        name = _backend()
    if name == "gpu":
        import torch
        name = torch.cuda.get_device_name()
    row = _DEVICE_PEAK_GFLOPS.get(name)
    if row is None:
        return None, f"unknown device {name!r}"
    return row[0] * 1e9, f"{name}: {row[1]}"


def mfu_block(prog, runs: int, device_busy_s: float, wall_s: float,
              dispatch_gap_fraction: float,
              peak_gflops: Optional[float] = None,
              hbm_gbps: float = DEFAULT_HBM_GBPS,
              ops: Optional[Dict[str, float]] = None) -> Dict[str, object]:
    """The ``summary()["mfu"]`` block: analytic ops + measured device
    time -> achieved vs roofline-predicted MFU, with the reference's
    keys.  ``ops`` optionally carries pre-computed ``{"useful",
    "program"}`` per-run counts (the profiler caches them); ``runs`` is
    the number of rows the measured ``device_busy_s`` covers."""
    region = prog.region
    if ops is None:
        ops = {"useful": region_ops_per_run(region),
               "program": program_ops_per_run(prog)}
    useful = float(ops["useful"])
    program = float(ops["program"])
    backend = _backend(prog)
    peak, peak_source = resolve_peak(backend, peak_gflops=peak_gflops)
    lanes = int(prog.cfg.num_clones)
    state_bytes = region_state_bytes(region)
    # The voter-traffic model: per commit step the voter moves
    # O(state x lanes) bytes while the step does the useful ops -- one
    # vote a step plus the boundary sync.
    voter_bytes = float(lanes * state_bytes * (region.nominal_steps + 1))
    out: Dict[str, object] = {
        "useful_ops_per_run": round(useful, 1),
        "program_ops_per_run": round(program, 1),
        "flops_overhead": round(program / useful, 4) if useful else None,
        "runs": int(runs),
        "device_busy_s": round(device_busy_s, 6),
        "dispatch_gap_fraction": round(dispatch_gap_fraction, 6),
        "state_bytes": state_bytes,
        "lanes": lanes,
        "voter_bytes_per_run": voter_bytes,
        "hbm_gbps": hbm_gbps,
        "backend": backend,
        "peak_source": peak_source,
    }
    achieved = (useful * runs / device_busy_s) if device_busy_s > 0 else 0.0
    wall_rate = (useful * runs / wall_s) if wall_s > 0 else 0.0
    out["achieved_ops_per_s"] = round(achieved, 1)
    out["achieved_ops_per_s_wall"] = round(wall_rate, 1)
    if peak:
        out["peak_gflops"] = peak / 1e9
        out["achieved_mfu"] = round(achieved / peak, 8)
        out["achieved_mfu_wall"] = round(wall_rate / peak, 8)
        # Roofline ceiling: useful-op time vs voter memory time.
        t_flops = useful / peak
        t_bytes = voter_bytes / (hbm_gbps * 1e9)
        denom = t_flops + t_bytes
        out["roofline_mfu"] = round(t_flops / denom, 8) if denom else None
        out["voter_bytes_share"] = (round(t_bytes / denom, 6)
                                    if denom else None)
    else:
        out["peak_gflops"] = None
        out["achieved_mfu"] = None
        out["roofline_mfu"] = None
        out["voter_bytes_share"] = None
    return out


def ops_by_operator(trip) -> Dict[str, float]:
    """Arithmetic ops of one captured trip, summed per aten overload
    (operators that count nothing left out)."""
    out: Dict[str, float] = {}
    for node in trip.nodes:
        ops = _node_ops(node, trip)
        if ops:
            out[node.op] = out.get(node.op, 0.0) + ops
    return dict(sorted(out.items()))


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m coast_tpu_torch.obs.roofline NAME...``: per registry
    name, the useful and TMR program ops a run and the bare step's first
    trip summed per operator, on the CPU capture."""
    import argparse
    import json

    import torch

    from coast_tpu_torch.analysis.lint.capture import capture_fn
    from coast_tpu_torch.models import REGISTRY
    from coast_tpu_torch.passes.strategies import TMR
    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("names", nargs="+", choices=sorted(REGISTRY),
                        metavar="NAME")
    args = parser.parse_args(argv)
    for name in args.names:
        region = REGISTRY[name]()
        rows = {k: v.expand(1, *v.shape).clone()
                for k, v in _image(region).items()}
        with torch.no_grad():
            trip = capture_fn(region.bound_step(), rows, 0)
        print(json.dumps({
            "name": name, "useful_ops_per_run": region_ops_per_run(region),
            "program_ops_per_run": program_ops_per_run(
                TMR(region, device="cpu")),
            "first_trip_ops": ops_by_operator(trip)}))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
