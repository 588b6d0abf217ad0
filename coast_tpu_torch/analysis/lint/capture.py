"""The graph capture of the protected step: the port's ``trace_step``.

The reference walks a ``jax.make_jaxpr`` of ``prog.step``.  The port's step
is eager torch with host-side branches (the halted test, the fire plan,
Python phase gates), so it cannot be traced once into one graph.  Instead
a :class:`~torch.utils._python_dispatch.TorchDispatchMode` records the aten
operations of one fault-free run's trips on the CPU, where the plain
versions of K1 and K2 run.  Each trip is a :class:`Trip`: its nodes in SSA
form, every node with its input and output values and their shapes.  The
union over a run's trips plays the role of the jaxpr's ``cond`` and
``select`` branches: each trip is the branch that ran.

In-place operations (``index_put_``, ``copy_``, ``scatter_``) write a new
version of their target, and a write through a view makes every other
tensor on that storage a new version too: values are keyed by the tensor
and its version counter, and a tensor whose counter moved past the value
it was recorded with reads as an ``alias_update`` of its old value and the
writes to its storage since (:meth:`_Recorder.value_of`).

The lint tags (``ops/voters.tag``) are the ``coast_lint::tag`` operator,
registered here and reached only while a capture records; a capture on a
CUDA tensor raises, since it is a CPU activity.  A program built on the
card is captured with its device set to the CPU for the duration
(:func:`on_cpu`): the plain versions compute what K1 and K2 compute.

:func:`capture_run` captures a protected program's trips,
:func:`capture_fn` one call of a bare region step (the derived dataflow of
``passes/verification.py``), and :func:`format_trip` prints a trip for
``opt -dumpModule``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from coast_tpu_torch.ops import voters

_LIB: Optional[torch.library.Library] = None

#: Operators whose value is their shape alone (and an in-place fill's
#: constant): they carry no provenance from their operand.
SHAPE_ONLY = ("zeros_like", "ones_like", "empty_like", "full_like",
              "new_zeros", "new_ones", "new_empty", "new_full", "fill",
              "fill_", "zero", "zero_", "rand_like", "randn_like",
              "randint_like")

#: The batch a capture runs: two rows, so the lane axis (size n) and the
#: merged row axis of the interleaved step (size 2n) differ from the
#: batch axis.
BATCH = 2


def _register() -> None:
    """Define ``coast_lint::tag(Tensor x, str name) -> Tensor`` (an
    identity copy on the CPU) once a process.  (The reference's
    primitive is ``name``; on a torch namespace that word is taken.)"""
    global _LIB
    if _LIB is not None:
        return
    lib = torch.library.Library("coast_lint", "DEF")
    lib.define("tag(Tensor x, str name) -> Tensor")
    lib.impl("tag", lambda x, name: x.clone(), "CPU")
    # Under vmap (a lifted step's replay) the tag marks the batched
    # value as it is.
    torch.library.register_vmap(
        "coast_lint::tag",
        lambda info, in_dims, x, name: (torch.ops.coast_lint.tag(x, name),
                                        in_dims[0]), lib=lib)
    _LIB = lib


class Ref(int):
    """A tensor argument of a node: the SSA id of its value."""

    def __repr__(self) -> str:
        return f"%{int(self)}"


@dataclasses.dataclass
class Node:
    """One recorded operation."""

    op: str                     # overload name, e.g. "aten.sum.dim_IntList"
    packet: str                 # the operator, e.g. "sum"
    args: tuple                 # positional args, tensors as Ref
    kwargs: dict
    ins: List[int]              # input values, in argument order
    outs: List[int]             # output values
    out_shapes: List[Tuple[int, ...]]
    mutates: bool = False       # an in-place op (its first out is the
    #                             target's new version)
    # Arithmetic ops per output element set by a ``voters.priced`` helper
    # (its result's node carries the helper's price, every other node it
    # dispatched 0); None: the roofline prices the operator itself.
    price: Optional[float] = None

    @property
    def tag(self) -> Optional[str]:
        return self.args[1] if self.op == "coast_lint.tag.default" else None


@dataclasses.dataclass
class Trip:
    """One step call: its nodes, and the values of its inputs and outputs
    (state leaves and flags by name)."""

    t: int
    nodes: List[Node]
    shapes: Dict[int, Tuple[int, ...]]
    state_in: Dict[str, int]
    flags_in: Dict[str, int]
    state_out: Dict[str, int]
    flags_out: Dict[str, int]
    # The dtype of every value (the lifter's join of same-signature
    # selects reads it).
    dtypes: Dict[int, torch.dtype] = dataclasses.field(default_factory=dict)

    def signature(self) -> tuple:
        """Trips with equal signatures are the same graph."""
        return tuple((n.op, repr(n.args), repr(n.kwargs), tuple(n.outs))
                     for n in self.nodes) + (
            tuple(sorted(self.state_out.items())),
            tuple(sorted(self.flags_out.items())))


@dataclasses.dataclass
class _Entry:
    vid: int
    version: int
    seq: int


class _Recorder(TorchDispatchMode):
    """Records every dispatched operation of one trip into SSA nodes."""

    def __init__(self):
        super().__init__()
        self.nodes: List[Node] = []
        self.shapes: Dict[int, Tuple[int, ...]] = {}
        self.dtypes: Dict[int, torch.dtype] = {}
        self._ids: Dict[int, _Entry] = {}
        self._keep: List[torch.Tensor] = []   # no id() reuse in a trip
        self._events: Dict[int, List[Tuple[int, int]]] = {}
        self._seq = 0
        self._next = 0

    def _fresh(self, t: torch.Tensor) -> int:
        vid = self._next
        self._next += 1
        self.shapes[vid] = tuple(t.shape)
        self.dtypes[vid] = t.dtype
        return vid

    def _bind(self, t: torch.Tensor, vid: int) -> None:
        self._keep.append(t)
        self._ids[id(t)] = _Entry(vid, t._version, self._seq)

    @staticmethod
    def _storage(t: torch.Tensor) -> int:
        try:
            return t.untyped_storage().data_ptr()
        except RuntimeError:
            return -1

    def bind_input(self, t: torch.Tensor) -> int:
        vid = self._fresh(t)
        self._bind(t, vid)
        return vid

    def value_of(self, t: torch.Tensor) -> int:
        """The SSA value ``t`` holds now (a fresh constant for a tensor
        made outside the capture)."""
        entry = self._ids.get(id(t))
        if entry is None:
            vid = self._fresh(t)
            self._bind(t, vid)
            return vid
        if entry.version == t._version:
            return entry.vid
        # Written through an alias since it was recorded: its new value
        # joins the old one and every write to its storage since.
        writes = [v for seq, v in self._events.get(self._storage(t), ())
                  if seq > entry.seq]
        vid = self._fresh(t)
        self.nodes.append(Node("alias_update", "alias_update",
                               (Ref(entry.vid), *map(Ref, writes)), {},
                               [entry.vid, *writes], [vid],
                               [tuple(t.shape)]))
        self._bind(t, vid)
        return vid

    def _ref(self, x, ins: List[int]):
        """``x`` with every tensor in it replaced by its value's Ref (and
        the value appended to ``ins``)."""
        if isinstance(x, torch.Tensor):
            if x.device.type != "cpu":
                raise RuntimeError(
                    "a lint capture records CPU tensors only; met a tensor "
                    f"on {x.device}")
            vid = self.value_of(x)
            ins.append(vid)
            return Ref(vid)
        if isinstance(x, (list, tuple)):
            return type(x)(self._ref(a, ins) for a in x)
        return x

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins: List[int] = []
        ref_args = tuple(self._ref(a, ins) for a in args)
        ref_kwargs = {k: self._ref(v, ins) for k, v in kwargs.items()}
        # The tensors the op writes (schema alias info).
        written = []
        for i, arg in enumerate(func._schema.arguments):
            info = arg.alias_info
            if info is None or not info.is_write:
                continue
            val = args[i] if i < len(args) else kwargs.get(arg.name)
            if isinstance(val, torch.Tensor):
                written.append(val)
        out = func(*args, **kwargs)
        outs, shapes = [], []
        new_written = {}
        for w in written:
            vid = self._fresh(w)
            new_written[id(w)] = vid
            outs.append(vid)
            shapes.append(tuple(w.shape))
        for x in (out if isinstance(out, (list, tuple)) else (out,)):
            if not isinstance(x, torch.Tensor) or id(x) in new_written:
                continue
            vid = self._fresh(x)
            outs.append(vid)
            shapes.append(tuple(x.shape))
            self._bind(x, vid)
        name = func.name() if hasattr(func, "name") else str(func)
        packet = name.split("::", 1)[-1].split(".", 1)[0]
        op = str(func).replace("::", ".")
        self.nodes.append(Node(op, packet, ref_args, ref_kwargs, ins, outs,
                               shapes, mutates=bool(written)))
        self._seq += 1
        for w in written:
            self._bind(w, new_written[id(w)])
            self._events.setdefault(self._storage(w), []).append(
                (self._seq, new_written[id(w)]))
        return out

    # -- voters.priced scopes -------------------------------------------------
    def price_begin(self) -> int:
        return len(self.nodes)

    def price_end(self, mark: int, per_element: float, out) -> None:
        """Price the nodes a helper dispatched since ``mark``: the node
        that made its result at ``per_element``, the others at 0 (an
        enclosing scope overrides an inner one)."""
        entry = (self._ids.get(id(out)) if isinstance(out, torch.Tensor)
                 else None)
        for node in self.nodes[mark:]:
            node.price = (float(per_element)
                          if entry is not None and entry.vid in node.outs
                          else 0.0)


@contextlib.contextmanager
def recording():
    """Tags active and every dispatched operation recorded."""
    _register()
    rec = _Recorder()
    voters.CAPTURE = True
    voters.PRICE_HOOK = rec
    try:
        with rec:
            yield rec
    finally:
        voters.CAPTURE = False
        voters.PRICE_HOOK = None


@contextlib.contextmanager
def on_cpu(prog):
    """A program built on the card, captured on the CPU: its device set to
    the CPU for the duration (the plain voters compute what K1 and K2
    compute)."""
    saved = prog.device
    prog.device = torch.device("cpu")
    try:
        yield prog
    finally:
        prog.device = saved


def capture_step(step, pstate: Mapping[str, torch.Tensor],
                 flags: Mapping[str, torch.Tensor], t: int):
    """Record one ``step(pstate, flags, t)`` -> ``(trip, new pstate, new
    flags)``."""
    with recording() as rec:
        state_in = {k: rec.bind_input(v) for k, v in pstate.items()}
        flags_in = {k: rec.bind_input(v) for k, v in flags.items()}
        new_state, new_flags = step(dict(pstate), dict(flags), t)
        state_out = {k: rec.value_of(v) for k, v in new_state.items()}
        flags_out = {k: rec.value_of(v) for k, v in new_flags.items()}
    trip = Trip(t, rec.nodes, rec.shapes, state_in, flags_in, state_out,
                flags_out, rec.dtypes)
    return trip, new_state, new_flags


#: Trips a capture records.  A trip's graph changes with ``t`` only
#: through Python phase gates; over the registry's 36 regions every
#: distinct graph of a whole fault-free run first appears by trip 2 (simd's
#: trips differ only in the constant offsets ``t`` picks), so eight trips
#: hold every branch a run takes.
MAX_TRIPS = 8


def capture_run(prog, batch: int = BATCH,
                max_trips: int = MAX_TRIPS) -> List[Trip]:
    """The distinct trips among the first ``max_trips`` of one fault-free
    run of ``prog`` on the CPU (fewer when every row halts first); a trip
    equal to an earlier one is kept once."""
    with on_cpu(prog), torch.no_grad():
        pstate, flags = prog.init_pstate(batch)
        trips: List[Trip] = []
        seen = set()
        limit = min(prog.region.max_steps, max_trips)
        for t in range(limit):
            trip, pstate, flags = capture_step(prog.step, pstate, flags, t)
            sig = trip.signature()
            if sig not in seen:
                seen.add(sig)
                trips.append(trip)
            if bool(prog._halted(flags).all()):
                break
    return trips


def capture_fn(fn, state: Mapping[str, torch.Tensor], t: int = 0) -> Trip:
    """One call ``fn(state, t)`` of a bare region step (its outputs the
    leaves it returns), recorded."""
    with torch.no_grad(), recording() as rec:
        state_in = {k: rec.bind_input(v) for k, v in state.items()}
        out = fn(dict(state), t)
        state_out = {k: rec.value_of(v) for k, v in out.items()}
    return Trip(t, rec.nodes, rec.shapes, state_in, {}, state_out, {},
                rec.dtypes)


def format_trip(trip: Trip) -> str:
    """A trip as text: one line a node, ``%out = op(args)``, in the order
    the operations ran (the port's ``-dumpModule`` listing)."""
    names = {v: f"state.{k}" for k, v in trip.state_in.items()}
    names.update({v: f"flags.{k}" for k, v in trip.flags_in.items()})
    lines = [f"trip t={trip.t}: "
             f"{len(trip.nodes)} operation(s) -- inputs "
             + ", ".join(f"%{v}={n}" for v, n in sorted(names.items()))]
    for node in trip.nodes:
        outs = ", ".join(f"%{v}:{list(s)}"
                         for v, s in zip(node.outs, node.out_shapes))
        args = ", ".join(repr(a) for a in node.args)
        if node.kwargs:
            args += ", " + ", ".join(f"{k}={v!r}"
                                     for k, v in node.kwargs.items())
        lines.append(f"  {outs or '()'} = {node.op}({args})")
    outs = [f"state.{k}=%{v}" for k, v in sorted(trip.state_out.items())]
    outs += [f"flags.{k}=%{v}" for k, v in sorted(trip.flags_out.items())]
    lines.append("  return " + ", ".join(outs))
    return "\n".join(lines)


class _Stream(TorchDispatchMode):
    """Appends each dispatched operation (name, output shapes) to a list."""

    def __init__(self, lines: list):
        super().__init__()
        self.lines = lines

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (list, tuple)) else (out,)
        self.lines.append((str(func).replace("::", "."),
                           [tuple(x.shape) for x in outs
                            if isinstance(x, torch.Tensor)]))
        return out


def dispatch_stream(prog) -> str:
    """The operation stream one trip (t=0, one row) dispatches on the
    program's device: every aten operation with its output shapes, and
    every grouped voter call (K1 or K2 on the card, their plain versions
    on the CPU) with its site records -- the closest the port has to the
    reference's compiled module (``opt -dumpModule=hlo``)."""
    pstate, flags = prog.init_pstate(1)
    lines: list = []
    voters.STREAM = lines
    try:
        with torch.no_grad(), _Stream(lines):
            prog.step(pstate, flags, 0)
    finally:
        voters.STREAM = None
    plain = prog.device.type == "cpu"
    n_ops = sum(1 for x in lines if not x[0] in ("K1", "K2"))
    n_calls = len(lines) - n_ops
    out = [f"dispatch stream of one trip (t=0, one row) of "
           f"{prog.region.name} [N={prog.cfg.num_clones}] on {prog.device}:"
           f" {n_ops} aten operation(s), {n_calls} voter call(s)"]
    for name, shapes in lines:
        if name in ("K1", "K2"):
            what = (f"{name} plain version ({'vote_sites' if name == 'K1' else 'plain_commit_sites'})"
                    if plain else f"{name} launch")
            out.append(f"  {what}: {len(shapes)} site record(s) "
                       + ", ".join(f"{list(s)} {d}" for s, d in shapes))
        else:
            out.append(f"  {name} -> {[list(s) for s in shapes]}")
    return "\n".join(out)
