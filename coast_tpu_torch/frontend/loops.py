"""Loop combinators with ``jax.lax``'s signatures, and the recorder that
lets ``lift_fn`` find a torch function's top-level loops.

Torch has no jaxpr: an eager function cannot be traced once into a graph
whose ``scan`` / ``while`` equations mark its loops.  So the port's user
writes a main loop with :func:`scan` or :func:`while_loop` (the
signatures and semantics of ``jax.lax.scan`` / ``jax.lax.while_loop``).
Outside a lift they are plain eager loops.  Inside ``lift_fn`` (a
:class:`Recording` is active) a call at depth 0 records one phase of the
program:

  * the operations before, between and after such calls are recorded on
    the main :class:`Tape` as SSA segments (aten operations with their
    input and output values), the code the lifted step replays;
  * the loop's body (and a ``while``'s condition) is recorded once on a
    tape of its own, over fresh copies of its carries and its first
    scanned row, then the recorded body is replayed on one row to the
    loop's end (so the function goes on with real values, and its
    Python runs once however many trips the loop takes);
  * the tensors the body reads that are neither a carry nor a scanned
    input are its captures: ``jax.lax`` closure-converts them into the
    loop's leading ``consts``, in first-use order, and so does this
    module.  A 0-d tensor made outside the function is a literal (JAX
    inlines scalar constants), not a capture.

A ``while_loop`` met while a body is recorded (a nested loop whose trip
count is data) is one :class:`LoopOp` of that body's tape: its condition
and body recorded on tapes of their own.  It cannot run under ``vmap``, so
:meth:`Program.rows` cuts the body's operations at it: the straight runs
go under ``vmap``, the loop runs over the explicit row axis with JAX's
batched-``while`` rule (every row steps while any row's condition holds,
one host read an iteration; a finished row keeps its carry).  A nested
``scan`` is unrolled on the tape.  A recorded body is simplified for its
replay: operations on constants alone are folded into constants, and an
operation that repeats an earlier one reads the earlier one's value.

The two forwarding rules of ``jax.lax`` are kept, because they decide the
reference's leaf layout: a carry the body returns unchanged moves to the
front of the consts (for ``while_loop`` only when the condition does not
read it), and a stacked output that is a scanned input unchanged is the
input itself.  Values are tensors or pytrees of them (tuples, lists,
dicts, whose keys are taken in sorted order as JAX does, and ``None``).
A Python number in a carry becomes a 0-d int32 / float32 tensor.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from coast_tpu_torch.ops import voters
from coast_tpu_torch.ops.indexing import clamp_index

# ---------------------------------------------------------------------------
# pytrees (JAX's order: dict keys sorted)
# ---------------------------------------------------------------------------


def flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; ``treedef`` rebuilds the tree (:func:`unflatten`).

    An object with ``tree_flatten()`` -> ``(children, aux)`` and a
    classmethod ``tree_unflatten(aux, children)`` is a node, as a
    registered pytree class is in JAX (the C front end's words and 64-bit
    limb pairs)."""
    if tree is None:
        return [], None
    if hasattr(tree, "tree_flatten") and not isinstance(tree, type):
        children, aux = tree.tree_flatten()
        leaves, d = flatten(tuple(children))
        return leaves, ("node", type(tree), aux, d)
    if isinstance(tree, (tuple, list)):
        leaves, defs = [], []
        for x in tree:
            sub, d = flatten(x)
            leaves += sub
            defs.append((len(sub), d))
        return leaves, (type(tree), defs)
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, defs = [], []
        for k in keys:
            sub, d = flatten(tree[k])
            leaves += sub
            defs.append((len(sub), d))
        return leaves, (dict, list(zip(keys, defs)))
    return [tree], "leaf"


def unflatten(treedef, leaves: List[Any]):
    if treedef is None:
        return None
    if treedef == "leaf":
        return leaves[0]
    if treedef[0] == "node":
        _, cls, aux, d = treedef
        return cls.tree_unflatten(aux, unflatten(d, leaves))
    kind, defs = treedef
    out, at = [], 0
    if kind is dict:
        res = {}
        for k, (n, d) in defs:
            res[k] = unflatten(d, leaves[at:at + n])
            at += n
        return res
    for n, d in defs:
        out.append(unflatten(d, leaves[at:at + n]))
        at += n
    return kind(out) if kind is tuple else out


def as_word(x) -> torch.Tensor:
    """A loop value as a tensor: a Python int is int32, a float float32."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, bool):
        return torch.tensor(x)
    if isinstance(x, int):
        return torch.tensor(x, dtype=torch.int32)
    if isinstance(x, float):
        return torch.tensor(x, dtype=torch.float32)
    raise TypeError(f"loop values must be tensors (got {type(x).__name__})")


# ---------------------------------------------------------------------------
# the tape: replayable SSA recording of aten operations
# ---------------------------------------------------------------------------


class Ref(int):
    """A tensor argument of a recorded operation: its value's id."""

    def __repr__(self) -> str:
        return f"%{int(self)}"


class ScalarRef(Ref):
    """An index argument that was a 0-d tensor read as a Python int
    (``x[i]``): the replay indexes with the tensor itself, so each row
    reads at its own index."""


@dataclasses.dataclass
class Op:
    """One recorded operation.  ``outs[j]`` came from ``where[j]``:
    ``("w", key)`` the argument ``key`` (position or name) it wrote in
    place, ``("r", k)`` its ``k``-th returned tensor."""

    func: Any
    packet: str
    args: tuple
    kwargs: dict
    ins: List[int]
    outs: List[int]
    where: List[tuple]


@dataclasses.dataclass
class LoopOp(Op):
    """A data-dependent ``while_loop`` met while a loop body was being
    recorded: one operation of that body's tape.  ``ins`` are the
    condition's captures (``n_cond``), the body's captures (``n_body``)
    and the carries; ``outs`` the final carries.  ``cond`` and ``body``
    are :class:`Program` over (captures, carries).  It cannot run under
    ``vmap`` (its trip count is data): :meth:`Program.rows` runs it over
    the explicit row axis, as JAX runs a batched ``while``."""

    cond: Any = None
    body: Any = None
    n_cond: int = 0
    n_body: int = 0

    def run_rows(self, vals: List[torch.Tensor], batch: int,
                 device: torch.device) -> List[torch.Tensor]:
        """JAX's batched ``while``: every row steps while any row's
        condition holds; a row whose condition failed keeps its carry."""
        cc = vals[:self.n_cond]
        bc = vals[self.n_cond:self.n_cond + self.n_body]
        carry = list(vals[self.n_cond + self.n_body:])
        (active,) = self.cond.rows(cc + carry, batch, device)
        while bool(active.any()):
            # The condition decides the trip count: a branch predicate of
            # the step, as the reference's dataflow reads a while.
            voters.tag(active, "coast:branch_pred")
            new = self.body.rows(bc + carry, batch, device)
            carry = [select_rows(active, n, c) for n, c in zip(new, carry)]
            (active,) = self.cond.rows(cc + carry, batch, device)
        return carry


def select_rows(pred: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """``a`` where ``pred`` holds (one flag a leading row, or a 0-d flag),
    else ``b``.  Integer words take a bitwise select, so the dataflow
    reads it as data through the mask (the branch role is a separate
    tag), not as one more ``where`` joined with the program's own."""
    m = pred.reshape(tuple(pred.shape) + (1,) * (a.dim() - pred.dim()))
    if a.dtype in (torch.int32, torch.int64):
        return b ^ ((a ^ b) & -m.to(a.dtype))
    return torch.where(m, a, b)


def mark(x: torch.Tensor, name: str) -> None:
    """Record a lint tag of ``x`` on the tape recording now: the replay
    calls ``voters.tag`` (an identity unless a lint capture records), so
    a captured step shows ``x`` in the role ``name``."""
    rec = _ACTIVE
    if rec is None:
        return
    tape = rec.tape if rec.depth == 0 else rec.recording_tape()
    if tape is None or tape.paused:
        return
    vid = tape.value_of(x)
    tape.ops.append(Op(func=functools.partial(_tag_value, name=name),
                       packet="coast_tag", args=(Ref(vid),), kwargs={},
                       ins=[vid], outs=[], where=[]))


def unliteral(t: torch.Tensor) -> None:
    """``t``, just made by an operation on the tape recording now, is a
    traced value, not a literal, even when all it read were literals: as
    an equation's output is in a jaxpr (the C front end's arrays, whose
    constants alone are concrete)."""
    rec = _ACTIVE
    if rec is None:
        return
    tape = rec.tape if rec.depth == 0 else rec.recording_tape()
    if tape is None or tape.paused:
        return
    vid = tape.known(t)
    if vid is not None and vid not in tape.consts:
        tape.literal.discard(vid)


def count_eqns(n: int) -> None:
    """Note that the code recorded next is ``n`` equations of the
    reference's jaxpr (read where the lift weighs an epilogue)."""
    rec = _ACTIVE
    if rec is None or rec.depth or rec.tape.paused or not n:
        return
    rec.tape.eqns.append((len(rec.tape.ops), n))


def _tag_value(x: torch.Tensor, name: str) -> None:
    voters.tag(x, name)


class Tape(TorchDispatchMode):
    """Records every dispatched operation as an :class:`Op`.

    A tensor first met as an operand (made before the recording, or by
    code the tape does not see) is a constant: its value id is in
    :attr:`consts` with the tensor.  :attr:`val` keeps each value as
    recorded (a value an in-place operation overwrites later is kept as a
    copy), the lift-time values of the prologue."""

    def __init__(self):
        super().__init__()
        self.ops: List[Op] = []
        self.shape: Dict[int, Tuple[int, ...]] = {}
        self.dtype: Dict[int, torch.dtype] = {}
        self.val: Dict[int, torch.Tensor] = {}
        self.consts: Dict[int, torch.Tensor] = {}
        # Values JAX would hold as literals: 0-d tensors made outside the
        # function, and 0-d results of operations on literals alone.
        self.literal: set = set()
        # A loop's result for a carry it hands back unchanged whose input
        # was a literal: a value of its own (as the loop's output is in
        # the reference), whose constant value the replay bakes.
        self.fixed: Dict[int, torch.Tensor] = {}
        # (op position, equations): the reference's equation count of the
        # code recorded from that position (the C front end's arrays say
        # what each of their operations is in the reference's jaxpr).
        self.eqns: List[Tuple[int, int]] = []
        self.paused = False
        self._scalar: Optional[Tuple[int, int]] = None
        self._ids: Dict[int, int] = {}
        self._keep: List[torch.Tensor] = []
        self._next = 0

    def fresh(self, t: torch.Tensor) -> int:
        vid = self._next
        self._next += 1
        self.shape[vid] = tuple(t.shape)
        self.dtype[vid] = t.dtype
        self.val[vid] = t
        self._ids[id(t)] = vid
        self._keep.append(t)
        return vid

    def bind_input(self, t: torch.Tensor) -> int:
        return self.fresh(t)

    def known(self, t: torch.Tensor) -> Optional[int]:
        return self._ids.get(id(t))

    def value_of(self, t: torch.Tensor) -> int:
        vid = self._ids.get(id(t))
        if vid is None:
            vid = self.fresh(t)
            self.consts[vid] = t
            if t.dim() == 0:
                self.literal.add(vid)
        return vid

    def _ref(self, x, ins: List[int]):
        if isinstance(x, torch.Tensor):
            vid = self.value_of(x)
            ins.append(vid)
            return Ref(vid)
        if isinstance(x, (list, tuple)):
            return type(x)(self._ref(a, ins) for a in x)
        return x

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.paused:
            return func(*args, **kwargs)
        ins: List[int] = []
        ref_args = tuple(self._ref(a, ins) for a in args)
        ref_kwargs = {k: self._ref(v, ins) for k, v in kwargs.items()}
        scalar, self._scalar = self._scalar, None
        if scalar is not None:
            if not (func is torch.ops.aten.select.int and len(args) == 3
                    and args[2] == scalar[0]):
                raise_scalar_read()
            # ``x[i]`` with a 0-d tensor ``i``: torch read ``i`` as an int
            # just before (``_local_scalar_dense``); keep the tensor.
            ref_args = ref_args[:2] + (ScalarRef(scalar[1]),)
            ins.append(scalar[1])
        written = []
        for i, arg in enumerate(func._schema.arguments):
            info = arg.alias_info
            if info is None or not info.is_write:
                continue
            key = i if i < len(args) else arg.name
            val = args[i] if i < len(args) else kwargs.get(arg.name)
            if isinstance(val, torch.Tensor):
                written.append((key, val))
                # The value it held is kept: the lift reads prologue
                # values after the program ran on.
                old = self._ids.get(id(val))
                if old is not None:
                    self.val[old] = val.clone()
        out = func(*args, **kwargs)
        outs, where = [], []
        wrote = {id(w) for _, w in written}
        for key, w in written:
            outs.append(self.fresh(w))
            where.append(("w", key))
        rets = out if isinstance(out, (list, tuple)) else (out,)
        for k, x in enumerate(rets):
            if isinstance(x, torch.Tensor) and id(x) not in wrote:
                outs.append(self.fresh(x))
                where.append(("r", k))
        name = func.name() if hasattr(func, "name") else str(func)
        packet = name.split("::", 1)[-1].split(".", 1)[0]
        self.ops.append(Op(func, packet, ref_args, ref_kwargs, ins, outs,
                           where))
        if packet == "_local_scalar_dense" and ins:
            self._scalar = (out, ins[0])
        if not written and all(v in self.literal for v in ins) and all(
                len(self.shape[v]) == 0 for v in outs):
            self.literal.update(outs)
        return out


    def close(self) -> None:
        """End of a recorded segment: a tensor read as a Python value and
        not yet indexed with is refused."""
        if self._scalar is not None:
            raise_scalar_read()


def raise_scalar_read():
    """A tensor read as a Python value anywhere but ``x[i]``: the value of
    the lift-time run would be baked into every step and row of the
    lifted program (a branch taken once, a slice bound, a shift count), as
    ``jax.make_jaxpr`` refuses a traced value used as a Python one."""
    from coast_tpu_torch.frontend.lifter import LiftError
    raise LiftError(
        "a tensor is read as a Python value (a branch, a slice bound, a "
        "shape or a count) inside the lifted function; only x[i] with a "
        "0-d tensor i is lifted: write a branch with torch.where and a "
        "window with index_select/gather")


def live_inputs(ops: List[Op], outs: List[int]) -> set:
    """The value ids ``outs`` depend on through ``ops`` (backwards)."""
    live = set(outs)
    for op in reversed(ops):
        if any(v in live for v in op.outs):
            live.update(op.ins)
    return live


def _sub(x, env: Dict[int, torch.Tensor]):
    if isinstance(x, Ref):
        return env[int(x)]
    if isinstance(x, (list, tuple)):
        return type(x)(_sub(a, env) for a in x)
    return x


def replay(ops: List[Op], env: Dict[int, torch.Tensor],
           device: torch.device) -> None:
    """Run ``ops`` again over ``env`` (value id -> tensor; filled in with
    every output).  Factory operations make their tensors on ``device``; a
    tensor the replay did not make is copied before an operation writes it
    in place (the step never writes its inputs)."""
    owned = set()
    for op in ops:
        if op.packet == "_local_scalar_dense":
            continue            # its reader indexes with the tensor
        if op.args and isinstance(op.args[-1], ScalarRef):
            # x[i] (``select.int``): a[i]'s rule of the reference, one
            # negative wrap then a clamp, per row.
            x, dim = env[int(op.args[0])], op.args[1]
            ic = clamp_index(env[int(op.args[2])], x.shape[dim])
            got = torch.index_select(x, dim, ic.reshape(1)).squeeze(dim)
            env[op.outs[0]] = got
            owned.add(id(got))
            continue
        args = list(_sub(a, env) for a in op.args)
        kwargs = {k: _sub(v, env) for k, v in op.kwargs.items()}
        if "device" in kwargs:
            kwargs["device"] = device
        for kind, key in op.where:
            if kind != "w":
                continue
            tgt = args[key] if isinstance(key, int) else kwargs[key]
            if id(tgt) not in owned:
                tgt = tgt.clone()
                if isinstance(key, int):
                    args[key] = tgt
                else:
                    kwargs[key] = tgt
        out = op.func(*args, **kwargs)
        rets = out if isinstance(out, (list, tuple)) else (out,)
        for vid, (kind, key) in zip(op.outs, op.where):
            if kind == "w":
                got = args[key] if isinstance(key, int) else kwargs[key]
            else:
                got = rets[key]
            env[vid] = got
            owned.add(id(got))


class Program:
    """A recorded segment as a function of its inputs: ``ops`` over the
    values ``inputs`` (per-row state) and the tape's constants, giving the
    values ``outputs``.  :meth:`rows` runs it over a leading row axis."""

    def __init__(self, ops: List[Op], inputs: List[int],
                 outputs: List[int], baked: Dict[int, torch.Tensor],
                 vals: Optional[Dict[int, torch.Tensor]] = None):
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.baked = dict(baked)
        self.ops = ops if vals is None else self._fold(ops, vals)
        self._on: Dict[str, Dict[int, torch.Tensor]] = {}

    def _fold(self, ops: List[Op], vals: Dict[int, torch.Tensor]
              ) -> List[Op]:
        """``ops`` simplified for the replay, with the same values:

          * an op that reads constants alone is dropped, its recorded
            value (``vals``) a constant: every row computes the same
            value there (a nested static loop's counter, the index
            arithmetic it feeds, a factory tensor);
          * an op that repeats an earlier one (same operator, same
            operands) is dropped, its values read from the earlier one's
            (a nested loop unrolled on the tape recomputes the same index
            of an outer carry at every trip).

        Neither touches an op that writes in place, reads a value read
        as a Python index, or is a loop; nor an op whose value a later op
        writes in place."""
        written = {_sub_id(op, key) for op in ops for kind, key in op.where
                   if kind == "w"}
        const = set(self.baked)
        alias: Dict[int, int] = {}
        seen: Dict[tuple, List[int]] = {}
        kept = []
        for op in ops:
            if alias:
                op = _renamed(op, alias)
            pure = (not isinstance(op, LoopOp) and op.outs
                    and op.packet != "_local_scalar_dense"
                    and not any(k == "w" for k, _ in op.where)
                    and not any(isinstance(a, ScalarRef) for a in op.args)
                    and not any(v in written for v in op.outs))
            if pure and all(v in const for v in op.ins) \
                    and all(v in vals for v in op.outs):
                for v in op.outs:
                    self.baked[v] = vals[v]
                    const.add(v)
                continue
            key = _op_key(op) if pure and op.ins else None
            if key is not None and key in seen:
                alias.update(zip(op.outs, seen[key]))
                continue
            if key is not None:
                seen[key] = op.outs
            kept.append(op)
        self.outputs = [alias.get(v, v) for v in self.outputs]
        return kept
    def _consts(self, device: torch.device) -> Dict[int, torch.Tensor]:
        key = str(device)
        if key not in self._on:
            self._on[key] = {v: t.to(device) for v, t in self.baked.items()}
        return self._on[key]

    def rows(self, values: List[torch.Tensor], batch: int,
             device: torch.device) -> List[torch.Tensor]:
        """The outputs for every row: ``values[j]`` is input ``j`` with a
        leading row axis.  An output that is an input unchanged is that
        input itself (identity survives, as a jaxpr passthrough does)."""
        consts = self._consts(device)
        direct = {v: x for v, x in zip(self.inputs, values)}
        if any(isinstance(op, LoopOp) for op in self.ops):
            got = self._split_rows(values, batch, device, consts)
        else:
            got = _vmapped(self.ops, self.inputs, values, self.outputs,
                           consts, batch, device)
        out = []
        for v, g in zip(self.outputs, got):
            out.append(direct[v] if v in direct else g.contiguous())
        return out

    def _split_rows(self, values, batch, device, consts):
        """The ops in runs cut at each :class:`LoopOp`: a straight run
        under ``vmap`` (it hands on every value a later piece reads), a
        loop over the explicit row axis.  ``env`` holds row-batched
        values; a constant a loop reads is expanded to the rows."""
        if not hasattr(self, "_plan"):
            self._plan = _split_plan(self.ops, self.outputs)
        env = dict(zip(self.inputs, values))
        for kind, ops, keep in self._plan:
            if kind == "loop":
                (op,) = ops
                vals = []
                for v in op.ins:
                    x = env[v] if v in env else consts[v]
                    if v not in env:
                        x = x.expand(batch, *x.shape).contiguous()
                    vals.append(x)
                env.update(zip(op.outs, op.run_rows(vals, batch, device)))
                continue
            reads = [v for v in _reads_of(ops) if v in env]
            env.update(zip(keep, _vmapped(ops, reads, [env[v] for v in reads],
                                          keep, consts, batch, device)))
        return [env[v] if v in env else
                consts[v].expand(batch, *consts[v].shape)
                for v in self.outputs]


def _sub_id(op: Op, key) -> Optional[int]:
    """The value id an op's argument ``key`` (position or name) holds."""
    arg = op.args[key] if isinstance(key, int) else op.kwargs.get(key)
    return int(arg) if isinstance(arg, Ref) else None


def _renamed(op: Op, alias: Dict[int, int]) -> Op:
    """``op`` reading ``alias[v]`` in place of each aliased value ``v``."""

    def sub(x):
        if isinstance(x, Ref) and int(x) in alias:
            return type(x)(alias[int(x)])
        if isinstance(x, (list, tuple)):
            return type(x)(sub(a) for a in x)
        return x

    return dataclasses.replace(
        op, args=tuple(sub(a) for a in op.args),
        kwargs={k: sub(v) for k, v in op.kwargs.items()},
        ins=[alias.get(v, v) for v in op.ins])


def _op_key(op: Op) -> Optional[tuple]:
    """A hashable key of an operation and its operands, or None."""

    def frozen(x):
        if isinstance(x, Ref):
            return ("%", int(x))
        if isinstance(x, (list, tuple)):
            return tuple(frozen(a) for a in x)
        if isinstance(x, torch.Tensor):
            raise TypeError
        return x

    try:
        key = (op.func, frozen(op.args),
               tuple(sorted((k, frozen(v)) for k, v in op.kwargs.items())))
        hash(key)
    except TypeError:
        return None
    return key


def _reads_of(ops: List[Op]) -> List[int]:
    """The values ``ops`` read that they do not make, in first-read order."""
    made, reads = set(), []
    for op in ops:
        for v in op.ins:
            if v not in made and v not in reads:
                reads.append(v)
        made.update(op.outs)
    return reads


def _split_plan(ops: List[Op], outputs: List[int]):
    """``[(kind, ops, keep)]``: runs of straight ops and single loops, each
    straight run with the values it makes that a later piece or the
    outputs read."""
    pieces: List[Tuple[str, List[Op]]] = []
    for op in ops:
        if isinstance(op, LoopOp):
            pieces.append(("loop", [op]))
        elif pieces and pieces[-1][0] == "ops":
            pieces[-1][1].append(op)
        else:
            pieces.append(("ops", [op]))
    plan = []
    later = set(outputs)
    for kind, run in reversed(pieces):
        made = [v for op in run for v in op.outs]
        keep = [v for v in made if v in later] if kind == "ops" else []
        plan.append((kind, run, keep))
        for op in run:
            later.update(op.ins)
    return plan[::-1]


def _vmapped(ops, inputs, values, outputs, consts, batch, device):
    """``ops`` over a leading row axis of ``values`` (one per input)."""
    if not outputs:
        return ()

    def one(*xs):
        env = dict(consts)
        env.update(zip(inputs, xs))
        replay(ops, env, device)
        return tuple(env[v] for v in outputs)

    if values:
        return torch.func.vmap(one)(*values)
    return tuple(x.expand(batch, *x.shape) for x in one())


# ---------------------------------------------------------------------------
# recorded loops
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LoopRecord:
    """One top-level loop as the lift saw it, in ``jax.lax``'s layout.

    ``in_vids``: the loop equation's inputs on the main tape (scan:
    consts, carries, xs; while: cond consts, body consts, carries), None
    for a literal.  ``out_vids``: its outputs (the carries kept, then the
    stacked outputs kept).  ``body`` (and ``cond``) are :class:`Program`
    over the same input order (cond: cond consts, carries)."""

    prim: str
    in_vids: List[Optional[int]]
    in_vals: List[torch.Tensor]
    out_vids: List[int]
    body: Program
    cond: Optional[Program] = None
    n_consts: int = 0
    n_carry: int = 0
    n_xs: int = 0
    length: int = 0
    reverse: bool = False
    cn: int = 0
    bn: int = 0
    ys_shapes: List[Tuple[Tuple[int, ...], torch.dtype]] = \
        dataclasses.field(default_factory=list)
    at_op: int = 0
    # The input tensors themselves (``in_vals`` holds copies).
    in_objs: List[torch.Tensor] = dataclasses.field(default_factory=list)


class Recording:
    """A lift in progress: the main tape and the loops met at depth 0."""

    def __init__(self):
        self.tape = Tape()
        self.loops: List[LoopRecord] = []
        self.depth = 0
        # The body tape being recorded, innermost last; None while a loop
        # runs eagerly for its results (nothing records then).
        self.tapes: List[Optional[Tape]] = []

    def recording_tape(self) -> Optional[Tape]:
        """The body tape a loop met now belongs on (depth > 0)."""
        return self.tapes[-1] if self.tapes else None

    def __enter__(self):
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("lift_fn does not nest")
        _ACTIVE = self
        self.tape.__enter__()
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        self.tape.__exit__(*exc)
        _ACTIVE = None
        if exc[0] is None:
            self.tape.close()
        return False

    # -- helpers -------------------------------------------------------
    def main_vid(self, t: torch.Tensor) -> Optional[int]:
        """The main tape's value of ``t``; None for a literal (a 0-d
        tensor made outside the function)."""
        vid = self.tape.known(t)
        if vid is not None:
            return None if vid in self.tape.literal else vid
        if t.dim() == 0:
            return None
        return self.tape.value_of(t)

    def _body_tape(self, fn, arg_trees):
        """Record ``fn(*arg_trees)`` on a fresh tape over copies of its
        input leaves -> ``(tape, in_vids, out_leaves, out_tree,
        out_vids)``."""
        tape = Tape()
        copies = []
        trees = []
        for tree in arg_trees:
            leaves, td = flatten(tree)
            cl = [x.clone() for x in leaves]
            copies += cl
            trees.append(unflatten(td, cl))
        with torch.no_grad(), tape:
            in_vids = [tape.bind_input(c) for c in copies]
            self.depth += 1
            self.tapes.append(tape)
            try:
                out = fn(*trees)
            finally:
                self.tapes.pop()
                self.depth -= 1
            tape.close()
            leaves, td = flatten(out)
            leaves = [as_word(x) for x in leaves]
            out_vids = [tape.value_of(x) for x in leaves]
        return tape, in_vids, leaves, td, out_vids

    def _split_consts(self, tape: Tape):
        """A body tape's captures, in first-use order, as ``(body vid, main
        vid, tensor)``, and its literals (``{body vid: tensor}``: 0-d
        tensors made outside the function, inlined as JAX inlines them)."""
        caps, baked = [], {}
        for vid in sorted(tape.consts):
            t = tape.consts[vid]
            mv = self.main_vid(t)
            if mv is None:
                baked[vid] = t
            else:
                caps.append((vid, mv, t))
        return caps, baked

    def _unchanged(self, t: torch.Tensor, vid: Optional[int]
                   ) -> torch.Tensor:
        """A loop's result for a carry its body hands back unchanged: the
        input itself, or for a literal input a value of its own (the
        reference's loop output is a traced value that a later loop
        captures), baked as a constant where the lift replays it."""
        if vid is not None:
            return t
        out = t.clone()
        self.tape.fixed[self.tape.fresh(out)] = out
        return out

    def _distinct(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, or a copy when the main tape already holds it (a loop
        output is a new value)."""
        return t.clone() if self.tape.known(t) is not None else t

    def scan(self, f, init, xs, length, reverse):
        """A depth-0 ``scan``: its phase recorded, its results from
        replays of the recorded body; the main tape records nothing
        meanwhile."""
        self.tape.close()
        self.tape.paused = True
        try:
            return self._scan(f, init, xs, length, reverse)
        finally:
            self.tape.paused = False

    def while_loop(self, cond_fn, body_fn, init):
        """A depth-0 ``while_loop``, as :meth:`scan`."""
        self.tape.close()
        self.tape.paused = True
        try:
            return self._while(cond_fn, body_fn, init)
        finally:
            self.tape.paused = False

    # -- scan ----------------------------------------------------------
    def _scan(self, f, init, xs, length, reverse):
        main = self.tape
        carry_leaves, carry_td = flatten(init)
        carry_leaves = [as_word(c) for c in carry_leaves]
        init = unflatten(carry_td, carry_leaves)
        xs_leaves, xs_td = flatten(xs)
        length = _scan_length(xs_leaves, length)
        carry_in = [self.main_vid(c) for c in carry_leaves]
        xs_in = [self.main_vid(x) for x in xs_leaves]
        row = (length - 1) if reverse else 0
        x0 = unflatten(xs_td, [
            (x[row] if length else torch.zeros(x.shape[1:],
                                               dtype=x.dtype))
            for x in xs_leaves])
        tape, b_in, b_out, out_td, b_out_vids = self._body_tape(f, [init, x0])
        if not (isinstance(out_td, tuple) and out_td[0] in (tuple, list)
                and len(out_td[1]) == 2):
            raise TypeError("scan body output must be a pair")
        n_carry = len(carry_leaves)
        n_cout = out_td[1][0][0]
        if n_cout != n_carry:
            raise TypeError(
                f"scan body carry has {n_cout} leaves, init {n_carry}")
        caps, baked = self._split_consts(tape)
        c_in = b_in[:n_carry]
        x_in = b_in[n_carry:]
        carry_out = b_out_vids[:n_carry]
        ys_out = b_out_vids[n_carry:]
        move = [carry_out[j] == c_in[j] for j in range(n_carry)]
        ys_fwd = [x_in.index(v) if v in x_in else None for v in ys_out]

        # The loop's results: the recorded body replayed one row a trip.
        prog = Program(tape.ops, list(b_in[:n_carry])
                       + [bv for bv, _, _ in caps] + list(x_in),
                       list(b_out_vids), baked, tape.val)
        c = list(carry_leaves)
        ys_rows: List[List[torch.Tensor]] = [[] for _ in ys_out]
        for i in (range(length - 1, -1, -1) if reverse else range(length)):
            outs = _one_row(prog, c + [t for _, _, t in caps]
                            + [xl[i] for xl in xs_leaves])
            c = outs[:n_carry]
            for j, y in enumerate(outs[n_carry:]):
                ys_rows[j].append(y)
        ys_shapes = [(tuple(b_out[n_carry + j].shape),
                      b_out[n_carry + j].dtype) for j in range(len(ys_out))]
        ys = []
        for j, (shape, dtype) in enumerate(ys_shapes):
            if ys_fwd[j] is not None:
                ys.append(xs_leaves[ys_fwd[j]])
                continue
            rows = ys_rows[j][::-1] if reverse else ys_rows[j]
            ys.append(torch.stack(rows) if rows
                      else torch.zeros((0, *shape), dtype=dtype))
        finals = []
        for j in range(n_carry):
            finals.append(self._unchanged(carry_leaves[j], carry_in[j])
                          if move[j] else self._distinct(c[j]))

        # jax.lax's layout: moved carries first among the consts.
        moved = [j for j in range(n_carry) if move[j]]
        kept = [j for j in range(n_carry) if not move[j]]
        ys_kept = [j for j in range(len(ys_out)) if ys_fwd[j] is None]
        cap_in = [(bv, mv, t) for bv, mv, t in caps]
        in_vids = ([carry_in[j] for j in moved] + [mv for _, mv, _ in cap_in]
                   + [carry_in[j] for j in kept] + xs_in)
        in_vals = ([carry_leaves[j] for j in moved] + [t for _, _, t in cap_in]
                   + [carry_leaves[j] for j in kept] + list(xs_leaves))
        prog_in = ([c_in[j] for j in moved] + [bv for bv, _, _ in cap_in]
                   + [c_in[j] for j in kept] + list(x_in))
        prog_out = [carry_out[j] for j in kept] + [ys_out[j] for j in ys_kept]
        body = Program(tape.ops, prog_in, prog_out, baked, tape.val)
        out_vids = ([main.fresh(finals[j]) for j in kept]
                    + [main.fresh(self._distinct(ys[j])) for j in ys_kept])
        # Re-read the kept outputs as the fresh objects just bound.
        kept_objs = [main.val[v] for v in out_vids]
        for n, j in enumerate(kept):
            finals[j] = kept_objs[n]
        for n, j in enumerate(ys_kept):
            ys[j] = kept_objs[len(kept) + n]
        self.loops.append(LoopRecord(
            prim="scan", in_vids=in_vids, in_objs=list(in_vals),
            in_vals=[x.clone() for x in in_vals], out_vids=out_vids,
            body=body, n_consts=len(moved) + len(cap_in),
            n_carry=len(kept), n_xs=len(xs_leaves), length=length,
            reverse=reverse,
            ys_shapes=[ys_shapes[j] for j in ys_kept],
            at_op=len(main.ops)))
        return (unflatten(carry_td, finals),
                unflatten(out_td[1][1][1], ys) if ys_out
                else unflatten(out_td[1][1][1], []))

    # -- while ---------------------------------------------------------
    def _while(self, cond_fn, body_fn, init):
        main = self.tape
        carry_leaves, carry_td = flatten(init)
        carry_leaves = [as_word(c) for c in carry_leaves]
        init = unflatten(carry_td, carry_leaves)
        n_carry = len(carry_leaves)
        carry_in = [self.main_vid(c) for c in carry_leaves]
        ctape, c_in, _, _, c_out_vids = self._body_tape(cond_fn, [init])
        btape, b_in, _, _, b_out_vids = self._body_tape(body_fn, [init])
        if len(b_out_vids) != n_carry:
            raise TypeError("while_loop body must return the carry")
        c_caps, c_baked = self._split_consts(ctape)
        b_caps, b_baked = self._split_consts(btape)
        cond_reads = live_inputs(ctape.ops, c_out_vids)
        move = [b_out_vids[j] == b_in[j] and c_in[j] not in cond_reads
                for j in range(n_carry)]
        c = _replay_while(
            Program(ctape.ops, [bv for bv, _, _ in c_caps] + c_in,
                    c_out_vids[:1], c_baked, ctape.val),
            Program(btape.ops, [bv for bv, _, _ in b_caps] + b_in,
                    b_out_vids, b_baked, btape.val),
            [t for _, _, t in c_caps], [t for _, _, t in b_caps],
            list(carry_leaves))
        finals = [self._unchanged(carry_leaves[j], carry_in[j]) if move[j]
                  else self._distinct(c[j]) for j in range(n_carry)]
        moved = [j for j in range(n_carry) if move[j]]
        kept = [j for j in range(n_carry) if not move[j]]
        in_vids = ([mv for _, mv, _ in c_caps]
                   + [carry_in[j] for j in moved] + [mv for _, mv, _ in b_caps]
                   + [carry_in[j] for j in kept])
        in_vals = ([t for _, _, t in c_caps]
                   + [carry_leaves[j] for j in moved]
                   + [t for _, _, t in b_caps]
                   + [carry_leaves[j] for j in kept])
        body = Program(btape.ops,
                       [b_in[j] for j in moved] + [bv for bv, _, _ in b_caps]
                       + [b_in[j] for j in kept],
                       [b_out_vids[j] for j in kept], b_baked, btape.val)
        cond = Program(ctape.ops,
                       [bv for bv, _, _ in c_caps] + [c_in[j] for j in kept],
                       c_out_vids[:1], c_baked, ctape.val)
        out_vids = [main.fresh(finals[j]) for j in kept]
        for n, j in enumerate(kept):
            finals[j] = main.val[out_vids[n]]
        self.loops.append(LoopRecord(
            prim="while", in_vids=in_vids, in_objs=list(in_vals),
            in_vals=[x.clone() for x in in_vals],
            out_vids=out_vids, body=body, cond=cond, cn=len(c_caps),
            bn=len(moved) + len(b_caps), n_carry=len(kept),
            at_op=len(main.ops)))
        return unflatten(carry_td, finals)


    def _run_eagerly(self, cond_fn, body_fn, val):
        """A ``while`` run to its end on real values, nothing recorded."""
        self.depth += 1
        self.tapes.append(None)
        try:
            while bool(as_word(flatten(cond_fn(val))[0][0])):
                val = body_fn(val)
        finally:
            self.tapes.pop()
            self.depth -= 1
        return val

    # -- a data-dependent while inside a recorded body ------------------
    def nested_while(self, outer: Tape, cond_fn, body_fn, init):
        """Record a ``while_loop`` met while ``outer`` (a body tape) is
        recording as one :class:`LoopOp` of ``outer``: its condition and
        body on tapes of their own, their captures read from ``outer`` in
        first-use order (the condition's, then the body's, as JAX traces
        them), then the loop run eagerly for its results."""
        outer.close()
        outer.paused = True
        try:
            carry_leaves, carry_td = flatten(init)
            carry_leaves = [as_word(c) for c in carry_leaves]
            init = unflatten(carry_td, carry_leaves)
            n_carry = len(carry_leaves)
            ctape, c_in, _, _, c_out = self._body_tape(cond_fn, [init])
            btape, b_in, _, _, b_out = self._body_tape(body_fn, [init])
            if len(b_out) != n_carry:
                raise TypeError("while_loop body must return the carry")
            progs, caps = [], []
            for tape, t_in, t_out in ((ctape, c_in, c_out[:1]),
                                      (btape, b_in, b_out)):
                own, baked = [], {}
                for vid in sorted(tape.consts):
                    t = tape.consts[vid]
                    ov = outer.known(t)
                    if ov is None and t.dim() == 0:
                        baked[vid] = t
                        continue
                    ov = outer.value_of(t) if ov is None else ov
                    if ov in outer.literal:
                        baked[vid] = outer.val[ov]
                        continue
                    own.append((vid, ov))
                progs.append(Program(tape.ops, [v for v, _ in own] + t_in,
                                     t_out, baked, tape.val))
                caps.append([ov for _, ov in own])
            carry_in = [outer.value_of(c) for c in carry_leaves]
            final = self._run_eagerly(cond_fn, body_fn, init)
            final = [as_word(v) for v in flatten(final)[0]]
            final = [x.clone() if outer.known(x) is not None else x
                     for x in final]
        finally:
            outer.paused = False
        outs = [outer.fresh(x) for x in final]
        ins = caps[0] + caps[1] + carry_in
        outer.ops.append(LoopOp(
            func=None, packet="while", args=(), kwargs={}, ins=ins,
            outs=outs, where=[("r", k) for k in range(len(outs))],
            cond=progs[0], body=progs[1], n_cond=len(caps[0]),
            n_body=len(caps[1])))
        return unflatten(carry_td, final)


def _one_row(prog: Program, vals: List[torch.Tensor]
             ) -> List[torch.Tensor]:
    """``prog`` over one row of ``vals`` (no row axis in or out)."""
    outs = prog.rows([v.unsqueeze(0) for v in vals], 1,
                     torch.device("cpu"))
    return [o[0] for o in outs]


def _replay_while(cond: Program, body: Program, cond_caps, body_caps,
                  carry: List[torch.Tensor]) -> List[torch.Tensor]:
    """A recorded ``while`` run to its end on one row."""
    while bool(_one_row(cond, cond_caps + carry)[0]):
        carry = _one_row(body, body_caps + carry)
    return carry


def _scan_length(xs_leaves, length) -> int:
    lens = {int(x.shape[0]) for x in xs_leaves}
    if length is not None:
        lens.add(int(length))
    if len(lens) != 1:
        if not lens:
            raise ValueError("scan got no xs and no length")
        raise ValueError(f"scan got inconsistent lengths {sorted(lens)}")
    return lens.pop()


_ACTIVE: Optional[Recording] = None


def _recording() -> Optional[Recording]:
    rec = _ACTIVE
    if rec is None or rec.depth > 0:
        return None
    return rec


# ---------------------------------------------------------------------------
# the combinators
# ---------------------------------------------------------------------------


def scan(f: Callable, init, xs=None, length: Optional[int] = None,
         reverse: bool = False):
    """``jax.lax.scan``: ``carry, ys = scan(f, init, xs)`` with ``f(carry,
    x) -> (carry, y)``; ``ys`` stacks each ``y`` along a new leading axis
    (in iteration order even when ``reverse``)."""
    rec = _recording()
    if rec is not None:
        return rec.scan(f, init, xs, length, reverse)
    xs_leaves, xs_td = flatten(xs)
    n = _scan_length(xs_leaves, length)
    carry = init
    ys: List[Any] = [None] * n
    y_td = None
    order = range(n - 1, -1, -1) if reverse else range(n)
    for i in order:
        carry, y = f(carry, unflatten(xs_td, [x[i] for x in xs_leaves]))
        leaves, y_td = flatten(y)
        ys[i] = leaves
    if n == 0:
        # The stacked outputs' shapes come from one call on zero rows.
        x0 = unflatten(xs_td, [torch.zeros(x.shape[1:], dtype=x.dtype)
                               for x in xs_leaves])
        _, y = f(init, x0)
        leaves, y_td = flatten(y)
        return carry, unflatten(y_td, [
            torch.zeros((0, *as_word(v).shape), dtype=as_word(v).dtype)
            for v in leaves])
    stacked = [torch.stack([as_word(ys[i][j]) for i in range(n)])
               for j in range(len(ys[0]))]
    return carry, unflatten(y_td, stacked)


def while_loop(cond_fun: Callable, body_fun: Callable, init_val):
    """``jax.lax.while_loop``: ``body_fun`` while ``cond_fun`` holds."""
    rec = _recording()
    if rec is not None:
        return rec.while_loop(cond_fun, body_fun, init_val)
    rec = _ACTIVE
    tape = rec.recording_tape() if rec is not None else None
    if tape is not None and not tape.paused:
        return rec.nested_while(tape, cond_fun, body_fun, init_val)
    val = init_val
    while bool(as_word(flatten(cond_fun(val))[0][0])):
        val = body_fun(val)
    return val
