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
    scanned row, then the loop runs eagerly to its end (so the function
    goes on with real values);
  * the tensors the body reads that are neither a carry nor a scanned
    input are its captures: ``jax.lax`` closure-converts them into the
    loop's leading ``consts``, in first-use order, and so does this
    module.  A 0-d tensor made outside the function is a literal (JAX
    inlines scalar constants), not a capture.

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
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from coast_tpu_torch.ops.indexing import clamp_index

# ---------------------------------------------------------------------------
# pytrees (JAX's order: dict keys sorted)
# ---------------------------------------------------------------------------


def flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; ``treedef`` rebuilds the tree (:func:`unflatten`)."""
    if tree is None:
        return [], None
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
                 outputs: List[int], baked: Dict[int, torch.Tensor]):
        self.ops = ops
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.baked = baked
        self._on: Dict[str, Dict[int, torch.Tensor]] = {}

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

        def one(*xs):
            env = dict(consts)
            env.update(zip(self.inputs, xs))
            replay(self.ops, env, device)
            return tuple(env[v] for v in self.outputs)

        if values:
            got = torch.func.vmap(one)(*values)
        else:
            got = tuple(x.expand(batch, *x.shape) for x in one())
        out = []
        for v, g in zip(self.outputs, got):
            out.append(direct[v] if v in direct else g.contiguous())
        return out


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


class Recording:
    """A lift in progress: the main tape and the loops met at depth 0."""

    def __init__(self):
        self.tape = Tape()
        self.loops: List[LoopRecord] = []
        self.depth = 0

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
            try:
                out = fn(*trees)
            finally:
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

    def _distinct(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, or a copy when the main tape already holds it (a loop
        output is a new value)."""
        return t.clone() if self.tape.known(t) is not None else t

    def scan(self, f, init, xs, length, reverse):
        """A depth-0 ``scan``: its phase recorded, its results computed
        eagerly; the main tape records nothing meanwhile."""
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

        # The loop runs eagerly (nothing recorded) for its results.
        c = list(carry_leaves)
        ys_rows: List[List[torch.Tensor]] = [[] for _ in ys_out]
        self.depth += 1
        try:
            order = range(length - 1, -1, -1) if reverse else range(length)
            for i in order:
                x = unflatten(xs_td, [xl[i] for xl in xs_leaves])
                out = f(unflatten(carry_td, c), x)
                leaves, _ = flatten(out)
                leaves = [as_word(v) for v in leaves]
                c = leaves[:n_carry]
                for j, y in enumerate(leaves[n_carry:]):
                    ys_rows[j].append(y)
        finally:
            self.depth -= 1
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
            finals.append(carry_leaves[j] if move[j]
                          else self._distinct(c[j]))

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
        body = Program(tape.ops, prog_in, prog_out, baked)
        out_vids = ([main.fresh(finals[j]) for j in kept]
                    + [main.fresh(self._distinct(ys[j])) for j in ys_kept])
        # Re-read the kept outputs as the fresh objects just bound.
        kept_objs = [main.val[v] for v in out_vids]
        for n, j in enumerate(kept):
            finals[j] = kept_objs[n]
        for n, j in enumerate(ys_kept):
            ys[j] = kept_objs[len(kept) + n]
        self.loops.append(LoopRecord(
            prim="scan", in_vids=in_vids,
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
        c = unflatten(carry_td, list(carry_leaves))
        self.depth += 1
        try:
            while bool(as_word(flatten(cond_fn(c))[0][0])):
                c = body_fn(c)
        finally:
            self.depth -= 1
        c = [as_word(v) for v in flatten(c)[0]]
        finals = [carry_leaves[j] if move[j] else self._distinct(c[j])
                  for j in range(n_carry)]
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
                       [b_out_vids[j] for j in kept], b_baked)
        cond = Program(ctape.ops,
                       [bv for bv, _, _ in c_caps] + [c_in[j] for j in kept],
                       c_out_vids[:1], c_baked)
        out_vids = [main.fresh(finals[j]) for j in kept]
        for n, j in enumerate(kept):
            finals[j] = main.val[out_vids[n]]
        self.loops.append(LoopRecord(
            prim="while", in_vids=in_vids,
            in_vals=[x.clone() for x in in_vals],
            out_vids=out_vids, body=body, cond=cond, cn=len(c_caps),
            bn=len(moved) + len(b_caps), n_carry=len(kept),
            at_op=len(main.ops)))
        return unflatten(carry_td, finals)


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
    val = init_val
    while bool(cond_fun(val)):
        val = body_fun(val)
    return val
