"""Region lifter: derive a protected Region from user code.

The counterpart of ``coast_tpu/frontend/lifter.py``.  The reference's
``opt -TMR`` discovers what to clone from the program itself
(populateValuesToClone, cloning.cpp:62-288); the user only annotates
scope.  Two entry points:

``lift_step(name, step, init, done=...)``
    A plain stepped function over a dict state and a termination
    predicate; everything else is derived:

      * **LeafSpec kinds** from the step's dataflow
        (``passes.verification.analyze_step``, a capture of up to eight
        calls on a two-row CPU image): an unwritten leaf is read-only; a
        leaf that is the target of a store-like partial update is ``mem``;
        a written leaf feeding ``done()``, a ``where`` condition or an
        index is ``ctrl``; any other written leaf is a data register.
      * **nominal_steps** from a fault-free run to termination, on the
        device the caller names (the card unless ``device="cpu"``).
      * **check()** as a golden compare against the fault-free output.
        The golden is computed per device, from a fault-free run on the
        device the checked state is on, and cached: cuBLAS and the CPU
        round a float program differently, so a golden taken on the host
        would read fault-free card rows as errors.  (The reference
        computes it once at lift time.)
      * a coarse three-block **graph** for CFCSS when none is given.

``lift_fn(name, fn, *example_args)``
    A whole function whose main loops are written with
    ``frontend.loops.scan`` / ``loops.while_loop`` (``jax.lax``'s
    signatures; plain eager loops outside a lift).  Torch has no jaxpr, so
    the function runs once on the CPU under a recorder
    (``frontend/loops.py``): each loop call at depth 0 becomes a stepped
    phase, the code before the first loop is the prologue (its values are
    the initial state), the code between loops (interludes) runs as phase
    transitions, and the epilogue is the output projection -- or, when it
    is heavy, a final stepped transition into an ``_outbuf`` leaf.  The
    body, interludes and epilogue are replayed from their recorded aten
    operations over the engine's ``[R, ...]`` rows (``torch.func.vmap``).
    The leaf layout is the reference's: ``_t``, ``c<i>``, ``k<i>`` /
    ``kc<i>``, ``x<i>``, ``y<i>``, ``g<i>``, ``p<N>_`` prefixes with
    ``_phase``, ``p<N>_i`` and ``m<i>``, ``_outbuf``.

Annotations (leaf -> LeafSpec) override any derived kind, the role of the
COAST.h ``__xMR`` / ``__NO_xMR`` macros.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from coast_tpu_torch import device as device_mod
from coast_tpu_torch.frontend import loops
from coast_tpu_torch.ir.graph import BlockGraph, pick
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_REG, KIND_RO,
                                       FnNamespace, LeafSpec, Region, State,
                                       rows)
from coast_tpu_torch.ops import voters
from coast_tpu_torch.ops.indexing import row_select, row_update
from coast_tpu_torch.passes.verification import analyze_step, reads_of

_32BIT = (torch.int32, torch.float32)


class LiftError(Exception):
    """The lifter could not derive a Region; the message says why and what
    to supply (the reference's refusal style, cloning.cpp:50)."""


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# lift_step: stepped user function -> Region
# ---------------------------------------------------------------------------

def _classify(image: State, step, done) -> Dict[str, LeafSpec]:
    flow = analyze_step(step, image, done=done)
    done_deps = reads_of(done, image)
    ctrl = done_deps | flow.load_addr | flow.store_addr | flow.branch_pred
    spec: Dict[str, LeafSpec] = {}
    for name in sorted(image):
        if name not in flow.written:
            kind = KIND_RO
        elif name in flow.stored_into:
            # Store-target beats ctrl: a memory leaf whose contents feed an
            # address or predicate is still memory.
            kind = KIND_MEM
        elif name in ctrl:
            kind = KIND_CTRL
        else:
            kind = KIND_REG
        spec[name] = LeafSpec(kind)
    return spec


def _run(init_fn, step, done, cap: int, device) -> tuple:
    """A fault-free single-row run while ``not done`` and ``t < cap`` ->
    ``(final rows, steps)``."""
    dev = device_mod.resolve(device)
    with torch.no_grad():
        s = {k: v.unsqueeze(0) for k, v in init_fn(dev).items()}
        t = 0
        while t < cap and not bool(done(s)[0]):
            s = {**s, **step(s, t)}
            t += 1
    return s, t


def _measure_steps(init_fn, step, done, cap: int, device) -> int:
    """Fault-free run to termination; the timing-calibration analogue."""
    _, steps = _run(init_fn, step, done, cap, device)
    if steps >= cap:
        raise LiftError(
            f"program did not terminate within {cap} steps; pass "
            "nominal_steps= explicitly (or fix the done() predicate)")
    return steps


def _flat_words(leaves: Sequence[torch.Tensor], batch: int) -> torch.Tensor:
    """Rows of 32-bit leaves as one int32 word vector a row (the
    word-addressed memory image, the reference's uint32 ``_flat_u32``)."""
    parts = []
    for x in leaves:
        x = x.reshape(batch, -1)
        parts.append(x.view(torch.int32) if x.dtype == torch.float32 else x)
    if not parts:
        return torch.zeros((batch, 0), dtype=torch.int32)
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def _batch(state) -> int:
    for v in state.values():
        return int(v.shape[0])
    return 1


def _device_of(state) -> torch.device:
    for v in state.values():
        return v.device
    return torch.device("cpu")


def lift_step(name: str,
              step: Callable[[State, int], State],
              init,
              *,
              done: Callable[[State], torch.Tensor],
              check: Optional[Callable[[State], torch.Tensor]] = None,
              output: Optional[Callable[[State], torch.Tensor]] = None,
              nominal_steps: Optional[int] = None,
              max_steps: Optional[int] = None,
              annotations: Optional[Dict[str, LeafSpec]] = None,
              default_xmr: bool = True,
              graph: Optional[BlockGraph] = None,
              step_cap: int = 1 << 16,
              functions: Optional[Dict[str, Callable]] = None,
              meta: Optional[dict] = None,
              device=device_mod.DEFAULT) -> Region:
    """Derive a Region from a stepped function.  Only ``step``, ``init``
    (a dict of unbatched tensors, or a callable of a device, as
    ``Region.init`` is) and ``done`` are required.  ``step`` works on the
    engine's ``[R, ...]`` rows and returns the leaves it writes.

    ``functions`` is the multi-function form ``step(state, t, fns)``:
    classification and step measurement run with the raw functions bound
    (as ``Region.bound_step()`` does), the Region keeps the three-argument
    step.  ``device`` is where ``nominal_steps`` is measured."""
    if callable(init):
        init_fn = init
    else:
        image0 = dict(init)

        def init_fn(dev, _image=image0):
            return {k: torch.as_tensor(v).to(dev).clone()
                    for k, v in _image.items()}
    user_step = step
    if functions:
        _raw_ns = FnNamespace(dict(functions))
        step = lambda s, t: user_step(s, t, _raw_ns)  # noqa: E731
    image = init_fn(torch.device("cpu"))
    if not isinstance(image, dict):
        raise LiftError("init must produce a flat dict of arrays "
                        f"(got {type(image).__name__})")
    bad = {k: _dtype_name(v.dtype) for k, v in image.items()
           if v.dtype not in _32BIT}
    if bad:
        raise LiftError(
            "injectable state must be 32-bit (word-addressed memory map); "
            f"non-32-bit leaves: {bad}; cast them or restructure")

    spec = _classify(image, step, done)
    for leaf, override in (annotations or {}).items():
        if leaf not in spec:
            raise LiftError(f"annotation for unknown leaf {leaf!r} "
                            f"(state has: {', '.join(sorted(spec))})")
        spec[leaf] = override

    if nominal_steps is None:
        nominal_steps = _measure_steps(init_fn, step, done, step_cap, device)
    if max_steps is None:
        # Watchdog bound: 3x fault-free runtime, the slack the reference
        # gives its sleep window over measured runtime.
        max_steps = max(3 * nominal_steps, nominal_steps + 4)

    if output is None:
        # The observable result: written memory if any, else the
        # surviving data registers.
        mem = [n for n in sorted(image) if spec[n].kind == KIND_MEM]
        obs = mem or [n for n in sorted(image) if spec[n].kind == KIND_REG]
        if not obs:
            raise LiftError("no written leaves to observe; pass output=")

        def output(s, _obs=tuple(obs)):
            return _flat_words([s[n] for n in _obs], _batch(s))

    if check is None:
        goldens: Dict[str, torch.Tensor] = {}
        final_steps = int(max_steps)

        def check(s, _goldens=goldens):
            out = output(s)
            key = str(out.device)
            if key not in _goldens:
                final, _ = _run(init_fn, step, done, final_steps, out.device)
                with torch.no_grad():
                    _goldens[key] = output(final)[0]
            return (out != _goldens[key]).sum(dim=1).to(torch.int32)

    if graph is None:
        # Coarse 3-block graph: enough structure for CFCSS to catch control
        # teleportation across the loop boundary.
        graph = BlockGraph(
            names=["entry", "body", "exit"],
            edges=[(0, 1), (1, 1), (1, 2)],
            block_of=lambda s: pick(done(s), 2, 1))

    region = Region(
        name=name,
        init=init_fn,
        step=user_step if functions else step,
        done=done,
        check=check,
        output=output,
        nominal_steps=int(nominal_steps),
        max_steps=int(max_steps),
        spec=spec,
        default_xmr=default_xmr,
        graph=graph,
        functions=dict(functions or {}),
        meta={"lifted": True, **(meta or {})},
    )
    region.validate()
    return region


# ---------------------------------------------------------------------------
# lift_fn: whole function -> Region (stepped at its loops)
# ---------------------------------------------------------------------------

#: aten operators that make an epilogue heavy, as the reference's
#: ``dot_general``/``conv``/``sort``/``fft``/``scan``/``while`` do.
_HEAVY_OPS = ("mm", "bmm", "matmul", "addmm", "addmv", "baddbmm", "mv",
              "dot", "vdot", "convolution", "_convolution", "sort", "argsort",
              "msort", "topk", "_fft_r2c", "_fft_c2r", "_fft_c2c")


def _epilogue_is_heavy(ops, eqns: Optional[int] = None) -> bool:
    """Epilogues with real work (a heavy operator, or enough operations to
    carry a cross-section) run as a final stepped transition inside the
    injection window; trivial ones stay in output().  ``eqns``, where the
    recorded code gave it, is the reference's equation count of the
    piece, which its rule weighs in place of the aten operations."""
    if (len(ops) if eqns is None else eqns) > 24:
        return True
    return any(op.packet in _HEAVY_OPS for op in ops)


def _to_tensor(x) -> torch.Tensor:
    """An example argument as a CPU tensor (uint32 numpy words as int32)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    arr = np.asarray(x)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    if arr.dtype == np.int64 and arr.ndim == 0 and isinstance(x, int):
        arr = arr.astype(np.int32)
    return torch.from_numpy(np.array(arr, copy=True))


class _Phase:
    """One top-level loop as a stepped phase: leaf layout, per-iteration
    step, completion predicate, and the map from state back to the loop's
    outputs.  ``prefix`` namespaces the leaves (empty for the single-loop
    layout, ``p<N>_`` for multi-phase regions); a scan counts its
    iterations in ``idx_name``."""

    def __init__(self, loop: loops.LoopRecord, prefix: str, idx_name: str):
        self.loop = loop
        self.prefix = prefix
        self.prim = loop.prim
        self.idx_name = idx_name
        self.length = loop.length
        self.reverse = loop.reverse
        self.n_carry = loop.n_carry
        if self.prim == "scan":
            self.n_consts = loop.n_consts
            self.n_xs = loop.n_xs
        else:
            self.cn, self.bn = loop.cn, loop.bn

    # -- leaf layout -------------------------------------------------------
    def leaf_names_by_position(self) -> List[str]:
        p = self.prefix
        if self.prim == "scan":
            return ([f"{p}k{j}" for j in range(self.n_consts)]
                    + [f"{p}c{j}" for j in range(self.n_carry)]
                    + [f"{p}x{j}" for j in range(self.n_xs)])
        return ([f"{p}kc{j}" for j in range(self.cn)]
                + [f"{p}k{j}" for j in range(self.bn)]
                + [f"{p}c{j}" for j in range(self.n_carry)])

    def leaves_from_invals(self, in_vals: List[torch.Tensor],
                           zeros: Callable) -> Dict[str, torch.Tensor]:
        """Leaf dict from the loop's inputs (in ``in_vids`` order);
        ``zeros(shape, dtype)`` makes the counter and stacked outputs."""
        st = dict(zip(self.leaf_names_by_position(), in_vals))
        if self.prim == "scan":
            st[self.idx_name] = zeros((), torch.int32)
            for j, (shape, dtype) in enumerate(self.loop.ys_shapes):
                st[f"{self.prefix}y{j}"] = zeros((self.length, *shape), dtype)
        return st

    # -- runtime behavior --------------------------------------------------
    def iter_step(self, st, batch: int, dev) -> Dict[str, torch.Tensor]:
        p = self.prefix
        new: Dict[str, torch.Tensor] = {}
        if self.prim == "scan":
            if self.length == 0:
                # Zero-trip phase: done at entry, the iteration a no-op.
                return new
            i = st[self.idx_name]
            pos = (self.length - 1) - i if self.reverse else i
            args = ([st[f"{p}k{j}"] for j in range(self.n_consts)]
                    + [st[f"{p}c{j}"] for j in range(self.n_carry)]
                    + [row_select(st[f"{p}x{j}"], pos)
                       for j in range(self.n_xs)])
            outs = self.loop.body.rows(args, batch, dev)
            for j in range(self.n_carry):
                new[f"{p}c{j}"] = outs[j]
            for j, y in enumerate(outs[self.n_carry:]):
                new[f"{p}y{j}"] = row_update(st[f"{p}y{j}"], y, pos)
            new[self.idx_name] = i + 1
        else:
            args = ([st[f"{p}k{j}"] for j in range(self.bn)]
                    + [st[f"{p}c{j}"] for j in range(self.n_carry)])
            outs = self.loop.body.rows(args, batch, dev)
            for j, o in enumerate(outs):
                new[f"{p}c{j}"] = o
        return new

    def phase_done(self, st, batch: int, dev) -> torch.Tensor:
        p = self.prefix
        if self.prim == "scan":
            return st[self.idx_name] >= self.length
        args = ([st[f"{p}kc{j}"] for j in range(self.cn)]
                + [st[f"{p}c{j}"] for j in range(self.n_carry)])
        (alive,) = self.loop.cond.rows(args, batch, dev)
        return torch.logical_not(alive)

    def outs_from_state(self, st) -> List[torch.Tensor]:
        p = self.prefix
        outs = [st[f"{p}c{j}"] for j in range(self.n_carry)]
        if self.prim == "scan":
            outs += [st[f"{p}y{j}"] for j in range(len(self.loop.ys_shapes))]
        return outs


def _select(mask: torch.Tensor, a: Dict[str, torch.Tensor],
            b: Dict[str, torch.Tensor], base) -> Dict[str, torch.Tensor]:
    """Per row ``a`` where ``mask`` else ``b`` (dicts of changed leaves
    over ``base``); a leaf both sides leave as the same tensor stays that
    tensor (the reference's cond passthrough)."""
    out = {}
    for k in set(a) | set(b):
        va = a.get(k, base[k])
        vb = b.get(k, base[k])
        out[k] = va if va is vb else torch.where(rows(mask, va), va, vb)
    return out


class _Lifted:
    """The recorded function, cut at its top-level loops, with the state
    each later piece reads: the shared machinery of the single- and
    multi-phase builders."""

    def __init__(self, rec: loops.Recording, arg_vids: List[int],
                 out_leaves: List[torch.Tensor]):
        tape = rec.tape
        self.tape = tape
        self.loops = rec.loops
        self.out_vids: List[Optional[int]] = [rec.main_vid(o)
                                              for o in out_leaves]
        self.out_vals = [o.clone() for o in out_leaves]
        bad = {i: _dtype_name(o.dtype) for i, o in enumerate(out_leaves)
               if o.dtype not in _32BIT}
        if bad:
            raise LiftError(
                "the function's outputs must be 32-bit words; non-32-bit "
                f"outputs (by position): {bad}")
        bounds = [lp.at_op for lp in self.loops] + [len(tape.ops)]
        self.prologue = tape.ops[:bounds[0]]
        self.segments = [tape.ops[bounds[p]:bounds[p + 1]]
                         for p in range(len(self.loops))]
        literal = tape.literal
        env = set(arg_vids) | {v for op in self.prologue for v in op.outs}
        env |= {v for v, t in tape.consts.items() if v not in literal}
        fixed = tape.fixed
        produced_after = {v for seg in self.segments for op in seg
                          for v in op.outs}
        for lp in self.loops:
            produced_after.update(lp.out_vids)
        # Prologue values read past the first loop boundary (the
        # reference's _free_prologue_vars, in its visiting order).
        needed: List[int] = []
        seen = set()

        def visit(v):
            if v is None or v in literal or v in fixed or v in seen:
                return
            seen.add(v)
            if v in env and v not in produced_after:
                needed.append(v)

        for seg in self.segments:
            for op in seg:
                for v in op.ins:
                    visit(v)
        for lp in self.loops[1:]:
            for v in lp.in_vids:
                visit(v)
        for v in self.out_vids:
            visit(v)
        self.g_map: Dict[int, str] = {}
        # Interlude values later phases read (``m<i>`` leaves; a
        # multi-phase build fills it in).
        self.mm_map: Dict[int, str] = {}
        self.baked: Dict[int, torch.Tensor] = {v: tape.val[v]
                                               for v in literal}
        self.baked.update(fixed)
        # The reference's equation count of each piece after a loop, where
        # the recorded code said (the C front end).
        self.seg_eqns = [sum(n for at, n in tape.eqns
                             if bounds[p] <= at < bounds[p + 1])
                         if tape.eqns else None
                         for p in range(len(self.loops))]
        for v in needed:
            if tape.dtype[v] in _32BIT:
                self.g_map[v] = f"g{len(self.g_map)}"
            else:
                self.baked[v] = tape.val[v]
        self.g_vals = {leaf: tape.val[v] for v, leaf in self.g_map.items()}
        if len(self.loops) == 1:
            self.phases = [_Phase(self.loops[0], "", "_t")]
        else:
            self.phases = [_Phase(lp, f"p{p}_", f"p{p}_i")
                           for p, lp in enumerate(self.loops)]
        # Which state leaf each program argument became (flat arg index).
        self.arg_leaves: Dict[int, str] = {}
        index = {v: i for i, v in enumerate(arg_vids)}
        for v, leaf in self.g_map.items():
            if v in index:
                self.arg_leaves[index[v]] = leaf
        for lp, ph in zip(self.loops, self.phases):
            for v, leaf in zip(lp.in_vids, ph.leaf_names_by_position()):
                if v is not None and v in index:
                    self.arg_leaves.setdefault(index[v], leaf)
        self.out_words = sum(int(np.prod(o.shape, dtype=np.int64))
                             for o in out_leaves)

    def leaf_values(self) -> Dict[str, torch.Tensor]:
        """Each state leaf that holds a recorded value, with the tensor
        it was made from (its first value)."""
        out = {leaf: self.tape.val[v] for v, leaf in self.g_map.items()}
        out.update({leaf: self.tape.val[v]
                    for v, leaf in self.mm_map.items()})
        for lp, ph in zip(self.loops, self.phases):
            out.update(zip(ph.leaf_names_by_position(), lp.in_objs))
            p = ph.prefix
            if lp.prim == "scan":
                ys = lp.out_vids[lp.n_carry:]
                out.update({f"{p}y{j}": self.tape.val[v]
                            for j, v in enumerate(ys)})
        return out

    def program(self, ops, state_vids: Dict[int, str],
                outs: List[Optional[int]]) -> "_Segment":
        """A recorded segment as a function of the state: its inputs are
        the state-backed values it reads (``state_vids``: value id ->
        leaf), its outputs ``outs`` (a literal, None, is filled in)."""
        made = {v for op in ops for v in op.outs}
        reads = []
        for v in [v for op in ops for v in op.ins] + list(outs):
            if v in state_vids and v not in made and v not in reads:
                reads.append(v)
        return _Segment(self, ops, reads, state_vids, outs)


class _Segment:
    def __init__(self, lifted: _Lifted, ops, reads, state_vids, outs):
        self.reads = reads
        self.state_vids = state_vids
        self.outs = outs
        self.prog = loops.Program(ops, reads,
                                  [v for v in outs if v is not None],
                                  lifted.baked)

    def __call__(self, st, batch: int, dev, literal_vals=None):
        got = iter(self.prog.rows([st[self.state_vids[v]]
                                   for v in self.reads], batch, dev))
        out = []
        for i, v in enumerate(self.outs):
            if v is None:
                x = literal_vals[i].to(dev)
                out.append(x.expand(batch, *x.shape).contiguous())
            else:
                out.append(next(got))
        return out


def lift_fn(name: str,
            fn: Callable,
            *example_args,
            annotations: Optional[Dict[str, LeafSpec]] = None,
            default_xmr: bool = True,
            max_steps: Optional[int] = None,
            step_cap: int = 1 << 16,
            meta: Optional[dict] = None,
            unsigned_of: Optional[Callable[[torch.Tensor], bool]] = None,
            device=device_mod.DEFAULT) -> Region:
    """Derive a Region from a whole function.

    EVERY top-level ``loops.scan`` / ``loops.while_loop`` becomes a stepped
    phase.  The prologue is evaluated once (the function runs on the CPU
    under the recorder) into the initial state; code between loops runs
    as stepped phase transitions; an epilogue with real work runs as a
    FINAL stepped transition writing the flattened output into an
    ``_outbuf`` leaf, a trivial one stays in output().  ``device`` is
    where a ``while`` phase's ``nominal_steps`` is measured.

    Leaf names: ``c<i>`` loop carries, ``k<i>`` loop-invariant captures,
    ``x<i>`` scanned inputs, ``y<i>`` stacked outputs, ``_t`` the step
    counter, ``g<i>`` prologue values read past the loop (read-only);
    multi-loop regions prefix phase leaves ``p<N>_`` and add ``_phase``
    and ``m<i>`` leaves for interlude values later phases read.
    ``meta["arg_leaves"]`` maps each flat argument index to the leaf it
    became, where it has one.  ``unsigned_of(tensor)`` (the C front end's)
    says which recorded values the reference holds as uint32: each leaf
    made from one gets ``LeafSpec.unsigned``, as does ``_outbuf``."""
    flat_args, args_td = loops.flatten(tuple(example_args))
    flat_args = [_to_tensor(x) for x in flat_args]
    rec = loops.Recording()
    with torch.no_grad(), rec:
        arg_vids = [rec.tape.bind_input(a) for a in flat_args]
        out = fn(*loops.unflatten(args_td, flat_args))
    out_leaves = [loops.as_word(o) for o in loops.flatten(out)[0]]
    if not rec.loops:
        raise LiftError(
            "no top-level loops.scan/loops.while_loop found to step the "
            "program at; write the main loop with loops.scan/while_loop, "
            "or author a stepped region via lift_step()")
    lifted = _Lifted(rec, arg_vids, out_leaves)
    meta = {"arg_leaves": lifted.arg_leaves, **(meta or {})}
    build = _lift_fn_single if len(lifted.loops) == 1 else _lift_fn_multi
    region = build(name, lifted, annotations, default_xmr, max_steps,
                   step_cap, meta, device)
    _check_replay(region, out_leaves)
    if unsigned_of is not None:
        for leaf, t in lifted.leaf_values().items():
            if leaf in region.spec and unsigned_of(t):
                region.spec[leaf] = dataclasses.replace(region.spec[leaf],
                                                        unsigned=True)
        if "_outbuf" in region.spec:
            region.spec["_outbuf"] = dataclasses.replace(
                region.spec["_outbuf"], unsigned=True)
    return region


def _check_replay(region: Region, out_leaves) -> None:
    """The lifted region, run fault-free once on the CPU, must give the
    function's own result: integer words bit for bit, float words to
    float32 rounding (the replay runs the body over a row axis, which may
    sum in another order).  A program the recorder got wrong fails here,
    not in a campaign."""
    final = region.run_unprotected("cpu")
    got = region.output({k: v.unsqueeze(0) for k, v in final.items()})[0]
    at = 0
    for want in out_leaves:
        n = want.numel()
        part = got[at:at + n].reshape(want.shape)
        at += n
        if want.dtype == torch.float32:
            ok = torch.allclose(part.view(torch.float32), want, rtol=1e-5,
                                atol=1e-6, equal_nan=True)
        else:
            ok = torch.equal(part, want.to(torch.int32))
        if not ok:
            raise LiftError(
                f"{region.name}: the lifted region's fault-free output "
                "differs from the function's own result; the recorder "
                "could not replay this function")


def _force_ro_g_leaves(g_leaves, annotations):
    """Prologue ``g<j>`` leaves are read-only unless the user says
    otherwise: no transition writes them (the reference pins them because
    its cond/switch outputs hide the passthrough from its analysis)."""
    if not g_leaves:
        return annotations
    return {**{leaf: LeafSpec(kind=KIND_RO) for leaf in g_leaves},
            **(annotations or {})}


def _zeros_on(dev):
    return lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=dev)


def _lift_fn_single(name, lifted: _Lifted, annotations, default_xmr,
                    max_steps, step_cap, meta, device):
    phase = lifted.phases[0]
    lp = lifted.loops[0]
    in_vals = lp.in_vals
    annotations = _force_ro_g_leaves(lifted.g_vals, annotations)
    # The epilogue reads the loop's outputs and the g leaves.
    state_vids = dict(lifted.g_map)
    state_vids.update(zip(lp.out_vids, _out_leaf_names(phase)))
    epilogue = lifted.program(lifted.segments[0], state_vids,
                              lifted.out_vids)
    out_vals = lifted.out_vals

    def eval_epilogue(st):
        batch, dev = _batch(st), _device_of(st)
        return _flat_words(epilogue(st, batch, dev, out_vals), batch)

    def base_init(dev):
        st = phase.leaves_from_invals(
            [v.to(dev, copy=True) for v in in_vals], _zeros_on(dev))
        st.update({k: v.to(dev, copy=True)
                   for k, v in lifted.g_vals.items()})
        return st

    if _epilogue_is_heavy(lifted.segments[0], lifted.seg_eqns[0]):
        # The epilogue runs as ONE extra stepped transition writing the
        # flattened output image into ``_outbuf`` -- inside the injection
        # window (the reference's exitMarker final memory image).  Both
        # sides are computed every step and selected per row, as the
        # reference's vmapped lax.cond is.
        def init_fn(dev):
            return {**base_init(dev),
                    "_phase": torch.zeros((), dtype=torch.int32, device=dev),
                    "_outbuf": torch.zeros((lifted.out_words,),
                                           dtype=torch.int32, device=dev)}

        def step(st, t):
            batch, dev = _batch(st), _device_of(st)
            it = phase.iter_step(st, batch, dev)
            epi = {"_outbuf": eval_epilogue(st),
                   "_phase": torch.ones_like(st["_phase"])}
            go = phase.phase_done(st, batch, dev) & (st["_phase"] == 0)
            return _select(go, epi, it, st)

        def done(st):
            return st["_phase"] >= 1

        def output(st):
            return st["_outbuf"]

        nominal = phase.length + 1 if phase.prim == "scan" else None
        return lift_step(
            name, step, init_fn, done=done, output=output,
            nominal_steps=nominal, max_steps=max_steps,
            annotations=annotations, default_xmr=default_xmr,
            step_cap=step_cap, device=device,
            meta={"lifted_from": "fn", "loop": phase.prim,
                  "stepped_epilogue": True, **(meta or {})})

    def step(st, t):
        return phase.iter_step(st, _batch(st), _device_of(st))

    def done(st):
        return phase.phase_done(st, _batch(st), _device_of(st))

    nominal = phase.length if phase.prim == "scan" else None
    return lift_step(
        name, step, base_init, done=done, output=eval_epilogue,
        nominal_steps=nominal, max_steps=max_steps,
        annotations=annotations, default_xmr=default_xmr,
        step_cap=step_cap, device=device,
        meta={"lifted_from": "fn", "loop": phase.prim, **(meta or {})})


def _out_leaf_names(phase: _Phase) -> List[str]:
    p = phase.prefix
    names = [f"{p}c{j}" for j in range(phase.n_carry)]
    if phase.prim == "scan":
        names += [f"{p}y{j}" for j in range(len(phase.loop.ys_shapes))]
    return names


def _lift_fn_multi(name, lifted: _Lifted, annotations, default_xmr,
                   max_steps, step_cap, meta, device):
    """Multi-phase region: phase p runs loop p one iteration a step; when
    loop p completes, ONE transition step evaluates the interlude, seeds
    phase p+1's leaves and advances ``_phase``.  A heavy epilogue runs in
    the final transition (into ``_outbuf``); a trivial one stays in
    output()."""
    lps, phases, segments = lifted.loops, lifted.phases, lifted.segments
    m = len(lps)
    tape = lifted.tape
    literal = tape.literal

    # Interlude values later pieces read live in state: m<j> leaves.
    mm_map: Dict[int, str] = {}
    m_producer: Dict[int, int] = {}
    for p in range(m - 1):
        consumed_later = set()
        for q in range(p + 1, m):
            for op in segments[q]:
                consumed_later.update(op.ins)
            consumed_later.update(v for v in lps[q].in_vids if v is not None)
        consumed_later.update(v for v in lifted.out_vids if v is not None)
        for op in segments[p]:
            for v in op.outs:
                if v in consumed_later and v not in mm_map \
                        and v not in literal:
                    if tape.dtype[v] not in _32BIT:
                        raise LiftError(
                            f"interlude value of dtype "
                            f"{_dtype_name(tape.dtype[v])} is consumed by a "
                            "later phase; only 32-bit values can cross "
                            "phases (word-addressed memory map)")
                    mm_map[v] = f"m{len(mm_map)}"
                    m_producer[v] = p

    lifted.mm_map = mm_map
    annotations = _force_ro_g_leaves(lifted.g_vals, annotations)
    later_in = [lp.in_vals for lp in lps]
    stepped_epi = _epilogue_is_heavy(segments[m - 1], lifted.seg_eqns[m - 1])

    def state_vids(upto: int) -> Dict[int, str]:
        sv = dict(lifted.g_map)
        sv.update(mm_map)
        for q in range(upto + 1):
            sv.update(zip(lps[q].out_vids, _out_leaf_names(phases[q])))
        return sv

    # Transition p: interlude p's outputs are loop p+1's inputs and the
    # m leaves it produces; the final one gives the function's outputs.
    trans = []
    for p in range(m):
        if p < m - 1:
            mine = [v for v, q in m_producer.items() if q == p]
            outs = list(lps[p + 1].in_vids) + mine
            trans.append((lifted.program(segments[p], state_vids(p), outs),
                          mine))
        else:
            trans.append((lifted.program(segments[p], state_vids(p),
                                         lifted.out_vids), []))

    def init_fn(dev):
        zeros = _zeros_on(dev)
        st = {"_phase": torch.zeros((), dtype=torch.int32, device=dev),
              **{k: v.to(dev, copy=True) for k, v in lifted.g_vals.items()}}
        st.update(phases[0].leaves_from_invals(
            [v.to(dev, copy=True) for v in later_in[0]], zeros))
        for p in range(1, m):
            st.update(phases[p].leaves_from_invals(
                [zeros(v.shape, v.dtype) for v in later_in[p]], zeros))
        for v, leaf in mm_map.items():
            st[leaf] = zeros(tape.shape[v], tape.dtype[v])
        if stepped_epi:
            st["_outbuf"] = zeros((lifted.out_words,), torch.int32)
        return st

    def transition(p, st, batch, dev):
        new: Dict[str, torch.Tensor] = {}
        seg, mine = trans[p]
        if p < m - 1:
            n_in = len(lps[p + 1].in_vids)
            vals = seg(st, batch, dev, later_in[p + 1] + [None] * len(mine))
            zeros = lambda shape, dtype: torch.zeros(  # noqa: E731
                (batch, *shape), dtype=dtype, device=dev)
            new.update(phases[p + 1].leaves_from_invals(vals[:n_in], zeros))
            for v, val in zip(mine, vals[n_in:]):
                new[mm_map[v]] = val
        elif stepped_epi:
            new["_outbuf"] = _flat_words(
                seg(st, batch, dev, lifted.out_vals), batch)
        new["_phase"] = st["_phase"] + 1
        return new

    def step(st, t):
        batch, dev = _batch(st), _device_of(st)
        ph = torch.clamp(st["_phase"], 0, m - 1)
        # The phases some row is in, in one host read: another phase's
        # work would be selected away (a capture records every phase, as
        # the reference's switch under vmap computes every branch).
        live = ([True] * m if voters.CAPTURE else
                (torch.bincount(ph.reshape(-1), minlength=m) > 0).tolist())
        out: Dict[str, torch.Tensor] = {}
        for p in range(m):
            if not live[p]:
                continue
            br = _select(phases[p].phase_done(st, batch, dev),
                         transition(p, st, batch, dev),
                         phases[p].iter_step(st, batch, dev), st)
            # A leaf phase p leaves alone keeps ``out``'s value: rows in
            # phase p hold the base value there already.
            in_p = ph == p
            for k, v in br.items():
                prev = out.get(k, st[k])
                out[k] = v if v is prev else torch.where(rows(in_p, v), v,
                                                         prev)
        return out

    def done(st):
        return st["_phase"] >= m

    def output(st):
        if stepped_epi:
            return st["_outbuf"]
        batch, dev = _batch(st), _device_of(st)
        seg, _ = trans[m - 1]
        return _flat_words(seg(st, batch, dev, lifted.out_vals), batch)

    # Explicit prologue/loop/interlude/epilogue structure for CFCSS:
    # entry=0, loop<p>=2p+1, inter<p>=2p+2, exit=2m+1.
    names = ["entry"]
    for p in range(m):
        names += [f"loop{p}", f"inter{p}"]
    names.append("exit")
    edges = [(0, 1), (0, 2)]
    for p in range(m):
        lp_, ip = 2 * p + 1, 2 * p + 2
        edges += [(lp_, lp_), (lp_, ip)]
        nxt = 2 * (p + 1) + 1 if p + 1 < m else 2 * m + 1
        edges.append((ip, nxt))
        if p + 1 < m:
            edges.append((ip, 2 * (p + 1) + 2))   # zero-trip next loop
    exit_b = 2 * m + 1

    def block_of(st):
        batch, dev = _batch(st), _device_of(st)
        ph = torch.clamp(st["_phase"], 0, m - 1)
        blk = torch.zeros(batch, dtype=torch.int32, device=dev)
        for p in range(m):
            b = pick(phases[p].phase_done(st, batch, dev), 2 * p + 2,
                     2 * p + 1)
            blk = torch.where(ph == p, b, blk)
        return pick(st["_phase"] >= m, exit_b, blk)

    graph = BlockGraph(names=names, edges=edges, block_of=block_of)
    return lift_step(
        name, step, init_fn, done=done, output=output,
        nominal_steps=None, max_steps=max_steps,
        annotations=annotations, default_xmr=default_xmr,
        step_cap=step_cap, graph=graph, device=device,
        meta={"lifted_from": "fn", "loops": [ph.prim for ph in phases],
              "phases": m, **(meta or {})})
