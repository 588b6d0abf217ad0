"""Restricted-C frontend: ingest reference benchmark sources directly.

The counterpart of ``coast_tpu/frontend/c_lifter.py``.  The reference
protects arbitrary programs handed to ``opt`` as LLVM IR
(cloning.cpp:62-288); its benchmarks are C files under tests/.  This
module parses a restricted C subset with pycparser, compiles the AST to a
torch function over ``c_array.Array`` words (globals become function
inputs, ``printf`` arguments become observed outputs), and hands that
function to ``lift_fn`` -- so every top-level C loop becomes a stepped
phase of the derived Region and the whole protection/injection stack
applies unchanged.  The compiler is the reference's, statement for
statement: ``lax.scan`` / ``lax.while_loop`` are ``frontend.loops``'s, a
traced ``if`` runs both branches and selects per row (what the
reference's ``lax.cond`` is under ``vmap``), and every word carries the
reference's dtype, so the lifted region has the reference's leaves,
kinds and records.  The compiler's Python runs once to record a loop
body, and again for each trip of a nested static loop (unrolled) or a
nested ``while`` (run for its values); its counters are reset per call
(``_FlowMixin._replayable``) so it leaves the state one trace leaves.

Supported subset (enough for tests/mm_common/mm.c and friends; refusals
are loud and name the construct):

  * global scalars/arrays of 32-bit integer types, with initializers;
  * ``typedef`` of integer types; ``#define NAME literal``;
  * functions with int parameters/locals, ``for`` loops (any bounds --
    statically-counted loops lower to ``loops.scan``, general ones to
    ``loops.while_loop``), ``if``/``else``, ternaries, assignments
    (including ``+=`` family, ``++``/``--``), array subscripts,
    integer arithmetic/bitwise/comparison ops, calls to other functions
    defined in the same translation unit, and ``printf`` (its arguments
    become program outputs -- the reference's QEMU loop greps stdout, so
    stdout IS the observable; prints must sit OUTSIDE loops/branches,
    where the printed value is a well-defined program output);
  * narrow integer types (char/short/uint8_t/uint16_t): modeled with
    exact C value semantics -- values live promoted in int32 lanes and
    every store/cast re-normalizes (mask + sign-extend), so byte/short
    wraparound (CRC state machines) is bit-exact; memory LAYOUT stays
    one lane word per element (the word-addressed injection model;
    bits above the declared width are masked at read, since they do
    not exist in real byte memory);
  * pointer parameters walked over a global array (``*p++``, ``p[i]``
    after ``p++``, ``p + k``, ``p = p + 1``), char-pointer globals
    initialized with a string literal (crc16.c's message), LOCAL
    pointer variables bound to arrays (``char *p = s;`` incl. through
    pointer casts), and deref stores (``*p++ = c``) -- a pointer is an
    int32 walk cursor over its aliased array;
  * caller-LOCAL arrays passed by reference (sha256.c's
    ``sha256_hash(data, bitlen, state, ...)``): modeled as
    copy-in/copy-out through a transient slot, sound because the
    subset has no overlapping aliases;
  * local array declarations (``uint32_t m[64]``), function-like
    macros with continuation lines (ROTRIGHT, DBL_INT_ADD), comma
    expressions in ``for`` init/next, character constants;
  * ``while``/``for`` conditions with side effects (``while
    (length--)``) via a rotated loop lowering; the run-once
    ``while (1) { ...; break; }`` idiom; mid-loop conditional breaks
    (``if (c) break;`` -- lowered to a carried flag with exact C
    semantics: the broken-out iteration skips the rest of the body AND
    the for-next); structured early ``return``s anywhere in a function
    (carried flag pair, same masking discipline; a printf AFTER an
    early-return point refuses loudly -- whether it prints would be
    data-dependent, so it cannot be a fixed program output) -- other
    break/goto placements refuse loudly;
  * COAST.h annotation macros are stripped and recorded
    (``__DEFAULT_NO_xMR``, ``__xMR``, ``__NO_xMR``).

Integer model: ILP32, matching the reference's Cortex-A9/MSP430 targets
-- ``int``/``long``/pointers-free code where ``unsigned long`` is 32
bits.  All arithmetic is mod-2^32 (uint32) or int32.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from coast_tpu_torch import device as device_mod
from coast_tpu_torch.frontend import c_array as cnp
from coast_tpu_torch.frontend.lifter import LiftError, lift_fn  # noqa: F401
from coast_tpu_torch.ir.region import LeafSpec, Region
from coast_tpu_torch.frontend.c_types import c_ast, c_parser

from coast_tpu_torch.frontend.c_types import (           # noqa: F401  (re-export)
    _PRINT_BUF_WORDS, CLiftError, _C64, _CType, _CType64, _NoPrintList,
    _Scope, _c64_add,
    _c64_divmod, _c64_lt, _c64_mul, _c64_neg, _c64_shl, _c64_shr,
    _const_int, _ctype_of, _mulhi_u32, _to64)
from coast_tpu_torch.frontend.c_preproc import (         # noqa: F401  (re-export)
    _COAST_MACROS, _COAST_STRIP_CALLS, _COAST_STRIP_TOKENS, _PRELUDE,
    _strip_comments, preprocess)
from coast_tpu_torch.frontend.c_eval import _EvalMixin
from coast_tpu_torch.frontend.c_flow import _FlowMixin


class _Compiler(_EvalMixin, _FlowMixin):
    def __init__(self, tu, typedefs, funcs, name: str,
                 g_ctypes: Optional[Dict[str, _CType]] = None,
                 g_ptrs: Optional[set] = None):
        self.tu = tu
        self.typedefs = typedefs
        self.funcs = funcs
        self.name = name
        self.g_ctypes = dict(g_ctypes or {})
        # Global pointer variables: their int32 CURSOR lives in the
        # globals dict (runtime, injectable state); the aliased base
        # array is static, resolved at the first seating and required
        # to stay the same (motion's ld_Rdptr over ld_Rdbfr).
        self.g_ptrs: set = set(g_ptrs or ())
        self.g_ptr_base: Dict[str, str] = {}
        self._tmp = 0          # transient copy-in/out slot counter
        # id(node) -> reason, for synthesized guard Ifs whose printf
        # refusal should name the REAL construct (pycparser nodes have
        # __slots__, so no attribute can be set on them).
        self._synth_reason = {}
        # Desugar pre-pass state (switch / do-while / while(1)-unroll /
        # branch print slots), memoized per function definition.
        self._desugared: set = set()
        self._print_slots: Dict[int, List[Tuple[str, int]]] = {}
        self._sw_temps: Dict[int, List[str]] = {}
        self._assigned_globals_cache: Dict[int, List[str]] = {}
        self.print_strings: List[str] = []     # slot id -> format string

    def _run_function(self, fndef, args, outer_sc: _Scope,
                      arg_consts: Optional[List[Optional[int]]] = None):
        self._desugar_fn(fndef)
        fid = id(fndef)
        sc = _Scope(outer_sc.g, self.g_ctypes)
        sc.printed = outer_sc.printed       # printf threads through
        # Known-constant GLOBALS flow into the callee (locals shadowing
        # a global keep their constness out of it).
        sc.consts = {n: v for n, v in outer_sc.consts.items()
                     if n not in outer_sc.locals}
        for nm, _k in self._print_slots.get(fid, ()):
            sc.locals[nm] = cnp.int32(-1)   # -1 = this line never printed
            sc.consts[nm] = -1
        for nm in self._sw_temps.get(fid, ()):
            sc.locals[nm] = cnp.int32(0)
            sc.consts.pop(nm, None)
        params = []
        decl = fndef.decl.type
        if decl.args:
            params = [p for p in decl.args.params
                      if not isinstance(p, c_ast.EllipsisParam)
                      and getattr(p, "name", None) is not None]
            if getattr(fndef, "param_decls", None):
                # K&R-style definition (blowfish's OpenSSL-vintage
                # `void BF_encrypt(data, key) BF_LONG *data; ...`):
                # the identifier list carries bare IDs; the real Decls
                # live in param_decls.
                by_name = {d.name: d for d in fndef.param_decls}
                params = [by_name.get(p.name, p) for p in params]
        if len(params) != len(args):
            raise CLiftError(
                f"{fndef.decl.name}: {len(args)} args for {len(params)} "
                "parameters (array parameters pass the global by name)")
        walked = self._walked_names(fndef.body)
        copy_backs: List[Tuple[str, str]] = []
        scalar_backs: List[Tuple[str, str]] = []
        g_scalar_backs: List[Tuple[str, str, object]] = []
        for pi, (p, a) in enumerate(zip(params, args)):
            if (isinstance(a, tuple) and len(a) == 2
                    and a[0] == "__alias_scalar_global__"):
                temp = f"__loc{self._tmp}"
                self._tmp += 1
                gv = sc.g[a[1]]
                sc.g[temp] = cnp.reshape(gv, (1,))
                oct_ = self.g_ctypes.get(a[1])
                if oct_ is not None:
                    sc.ctypes[temp] = oct_
                sc.aliases[p.name] = temp
                sc.locals[p.name] = cnp.int32(0)
                g_scalar_backs.append((temp, a[1], gv.dtype))
                continue
            if (isinstance(a, tuple) and len(a) == 2
                    and a[0] == "__alias_scalar_local__"):
                temp = f"__loc{self._tmp}"
                self._tmp += 1
                val0 = outer_sc.locals[a[1]]
                sc.g[temp] = (cnp.stack([val0.lo, val0.hi]).reshape(1, 2)
                              if isinstance(val0, _C64)
                              else cnp.reshape(val0, (1,)))
                oct_ = outer_sc.ctype(a[1])
                if oct_ is not None:
                    sc.ctypes[temp] = oct_
                sc.aliases[p.name] = temp
                sc.locals[p.name] = cnp.int32(0)
                scalar_backs.append((temp, a[1]))
                continue
            if isinstance(a, tuple) and a[0] == "__alias_local_off__":
                # Caller-local array element address: transient slot
                # with the cursor starting at the element's offset.
                temp = f"__loc{self._tmp}"
                self._tmp += 1
                sc.g[temp] = outer_sc.locals[a[1]]
                oct_ = outer_sc.ctype(a[1])
                if oct_ is not None:
                    sc.ctypes[temp] = oct_
                sc.aliases[p.name] = temp
                sc.locals[p.name] = cnp.asarray(a[2], cnp.int32)
                copy_backs.append((temp, a[1]))
                continue
            if (isinstance(a, tuple) and len(a) == 2
                    and a[0] == "__alias_local__"):
                # Caller-local array passed by reference: copy into a
                # transient slot of the (shared) globals dict, alias the
                # parameter to it, and copy back after the body runs.
                temp = f"__loc{self._tmp}"
                self._tmp += 1
                sc.g[temp] = outer_sc.locals[a[1]]
                oct_ = outer_sc.ctype(a[1])
                if oct_ is not None:
                    sc.ctypes[temp] = oct_
                sc.aliases[p.name] = temp
                copy_backs.append((temp, a[1]))
                if p.name in walked:
                    sc.locals[p.name] = cnp.int32(0)
                continue
            if isinstance(a, tuple) and a[0] == "__alias_off__":
                # Forwarded pointer: alias the base, start the cursor at
                # the caller's offset.
                sc.aliases[p.name] = a[1]
                sc.locals[p.name] = cnp.asarray(a[2], cnp.int32)
            elif isinstance(a, tuple) and len(a) == 2 \
                    and a[0] == "__alias__":
                sc.aliases[p.name] = a[1]
                if p.name in walked:
                    # The body does pointer arithmetic on this parameter
                    # (``p++``): give it a walk cursor, carried like any
                    # other local through the body's loops.
                    sc.locals[p.name] = cnp.int32(0)
            else:
                ct = (_ctype_of(getattr(p.type.type, "names", ["int"]),
                                self.typedefs)
                      if isinstance(p.type, c_ast.TypeDecl) else None)
                if ct is not None:
                    sc.locals[p.name] = ct.store(a)
                    sc.ctypes[p.name] = ct
                else:
                    sc.locals[p.name] = a
                kc = arg_consts[pi] if arg_consts else None
                self._const_set(sc, p.name, kc,
                                ct if not isinstance(ct, _CType64)
                                else None)
        # Function-wide pointer pre-seating: a pointer seated over
        # DIFFERENT arrays in different loops (ChenIDct's aptr over x
        # then y) must take its union alias before the first loop
        # traces, not per-loop.
        self._preseat(fndef.body, sc)
        new_items, set_n, val_n, synth = self._rewrite_early_returns(fndef)
        if new_items is not None:
            rett = fndef.decl.type.type
            rct = (_ctype_of(getattr(rett.type, "names", ["int"]),
                             self.typedefs)
                   if isinstance(rett, c_ast.TypeDecl) else None)
            for n in synth:
                if n == val_n and rct is not None:
                    # The carried return value takes the declared return
                    # type from the start: every `return E` then
                    # converts E at the store (C semantics), and a
                    # 64-bit return stays a limb pair across cond
                    # branches (pytree consistency).
                    sc.locals[n] = rct.zero()
                    sc.ctypes[n] = rct
                    if isinstance(rct, _CType64):
                        sc.consts.pop(n, None)
                    else:
                        sc.consts[n] = 0
                else:
                    sc.locals[n] = cnp.int32(0)
                    sc.consts[n] = 0
            self._exec_block(
                c_ast.Compound(new_items, fndef.body.coord), sc)
            ret = sc.locals[val_n]
        else:
            ret = self._exec_block(fndef.body, sc)
        for temp, lname in copy_backs:
            outer_sc.locals[lname] = sc.g.pop(temp)
        for temp, gname, dt in g_scalar_backs:
            slot = sc.g.pop(temp)
            sc.g[gname] = cnp.reshape(slot, ()).astype(dt)
            outer_sc.consts.pop(gname, None)
        for temp, lname in scalar_backs:
            slot = sc.g.pop(temp)
            oct_ = outer_sc.ctype(lname)
            if isinstance(oct_, _CType64):
                pair = slot.reshape(-1, 2)[0]
                outer_sc.locals[lname] = _C64(pair[0], pair[1],
                                              oct_.unsigned)
            else:
                outer_sc.locals[lname] = cnp.reshape(slot, ())
            outer_sc.consts.pop(lname, None)   # written via the slot
        # Global constness after the call: invalidate exactly the
        # globals the callee may write (a callee-LOCAL shadowing a
        # global -- AddRoundKey's `int j, nb;` -- must not kill the
        # caller's knowledge of the global), then flow the callee's
        # known globals back (its view of its own writes is the truth).
        may_write = set(self._assigned_globals(fndef))
        for n in list(outer_sc.consts):
            if n not in outer_sc.locals and n in may_write:
                outer_sc.consts.pop(n, None)
        for n, v in sc.consts.items():
            if n not in sc.locals and n not in outer_sc.locals:
                outer_sc.consts[n] = v
        # A function's print slots join the output surface when it
        # returns.  At a traced call site (inside a loop/branch) the
        # slots flow into the UART buffer when the program has one --
        # only slots that actually fired (id >= 0) append -- otherwise
        # the printed sentinel refuses, as for any in-loop print.
        for nm, _k in self._print_slots.get(fid, ()):
            v = cnp.asarray(sc.locals[nm])
            if (isinstance(sc.printed, _NoPrintList)
                    and "__print_buf" in sc.g):
                buf = sc.g["__print_buf"]
                cnt = sc.g["__print_cnt"]
                fired = v >= 0
                idx = cnp.clip(cnt, 0, _PRINT_BUF_WORDS - 1)
                keep = cnp.logical_and(fired, cnt < _PRINT_BUF_WORDS)
                buf = buf.at[idx].set(
                    cnp.where(keep, v.astype(cnp.uint32), buf[idx]))
                cnt = cnt + fired.astype(cnp.int32)
                sc.g["__print_buf"] = buf
                sc.g["__print_cnt"] = cnt
            else:
                sc.printed.append(v)
        if ret is None:
            return cnp.int32(0)
        # C return-value conversion: the value converts to the declared
        # return type (a narrow return like TI_aes_128.c's galois_mul2
        # 'unsigned char' drops bit 8 HERE, not at some later store).
        rett = fndef.decl.type.type
        if isinstance(rett, c_ast.TypeDecl):
            ct = _ctype_of(getattr(rett.type, "names", ["int"]),
                           self.typedefs)
            ret = ct.store(ret)
        return ret

    # -- statements --------------------------------------------------------
    def _exec_block(self, block, sc: _Scope):
        if block is None:
            return None
        items = block.block_items or [] if isinstance(
            block, c_ast.Compound) else [block]
        for stmt in items:
            ret = self._exec_stmt(stmt, sc)
            if ret is not None:
                return ret
        return None

    def _exec_stmt(self, stmt, sc: _Scope):
        if isinstance(stmt, c_ast.Decl):
            if isinstance(stmt.type, c_ast.ArrayDecl):
                # Local array: zeros or element-wise initializer list.
                dims, t = [], stmt.type
                while isinstance(t, c_ast.ArrayDecl):
                    n = _const_int(t.dim)
                    if n is None:
                        if (t.dim is None and not dims
                                and isinstance(stmt.init, c_ast.InitList)):
                            n = len(stmt.init.exprs)   # char key[] = {..}
                        else:
                            raise CLiftError(
                                f"non-literal local array dim for "
                                f"{stmt.name} at {stmt.coord}")
                    dims.append(n)
                    t = t.type
                ct = _ctype_of(getattr(t.type, "names", ["int"]),
                               self.typedefs)
                if isinstance(ct, _CType64):
                    raise CLiftError(
                        f"long long array {stmt.name!r} at {stmt.coord}: "
                        "64-bit elements are outside the word-addressed "
                        "memory model (locals only)")
                arr = cnp.zeros(tuple(dims), ct.dtype)
                if stmt.init is not None:
                    if not isinstance(stmt.init, c_ast.InitList):
                        raise CLiftError(
                            f"unsupported local array initializer at "
                            f"{stmt.coord}")
                    flat = arr.reshape(-1)
                    exprs = list(stmt.init.exprs)
                    for k, e in enumerate(exprs):
                        flat = flat.at[k].set(
                            ct.store(self.eval(e, sc)).astype(ct.dtype))
                    arr = flat.reshape(tuple(dims))
                sc.locals[stmt.name] = arr
                sc.ctypes[stmt.name] = ct
                return None
            if isinstance(stmt.type, c_ast.PtrDecl):
                # Local pointer: binds to (global-or-copied array, offset).
                sc.ptrs.add(stmt.name)
                if stmt.init is None:
                    # Declared-but-unbound: a bare cursor with no alias
                    # until `p = arr;` re-seats it (adpcm.c's h_ptr);
                    # any deref before that fails loudly.  A function-
                    # wide pre-seat may already have aliased it.
                    sc.locals.setdefault(stmt.name, cnp.int32(0))
                    return None
                base, off = self._ptr_parts(stmt.init, sc)
                union = self._union_bases(sc.aliases.get(stmt.name))
                if union is not None and not isinstance(base, tuple):
                    off = (self._union_offset(sc, union, base)
                           + cnp.asarray(off, cnp.int32))
                else:
                    sc.aliases[stmt.name] = base
                sc.locals[stmt.name] = off
                return None
            ct = _ctype_of(getattr(stmt.type.type, "names", ["int"]),
                           self.typedefs)
            val = (ct.store(self.eval(stmt.init, sc))
                   if stmt.init is not None else ct.zero())
            sc.locals[stmt.name] = val
            sc.ctypes[stmt.name] = ct
            if isinstance(ct, _CType64):
                sc.consts.pop(stmt.name, None)
            else:
                # The model zero-initializes declared scalars, so a
                # no-init local IS the constant 0 at this point.
                self._const_set(
                    sc, stmt.name,
                    0 if stmt.init is None
                    else self._const_eval(stmt.init, sc), ct)
            return None
        if isinstance(stmt, c_ast.DeclList):
            for d in stmt.decls:
                self._exec_stmt(d, sc)
            return None
        if isinstance(stmt, c_ast.Assignment):
            self._assign(stmt, sc)
            return None
        if isinstance(stmt, (c_ast.UnaryOp, c_ast.FuncCall, c_ast.ExprList)):
            self.eval(stmt, sc)
            return None
        if isinstance(stmt, c_ast.If):
            return self._exec_if(stmt, sc)
        if isinstance(stmt, c_ast.For):
            return self._exec_for(stmt, sc)
        if isinstance(stmt, c_ast.While):
            return self._exec_while(stmt, sc)
        if isinstance(stmt, c_ast.Return):
            return (self.eval(stmt.expr, sc) if stmt.expr is not None
                    else cnp.int32(0))
        if isinstance(stmt, c_ast.Compound):
            return self._exec_block(stmt, sc)
        if isinstance(stmt, c_ast.EmptyStatement):
            return None
        raise CLiftError(
            f"unsupported statement {type(stmt).__name__} at {stmt.coord}")

    @staticmethod
    def _base_ids(expr) -> List[str]:
        """Base identifiers a pointer-valued expression could alias
        (static over-approximation for carry discovery)."""
        out: List[str] = []
        stack = [expr]
        while stack:
            e = stack.pop()
            if isinstance(e, c_ast.ID):
                out.append(e.name)
            elif isinstance(e, c_ast.Cast):
                stack.append(e.expr)
            elif isinstance(e, c_ast.UnaryOp) and e.op in ("&", "++", "p++",
                                                           "--", "p--"):
                stack.append(e.expr)
            elif isinstance(e, c_ast.ArrayRef):
                stack.append(e.name)
            elif isinstance(e, c_ast.BinaryOp) and e.op in ("+", "-"):
                stack.extend((e.left, e.right))
        return out

    def _assigned_names(self, node) -> List[str]:
        """Names written anywhere under ``node`` (loop-carry discovery).

        Local POINTERS complicate this: a deref-store ``*p = v`` writes
        the array ``p`` is seated on, so the seated base names (from
        ``T *p = arr;`` declarations and ``p = arr;`` re-seatings in the
        same subtree) are added for every deref-written pointer --
        without them, a callee that walks a global through a local
        pointer (adpcm.c's encode/decode delay lines) would not carry
        that global through the CALLER's loop, silently freezing it."""
        names: List[str] = []
        ptr_decls: set = set()
        seats: Dict[str, List[str]] = {}
        deref_targets: List[str] = []

        class V(c_ast.NodeVisitor):
            def visit_Assignment(v, n):
                t = n.lvalue
                derefed = False
                while isinstance(t, (c_ast.ArrayRef, c_ast.UnaryOp)):
                    # Unwrap a[i]... and deref lvalues (*p = v writes both
                    # the pointee and, via the walk machinery, p's cursor).
                    derefed = True
                    t = t.name if isinstance(t, c_ast.ArrayRef) else t.expr
                if isinstance(t, c_ast.ID):
                    names.append(t.name)
                    if t.name.startswith("__print_sel_"):
                        # Desugared branch print: its slot flows into
                        # the UART buffer at function end.
                        names.extend(["__print_buf", "__print_cnt"])
                    if derefed:
                        deref_targets.append(t.name)
                    elif n.op == "=":
                        seats.setdefault(t.name, []).extend(
                            _Compiler._base_ids(n.rvalue))
                v.generic_visit(n)

            def visit_UnaryOp(v, n):
                if n.op in ("++", "p++", "--", "p--"):
                    t = n.expr
                    while isinstance(t, c_ast.ArrayRef):
                        t = t.name
                    if isinstance(t, c_ast.ID):
                        names.append(t.name)
                v.generic_visit(n)

            def visit_Decl(v, n):
                if n.name:
                    names.append(n.name)
                    if isinstance(n.type, c_ast.PtrDecl):
                        ptr_decls.add(n.name)
                        if n.init is not None:
                            seats.setdefault(n.name, []).extend(
                                _Compiler._base_ids(n.init))
                v.generic_visit(n)

            def visit_FuncCall(v, n):
                # A called function may write globals directly or through
                # an array-pointer parameter; treat ID arguments bound to
                # POINTER/ARRAY parameters (and every callee-assigned
                # name) as written.  Scalar by-value parameters cannot
                # write the caller's variable -- and carrying them would
                # also destroy trace-time concreteness (aes_enc.c's `nb`
                # must stay concrete through the rounds loop for the
                # ciphertext print loop's static bound).
                if isinstance(n.name, c_ast.ID):
                    if n.name.name == "printf":
                        # printf only READS its arguments -- but under
                        # the UART-buffer model it writes the buffer.
                        names.extend(["__print_buf", "__print_cnt"])
                        v.generic_visit(n)
                        return
                    if n.name.name == "exit":
                        # exit() writes the poison observable; without
                        # this the write would die in a branch fork.
                        names.append("__exit_state")
                    callee = self.funcs.get(n.name.name)
                    params = []
                    if (callee is not None
                            and not getattr(callee, "param_decls", None)):
                        decl = callee.decl.type
                        if decl.args:
                            params = [p for p in decl.args.params
                                      if not isinstance(
                                          p, c_ast.EllipsisParam)]
                    for ai, a in enumerate(n.args.exprs if n.args else []):
                        if isinstance(a, c_ast.UnaryOp) and a.op == "&":
                            # Out-parameter (&aSig): the callee writes
                            # through it -- the pointee is written.
                            names.extend(_Compiler._base_ids(a))
                            continue
                        if isinstance(a, c_ast.ArrayRef):
                            # Sub-array argument (PMV[0][s]) decays to a
                            # pointer; conservatively count the base as
                            # written -- unless the callee's parameter
                            # is a by-value scalar (full indexing).
                            if params and ai < len(params):
                                pt = getattr(params[ai], "type", None)
                                if not isinstance(pt, (c_ast.PtrDecl,
                                                       c_ast.ArrayDecl)):
                                    continue
                            t2 = a
                            while isinstance(t2, c_ast.ArrayRef):
                                t2 = t2.name
                            if isinstance(t2, c_ast.ID):
                                names.append(t2.name)
                            continue
                        if not isinstance(a, c_ast.ID):
                            continue
                        if params and ai < len(params):
                            pt = getattr(params[ai], "type", None)
                            if not isinstance(pt, (c_ast.PtrDecl,
                                                   c_ast.ArrayDecl)):
                                continue    # by-value scalar
                        names.append(a.name)
                    if callee is not None:
                        names.extend(self._assigned_globals(callee))
                v.generic_visit(n)

        V().visit(node)
        # Deref-written pointers write their seated arrays.  A GLOBAL
        # pointer seated outside the analyzed node (gp = A before the
        # loop, gp[i] = v inside it) has no local seat entry; its
        # statically-known candidate bases stand in -- without them the
        # written array would drop out of a scan's carry.
        for p in dict.fromkeys(deref_targets):
            names.extend(seats.get(p, ()))
            if p in self.g_ptrs and p not in seats:
                names.extend(sorted(self._g_ptr_static_bases(p)))
        return list(dict.fromkeys(names))

    def _g_ptr_static_base(self, name: str) -> Optional[str]:
        """Static whole-program resolution of a global pointer's base:
        the single base array every seating agrees on (None if
        unseated/ambiguous)."""
        bases = self._g_ptr_static_bases(name)
        return next(iter(bases)) if len(bases) == 1 else None

    def _g_ptr_static_bases(self, name: str) -> frozenset:
        """ALL candidate base arrays a global pointer's seatings alias:
        scan every function for `name = <expr>` seatings, collapsing
        cursor-on-cursor chains.  Empty if never seated."""
        cache = getattr(self, "_g_ptr_seat_cache", None)
        if cache is None:
            cache = {}
            comp = self

            class V(c_ast.NodeVisitor):
                def visit_Assignment(v, n):
                    if (n.op == "=" and isinstance(n.lvalue, c_ast.ID)
                            and n.lvalue.name in comp.g_ptrs):
                        for b in comp._base_ids(n.rvalue):
                            if b != n.lvalue.name:
                                cache.setdefault(n.lvalue.name,
                                                 set()).add(b)
                    v.generic_visit(n)

            for fn in self.funcs.values():
                V().visit(fn.body)
            self._g_ptr_seat_cache = cache
        bases = cache.get(name)
        # Cursors seated on one another (ld_Rdmax = ld_Rdptr) collapse
        # through the other pointer's bases.
        for _ in range(4):
            if not bases:
                return frozenset()
            flat = set()
            again = False
            for b in bases:
                if b in self.g_ptrs:
                    sub = cache.get(b)
                    if sub:
                        flat |= sub
                        again = True
                else:
                    flat.add(b)
            bases = flat
            if not again:
                break
        return frozenset(bases)

    def _assigned_globals(self, fndef) -> List[str]:
        """Names a callee writes OUTSIDE its own scope: its assigned
        names minus its params and local declarations.  A callee-local
        shadowing a global (AddRoundKey's `int j, nb;` vs the global
        nb) must not count as a caller-side write -- it would both
        over-carry and invalidate constant propagation."""
        fid = id(fndef)
        cached = self._assigned_globals_cache.get(fid)
        if cached is not None:
            return cached
        self._assigned_globals_cache[fid] = []     # cut recursion cycles
        names = self._assigned_names(fndef.body)
        local: set = set()
        decl = fndef.decl.type
        if decl.args:
            for p in decl.args.params:
                nm = getattr(p, "name", None)
                if nm:
                    local.add(nm)

        class V(c_ast.NodeVisitor):
            def visit_Decl(v, n):
                if n.name:
                    local.add(n.name)
                v.generic_visit(n)

        V().visit(fndef.body)
        out = [n for n in names if n not in local]
        self._assigned_globals_cache[fid] = out
        return out

    def written_globals(self, fndef, g_names, subst=None):
        """Globals (transitively) written by ``fndef``, following array-
        argument aliasing: a callee's writes through an array parameter
        count against the global the caller passed."""
        subst = subst or {}
        out = set()
        comp = self

        # Local pointer variables (char *p = s;) route stores to their
        # target: track Decl-time bindings AND later re-seatings
        # (``p1 = (LONG *)s1;``) so deref stores through them count
        # against the right global (chains and casts included).
        local_ptr: Dict[str, str] = {}
        ptr_names: set = set()
        multi_seats: Dict[str, set] = {}        # union-pointer candidates

        def resolve(nm):
            for _ in range(8):
                if nm in local_ptr:
                    nm = local_ptr[nm]
                    continue
                if nm in comp.g_ptrs:
                    base = comp._g_ptr_static_base(nm)
                    if base is not None and base != nm:
                        nm = base
                        continue
                break
            return subst.get(nm, nm)

        def resolve_all(nm):
            """Every base a store through ``nm`` may write.  Unlike
            ``resolve``, an AMBIGUOUS global-pointer seating (gp = A in
            one function, gp = B in another) unions every candidate:
            conservatively over-reporting keeps injections into the
            really-written array out of the masked bucket."""
            out_s: set = set()
            frontier, seen = {nm}, set()
            for _ in range(8):
                nxt: set = set()
                for x in frontier:
                    if x in seen:
                        continue
                    seen.add(x)
                    if x in local_ptr:
                        nxt.add(local_ptr[x])
                        continue
                    if x in comp.g_ptrs:
                        bases = comp._g_ptr_static_bases(x) - {x}
                        if bases:
                            nxt.update(bases)
                            continue
                    out_s.add(subst.get(x, x))
                if not nxt:
                    break
                frontier = nxt
            return out_s

        def targets_of(t):
            while isinstance(t, (c_ast.ArrayRef, c_ast.UnaryOp)):
                t = t.name if isinstance(t, c_ast.ArrayRef) else t.expr
            if isinstance(t, c_ast.ID):
                return resolve_all(t.name)
            return set()

        def seat_base(expr):
            """First base identifier a seating RHS aliases, resolved."""
            for cand in _Compiler._base_ids(expr):
                r = resolve(cand)
                if r in g_names or cand in local_ptr or cand in subst:
                    return cand if cand in local_ptr else r
            return None

        class V(c_ast.NodeVisitor):
            def visit_Decl(v, n):
                if isinstance(n.type, c_ast.PtrDecl):
                    ptr_names.add(n.name)
                    if n.init is not None:
                        e = n.init
                        while isinstance(e, c_ast.Cast):
                            e = e.expr
                        if isinstance(e, c_ast.ID):
                            local_ptr[n.name] = e.name
                v.generic_visit(n)

            def visit_Assignment(v, n):
                # Reseating a pointer (``p = p + 1``, ``p1 = (LONG*)s1``,
                # parameter or local pointer variable) writes the walk
                # cursor / rebinds the alias, not the pointed-to global;
                # only element stores (ArrayRef/deref lvalues) write the
                # array.  Record the re-seating so later deref stores
                # route to the right base.
                if (isinstance(n.lvalue, c_ast.ID)
                        and (n.lvalue.name in subst
                             or n.lvalue.name in local_ptr
                             or n.lvalue.name in ptr_names)):
                    if n.op == "=":
                        base = seat_base(n.rvalue)
                        if base is not None and base != n.lvalue.name:
                            local_ptr[n.lvalue.name] = base
                            r = resolve(n.lvalue.name)
                            if r in g_names:
                                multi_seats.setdefault(
                                    n.lvalue.name, set()).add(r)
                    v.generic_visit(n)
                    return
                out.update(t for t in targets_of(n.lvalue)
                           if t in g_names)
                # A deref store through a MULTI-seated (union) pointer
                # may write any of its candidate bases.
                t2 = n.lvalue
                derefed = False
                while isinstance(t2, (c_ast.ArrayRef, c_ast.UnaryOp)):
                    derefed = True
                    t2 = (t2.name if isinstance(t2, c_ast.ArrayRef)
                          else t2.expr)
                if (derefed and isinstance(t2, c_ast.ID)
                        and len(multi_seats.get(t2.name, ())) > 1):
                    out.update(multi_seats[t2.name])
                v.generic_visit(n)

            def visit_UnaryOp(v, n):
                if n.op in ("++", "p++", "--", "p--"):
                    # Same rule: ++/-- on a bare pointer ID is cursor
                    # arithmetic.
                    if (isinstance(n.expr, c_ast.ID)
                            and (n.expr.name in subst
                                 or n.expr.name in local_ptr)):
                        return
                    out.update(t for t in targets_of(n.expr)
                               if t in g_names)
                v.generic_visit(n)

            def visit_FuncCall(v, n):
                if isinstance(n.name, c_ast.ID):
                    if (n.name.name == "exit"
                            and "__exit_state" in g_names):
                        out.add("__exit_state")
                    if n.name.name == "printf":
                        out.update({"__print_buf", "__print_cnt"}
                                   & set(g_names))
                    callee = comp.funcs.get(n.name.name)
                    if callee is not None:
                        decl = callee.decl.type
                        params = ([p.name for p in decl.args.params
                                   if not isinstance(p, c_ast.EllipsisParam)
                                   and p.name is not None]
                                  if decl.args else [])
                        sub2 = {}
                        args = n.args.exprs if n.args else []
                        for p, a in zip(params, args):
                            if isinstance(a, c_ast.ID):
                                tgt = resolve(a.name)
                                if tgt in g_names:
                                    sub2[p] = tgt
                            elif (isinstance(a, c_ast.UnaryOp)
                                    and a.op == "&"):
                                # &global out-param: the callee may
                                # write the pointee.
                                for b in comp._base_ids(a):
                                    if resolve(b) in g_names:
                                        out.add(resolve(b))
                        out.update(comp.written_globals(
                            callee, g_names, sub2))
                v.generic_visit(n)

        V().visit(fndef.body)
        return out

    @staticmethod
    def _union_bases(alias) -> Optional[Tuple[str, ...]]:
        """The member tuple of a union alias, or None for plain ones."""
        return alias if isinstance(alias, tuple) else None

    def _union_offset(self, sc: _Scope, bases: Tuple[str, ...],
                      member: str):
        off = 0
        for b in bases:
            if b == member:
                return cnp.int32(off)
            off += int(np.prod(cnp.shape(sc.g[b])))
        raise CLiftError(
            f"array {member!r} is not a member of the union pointer "
            f"over {bases}")

    def _union_read(self, sc: _Scope, bases: Tuple[str, ...]):
        return cnp.concatenate([sc.g[b].reshape(-1) for b in bases])

    def _union_write(self, sc: _Scope, bases: Tuple[str, ...],
                     flat) -> None:
        off = 0
        for b in bases:
            n = int(np.prod(cnp.shape(sc.g[b])))
            sc.write_binding(b, flat[off:off + n].reshape(
                cnp.shape(sc.g[b])))
            off += n

    def _preseat(self, node, sc: _Scope) -> None:
        """Seat outer-declared pointers whose FIRST seating happens inside
        ``node`` (a loop body or branch) before tracing it: the alias map
        is trace-time state, so the seating must be hoisted.  A single
        static base seats plainly; MULTIPLE same-dtype candidate bases
        (jpeg's huffman tables: `p = ac_tbl[i]` in one branch,
        `p = dc_tbl[i]` in the other) seat as a UNION pointer -- the
        cursor indexes the concatenation of the members, reads gather
        from it, writes split back, so the runtime branch merely picks
        the cursor's segment.  Anything else is left for _guard_reseat's
        loud refusal."""
        seats: Dict[str, List[str]] = {}
        decl_ptrs: set = set()

        class V(c_ast.NodeVisitor):
            def visit_Assignment(v, n):
                if n.op == "=" and isinstance(n.lvalue, c_ast.ID):
                    seats.setdefault(n.lvalue.name, []).extend(
                        _Compiler._base_ids(n.rvalue))
                v.generic_visit(n)

            def visit_Decl(v, n):
                if isinstance(n.type, c_ast.PtrDecl) and n.name:
                    decl_ptrs.add(n.name)
                    if n.init is not None:
                        seats.setdefault(n.name, []).extend(
                            _Compiler._base_ids(n.init))
                v.generic_visit(n)

        V().visit(node)
        for p, cands in seats.items():
            if (p not in sc.ptrs and p not in decl_ptrs) \
                    or p in sc.aliases:
                continue
            bases = {sc.aliases.get(c, c) for c in cands}
            bases = {b for b in bases
                     if b in sc.g and cnp.ndim(sc.g[b]) >= 1}
            if len(bases) == 1:
                sc.aliases[p] = bases.pop()
            elif len(bases) > 1:
                members = tuple(sorted(bases))
                dts = {sc.g[b].dtype for b in members}

                def ctkey(b):
                    ct = sc.ctypes.get(b)
                    # None and any 32-bit ctype behave identically on
                    # the lane model (no store narrowing); only NARROW
                    # members must match exactly.  64-bit members never
                    # unify (the limb-pair access paths do not speak
                    # unions) -- a unique key forces the loud
                    # _guard_reseat refusal instead.
                    if ct is not None and ct.bits == 64:
                        return ("w64", b)
                    if ct is None or ct.bits == 32:
                        return "w32"
                    return (ct.dtype, ct.bits, ct.unsigned)

                if len(dts) == 1 and len({ctkey(b) for b in members}) == 1:
                    sc.aliases[p] = members

    def _guard_reseat(self, sc, sub, coord):
        """Refuse pointer re-seating to a DIFFERENT array inside a traced
        sub-region (loop body/branch): the aliased base is resolved at
        trace time, so a per-iteration/per-branch base change cannot be
        expressed (same-base re-seating -- a cursor reset -- is a traced
        value write and passes)."""
        for n in sc.ptrs | set(sc.aliases):
            if sub.aliases.get(n) != sc.aliases.get(n):
                raise CLiftError(
                    f"pointer {n!r} re-seated to a different array inside "
                    f"a traced branch/loop at {coord}; hoist the "
                    "re-seating or restructure")

    def _loop_carry(self, stmt, sc) -> List[str]:
        """Variables the loop body writes that already exist in scope (the
        scan/while carry); body-local declarations stay local."""
        # A name that is itself a local (incl. a pointer parameter's walk
        # cursor, which shares its name with an alias) carries as that
        # local.  A WALKED pointer name additionally carries its aliased
        # global: ``p[0] = v`` inside the loop stores into the global
        # while ``p++`` moves the cursor, and both writes must survive
        # the iteration (a read-only extra carry is loop-invariant and
        # hoisted by XLA).
        assigned: List[str] = []

        def add_alias(alias):
            if isinstance(alias, tuple):
                assigned.extend(alias)           # union: every member
            else:
                assigned.append(alias)

        for n in self._assigned_names(stmt):
            if n in sc.locals:
                assigned.append(n)
                if n in sc.aliases:
                    add_alias(sc.aliases[n])
            else:
                add_alias(sc.aliases.get(n, n))
        return [n for n in dict.fromkeys(assigned)
                if n in sc.locals or n in sc.g]


def _string_bytes(lit: str) -> List[int]:
    """Decode a C string literal (quotes included) to its bytes + NUL."""
    body = lit[1:-1]
    decoded = body.encode("utf-8").decode("unicode_escape")
    return [b for b in decoded.encode("latin-1")] + [0]


def _normalize_init(vals: np.ndarray, ct: _CType) -> np.ndarray:
    """C conversion of initializer values into the declared type's lane."""
    if ct.bits == 32:
        return (vals & 0xFFFFFFFF).astype(np.uint32)
    mask = (1 << ct.bits) - 1
    v = (vals & mask).astype(np.int64)
    if not ct.unsigned:
        sign = 1 << (ct.bits - 1)
        v = ((v ^ sign) - sign)
    return v.astype(np.int64)


def _parse_globals(tu, typedefs):
    """Global declarations -> ({name: jnp array}, {name: _CType}).

    C linkage rules across the linked TUs: an ``extern`` declaration or
    a tentative (initializer-less) definition never OVERWRITES an
    earlier entry -- a shared header included by several TUs (CHStone
    sha.h's ``extern const int in_i[VSIZE]``) must not zero out the
    defining TU's initializer, in either include order."""
    out: Dict[str, cnp.Array] = {}
    ctypes: Dict[str, _CType] = {}
    inited: set = set()
    g_ptrs: set = set()          # uninitialized pointer globals (cursors)

    def flat_init(init) -> List[int]:
        if isinstance(init, c_ast.InitList):
            vals = []
            for e in init.exprs:
                vals.extend(flat_init(e))
            return vals
        v = _const_int(init)
        if v is None:
            raise CLiftError(f"unsupported global initializer at "
                             f"{init.coord}")
        return [v]

    for ext in tu.ext:
        if not isinstance(ext, c_ast.Decl) or isinstance(
                ext.type, c_ast.FuncDecl):
            continue
        t = ext.type
        shape = []
        deferred = False
        while isinstance(t, c_ast.ArrayDecl):
            n = _const_int(t.dim)
            if n is None:
                # Unsized outer dim (char key[] = {...}): C sizes it from
                # the initializer.
                if (t.dim is None and not shape
                        and isinstance(ext.init, c_ast.InitList)):
                    n = len(ext.init.exprs)
                elif t.dim is None and ext.init is None:
                    # extern/tentative unsized array (motion.h's
                    # `extern const unsigned char inRdbfr[];`): an
                    # incomplete type the defining declaration
                    # completes; defer -- never-defined names fail
                    # loudly at first read.
                    deferred = True
                    break
                else:
                    raise CLiftError(
                        f"non-literal array dim for {ext.name}")
            shape.append(n)
            t = t.type
        if deferred:
            continue
        if isinstance(t, c_ast.PtrDecl):
            # Two pointer-global shapes: a char pointer initialized with
            # a string literal (crc16.c's message) becomes the byte
            # array itself; an UNINITIALIZED pointer global (motion's
            # ld_Rdptr) becomes an int32 CURSOR global -- runtime,
            # injectable pointer state -- whose aliased base array is
            # resolved at its first seating (single static base).
            inner = t.type
            if (isinstance(inner, c_ast.TypeDecl)
                    and isinstance(ext.init, c_ast.Constant)
                    and ext.init.type == "string"):
                ct = _ctype_of(inner.type.names, typedefs)
                vals = np.array(_string_bytes(ext.init.value), np.int64)
                out[ext.name] = cnp.asarray(
                    _normalize_init(vals, ct)).astype(ct.dtype)
                ctypes[ext.name] = ct
                continue
            if ext.init is None:
                if ext.name not in out:
                    out[ext.name] = cnp.int32(0)
                    g_ptrs.add(ext.name)
                continue
            raise CLiftError(
                f"unsupported pointer global {ext.name!r} (only char* "
                "with a string-literal initializer, or an uninitialized "
                "pointer seated at runtime, is modeled)")
        if isinstance(t, c_ast.TypeDecl):
            ct = _ctype_of(t.type.names, typedefs)
            if isinstance(ct, _CType64) and not shape:
                raise CLiftError(
                    f"long long global scalar {ext.name!r}: model it as "
                    "an element of a 64-bit array (limb-pair layout) or "
                    "a local")
        else:
            raise CLiftError(f"unsupported global type for {ext.name}")
        if isinstance(ct, _CType64):
            # 64-bit ARRAY: (dims..., 2) uint32 limb pairs -- each
            # element is two 32-bit memory words (lo, hi), exactly the
            # real layout, so the word-addressed injection map holds
            # (dfmul/dfdiv test vectors).
            total = int(np.prod(shape))
            if ext.init is not None:
                vals = [(_const_int(e) if not isinstance(e, c_ast.InitList)
                         else None) for e in ext.init.exprs]
                if any(v is None for v in vals):
                    raise CLiftError(
                        f"unsupported 64-bit initializer for {ext.name}")
                vals += [0] * (total - len(vals))
                pairs = np.array([[v & 0xFFFFFFFF, (v >> 32) & 0xFFFFFFFF]
                                  for v in vals], dtype=np.uint32)
                arr = cnp.asarray(pairs).reshape(tuple(shape) + (2,))
                inited.add(ext.name)
            else:
                if ext.name in out:
                    continue
                arr = cnp.zeros(tuple(shape) + (2,), cnp.uint32)
            out[ext.name] = arr
            ctypes[ext.name] = ct
            continue
        if ext.init is not None:
            # int64 container so negative initializers wrap mod 2^32 (C
            # conversion to a 32-bit lane); partial initializer lists
            # zero-fill the tail, per C aggregate-initialization rules.
            vals = np.array(flat_init(ext.init), dtype=np.int64)
            total = int(np.prod(shape)) if shape else 1
            if len(vals) > total:
                raise CLiftError(
                    f"{ext.name}: {len(vals)} initializers for "
                    f"{total} elements")
            vals = np.concatenate(
                [vals, np.zeros(total - len(vals), np.int64)])
            arr = cnp.asarray(
                _normalize_init(vals, ct)).astype(ct.dtype)
            arr = arr.reshape(shape) if shape else arr.reshape(())
            inited.add(ext.name)
        else:
            if ext.name in out:
                # extern/tentative re-declaration of an existing name:
                # keep the existing (possibly initialized) definition.
                continue
            arr = cnp.zeros(tuple(shape) if shape else (), ct.dtype)
        out[ext.name] = arr
        ctypes[ext.name] = ct
    return out, ctypes, g_ptrs




def _static_for_shape(n) -> bool:
    """AST-only mirror of _static_trip's canonical literal-bound shape."""
    init, cond, nxt = n.init, n.cond, n.next
    if init is None or cond is None or nxt is None:
        return False
    if isinstance(init, c_ast.DeclList) and len(init.decls) == 1:
        var, a = init.decls[0].name, _const_int(init.decls[0].init)
    elif (isinstance(init, c_ast.Assignment) and init.op == "="
          and isinstance(init.lvalue, c_ast.ID)):
        var, a = init.lvalue.name, _const_int(init.rvalue)
    else:
        return False
    if a is None:
        return False
    if not (isinstance(cond, c_ast.BinaryOp) and cond.op in ("<", "<=")
            and isinstance(cond.left, c_ast.ID) and cond.left.name == var):
        return False
    if _const_int(cond.right) is None:
        return False
    if not (isinstance(nxt, c_ast.UnaryOp) and nxt.op in ("++", "p++")
            and isinstance(nxt.expr, c_ast.ID) and nxt.expr.name == var):
        return False

    # Mirror _static_trip's last condition: the loop variable must not
    # be written in the body (else the runtime classifier disagrees).
    written: List[bool] = []

    class _W(c_ast.NodeVisitor):
        def visit_Assignment(self, nn):
            if isinstance(nn.lvalue, c_ast.ID) and nn.lvalue.name == var:
                written.append(True)
            self.generic_visit(nn)

        def visit_UnaryOp(self, nn):
            if (nn.op in ("++", "p++", "--", "p--")
                    and isinstance(nn.expr, c_ast.ID)
                    and nn.expr.name == var):
                written.append(True)
            self.generic_visit(nn)

    _W().visit(n.stmt)
    return not written


def _needs_print_buffer(funcs) -> bool:
    """Does any value-printing printf sit where the printed arity
    cannot be static (dynamic loop, or branch under any loop)?"""
    need: List[bool] = []

    def walk(n, dyn_loop: int, any_loop: int, branch: int):
        if n is None or not isinstance(n, c_ast.Node):
            return
        if isinstance(n, (c_ast.While, c_ast.DoWhile)):
            walk(n.stmt, dyn_loop + 1, any_loop + 1, branch)
            return
        if isinstance(n, c_ast.For):
            d = 0 if _static_for_shape(n) else 1
            walk(n.stmt, dyn_loop + d, any_loop + 1, branch)
            return
        if isinstance(n, c_ast.If):
            walk(n.iftrue, dyn_loop, any_loop, branch + 1)
            walk(n.iffalse, dyn_loop, any_loop, branch + 1)
            return
        if (isinstance(n, c_ast.FuncCall)
                and isinstance(n.name, c_ast.ID)
                and n.name.name == "printf"
                and n.args is not None and len(n.args.exprs) > 1):
            if dyn_loop > 0 or (any_loop > 0 and branch > 0):
                need.append(True)
            return
        for _, ch in n.children():
            walk(ch, dyn_loop, any_loop, branch)

    for fn in funcs.values():
        walk(fn.body, 0, 0, 0)
    return bool(need)


def parse_c_sources(paths: Sequence[str]):
    """Parse + link the restricted-C sources into (tu, globals, funcs,
    typedefs, coast_annotations)."""
    include_dirs = sorted({os.path.dirname(os.path.abspath(p))
                           for p in paths})
    texts, anns = [], []
    name_flags: Dict[str, bool] = {}
    for p in paths:
        # Per-translation-unit preprocessing state (object-like AND
        # function-like defines), matching C: a macro from one source
        # file must not leak into the next.  Includes share the
        # including file's tables (textual inclusion).
        with open(p) as f:
            src, _, ann, _ = preprocess(f.read(), include_dirs,
                                        name_flags=name_flags,
                                        fdefines={})
        texts.append(src)
        anns.extend(ann)
    parser = c_parser.CParser()
    try:
        tu = parser.parse(_PRELUDE + "\n".join(texts),
                          filename="<coast_tpu>")
    except Exception as e:          # pycparser ParseError and lexer errors
        raise CLiftError(f"C parse error: {e}") from e

    typedefs: Dict[str, object] = {}
    funcs: Dict[str, object] = {}
    for ext in tu.ext:
        if isinstance(ext, c_ast.Typedef):
            base = ext.type
            if isinstance(base, c_ast.TypeDecl):
                names = getattr(base.type, "names", ["int"])
                typedefs[ext.name] = _ctype_of(names, typedefs)
        elif isinstance(ext, c_ast.FuncDef):
            funcs[ext.decl.name] = ext
    globals_, g_ctypes, g_ptrs = _parse_globals(tu, typedefs)

    # Any exit() call introduces the synthetic observable __exit_state
    # (0 = ran to completion; 1+n = exited with code n).
    class _ExitScan(c_ast.NodeVisitor):
        found = False

        def visit_FuncCall(self, n):
            if isinstance(n.name, c_ast.ID) and n.name.name == "exit":
                _ExitScan.found = True
            self.generic_visit(n)

    for fn in funcs.values():
        _ExitScan().visit(fn.body)
    if _ExitScan.found:
        globals_["__exit_state"] = cnp.int32(0)
        g_ctypes["__exit_state"] = _CType(cnp.int32, 32, False)

    # Value prints whose arity cannot be static -- under a dynamic loop
    # or under a branch inside any loop (jpeg's for(;;) marker loop) --
    # get the UART-buffer model: a synthetic bounded __print_buf plus
    # __print_cnt become the stdout observable.  Only created when
    # needed, so every other program's leaf layout is untouched.
    if _needs_print_buffer(funcs):
        globals_["__print_buf"] = cnp.zeros(_PRINT_BUF_WORDS, cnp.uint32)
        globals_["__print_cnt"] = cnp.int32(0)
        g_ctypes["__print_cnt"] = _CType(cnp.int32, 32, False)
        g_ctypes["__print_buf"] = _CType(cnp.uint32, 32, True)
    return (tu, globals_, funcs, typedefs, anns, name_flags, g_ctypes,
            g_ptrs)


def lift_c(name: str,
           sources: Sequence[str],
           *,
           entry: str = "main",
           annotations: Optional[Dict[str, LeafSpec]] = None,
           default_xmr: Optional[bool] = None,
           max_steps: Optional[int] = None,
           meta: Optional[dict] = None,
           device=device_mod.DEFAULT) -> Region:
    """Ingest C sources and derive a protected Region.

    Globals become the lifted function's inputs (hence injectable leaves
    named by ``lift_fn``'s layout); written globals plus every value the
    program printf'd become its outputs.  ``entry`` (default ``main``) is
    executed.  COAST.h macros in the source set ``default_xmr`` unless
    overridden.  The program is compiled and recorded on the CPU;
    ``device`` is where ``lift_fn`` measures a ``while`` phase's steps
    (the card unless ``"cpu"`` is given).  A leaf whose value the
    reference holds as ``uint32`` has ``LeafSpec.unsigned``."""
    (tu, globals_, funcs, typedefs, anns, name_flags, g_ctypes,
     g_ptrs) = parse_c_sources(sources)
    if entry not in funcs:
        raise CLiftError(
            f"entry function {entry!r} not defined; have "
            f"{sorted(funcs)}")
    if default_xmr is None:
        default_xmr = "__DEFAULT_NO_xMR" not in anns

    comp = _Compiler(tu, typedefs, funcs, name, g_ctypes,
                     g_ptrs=g_ptrs)
    g_names = sorted(globals_)
    g_dtypes = [globals_[n].dtype for n in g_names]
    out_globals = sorted(comp.written_globals(funcs[entry], set(g_names)))

    def program(*g_vals):
        sc = _Scope({n: cnp.Array(t, dt)
                     for n, t, dt in zip(g_names, g_vals, g_dtypes)},
                    g_ctypes)
        comp._run_function(funcs[entry], [], sc)
        outs = [sc.g[n] for n in out_globals] + list(sc.printed)
        return tuple(outs)

    def unsigned_of(t) -> bool:
        dt = cnp.dtype_of_tensor(t)
        return dt is not None and dt.unsigned

    example = [globals_[n].t for n in g_names]
    cnp.track(True)
    try:
        region = lift_fn(
            name, program, *example,
            annotations=annotations, default_xmr=default_xmr,
            max_steps=max_steps, unsigned_of=unsigned_of,
            device=device,
            meta={"frontend": "c", "sources": [os.path.basename(s)
                                               for s in sources],
                  "source_paths": [os.path.realpath(s) for s in sources],
                  "coast_annotations": sorted(set(anns)),
                  "global_xmr": {n: f for n, f in sorted(name_flags.items())
                                 if n in globals_},
                  "observed_globals": out_globals, **(meta or {})})
    finally:
        cnp.track(False)
    # The print-slot string table fills while lift_fn records the program
    # (the desugar pass runs at first execution), so attach it after.
    region.meta["print_strings"] = list(comp.print_strings)

    # Per-declaration __xMR/__NO_xMR annotations, lowered the way the
    # reference's engine consumes them (tests/mm_common/mm_tmr.c):
    #
    #   * an annotated FUNCTION replicates its computation -- its locals
    #     become the lifted loop machinery (carries, indices, _phase), so
    #     those leaves inherit the function scope;
    #   * an annotated GLOBAL maps onto the state leaf its argument
    #     position became -- except UNWRITTEN globals, which the
    #     reference never clones regardless of annotation (the
    #     unwritten-global rule, cloning.cpp:62-288), so RO leaves keep
    #     the shared default;
    #   * globals consumed only through a transformed value have no
    #     single leaf; warn, do not drop silently.
    import dataclasses as _dc
    from coast_tpu_torch.ir.region import KIND_RO
    arg_leaves = region.meta.get("arg_leaves", {})
    global_leaves = set()
    for gname, flag in sorted(name_flags.items()):
        if gname not in globals_:
            continue
        idx = g_names.index(gname)
        leaf = arg_leaves.get(idx)
        if leaf is None:
            import warnings
            warnings.warn(
                f"lift_c: __xMR annotation on global {gname!r} could not "
                "be mapped to a state leaf (the value is transformed "
                "before its first loop use); the region default applies",
                stacklevel=2)
            continue
        global_leaves.add(leaf)
        if region.spec[leaf].kind == KIND_RO:
            continue                      # unwritten: never cloned
        if region.spec[leaf].xmr is None:     # explicit API override wins
            region.spec[leaf] = _dc.replace(region.spec[leaf], xmr=flag)
    # Every GLOBAL's leaf (annotated or not) keeps its own scope: the
    # function-level blanket below covers only the machinery derived
    # from function LOCALS -- an unannotated global under
    # __DEFAULT_NO_xMR stays unprotected, as in the reference.
    all_global_leaves = {arg_leaves[g_names.index(n)]
                         for n in g_names
                         if g_names.index(n) in arg_leaves}
    fn_flags = [f for n, f in name_flags.items() if n in funcs]
    if fn_flags and all(fn_flags):
        # Every annotated function is __xMR (and at least one is): the
        # stepped machinery derived from their locals is inside the
        # sphere of replication.
        for leaf, spec in region.spec.items():
            if leaf in all_global_leaves or spec.kind == KIND_RO:
                continue
            if spec.xmr is None:
                region.spec[leaf] = _dc.replace(spec, xmr=True)
    elif fn_flags:
        # Mixed / __NO_xMR function scopes cannot be attributed to
        # individual leaves (locals from different functions fuse into
        # one stepped machinery); never drop annotations silently.
        import warnings
        warnings.warn(
            "lift_c: mixed function-level __xMR/__NO_xMR annotations "
            "cannot be lowered per-function (their locals fuse into one "
            "stepped machinery); the region default applies to "
            "machinery leaves.  Annotate globals, or split the scopes "
            "with lift_fn annotations.", stacklevel=2)
    region.validate()
    return region
