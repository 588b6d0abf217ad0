"""Expression evaluation for the restricted-C compiler: constant
propagation, the usual arithmetic conversions, 64-bit limb lowering,
pointer/array paths, stores, compound assignment, and calls.  Mixin
methods of _Compiler (c_lifter.py); split out in round 5.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from coast_tpu_torch.frontend import c_array as cnp
from coast_tpu_torch.frontend.c_types import (
    _PRINT_BUF_WORDS, CLiftError, _C64, _CType, _CType64, _NoPrintList, _Scope,
    _c64_add, _c64_divmod, _c64_lt, _c64_mul, _c64_neg, _c64_shl,
    _c64_shr, _ctype_of, _to64, c_ast)


class _EvalMixin:
    """Expression/memory evaluation half of _Compiler."""

    # -- trace-time constant propagation -----------------------------------
    @staticmethod
    def _wrap32(v: int) -> int:
        """Canonical signed-32 representation of a mod-2^32 value."""
        v &= 0xFFFFFFFF
        return v - (1 << 32) if v >= 0x80000000 else v

    @staticmethod
    def _has_effects(node) -> bool:
        """Does evaluating ``node`` have side effects (writes/calls)?"""
        found: List[object] = []

        class V(c_ast.NodeVisitor):
            def visit_Assignment(v, n):
                found.append(n)

            def visit_FuncCall(v, n):
                found.append(n)

            def visit_UnaryOp(v, n):
                if n.op in ("++", "p++", "--", "p--"):
                    found.append(n)
                v.generic_visit(n)

        if node is not None:
            V().visit(node)
        return bool(found)

    def _const_eval(self, node, sc: _Scope) -> Optional[int]:
        """Compile-time value of a PURE expression, or None if unknown.

        Conservative by construction: every fold either matches the C
        (ILP32) result exactly or returns None -- ordered comparisons
        and ``>>`` bail out when a sign-domain ambiguity could flip the
        result.  Values are kept in canonical signed-32 form."""
        if isinstance(node, c_ast.Constant):
            if "char" in node.type and node.value.startswith("'"):
                body = node.value[1:-1].encode().decode("unicode_escape")
                return ord(body)
            if "int" in node.type:
                v = int(node.value.rstrip("uUlL"), 0)
                return self._wrap32(v) if v <= 0xFFFFFFFF else None
            return None
        if isinstance(node, c_ast.ID):
            return sc.consts.get(node.name)
        if isinstance(node, c_ast.Cast):
            if isinstance(node.to_type.type, c_ast.PtrDecl):
                return None
            v = self._const_eval(node.expr, sc)
            if v is None:
                return None
            ct = _ctype_of(node.to_type.type.type.names, self.typedefs)
            if isinstance(ct, _CType64):
                return None
            return self._norm_const(ct, v)
        if isinstance(node, c_ast.UnaryOp):
            if node.op not in ("-", "+", "~", "!"):
                return None
            v = self._const_eval(node.expr, sc)
            if v is None:
                return None
            if node.op == "!":
                return int(v == 0)
            return self._wrap32({"-": -v, "+": v, "~": ~v}[node.op])
        if isinstance(node, c_ast.TernaryOp):
            c = self._const_eval(node.cond, sc)
            if c is None:
                return None
            return self._const_eval(node.iftrue if c else node.iffalse, sc)
        if isinstance(node, c_ast.BinaryOp):
            a = self._const_eval(node.left, sc)
            if a is None:
                return None
            if node.op in ("&&", "||"):
                if node.op == "&&" and a == 0:
                    return 0
                if node.op == "||" and a != 0:
                    return 1
                b = self._const_eval(node.right, sc)
                return None if b is None else int(b != 0)
            b = self._const_eval(node.right, sc)
            if b is None:
                return None
            op = node.op
            if op in ("==", "!="):
                eq = (a & 0xFFFFFFFF) == (b & 0xFFFFFFFF)
                return int(eq if op == "==" else not eq)
            if op in ("<", ">", "<=", ">="):
                # int vs unsigned compare agree only when both
                # operands are non-negative in the signed view.
                if a < 0 or b < 0:
                    return None
                return int({"<": a < b, ">": a > b,
                            "<=": a <= b, ">=": a >= b}[op])
            if op == ">>":
                if a < 0:
                    return None          # arithmetic-vs-logical ambiguity
                return a >> (b & 31)
            if op == "<<":
                return self._wrap32(a << (b & 31))
            if op in ("+", "-", "*", "&", "|", "^"):
                return self._wrap32({"+": a + b, "-": a - b, "*": a * b,
                                     "&": a & b, "|": a | b,
                                     "^": a ^ b}[op])
            if op in ("/", "%"):
                # C truncates toward zero; Python floors -- fold only
                # the unambiguous non-negative case.
                if a < 0 or b <= 0:
                    return None
                return a // b if op == "/" else a % b
            return None
        return None

    @staticmethod
    def _norm_const(ct: _CType, v: int) -> int:
        """C conversion of a known value into the declared type."""
        mask = (1 << ct.bits) - 1
        v &= mask
        if not ct.unsigned and v >= (1 << (ct.bits - 1)):
            v -= 1 << ct.bits
        return v

    def _const_set(self, sc: _Scope, name: str, v: Optional[int],
                   ct: Optional[_CType] = None) -> None:
        if v is None:
            sc.consts.pop(name, None)
        else:
            if ct is not None and not isinstance(ct, _CType64):
                v = self._norm_const(ct, v)
            sc.consts[name] = v

    # -- expressions -------------------------------------------------------
    def eval(self, node, sc: _Scope):
        if isinstance(node, c_ast.Constant):
            if "char" in node.type and node.value.startswith("'"):
                # Character constant: type int in C.
                body = node.value[1:-1].encode().decode("unicode_escape")
                return cnp.int32(ord(body))
            if "int" in node.type:
                v = node.value.rstrip("uUlL")
                base = int(v, 0)
                # C type of the literal: explicit u suffix, or a hex/octal
                # literal too big for int (0xffffffff is unsigned int in
                # ILP32; decimal literals never become unsigned).
                uns = ("u" in node.value.lower()
                       or (base > 0x7FFFFFFF
                           and v.lower().startswith("0")))
                if base > 0xFFFFFFFF:
                    # Literal outside 32 bits: a long long constant.
                    return _C64(base & 0xFFFFFFFF,
                                (base >> 32) & 0xFFFFFFFF, uns)
                return (cnp.uint32(base & 0xFFFFFFFF) if uns
                        else cnp.int32(np.int32(base & 0xFFFFFFFF)))
            raise CLiftError(f"unsupported constant type {node.type!r}")
        if isinstance(node, c_ast.ExprList):
            # C comma expression: evaluate left to right, value is last.
            v = cnp.int32(0)
            for e in node.exprs:
                v = self.eval(e, sc)
            return v
        if isinstance(node, c_ast.ID):
            v = sc.read(node.name)
            ct = sc.ctype(node.name)
            # Narrow SCALAR reads re-normalize: an injected bit above the
            # declared width does not exist in real byte/short memory, so
            # the promoted value masks it (docs/lifter.md, layout
            # envelope).  Arrays pass through untouched -- an ID naming an
            # array is C pointer decay, not a value read.
            if ct is not None and ct.bits < 32 and cnp.ndim(v) == 0:
                return ct.store(v)
            return v
        if isinstance(node, c_ast.ArrayRef):
            arr, idx, base = self._array_path(node, sc)
            ct = (sc.ctypes.get(base[0]) if isinstance(base, tuple)
                  else sc.ctype(base))
            if isinstance(ct, _CType64):
                row = arr[idx]                  # (..., 2) limb pair
                return _C64(row[..., 0], row[..., 1], ct.unsigned)
            v = arr[idx]
            return (ct.store(v) if ct is not None and ct.bits < 32
                    else v)
        if isinstance(node, c_ast.BinaryOp):
            return self._binop(node, sc)
        if isinstance(node, c_ast.UnaryOp):
            return self._unop(node, sc)
        if isinstance(node, c_ast.TernaryOp):
            c = self.eval(node.cond, sc)
            a = self.eval(node.iftrue, sc)
            b = self.eval(node.iffalse, sc)
            if isinstance(a, _C64) or isinstance(b, _C64):
                a64, b64 = _to64(a), _to64(b)
                t_ = self._truth(c)
                return _C64(cnp.where(t_, a64.lo, b64.lo),
                            cnp.where(t_, a64.hi, b64.hi),
                            a64.unsigned or b64.unsigned)
            a, b = self._usual_conv(a, b)
            return cnp.where(cnp.not_equal(c, 0), a, b)
        if isinstance(node, c_ast.FuncCall):
            return self._call(node, sc)
        if isinstance(node, c_ast.Cast):
            if isinstance(node.to_type.type, c_ast.PtrDecl):
                raise CLiftError(
                    f"pointer cast in value position at {node.coord}; "
                    "pointer casts are modeled only where a pointer "
                    "flows (seatings, call arguments, derefs)")
            ct = _ctype_of(node.to_type.type.type.names, self.typedefs)
            # C cast semantics: value converted to the target type --
            # truncate + re-sign for narrow targets, plain dtype change
            # for 32-bit ones.
            return ct.store(self.eval(node.expr, sc))
        if isinstance(node, c_ast.Assignment):
            # expression-position assignment (e.g. in for-next)
            return self._assign(node, sc)
        raise CLiftError(
            f"unsupported expression {type(node).__name__} at {node.coord}")

    def _usual_conv(self, a, b):
        """C usual arithmetic conversions, ILP32 32-bit lane: if either
        side is unsigned, both are."""
        a = cnp.asarray(a)
        b = cnp.asarray(b)
        if a.dtype == cnp.uint32 or b.dtype == cnp.uint32:
            return a.astype(cnp.uint32), b.astype(cnp.uint32)
        return a.astype(cnp.int32), b.astype(cnp.int32)

    @staticmethod
    def _truth(v):
        """C truth value of a scalar or limb-pair value."""
        if isinstance(v, _C64):
            return cnp.not_equal(v.lo | v.hi, 0)
        return cnp.not_equal(cnp.asarray(v), 0)

    def _ptrish(self, node, sc) -> bool:
        """Is this expression a pointer value (decayed array, walked or
        global pointer, &-expr, pointer +/- offset)?"""
        if isinstance(node, c_ast.ID):
            if node.name in sc.aliases:
                return True
            if (node.name in self.g_ptrs
                    and node.name not in sc.locals):
                return True
            tgt = node.name
            return tgt in sc.g and cnp.ndim(sc.g[tgt]) >= 1
        if isinstance(node, c_ast.Cast):
            return (isinstance(node.to_type.type, c_ast.PtrDecl)
                    and self._ptrish(node.expr, sc))
        if isinstance(node, c_ast.UnaryOp) and node.op == "&":
            return True
        if isinstance(node, c_ast.BinaryOp) and node.op in ("+", "-"):
            return (self._ptrish(node.left, sc)
                    or self._ptrish(node.right, sc))
        return False

    def _binop(self, node, sc):
        if (node.op in ("==", "!=", "<", ">", "<=", ">=", "-")
                and (self._ptrish(node.left, sc)
                     or self._ptrish(node.right, sc))):
            # Pointer comparison / difference: both sides resolve to
            # (base, offset); same base -> compare/subtract offsets
            # (element-indexed cursors, matching C's element units).
            ba, oa = self._ptr_parts(node.left, sc)
            bb, ob = self._ptr_parts(node.right, sc)
            if ba != bb:
                raise CLiftError(
                    f"pointer {node.op} across different arrays "
                    f"({ba!r} vs {bb!r}) at {node.coord}")
            return self._apply_binop(node.op, cnp.asarray(oa, cnp.int32),
                                     cnp.asarray(ob, cnp.int32), node)
        a = self.eval(node.left, sc)
        b = self.eval(node.right, sc)
        return self._apply_binop(node.op, a, b, node)

    def _apply_binop(self, op, a, b, node):
        if op in ("&&", "||"):
            az = self._truth(a)
            bz = self._truth(b)
            r = cnp.logical_and(az, bz) if op == "&&" else cnp.logical_or(az, bz)
            return r.astype(cnp.int32)
        if isinstance(a, _C64) or isinstance(b, _C64):
            return self._binop64(op, a, b, node)
        a, b = self._usual_conv(a, b)
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            return cnp.div(a, b) if a.dtype == cnp.int32 else a // b
        if op == "%":
            return cnp.rem(a, b) if a.dtype == cnp.int32 else a % b
        if op == "^":
            return a ^ b
        if op == "&":
            return a & b
        if op == "|":
            return a | b
        if op == "<<":
            return a << b
        if op == ">>":
            return a >> b
        cmp = {"==": cnp.equal, "!=": cnp.not_equal, "<": cnp.less,
               ">": cnp.greater, "<=": cnp.less_equal,
               ">=": cnp.greater_equal}.get(op)
        if cmp is not None:
            return cmp(a, b).astype(cnp.int32)
        raise CLiftError(f"unsupported binary op {op!r} at {node.coord}")

    def _binop64(self, op, a, b, node):
        """Binary ops with a 64-bit (limb-pair) operand."""
        if op in ("<<", ">>"):
            # The SHIFT COUNT is not subject to the usual conversions:
            # a << amount keeps a's type; the amount reduces to int.
            a64 = _to64(a)
            s = b.lo if isinstance(b, _C64) else cnp.asarray(b, cnp.uint32)
            return _c64_shl(a64, s) if op == "<<" else _c64_shr(a64, s)
        a64, b64 = _to64(a), _to64(b)
        unsigned = a64.unsigned or b64.unsigned
        if op == "+":
            return _c64_add(a64, b64, unsigned)
        if op == "-":
            return _c64_add(a64, _c64_neg(b64), unsigned)
        if op == "*":
            return _c64_mul(a64, b64, unsigned)
        if op in ("/", "%"):
            if not unsigned:
                raise CLiftError(
                    f"signed 64-bit {op} at {node.coord} is outside the "
                    "modeled envelope (softfloat divides unsigned)")
            q, r = _c64_divmod(a64, b64)
            return q if op == "/" else r
        if op == "&":
            return _C64(a64.lo & b64.lo, a64.hi & b64.hi, unsigned)
        if op == "|":
            return _C64(a64.lo | b64.lo, a64.hi | b64.hi, unsigned)
        if op == "^":
            return _C64(a64.lo ^ b64.lo, a64.hi ^ b64.hi, unsigned)
        if op == "==":
            return cnp.logical_and(cnp.equal(a64.lo, b64.lo),
                                   cnp.equal(a64.hi, b64.hi)
                                   ).astype(cnp.int32)
        if op == "!=":
            return cnp.logical_or(cnp.not_equal(a64.lo, b64.lo),
                                  cnp.not_equal(a64.hi, b64.hi)
                                  ).astype(cnp.int32)
        if op == "<":
            return _c64_lt(a64, b64, unsigned).astype(cnp.int32)
        if op == ">":
            return _c64_lt(b64, a64, unsigned).astype(cnp.int32)
        if op == "<=":
            return cnp.logical_not(_c64_lt(b64, a64, unsigned)
                                   ).astype(cnp.int32)
        if op == ">=":
            return cnp.logical_not(_c64_lt(a64, b64, unsigned)
                                   ).astype(cnp.int32)
        raise CLiftError(
            f"unsupported 64-bit binary op {op!r} at {node.coord} "
            "(long long supports + - * & | ^ << >> and comparisons)")

    def _unop(self, node, sc):
        op = node.op
        if op in ("++", "p++", "--", "p--"):
            name = node.expr
            old = self.eval(name, sc)
            if isinstance(old, _C64):
                one = _C64(1, 0, old.unsigned)
                new = (_c64_add(old, one, old.unsigned) if "++" in op
                       else _c64_add(old, _c64_neg(one), old.unsigned))
            else:
                delta = cnp.asarray(1, old.dtype)
                new = old + delta if "++" in op else old - delta
            self._store(name, new, sc)
            if isinstance(name, c_ast.ID):
                prev = sc.consts.get(name.name)
                self._const_set(
                    sc, name.name,
                    None if prev is None else
                    self._wrap32(prev + (1 if "++" in op else -1)),
                    sc.ctype(name.name))
            return old if op.startswith("p") else new
        if op == "*":
            base, off = self._ptr_parts(node.expr, sc)
            if isinstance(base, tuple):          # union pointer
                ct = sc.ctypes.get(base[0])
                v = self._union_read(sc, base)[off]
                return (ct.store(v) if ct is not None and ct.bits < 32
                        else v)
            arr = sc.g[base]
            ct = sc.ctypes.get(base)
            if isinstance(ct, _CType64):
                row = arr.reshape(-1, 2)[off]   # limb-pair element
                return _C64(row[0], row[1], ct.unsigned)
            if cnp.ndim(arr) > 1:
                arr = arr.reshape(-1)       # cursors walk row-major memory
            v = arr[off]
            return (ct.store(v) if ct is not None and ct.bits < 32
                    else v)
        if op == "sizeof":
            return cnp.int32(self._sizeof(node.expr, sc))
        v = self.eval(node.expr, sc)
        if isinstance(v, _C64):
            if op == "-":
                return _c64_neg(v)
            if op == "+":
                return v
            if op == "~":
                return _C64(~v.lo, ~v.hi, v.unsigned)
            if op == "!":
                return cnp.equal(v.lo | v.hi, 0).astype(cnp.int32)
            raise CLiftError(
                f"unsupported unary op {op!r} on long long at {node.coord}")
        if op == "-":
            return -v
        if op == "+":
            return v
        if op == "~":
            return ~v
        if op == "!":
            return cnp.equal(v, 0).astype(cnp.int32)
        raise CLiftError(f"unsupported unary op {op!r} at {node.coord}")

    def _sizeof(self, expr, sc) -> int:
        """C sizeof in the REAL C layout (not the lane layout): element
        count times the declared element width in bytes.  The benchmarks
        use it for byte-array lengths (aes.c's sizeof(input))."""
        if isinstance(expr, c_ast.Typename):
            ct = _ctype_of(getattr(expr.type.type, "names", ["int"]),
                           self.typedefs)
            return ct.bits // 8
        if isinstance(expr, c_ast.ID):
            name = expr.name
            if name in sc.aliases:
                # Array/pointer PARAMETERS and local pointer variables
                # decay: C's sizeof is the pointer size (ILP32: 4), the
                # classic sizeof-of-parameter trap included.
                return 4
            arr = sc.read(name)
            ct = sc.ctype(name)
            width = (ct.bits // 8) if ct is not None else 4
            n = int(np.prod(arr.shape)) if cnp.ndim(arr) else 1
            return n * width
        raise CLiftError(
            f"unsupported sizeof operand at {getattr(expr, 'coord', '?')}")

    def _ptr_parts(self, expr, sc) -> Tuple[str, cnp.Array]:
        """Resolve a pointer-valued expression to (global name, offset).

        The subset's pointers are walked array parameters: ``p`` (cursor
        or start), ``p++``/``++p``/``p--``/``--p`` (cursor effect applies,
        value is the C-correct old/new pointer), and ``p + e``.  This is
        the shape the reference's byte-stream benchmarks use
        (crc16.c:26 ``*data_p++``)."""
        if isinstance(expr, c_ast.ID) and expr.name in sc.aliases:
            return (sc.aliases[expr.name],
                    cnp.asarray(sc.locals.get(expr.name, 0), cnp.int32))
        if (isinstance(expr, c_ast.ID) and expr.name in self.g_ptrs
                and expr.name not in sc.locals):
            base = self.g_ptr_base.get(expr.name)
            if base is None:
                raise CLiftError(
                    f"global pointer {expr.name!r} used before any "
                    "seating; seat it (p = arr) first")
            return base, cnp.asarray(sc.read(expr.name), cnp.int32)
        if isinstance(expr, c_ast.ID) and expr.name in sc.locals:
            # A LOCAL array (possibly shadowing a same-name global)
            # cannot be a pointer target -- aliases only bind into the
            # globals dict.  Refuse loudly instead of silently binding
            # the shadowed global.
            raise CLiftError(
                f"pointer to local array {expr.name!r} at "
                f"{getattr(expr, 'coord', '?')} is not supported; make "
                "the array a global or pass it as a call argument")
        if (isinstance(expr, c_ast.ID) and expr.name in sc.g
                and cnp.ndim(sc.g[expr.name]) >= 1):
            # A global array name decays to a pointer to its start.
            return expr.name, cnp.int32(0)
        if (isinstance(expr, c_ast.UnaryOp)
                and expr.op in ("++", "p++", "--", "p--")
                and isinstance(expr.expr, c_ast.ID)):
            nm = expr.expr.name
            if nm in sc.aliases:
                if nm not in sc.locals:
                    raise CLiftError(
                        f"pointer arithmetic on unwalked parameter "
                        f"{nm!r} at {expr.coord}")
                off = self._unop(expr, sc)      # applies the cursor effect
                return sc.aliases[nm], cnp.asarray(off, cnp.int32)
            if nm in self.g_ptrs and nm not in sc.locals:
                base = self.g_ptr_base.get(nm)
                if base is None:
                    raise CLiftError(
                        f"global pointer {nm!r} walked before any "
                        f"seating at {expr.coord}")
                off = self._unop(expr, sc)      # global cursor effect
                return base, cnp.asarray(off, cnp.int32)
        if isinstance(expr, c_ast.Cast):
            # Pointer casts ((void*)buf, (char*)p) change the static type,
            # not the address: pass through.  The pointee's ctype stays
            # the ALIASED array's -- reinterpreting an int array as bytes
            # would need sub-word addressing, outside the lane model.
            return self._ptr_parts(expr.expr, sc)
        if isinstance(expr, c_ast.UnaryOp) and expr.op == "&":
            # Address-of: &arr -> (arr, 0); &arr[k] -> (arr, k); multi-dim
            # &arr[j][k] -> (arr, j*cols + k) -- the cursor indexes the
            # row-major FLATTENED array (sha_stream's &indata[j][0]).
            inner = expr.expr
            if isinstance(inner, c_ast.ArrayRef):
                idxs, node2 = [], inner
                while isinstance(node2, c_ast.ArrayRef):
                    idxs.append(node2.subscript)
                    node2 = node2.name
                if isinstance(node2, c_ast.ID):
                    base, off = self._ptr_parts(node2, sc)
                    shape = cnp.shape(sc.g[base])
                    idxs = list(reversed(idxs))
                    if len(idxs) > len(shape):
                        raise CLiftError(
                            f"too many subscripts under & at {expr.coord}")
                    flat = cnp.int32(0)
                    for d, ix in enumerate(idxs):
                        stride = int(np.prod(shape[d + 1:], dtype=np.int64))
                        flat = flat + cnp.asarray(
                            self.eval(ix, sc), cnp.int32) * stride
                    return base, off + flat
            if (isinstance(inner, c_ast.ID) and inner.name in sc.locals
                    and inner.name not in sc.aliases
                    and cnp.ndim(sc.locals[inner.name]) == 0):
                raise CLiftError(
                    f"address-of scalar {inner.name!r} at "
                    f"{getattr(expr, 'coord', '?')} is not supported "
                    "(no out-parameter model; return the value instead)")
            return self._ptr_parts(inner, sc)
        if isinstance(expr, c_ast.BinaryOp) and expr.op in ("+", "-"):
            base, off = self._ptr_parts(expr.left, sc)
            d = cnp.asarray(self.eval(expr.right, sc), cnp.int32)
            return base, (off + d if expr.op == "+" else off - d)
        if isinstance(expr, c_ast.ArrayRef):
            # PARTIAL indexing decays a sub-array to a pointer
            # (`p = ta[i]` over int ta[2][4] -> base ta, offset i*4).
            idxs, node2 = [], expr
            while isinstance(node2, c_ast.ArrayRef):
                idxs.append(node2.subscript)
                node2 = node2.name
            if isinstance(node2, c_ast.ID):
                base, off0 = self._ptr_parts(node2, sc)
                if not isinstance(base, tuple):
                    arrv = sc.g[base]
                    eff_nd = cnp.ndim(arrv)
                    if isinstance(sc.ctypes.get(base), _CType64):
                        eff_nd -= 1
                    if len(idxs) < eff_nd:
                        shape = cnp.shape(arrv)
                        flat = cnp.int32(0)
                        for d2, ix in enumerate(reversed(idxs)):
                            stride = int(np.prod(shape[d2 + 1:eff_nd],
                                                 dtype=np.int64))
                            flat = flat + cnp.asarray(
                                self.eval(ix, sc), cnp.int32) * stride
                        return base, off0 + flat
        raise CLiftError(
            f"unsupported pointer expression at {getattr(expr, 'coord', '?')}")

    def _array_path(self, node, sc):
        """Flatten a[i][j]... into (array value, index tuple).  A pointer
        parameter that has been walked (``p++``) indexes relative to its
        cursor: ``p[i]`` reads the aliased global at cursor+i."""
        idxs = []
        while isinstance(node, c_ast.ArrayRef):
            idxs.append(node.subscript)
            node = node.name
        if not isinstance(node, c_ast.ID):
            raise CLiftError(f"unsupported array base at {node.coord}")
        name = node.name
        cursor = (sc.locals.get(name) if name in sc.aliases else None)
        base = sc.aliases.get(name, name)
        if name in sc.aliases and isinstance(sc.aliases[name], tuple):
            arr = self._union_read(sc, sc.aliases[name])
        elif name in sc.aliases:
            arr = sc.g[sc.aliases[name]]
        elif (name in self.g_ptrs and name not in sc.locals):
            # Subscripting a GLOBAL pointer (gp[i]) routes through its
            # seated base + cursor, same as _ptr_parts' deref path --
            # sc.read(name) would hand back the int32 cursor scalar.
            seated = self.g_ptr_base.get(name)
            if seated is None:
                raise CLiftError(
                    f"global pointer {name!r} subscripted before any "
                    f"seating at {node.coord}; seat it (p = arr) first")
            arr = sc.g[seated]
            cursor = cnp.asarray(sc.read(name), cnp.int32)
            base = seated
        else:
            arr = sc.read(name)
        idx = tuple(self.eval(i, sc).astype(cnp.int32)
                    for i in reversed(idxs))
        if cursor is not None:
            if len(idx) != 1:
                raise CLiftError(
                    f"walked pointer {name!r} must be 1-D at {node.coord}")
            # Cursor over row-major memory: flatten to element rows.  A
            # 64-bit base keeps its trailing limb-pair axis -- the cursor
            # counts ELEMENTS, and the _CType64 load/store consume (n, 2)
            # rows; a full flatten would index half-pairs.
            ct_c = (sc.ctypes.get(base[0]) if isinstance(base, tuple)
                    else sc.ctype(base))
            if isinstance(ct_c, _CType64):
                if cnp.ndim(arr) > 2:
                    arr = arr.reshape(-1, 2)
            elif cnp.ndim(arr) > 1:
                arr = arr.reshape(-1)
            idx = (idx[0] + cursor,)
        return arr, (idx if len(idx) > 1 else idx[0]), base

    def _store(self, lhs, val, sc):
        if isinstance(lhs, c_ast.ID):
            ct = sc.ctype(lhs.name)
            if ct is not None:
                sc.write(lhs.name, ct.store(val))
                return
            if isinstance(val, _C64):
                # Untyped slot receiving a 64-bit value (early-return
                # carries of 64-bit functions): store the pair as-is.
                sc.write(lhs.name, val)
                return
            old = sc.read(lhs.name)
            sc.write(lhs.name, cnp.asarray(val).astype(old.dtype)
                     if hasattr(old, "dtype") else val)
            return
        if isinstance(lhs, c_ast.ArrayRef):
            arr, idx, base = self._array_path(lhs, sc)
            if isinstance(base, tuple):          # union pointer
                ct = sc.ctypes.get(base[0])
                stored = (ct.store(val) if ct is not None
                          else cnp.asarray(val).astype(arr.dtype))
                self._union_write(
                    sc, base, arr.at[idx].set(stored.astype(arr.dtype)))
                return
            ct = sc.ctype(base)
            if isinstance(ct, _CType64):
                v64 = _to64(val)
                new = arr.at[idx].set(cnp.stack([v64.lo, v64.hi]))
                orig = sc.read_binding(base)
                if cnp.shape(new) != cnp.shape(orig):
                    # _array_path flattened a cursor view over a
                    # multi-dim 64-bit array to (-1, 2) limb rows;
                    # restore the canonical shape.
                    new = new.reshape(cnp.shape(orig))
                sc.write_binding(base, new)
                return
            stored = (ct.store(val) if ct is not None
                      else cnp.asarray(val).astype(arr.dtype))
            new = arr.at[idx].set(stored.astype(arr.dtype))
            orig = sc.read_binding(base)
            if cnp.shape(new) != cnp.shape(orig):
                # _array_path flattened a cursor view over a multi-dim
                # array; restore the canonical shape.
                new = new.reshape(cnp.shape(orig))
            # base is already alias-RESOLVED: write the binding
            # directly (re-resolving would mis-route when a parameter
            # shadows a global of the same name).
            sc.write_binding(base, new)
            return
        if isinstance(lhs, c_ast.UnaryOp) and lhs.op == "*":
            # Deref store (*p++ = c): C order -- the store targets the
            # pointer value BEFORE any ++/-- side effect, which
            # _ptr_parts implements (p++ yields the old offset).
            base, off = self._ptr_parts(lhs.expr, sc)
            if isinstance(base, tuple):          # union pointer
                ct = sc.ctypes.get(base[0])
                flat = self._union_read(sc, base)
                stored = (ct.store(val) if ct is not None
                          else cnp.asarray(val).astype(flat.dtype))
                self._union_write(
                    sc, base, flat.at[off].set(stored.astype(flat.dtype)))
                return
            arr = sc.g[base]
            ct = sc.ctypes.get(base)
            if isinstance(ct, _CType64):
                v64 = _to64(val)
                flat = arr.reshape(-1, 2).at[off].set(
                    cnp.stack([v64.lo, v64.hi]))
                sc.write_binding(base, flat.reshape(cnp.shape(arr)))
                return
            stored = (ct.store(val) if ct is not None
                      else cnp.asarray(val).astype(arr.dtype))
            if cnp.ndim(arr) > 1:           # cursors walk row-major memory
                flat = arr.reshape(-1).at[off].set(stored.astype(arr.dtype))
                sc.write_binding(base, flat.reshape(cnp.shape(arr)))
            else:
                sc.write_binding(base,
                                 arr.at[off].set(stored.astype(arr.dtype)))
            return
        raise CLiftError(
            f"unsupported assignment target {type(lhs).__name__}")

    def _assign(self, node, sc):
        op = node.op
        if (op == "=" and isinstance(node.lvalue, c_ast.ID)
                and node.lvalue.name in self.g_ptrs
                and node.lvalue.name not in sc.locals
                and node.lvalue.name not in sc.aliases):
            # GLOBAL pointer (re-)seating: static single base, runtime
            # cursor stored in the int32 cursor global.
            name = node.lvalue.name
            base, off = self._ptr_parts(node.rvalue, sc)
            prev = self.g_ptr_base.get(name)
            if prev is not None and prev != base:
                raise CLiftError(
                    f"global pointer {name!r} re-seated from {prev!r} "
                    f"to {base!r} at {node.coord}: a single static base "
                    "per global pointer is the modeled envelope")
            self.g_ptr_base[name] = base
            sc.write(name, cnp.asarray(off, cnp.int32))
            sc.consts.pop(name, None)
            return off
        if (op == "=" and isinstance(node.lvalue, c_ast.ID)
                and (node.lvalue.name in sc.ptrs
                     or node.lvalue.name in sc.aliases)):
            # Pointer (re-)seating: `p = arr`, `p = q`, `p = p + k`,
            # `p = (T*)s`, `p = &a[k]` -- resolve the RHS to
            # (array, offset) and re-bind the cursor.  An unresolvable
            # RHS refuses loudly in _ptr_parts (the round-3 advisor
            # found the old scalar path silently storing a whole array
            # into the cursor local).
            name = node.lvalue.name
            base, off = self._ptr_parts(node.rvalue, sc)
            union = self._union_bases(sc.aliases.get(name))
            if union is not None and not isinstance(base, tuple):
                # Union pointer: a seat on a member re-bases the cursor
                # into that member's segment of the concatenation.
                off = self._union_offset(sc, union, base) + cnp.asarray(
                    off, cnp.int32)
            else:
                sc.aliases[name] = base
            sc.locals[name] = cnp.asarray(off, cnp.int32)
            sc.consts.pop(name, None)
            return off
        if op == "=":
            const = (self._const_eval(node.rvalue, sc)
                     if isinstance(node.lvalue, c_ast.ID) else None)
            val = self.eval(node.rvalue, sc)
            self._store(node.lvalue, val, sc)
            if isinstance(node.lvalue, c_ast.ID):
                self._const_set(sc, node.lvalue.name, const,
                                sc.ctype(node.lvalue.name))
            return val
        # Compound assignment (+= <<= ...): the lvalue designates ONE
        # location, evaluated ONCE (C11 6.5.16.2) -- a side-effecting
        # lvalue like GSM's rescale `*s++ <<= scalauto` must advance the
        # cursor exactly once, with read and store hitting the SAME
        # element (the old fake-binop path re-evaluated it for the
        # store, double-stepping the cursor).
        bin_op = op[:-1]
        lhs = node.lvalue
        if isinstance(lhs, c_ast.UnaryOp) and lhs.op == "*":
            base, off = self._ptr_parts(lhs.expr, sc)   # effects, once
            if isinstance(base, tuple):          # union pointer
                ct = sc.ctypes.get(base[0])
                flat0 = self._union_read(sc, base)
                old = flat0[off]
                if ct is not None and ct.bits < 32:
                    old = ct.store(old)
                val = self._apply_binop(bin_op, old,
                                        self.eval(node.rvalue, sc), node)
                stored = (ct.store(val) if ct is not None
                          else cnp.asarray(val).astype(flat0.dtype))
                self._union_write(
                    sc, base,
                    flat0.at[off].set(stored.astype(flat0.dtype)))
                return val
            arr = sc.g[base]
            flat = arr.reshape(-1) if cnp.ndim(arr) > 1 else arr
            ct = sc.ctypes.get(base)
            old = flat[off]
            if ct is not None and ct.bits < 32:
                old = ct.store(old)
            val = self._apply_binop(bin_op, old,
                                    self.eval(node.rvalue, sc), node)
            stored = (ct.store(val) if ct is not None
                      else cnp.asarray(val).astype(arr.dtype))
            new = flat.at[off].set(stored.astype(arr.dtype))
            if cnp.ndim(arr) > 1:
                new = new.reshape(cnp.shape(arr))
            sc.write_binding(base, new)
            return val
        if isinstance(lhs, c_ast.ArrayRef):
            arr, idx, base = self._array_path(lhs, sc)  # subscripts, once
            ct = (sc.ctypes.get(base[0]) if isinstance(base, tuple)
                  else sc.ctype(base))
            old = arr[idx]
            if ct is not None and ct.bits < 32:
                old = ct.store(old)
            val = self._apply_binop(bin_op, old,
                                    self.eval(node.rvalue, sc), node)
            stored = (ct.store(val) if ct is not None
                      else cnp.asarray(val).astype(arr.dtype))
            new = arr.at[idx].set(stored.astype(arr.dtype))
            if isinstance(base, tuple):              # union pointer
                self._union_write(sc, base, new)
                return val
            orig = sc.read_binding(base)
            if cnp.shape(new) != cnp.shape(orig):
                new = new.reshape(cnp.shape(orig))
            sc.write_binding(base, new)
            return val
        # Plain identifier lvalue: no side effects to duplicate.
        fake = c_ast.BinaryOp(bin_op, node.lvalue, node.rvalue, node.coord)
        const = (self._const_eval(fake, sc)
                 if isinstance(node.lvalue, c_ast.ID) else None)
        val = self._binop(fake, sc)
        self._store(node.lvalue, val, sc)
        if isinstance(node.lvalue, c_ast.ID):
            self._const_set(sc, node.lvalue.name, const,
                            sc.ctype(node.lvalue.name))
        return val

    def _call(self, node, sc):
        if not isinstance(node.name, c_ast.ID):
            raise CLiftError(f"unsupported indirect call at {node.coord}")
        fname = node.name.name
        arg_nodes = node.args.exprs if node.args else []
        if fname == "printf":
            # The QEMU loop's observable: everything printed is output.
            # The format string itself is not evaluated (no string
            # model); a 64-bit value prints as its two limbs.
            vals = []
            for a in arg_nodes[1:]:
                v = self.eval(a, sc)
                if isinstance(v, _C64):
                    vals.extend([v.lo, v.hi])
                else:
                    vals.append(cnp.asarray(v))
            if (not vals and isinstance(sc.printed, _NoPrintList)
                    and "__print_buf" in sc.g and arg_nodes
                    and isinstance(arg_nodes[0], c_ast.Constant)
                    and arg_nodes[0].type == "string"):
                # String-only print at a dynamically-reached site: its
                # string-table id is the buffered word.
                text = (arg_nodes[0].value[1:-1]
                        .encode("utf-8").decode("unicode_escape"))
                if text in self.print_strings:
                    sid = self.print_strings.index(text)
                else:
                    self.print_strings.append(text)
                    sid = len(self.print_strings) - 1
                vals = [cnp.uint32(sid)]
            if (vals and isinstance(sc.printed, _NoPrintList)
                    and "__print_buf" in sc.g):
                # UART-buffer model: dynamically-reached prints append
                # into the bounded __print_buf observable (overflowing
                # words drop; __print_cnt keeps the true total).
                buf = sc.g["__print_buf"]
                cnt = sc.g["__print_cnt"]
                for v in vals:
                    idx = cnp.clip(cnt, 0, _PRINT_BUF_WORDS - 1)
                    keep = cnt < _PRINT_BUF_WORDS
                    buf = buf.at[idx].set(
                        cnp.where(keep, cnp.asarray(v).astype(cnp.uint32),
                                  buf[idx]))
                    cnt = cnt + 1
                sc.g["__print_buf"] = buf
                sc.g["__print_cnt"] = cnt
                return cnp.int32(0)
            sc.printed.extend(vals)
            return cnp.int32(0)
        # C array arguments are pointers: a bare ID naming a (possibly
        # already-aliased) global array binds the parameter to that global.
        args = []
        for a in arg_nodes:
            # A pointer CAST on an argument changes the static type only
            # ((unsigned char *)ivec): unwrap it and bind the underlying
            # array/pointer as usual.
            while (isinstance(a, c_ast.Cast)
                   and isinstance(a.to_type.type, c_ast.PtrDecl)):
                a = a.expr
            if isinstance(a, c_ast.UnaryOp) and a.op == "&":
                inner = a.expr
                if (isinstance(inner, c_ast.ID) and inner.name in sc.locals
                        and inner.name not in sc.aliases
                        and cnp.ndim(sc.locals[inner.name]) == 0):
                    # Scalar out-parameter (&num, blowfish's cfb64 state):
                    # copy-in/copy-out through a 1-word transient slot,
                    # like caller-local arrays.
                    args.append(("__alias_scalar_local__", inner.name))
                    continue
                if (isinstance(inner, c_ast.ID) and inner.name in sc.g
                        and cnp.ndim(sc.g[inner.name]) == 0):
                    # Address of a GLOBAL scalar (jpeg's
                    # &OutData_image_width): same slot model, copied
                    # back into the global when the callee returns
                    # (in-call aliasing with direct reads of the same
                    # global is outside the envelope).
                    args.append(("__alias_scalar_global__", inner.name))
                    continue
                # &localarr[k]: caller-LOCAL array element address
                # (motion's &PMV[0]) -- transient slot + cursor k.
                idxs, node2 = [], inner
                while isinstance(node2, c_ast.ArrayRef):
                    idxs.append(node2.subscript)
                    node2 = node2.name
                if (isinstance(node2, c_ast.ID) and node2.name in sc.locals
                        and node2.name not in sc.aliases
                        and cnp.ndim(sc.locals[node2.name]) >= 1):
                    shape = cnp.shape(sc.locals[node2.name])
                    flat = cnp.int32(0)
                    for d, ix in enumerate(reversed(idxs)):
                        stride = int(np.prod(shape[d + 1:],
                                             dtype=np.int64))
                        flat = flat + cnp.asarray(
                            self.eval(ix, sc), cnp.int32) * stride
                    args.append(("__alias_local_off__", node2.name, flat))
                    continue
                # &arr[k] / &glob: a pointer value -- forward base+offset.
                base, off = self._ptr_parts(a, sc)
                args.append(("__alias_off__", base,
                             cnp.asarray(off, cnp.int32)))
                continue
            if isinstance(a, c_ast.ID):
                if (a.name in sc.locals and a.name not in sc.aliases
                        and cnp.ndim(sc.locals[a.name]) >= 1):
                    # A caller-LOCAL array argument: C passes a pointer to
                    # it.  Modeled as copy-in/copy-out through a transient
                    # slot (run_function), sound because the subset has no
                    # overlapping aliases.
                    args.append(("__alias_local__", a.name))
                    continue
                tgt = sc.aliases.get(a.name, a.name)
                if isinstance(tgt, tuple):       # union pointer forwards
                    args.append(("__alias_off__", tgt,
                                 cnp.asarray(sc.locals.get(a.name, 0),
                                             cnp.int32)))
                    continue
                if tgt in sc.g and cnp.ndim(sc.g[tgt]) >= 1:
                    if a.name in sc.aliases and a.name in sc.locals:
                        # A WALKED/SEATED pointer forwards base AND
                        # cursor, so the callee continues from the
                        # caller's position (sha_stream passing
                        # &indata[j][0] onward to sha_update).
                        args.append(("__alias_off__", tgt,
                                     cnp.asarray(sc.locals[a.name],
                                                 cnp.int32)))
                        continue
                    args.append(("__alias__", tgt))
                    continue
            if isinstance(a, c_ast.ArrayRef):
                # PARTIAL indexing of a multi-dim array (motion.c's
                # motion_vector(PMV[0][s], ...)): C decays the sub-array
                # to a pointer -- forward base + flattened row offset so
                # callee writes land in the caller's array.  FULL
                # indexing stays a by-value element.
                idxs, node2 = [], a
                while isinstance(node2, c_ast.ArrayRef):
                    idxs.append(node2.subscript)
                    node2 = node2.name
                if isinstance(node2, c_ast.ID):
                    nm2 = node2.name
                    arrv = cur = None
                    basen, is_local = nm2, False
                    if nm2 in sc.aliases:
                        basen = sc.aliases[nm2]
                        arrv = sc.g.get(basen)
                        cur = sc.locals.get(nm2)
                    elif (nm2 in sc.locals
                            and cnp.ndim(sc.locals[nm2]) >= 1):
                        arrv, is_local = sc.locals[nm2], True
                    elif nm2 in sc.g and cnp.ndim(sc.g[nm2]) >= 1:
                        arrv = sc.g[nm2]
                    eff_nd = None
                    if arrv is not None:
                        eff_nd = cnp.ndim(arrv)
                        # The BASE array's element type decides the
                        # logical arity (a walked cursor's own ctype is
                        # deliberately None, so resolve the base).
                        ctn = (sc.ctype(nm2) if is_local
                               else sc.ctypes.get(basen))
                        if isinstance(ctn, _CType64):
                            eff_nd -= 1     # trailing dim is the limb pair
                    if arrv is not None and len(idxs) < eff_nd:
                        shape = cnp.shape(arrv)
                        flat = cnp.int32(0)
                        for d, ix in enumerate(reversed(idxs)):
                            stride = int(np.prod(shape[d + 1:],
                                                 dtype=np.int64))
                            flat = flat + cnp.asarray(
                                self.eval(ix, sc), cnp.int32) * stride
                        if cur is not None:
                            flat = flat + cnp.asarray(cur, cnp.int32)
                        if is_local:
                            args.append(("__alias_local_off__", nm2,
                                         flat))
                        else:
                            args.append(("__alias_off__", basen, flat))
                        continue
            args.append(self.eval(a, sc))
        if fname == "exit":
            # exit(n) on an error path (jpeg's "Not Jpeg File!"/huffman
            # read error): modeled as an OBSERVABLE poison -- the
            # synthetic global __exit_state records 1+n and joins the
            # output surface.  Fault-free runs never take these paths,
            # so the oracle is exact; under injection the poisoned flag
            # plus divergent outputs classify the run, though in-model
            # execution continues past the exit (documented fidelity
            # envelope -- the QEMU guest would stop).
            code = (args[0] if args else cnp.int32(0))
            # POSIX truncates the exit status to 8 bits; 1+(n & 0xFF)
            # is in [1, 256], never colliding with 0 = ran to end.
            sc.g["__exit_state"] = (
                (cnp.asarray(code, cnp.int32) & cnp.int32(0xFF))
                + cnp.int32(1))
            return cnp.int32(0)
        if fname == "abort":
            raise CLiftError(
                "abort() needs the abort/DUE machinery; model it via "
                "DWC (detect-only strategy) instead")
        fn = self.funcs.get(fname)
        if fn is None:
            raise CLiftError(f"call to undefined function {fname!r} "
                             f"at {node.coord}")
        arg_consts = [None if isinstance(v, tuple)
                      or self._has_effects(n2)
                      else self._const_eval(n2, sc)
                      for n2, v in zip(arg_nodes, args)]
        return self._run_function(fn, args, sc, arg_consts)

    def _walked_names(self, node) -> set:
        """Names subject to POINTER arithmetic: ++/--/assignment on the
        BARE identifier.  Element stores (``a[i] = v``) do not count --
        they write the pointee, not the pointer (mm.c's r_matrix vs
        crc16.c's data_p)."""
        names: set = set()

        class V(c_ast.NodeVisitor):
            def visit_UnaryOp(v, n):
                if (n.op in ("++", "p++", "--", "p--")
                        and isinstance(n.expr, c_ast.ID)):
                    names.add(n.expr.name)
                v.generic_visit(n)

            def visit_Assignment(v, n):
                if isinstance(n.lvalue, c_ast.ID):
                    names.add(n.lvalue.name)
                v.generic_visit(n)

        V().visit(node)
        return names

    # -- desugar pre-pass --------------------------------------------------
    @staticmethod
    def _string_only_printf(stmt) -> bool:
        return (isinstance(stmt, c_ast.FuncCall)
                and isinstance(stmt.name, c_ast.ID)
                and stmt.name.name == "printf"
                and stmt.args is not None
                and len(stmt.args.exprs) == 1
                and isinstance(stmt.args.exprs[0], c_ast.Constant)
                and stmt.args.exprs[0].type == "string")

