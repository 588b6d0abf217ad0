"""Restricted-C type model: the ILP32 integer lattice, the 64-bit
limb-pair (_C64) arithmetic, scopes, and the shared error type.

The counterpart of ``coast_tpu/frontend/c_types.py``; see
``c_lifter.py`` for the front end's contract.  Values are
``c_array.Array`` words (an int32 tensor with the reference's dtype), so
a C ``unsigned`` is an int32 tensor whose array dtype is ``uint32`` and
whose leaf, once lifted, has ``LeafSpec.unsigned``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from coast_tpu_torch.frontend import c_array as cnp
from coast_tpu_torch.frontend.lifter import LiftError

try:
    from pycparser import c_ast, c_parser
except ImportError as e:     # the front end cannot parse without it
    raise ImportError(
        "the restricted-C front end (frontend.lift_c, a .c program) needs "
        "the pycparser package, which is not installed") from e



class CLiftError(LiftError):
    """Unsupported C construct; the message names it and the location."""


_UNSIGNED = {"unsigned", "uint32_t", "_Bool"}
_NARROW = {"char": 8, "short": 16, "uint8_t": 8, "int8_t": 8,
           "uint16_t": 16, "int16_t": 16}




# UART print-buffer capacity in 32-bit words (dynamic-context
# printf capture; see c_lifter._parse_globals / c_flow scan flush).
_PRINT_BUF_WORDS = 256


class _CType:
    """A C integer type on the 32-bit lane model.

    Narrow (8/16-bit) values live in int32 lanes holding their PROMOTED
    value (C's integer promotions take unsigned char/short to int, which
    int32 represents exactly), and every STORE to a narrow lvalue
    re-normalizes: mask to the declared width, sign-extend if signed --
    the mod-2^8/2^16 wraparound semantics the reference's byte/short
    benchmarks rely on (crc16.c's ``unsigned char x``/``unsigned short
    crc``).  Memory LAYOUT stays one lane word per element (the
    injection model is word-addressed; byte packing is out of scope and
    documented in docs/lifter.md)."""

    __slots__ = ("dtype", "bits", "unsigned")

    def __init__(self, dtype, bits: int = 32, unsigned: bool = False):
        self.dtype = dtype
        self.bits = bits
        self.unsigned = unsigned

    def store(self, v):
        """Normalize a value being stored into this type's lane."""
        if isinstance(v, _C64):
            v = v.lo                    # C conversion 64 -> 32: mod 2^32
        v = cnp.asarray(v)
        if self.bits == 32:
            return v.astype(self.dtype)
        mask = (1 << self.bits) - 1
        v = v.astype(cnp.int32) & mask
        if not self.unsigned:
            sign = 1 << (self.bits - 1)
            v = (v ^ sign) - sign
        return v

    def zero(self):
        return cnp.zeros((), self.dtype)


class _C64:
    """A 64-bit C integer as a uint32 limb pair (lo, hi).

    JAX's x64 mode stays off (the whole lane/memory model is 32-bit
    words, matching the reference's ILP32 targets); ``long long``
    values instead live as two 32-bit lanes with explicit carry
    arithmetic -- the same limb model the df64 softfloat re-expression
    uses (models/chstone/df64.py).  A pytree node of ``frontend.loops``
    (``tree_flatten``), so 64-bit locals carry through ``loops.scan`` /
    ``loops.while_loop`` and the branch select like any other value."""

    def __init__(self, lo, hi, unsigned: bool = False):
        self.lo = cnp.asarray(lo, cnp.uint32)
        self.hi = cnp.asarray(hi, cnp.uint32)
        self.unsigned = bool(unsigned)

    def tree_flatten(self):
        return (self.lo, self.hi), self.unsigned

    @classmethod
    def tree_unflatten(cls, aux, children):
        # Bypass __init__: the children are the limb arrays as they are.
        obj = object.__new__(cls)
        obj.lo, obj.hi = children
        obj.unsigned = aux
        return obj

    def with_sign(self, unsigned: bool) -> "_C64":
        return _C64(self.lo, self.hi, unsigned)


def _to64(v, unsigned_hint: bool = False) -> _C64:
    """C conversion of a value to a 64-bit integer."""
    if isinstance(v, _C64):
        return v
    v = cnp.asarray(v)
    if v.dtype == cnp.uint32 or unsigned_hint:
        return _C64(v, cnp.uint32(0), True)
    v32 = v.astype(cnp.int32)
    hi = cnp.where(v32 < 0, cnp.uint32(0xFFFFFFFF), cnp.uint32(0))
    return _C64(v32, hi, False)


def _mulhi_u32(x, y):
    """High 32 bits of the exact 64-bit product of two uint32 (16-bit
    limb decomposition; every partial product fits uint32)."""
    x = cnp.asarray(x, cnp.uint32)
    y = cnp.asarray(y, cnp.uint32)
    xl, xh = x & 0xFFFF, x >> 16
    yl, yh = y & 0xFFFF, y >> 16
    ll = xl * yl
    lh = xl * yh
    hl = xh * yl
    hh = xh * yh
    cross = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    return hh + (lh >> 16) + (hl >> 16) + (cross >> 16)


def _c64_add(a: _C64, b: _C64, unsigned: bool) -> _C64:
    lo = a.lo + b.lo
    carry = (lo < a.lo).astype(cnp.uint32)
    return _C64(lo, a.hi + b.hi + carry, unsigned)


def _c64_neg(a: _C64) -> _C64:
    return _c64_add(_C64(~a.lo, ~a.hi, a.unsigned),
                    _C64(1, 0, a.unsigned), a.unsigned)


def _c64_mul(a: _C64, b: _C64, unsigned: bool) -> _C64:
    # Product mod 2^64: lo-lo full product + cross terms into hi.
    lo = a.lo * b.lo
    hi = _mulhi_u32(a.lo, b.lo) + a.lo * b.hi + a.hi * b.lo
    return _C64(lo, hi, unsigned)


def _c64_shl(a: _C64, s) -> _C64:
    s = cnp.asarray(s, cnp.uint32) & 63
    sl = cnp.clip(s, 0, 31)
    sr = cnp.clip(32 - s.astype(cnp.int32), 0, 31).astype(cnp.uint32)
    lo_small = a.lo << sl
    hi_small = (a.hi << sl) | cnp.where(s > 0, a.lo >> sr, cnp.uint32(0))
    big = cnp.clip(s - 32, 0, 31)
    lo = cnp.where(s < 32, lo_small, cnp.uint32(0))
    hi = cnp.where(s < 32, hi_small, a.lo << big)
    return _C64(lo, hi, a.unsigned)


def _c64_shr(a: _C64, s) -> _C64:
    """C >> on the 64-bit value: logical for unsigned, arithmetic for
    signed (the left operand's type governs, C11 6.5.7)."""
    s = cnp.asarray(s, cnp.uint32) & 63
    sl = cnp.clip(s, 0, 31)
    sr = cnp.clip(32 - s.astype(cnp.int32), 0, 31).astype(cnp.uint32)
    fill = (cnp.uint32(0) if a.unsigned else
            cnp.where(a.hi.astype(cnp.int32) < 0,
                      cnp.uint32(0xFFFFFFFF), cnp.uint32(0)))
    hi_sh = ((a.hi >> sl) if a.unsigned
             else (a.hi.astype(cnp.int32) >> sl.astype(cnp.int32)
                   ).astype(cnp.uint32))
    lo_small = (a.lo >> sl) | cnp.where(s > 0, a.hi << sr, cnp.uint32(0))
    big = cnp.clip(s - 32, 0, 31)
    lo_big = ((a.hi >> big) if a.unsigned
              else (a.hi.astype(cnp.int32) >> big.astype(cnp.int32)
                    ).astype(cnp.uint32))
    lo = cnp.where(s < 32, lo_small, lo_big)
    hi = cnp.where(s < 32, hi_sh, fill)
    return _C64(lo, hi, a.unsigned)


def _c64_divmod(a: _C64, b: _C64) -> Tuple[_C64, _C64]:
    """Unsigned 64/64 division: 64-step restoring shift-subtract on
    limb pairs (softfloat's estimateDiv128To64 path).  The classic
    overflow trick keeps the remainder in 64 bits: when the shifted
    remainder wraps past 2^64 its true value exceeds the divisor, so
    the subtraction is taken and the mod-2^64 result is exact."""

    z = cnp.uint32(0)
    qlo, qhi, rlo, rhi = z, z, z, z
    for i in range(64):                  # the reference's fori_loop(0, 64)
        bit = 63 - i
        nbit = ((a.hi >> cnp.uint32(bit - 32)) & 1 if bit >= 32
                else (a.lo >> cnp.uint32(bit)) & 1)
        ov = rhi >> 31
        r2 = _c64_shl(_C64(rlo, rhi, True), 1)
        r2 = _C64(r2.lo | nbit, r2.hi, True)
        ge = cnp.logical_or(
            ov.astype(cnp.bool_),
            cnp.logical_not(_c64_lt(r2, b, True)))
        r3 = _c64_add(r2, _c64_neg(b), True)
        rlo = cnp.where(ge, r3.lo, r2.lo)
        rhi = cnp.where(ge, r3.hi, r2.hi)
        q2 = _c64_shl(_C64(qlo, qhi, True), 1)
        qlo, qhi = q2.lo | ge.astype(cnp.uint32), q2.hi
    # b == 0 is C UB; pin it to q=~0, r=a (softfloat never divides by 0).
    bz = cnp.equal(b.lo | b.hi, 0)
    q = _C64(cnp.where(bz, cnp.uint32(0xFFFFFFFF), qlo),
             cnp.where(bz, cnp.uint32(0xFFFFFFFF), qhi), True)
    r = _C64(cnp.where(bz, a.lo, rlo), cnp.where(bz, a.hi, rhi), True)
    return q, r


def _c64_lt(a: _C64, b: _C64, unsigned: bool):
    if unsigned:
        hi_lt = cnp.less(a.hi, b.hi)
        hi_eq = cnp.equal(a.hi, b.hi)
    else:
        hi_lt = cnp.less(a.hi.astype(cnp.int32), b.hi.astype(cnp.int32))
        hi_eq = cnp.equal(a.hi, b.hi)
    return cnp.logical_or(hi_lt, cnp.logical_and(hi_eq,
                                                 cnp.less(a.lo, b.lo)))


class _CType64(_CType):
    """``long long`` on the limb-pair model (no memory layout: 64-bit
    GLOBALS/arrays are outside the word-addressed injection map and
    refuse at declaration; 64-bit LOCALS are register values)."""

    def __init__(self, unsigned: bool = False):
        super().__init__(cnp.uint32, 64, unsigned)

    def store(self, v):
        # Extension is governed by the SOURCE's signedness (in _to64);
        # the declared type only sets the result's signedness.
        v64 = _to64(v)
        return _C64(v64.lo, v64.hi, self.unsigned)

    def zero(self):
        return _C64(0, 0, self.unsigned)


def _ctype_of(names: List[str], typedefs: Dict[str, object]) -> _CType:
    """ILP32 _CType for a declared type-name list (``long long`` -> the
    64-bit limb-pair type)."""
    for n in names:
        if n in typedefs:
            return typedefs[n]
    uns = any(n in _UNSIGNED for n in names) or "unsigned" in names
    # Plain char is UNSIGNED on the reference's ARM targets (AAPCS).
    if "char" in names and "signed" not in names:
        uns = True
    if names.count("long") >= 2:
        return _CType64(uns)
    bits = 32
    for n in names:
        if n in _NARROW:
            bits = _NARROW[n]
    if bits == 32:
        return _CType(cnp.uint32 if uns else cnp.int32, 32, uns)
    return _CType(cnp.int32, bits, uns)


# ---------------------------------------------------------------------------
# AST -> JAX compiler
# ---------------------------------------------------------------------------

class _NoPrintList(list):
    """printf sentinel for traced sub-regions (loops, branches)."""

    def __init__(self, coord, reason=None):
        super().__init__()
        self.coord = coord
        self.reason = reason

    def _refuse(self):
        if self.reason:
            raise CLiftError(
                f"printf {self.reason} at {self.coord}: whether the "
                "print happens would depend on traced values, so it "
                "cannot be a fixed program output; print before the "
                "early exit or restructure")
        raise CLiftError(
            f"printf inside a loop or branch at {self.coord}: per-"
            "iteration prints would be traced values that cannot escape "
            "the loop; move the printf after the loop (print the final "
            "value) or restructure")

    def append(self, _):
        self._refuse()

    def extend(self, _):
        self._refuse()


class _Scope:
    """Name -> traced value, with global-write tracking.

    ``aliases`` implements C's array-argument pointer semantics at the
    only granularity the subset needs: an array parameter whose call
    argument names a GLOBAL array reads/writes that global directly
    (matrix_multiply(first_matrix, ..., results_matrix) mutates
    results_matrix, exactly as the pointer would)."""

    def __init__(self, globals_: Dict[str, cnp.Array],
                 ctypes: Optional[Dict[str, "_CType"]] = None):
        self.g = globals_          # shared, mutated in place
        self.locals: Dict[str, cnp.Array] = {}
        self.aliases: Dict[str, str] = {}       # param name -> global name
        self.ptrs: set = set()                  # declared pointer locals
        self.ctypes: Dict[str, _CType] = dict(ctypes or {})
        self.printed: List[cnp.Array] = []
        # Constant shadow environment: scalar names whose CURRENT value
        # is a compile-time-known int.  Under the port's recorder every
        # value is concrete, but reading one would bake the lift-time
        # row into every row of the lifted program (the recorder
        # refuses it), so trace-time control decisions (statically-
        # taken branches, print-loop bounds) need classic constant
        # propagation on the side.  Absent = unknown; every traced write
        # invalidates.
        self.consts: Dict[str, int] = {}

    def fork(self, no_print_at=None, no_print_reason=None):
        """Child scope for a traced sub-region (loop body/cond, branch).
        ``no_print_at`` arms the printf guard: values printed inside a
        traced sub-region are scan/cond tracers that cannot escape to the
        program output, so the guard refuses loudly instead of letting
        an opaque tracer-leak KeyError surface at lift time."""
        sub = _Scope(dict(self.g), self.ctypes)
        sub.locals = dict(self.locals)
        sub.aliases = dict(self.aliases)
        sub.ptrs = set(self.ptrs)
        sub.consts = dict(self.consts)
        sub.printed = (self.printed if no_print_at is None
                       else _NoPrintList(no_print_at, no_print_reason))
        return sub

    def read(self, name: str):
        # Locals FIRST: a pointer parameter holds its walk cursor as a
        # local under its own name while aliasing the pointed-to global
        # (``*p++`` support; _Compiler._ptr_parts).
        if name in self.locals:
            return self.locals[name]
        name = self.aliases.get(name, name)
        if name in self.locals:
            return self.locals[name]
        if name in self.g:
            return self.g[name]
        raise CLiftError(f"undeclared identifier {name!r}")

    def write(self, name: str, val):
        if name in self.locals:
            self.locals[name] = val
            return
        name = self.aliases.get(name, name)
        if name in self.locals:
            self.locals[name] = val
        elif name in self.g:
            self.g[name] = val
        else:
            self.locals[name] = val

    def read_binding(self, name: str):
        """Read an already-RESOLVED binding (a local name or a global/
        transient-slot name) with NO alias resolution.  Loop/branch
        carries hold resolved names; re-resolving them through this
        scope's alias map would mis-route when a parameter shadows a
        global of the same name (sha256_hash's ``data`` param vs the
        global ``data``)."""
        if name in self.locals:
            return self.locals[name]
        if name in self.g:
            return self.g[name]
        raise CLiftError(f"unbound carry name {name!r}")

    def write_binding(self, name: str, val):
        if name in self.locals:
            self.locals[name] = val
        else:
            self.g[name] = val

    def ctype(self, name: str) -> Optional["_CType"]:
        if name in self.locals:
            # The local's own declared type.  A pointer parameter's walk
            # cursor deliberately has none: it is a plain int32 offset,
            # NOT the narrow pointee type the alias would resolve to.
            return self.ctypes.get(name)
        return self.ctypes.get(self.aliases.get(name, name))


def _const_int(node) -> Optional[int]:
    # pycparser types suffixed literals "unsigned int"/"long int"/etc.
    if isinstance(node, c_ast.Constant) and "int" in node.type:
        return int(node.value.rstrip("uUlL"), 0)
    if isinstance(node, c_ast.UnaryOp) and node.op in ("-", "+", "~"):
        v = _const_int(node.expr)
        if v is None:
            return None
        return {"-": -v, "+": v, "~": ~v}[node.op]
    if isinstance(node, c_ast.BinaryOp):
        # Constant folding for dimension/label expressions (blowfish's
        # `BF_ROUNDS + 2`); division is C truncation toward zero.
        a, b = _const_int(node.left), _const_int(node.right)
        if a is None or b is None:
            return None
        try:
            return {
                "+": lambda: a + b, "-": lambda: a - b,
                "*": lambda: a * b,
                "/": lambda: int(a / b) if b else None,
                "%": lambda: a - int(a / b) * b if b else None,
                "<<": lambda: a << b, ">>": lambda: a >> b,
                "&": lambda: a & b, "|": lambda: a | b,
                "^": lambda: a ^ b,
            }[node.op]()
        except KeyError:
            return None
    return None


