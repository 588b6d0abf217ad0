"""The array words of the restricted-C compiler: ``jax.numpy``'s integer
semantics over torch tensors.

The reference compiles C to ``jax.numpy`` code, and its results depend on
what ``jnp`` and XLA do with 32-bit integers: a ``uint32`` word compares,
divides and shifts unsigned; ``uint32`` with ``int32`` promotes to int32
(x64 off); a Python int is weakly typed and takes the other operand's
type; a traced index wraps once when negative, then clamps on a read and
drops the write on a store.  torch has no usable ``uint32``, so an
:class:`Array` carries an int32 tensor (or a bool one) with the dtype the
reference's value has, and every operator here applies the reference's
rule.  Only the operations the compiler uses exist.

XLA's integer edge values are kept, so a lifted program gives the
reference's words on every row, a faulty one included:

  * ``div(x, 0)`` is -1 (all ones) and ``rem(x, 0)`` is ``x``;
    ``div(INT_MIN, -1)`` is INT_MIN and its ``rem`` 0 (``lax.div`` /
    ``lax.rem``, which C's ``/`` and ``%`` on int32 lower to);
  * ``x // 0`` on uint32 is all ones, ``x % 0`` is 0 (``jnp``'s
    ``floor_divide`` / ``remainder``, C's unsigned ``/`` and ``%``);
  * a shift count outside ``[0, 31]`` (read unsigned) gives 0, or the
    sign fill for an arithmetic right shift.

torch raises on an integer division by zero on the CPU and leaves it
unspecified on the card, so no division here ever sees a zero divisor.

An :class:`Array` is a pytree node of ``frontend.loops`` (its tensor the
one leaf), so loop carries keep their dtypes across ``loops.scan`` and
``loops.while_loop``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from coast_tpu_torch.frontend.loops import count_eqns as _eq
from coast_tpu_torch.frontend.loops import unliteral
from coast_tpu_torch.ops import u32

_SIGN = -2**31


class DType:
    """A dtype of the reference's C values; calling it makes a strong
    array of that dtype, as ``jnp.int32(v)`` does."""

    def __init__(self, name: str, torch_dtype: torch.dtype,
                 unsigned: bool = False):
        self.name = name
        self.torch = torch_dtype
        self.unsigned = unsigned

    def __call__(self, v) -> "Array":
        return asarray(v, self)

    def __repr__(self) -> str:
        return self.name


int32 = DType("int32", torch.int32)
uint32 = DType("uint32", torch.int32, unsigned=True)
bool_ = DType("bool", torch.bool)

# Tensors made while a lift records, with the dtype of the array that
# holds them: ``lift_c`` reads it back for each leaf's ``unsigned`` flag.
_SEEN: Optional[Dict[int, Tuple[torch.Tensor, DType]]] = None


def track(on: bool) -> None:
    """Start (or stop and forget) recording each array's tensor dtype."""
    global _SEEN
    _SEEN = {} if on else None


def dtype_of_tensor(t: torch.Tensor) -> Optional[DType]:
    if _SEEN is None:
        return None
    got = _SEEN.get(id(t))
    return got[1] if got is not None and got[0] is t else None


class Array:
    """A C value: ``t`` (int32 words, or bool), its reference dtype, and
    whether it is weakly typed (made from a Python scalar)."""

    __slots__ = ("t", "dtype", "weak", "const")

    def __init__(self, t: torch.Tensor, dtype: DType, weak: bool = False,
                 const: bool = False):
        self.t = t
        self.dtype = dtype
        self.weak = weak
        self.const = const
        if _SEEN is not None:
            _SEEN[id(t)] = (t, dtype)
        if not const:
            # A computed value is traced in the reference; only a
            # constant made from a Python or numpy value is concrete.
            unliteral(t)

    # -- pytree (frontend.loops) -----------------------------------------
    def tree_flatten(self):
        return (self.t,), (self.dtype, self.weak)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1])

    # -- shape -----------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.t.shape)

    @property
    def ndim(self) -> int:
        return self.t.dim()

    @property
    def size(self) -> int:
        return int(self.t.numel())

    def reshape(self, *shape) -> "Array":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        t = self.t.reshape(shape)
        _eq(int(tuple(t.shape) != self.shape))
        return Array(t, self.dtype, self.weak)

    def astype(self, dtype: DType) -> "Array":
        return _convert(self, dtype)

    def __bool__(self):
        raise TypeError("a C value is read as a Python bool; a static "
                        "decision must come from the constant shadow")

    def __iter__(self):
        raise TypeError("a C array is not iterable")

    def __repr__(self) -> str:
        return f"Array({self.dtype}, {tuple(self.t.shape)})"

    # -- operators -------------------------------------------------------
    def __add__(self, o):
        return _arith(self, o, "+")

    def __radd__(self, o):
        return _arith(o, self, "+")

    def __sub__(self, o):
        return _arith(self, o, "-")

    def __rsub__(self, o):
        return _arith(o, self, "-")

    def __mul__(self, o):
        return _arith(self, o, "*")

    def __rmul__(self, o):
        return _arith(o, self, "*")

    def __floordiv__(self, o):
        return _floordiv(self, o)

    def __mod__(self, o):
        return _remainder(self, o)

    def __and__(self, o):
        return _bitwise(self, o, "&")

    def __rand__(self, o):
        return _bitwise(o, self, "&")

    def __or__(self, o):
        return _bitwise(self, o, "|")

    def __ror__(self, o):
        return _bitwise(o, self, "|")

    def __xor__(self, o):
        return _bitwise(self, o, "^")

    def __rxor__(self, o):
        return _bitwise(o, self, "^")

    def __lshift__(self, o):
        return _shift(self, o, "<<")

    def __rlshift__(self, o):
        return _shift(o, self, "<<")

    def __rshift__(self, o):
        return _shift(self, o, ">>")

    def __rrshift__(self, o):
        return _shift(o, self, ">>")

    def __invert__(self):
        _eq(1)
        if self.dtype is bool_:
            return Array(torch.logical_not(self.t), bool_)
        return Array(~self.t, self.dtype, self.weak)

    def __neg__(self):
        _eq(1)
        return Array(-self.t, self.dtype, self.weak)

    def __lt__(self, o):
        return less(self, o)

    def __le__(self, o):
        return less_equal(self, o)

    def __gt__(self, o):
        return greater(self, o)

    def __ge__(self, o):
        return greater_equal(self, o)

    def __eq__(self, o):                    # noqa: D105 (elementwise)
        return equal(self, o)

    def __ne__(self, o):
        return not_equal(self, o)

    __hash__ = object.__hash__

    # -- indexing --------------------------------------------------------
    def __getitem__(self, key):
        if _is_dynamic(key):
            return _take(self, key)
        keys = key if isinstance(key, tuple) else (key,)
        _eq(2 if any(isinstance(k, int) for k in keys) else 1)
        return Array(self.t[key], self.dtype, self.weak)

    @property
    def at(self):
        return _At(self)


class _At:
    def __init__(self, arr: Array):
        self.arr = arr

    def __getitem__(self, key):
        return _Update(self.arr, key)


class _Update:
    def __init__(self, arr: Array, key):
        self.arr, self.key = arr, key

    def set(self, v, mode=None):
        """``.at[key].set(v)``: a negative index wraps once, a write still
        outside the array is dropped (the default and ``mode="drop"``)."""
        return _scatter(self.arr, self.key, v)


# ---------------------------------------------------------------------------
# conversions and promotion
# ---------------------------------------------------------------------------

def _bits(v: int) -> int:
    return u32.const(int(v))


def _scalar_tensor(v, dtype: DType) -> torch.Tensor:
    if dtype is bool_:
        return torch.tensor(bool(v))
    return torch.tensor(_bits(v), dtype=torch.int32)


def asarray(x, dtype: Optional[DType] = None) -> Array:
    """``jnp.asarray``: an array as is (converted when ``dtype`` is given);
    a Python int is a weak int32 without ``dtype``."""
    if isinstance(x, Array):
        return x if dtype is None else _convert(x, dtype)
    if isinstance(x, torch.Tensor):
        raise TypeError("a raw tensor reached the C compiler")
    if isinstance(x, (bool, np.bool_)):
        a = Array(_scalar_tensor(x, bool_), bool_, const=True)
        return a if dtype is None else _convert(a, dtype)
    if isinstance(x, (int, np.integer)) and not isinstance(x, np.ndarray):
        if dtype is None:
            dt = uint32 if isinstance(x, np.uint32) else int32
            return Array(_scalar_tensor(x, dt), dt,
                         weak=isinstance(x, int), const=True)
        return Array(_scalar_tensor(x, dtype), dtype, const=True)
    arr = np.asarray(x)
    dt = {np.dtype(np.uint32): uint32, np.dtype(np.bool_): bool_}.get(
        arr.dtype, int32)
    if dt is bool_:
        t = torch.from_numpy(arr.copy())
    else:
        t = torch.from_numpy(
            (arr.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)
            .view(np.int32).copy())
    a = Array(t, dt, const=True)
    return a if dtype is None else _convert(a, dtype)


def _convert(a: Array, dtype: DType) -> Array:
    """``astype``: int32 <-> uint32 keep the bits, a bool becomes 0/1, a
    word becomes ``!= 0``.  A conversion is a new value (a passthrough
    is not), as ``convert_element_type`` is in a jaxpr; a constant's
    conversion is a constant, as JAX folds it."""
    if a.dtype is dtype and not a.weak:
        return a
    # A constant converts at trace time (no equation, still concrete).
    _eq(int(a.dtype is not dtype and not a.const))
    if dtype is bool_:
        return Array(a.t != 0, bool_, const=a.const)
    if a.dtype is bool_:
        return Array(a.t.to(torch.int32), dtype, const=a.const)
    # A view of the same words (``view`` by shape has a batching rule on
    # every torch the port runs on; ``view(dtype)`` has not).
    return Array(a.t.view(tuple(a.t.shape)), dtype, const=a.const)


def _promote(a: Array, b: Array) -> Tuple[DType, bool]:
    """``jnp``'s result dtype for two C values, x64 off."""
    if a.dtype is b.dtype:
        return a.dtype, a.weak and b.weak
    if a.weak != b.weak:
        strong, weak = (b, a) if a.weak else (a, b)
        if strong.dtype is bool_:
            return weak.dtype, True
        return strong.dtype, False
    kinds = {a.dtype, b.dtype}
    if kinds == {int32, uint32}:
        return int32, False
    if bool_ in kinds:
        return (kinds - {bool_}).pop(), a.weak and b.weak
    raise TypeError(f"no promotion for {a.dtype} and {b.dtype}")


def _operands(a, b):
    """Both sides as arrays of their common dtype."""
    if not isinstance(a, Array) and not isinstance(b, Array):
        a, b = asarray(a), asarray(b)
    if not isinstance(a, Array):
        a = _scalar_like(a, b)
    if not isinstance(b, Array):
        b = _scalar_like(b, a)
    dt, weak = _promote(a, b)
    return _convert_keep(a, dt), _convert_keep(b, dt), dt, weak


def _scalar_like(v, other: Array) -> Array:
    """A Python scalar next to ``other``: weakly typed, so it takes
    ``other``'s dtype (a bool operand makes it int32)."""
    if isinstance(v, (bool, np.bool_)):
        return asarray(v)
    dt = other.dtype if other.dtype is not bool_ else int32
    return Array(_scalar_tensor(v, dt), dt, weak=True, const=True)


def _convert_keep(a: Array, dtype: DType) -> Array:
    """The operand converted for an operation (a weak operand of the
    same dtype stays the tensor it is)."""
    if a.dtype is dtype:
        return a
    return _convert(a, dtype)


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------

def _arith(a, b, op: str) -> Array:
    a, b, dt, weak = _operands(a, b)
    _eq(1)
    if dt is bool_:
        a, b = _convert(a, int32), _convert(b, int32)
        dt = int32
    if op == "+":
        t = a.t + b.t
    elif op == "-":
        t = a.t - b.t
    else:
        # The product's low 32 bits, computed in int64 so that no int32
        # product overflows on either device.
        t = (a.t.to(torch.int64) * b.t.to(torch.int64)).to(torch.int32)
    return Array(t, dt, weak)


def _bitwise(a, b, op: str) -> Array:
    a, b, dt, weak = _operands(a, b)
    _eq(1)
    f = {"&": torch.bitwise_and, "|": torch.bitwise_or,
         "^": torch.bitwise_xor}[op]
    return Array(f(a.t, b.t), dt, weak)


def _shift(a, b, op: str) -> Array:
    """``<<`` / ``>>`` of the promoted operands, XLA's rule for a count
    outside ``[0, 31]``.  One shift each, as in the reference's jaxpr: the
    range test is a mask, not a select."""
    a, b, dt, weak = _operands(a, b)
    n = u32.wide(b.t)
    _eq(1)
    if op == ">>" and not dt.unsigned:
        return Array(a.t >> torch.clamp(n, max=31).to(torch.int32), dt, weak)
    ok = -(n < 32).to(torch.int64)
    if op == "<<":
        t = (a.t.to(torch.int64) << torch.clamp(n, max=31)) & ok
    else:
        t = (u32.wide(a.t) >> torch.clamp(n, max=31)) & ok
    return Array(u32.word(t), dt, weak)


def _pick(keep: torch.Tensor, other, use_other: torch.Tensor):
    """``other`` where ``use_other`` (bool) holds, else ``keep``: a
    bitwise select, so that it reads as data, not as a branch."""
    m = -use_other.to(keep.dtype)
    return keep ^ ((keep ^ other) & m)


def div(a, b) -> Array:
    """``lax.div``: truncating division with XLA's edge values (one
    primitive there: the guards here are arithmetic, not selects)."""
    a, b, dt, weak = _operands(a, b)
    _eq(1)
    if dt.unsigned:
        x, y = u32.wide(a.t), u32.wide(b.t)
        zero = y == 0
        q = torch.div(x, y + zero.to(torch.int64), rounding_mode="trunc")
        return Array(u32.word(_pick(q, 0xFFFFFFFF, zero)), dt, weak)
    zero = b.t == 0
    ovf = (a.t == _SIGN) & (b.t == -1)
    q = torch.div(a.t, b.t + zero.to(torch.int32) + 2 * ovf.to(torch.int32),
                  rounding_mode="trunc")
    return Array(_pick(q.to(torch.int32), -1, zero), dt, weak)


def rem(a, b) -> Array:
    """``lax.rem``: the remainder of :func:`div` (sign of the dividend);
    ``x rem 0`` is ``x``."""
    a, b, dt, weak = _operands(a, b)
    _eq(1)
    if dt.unsigned:
        x, y = u32.wide(a.t), u32.wide(b.t)
        zero = y == 0
        r = torch.remainder(x, y + zero.to(torch.int64))
        return Array(u32.word(_pick(r, x, zero)), dt, weak)
    zero = b.t == 0
    ovf = (a.t == _SIGN) & (b.t == -1)
    r = torch.fmod(a.t, b.t + zero.to(torch.int32) + 2 * ovf.to(torch.int32))
    return Array(_pick(r.to(torch.int32), a.t, zero), dt, weak)


def _floordiv(a, b) -> Array:
    """``jnp.floor_divide`` (C's unsigned ``/``)."""
    a, b, dt, weak = _operands(a, b)
    if not dt.unsigned:
        raise NotImplementedError("signed // is lowered through div()")
    return div(Array(a.t, dt, weak), Array(b.t, dt, weak))


def _remainder(a, b) -> Array:
    """``jnp.remainder``, as its jaxpr is: a zero divisor replaced by 1
    (so ``x % 0`` is 0; a ``where``), ``lax.rem``, then the select that
    moves a remainder to the divisor's sign."""
    a, b, dt, weak = _operands(a, b)
    _eq(1)
    one = torch.ones_like(b.t)
    y = torch.where(b.t == 0, one, b.t)
    if dt.unsigned:
        x, yw = u32.wide(a.t), u32.wide(y)
        r = u32.word(torch.remainder(x, yw))
        fix = (r != 0) & ((u32.wide(r) < 0) != (yw < 0))
    else:
        # rem(INT_MIN, -1) is 0: the divisor -1 reads as 1.
        r = torch.fmod(a.t, y + 2 * (y == -1).to(torch.int32))
        r = r.to(torch.int32)
        fix = (r != 0) & ((r < 0) != (y < 0))
    return Array(torch.where(fix, r + y, r).to(torch.int32), dt, weak)


# ---------------------------------------------------------------------------
# comparisons and logic
# ---------------------------------------------------------------------------

def _compare(a, b, op: str) -> Array:
    a, b, dt, _ = _operands(a, b)
    _eq(1)
    x, y = a.t, b.t
    if dt.unsigned and op not in ("==", "!="):
        x, y = x ^ _SIGN, y ^ _SIGN
    f = {"==": torch.eq, "!=": torch.ne, "<": torch.lt, ">": torch.gt,
         "<=": torch.le, ">=": torch.ge}[op]
    return Array(f(x, y), bool_)


def equal(a, b):
    return _compare(a, b, "==")


def not_equal(a, b):
    return _compare(a, b, "!=")


def less(a, b):
    return _compare(a, b, "<")


def greater(a, b):
    return _compare(a, b, ">")


def less_equal(a, b):
    return _compare(a, b, "<=")


def greater_equal(a, b):
    return _compare(a, b, ">=")


def _truth(c) -> torch.Tensor:
    c = asarray(c)
    return c.t if c.dtype is bool_ else c.t != 0


def logical_and(a, b) -> Array:
    _eq(1)
    return Array(torch.logical_and(_truth(a), _truth(b)), bool_)


def logical_or(a, b) -> Array:
    _eq(1)
    return Array(torch.logical_or(_truth(a), _truth(b)), bool_)


def logical_not(a) -> Array:
    _eq(1)
    return Array(torch.logical_not(_truth(a)), bool_)


def where(c, a, b) -> Array:
    """``jnp.where``: ``a`` where ``c`` holds (nonzero), else ``b``."""
    a, b, dt, weak = _operands(a, b)
    _eq(1)
    return Array(torch.where(_truth(c), a.t, b.t), dt, weak)


def clip(x, lo, hi) -> Array:
    """``jnp.clip``: ``min(max(x, lo), hi)`` in ``x``'s dtype (a max and
    a min, no select)."""
    x = asarray(x)
    _eq(1)
    flip = _SIGN if x.dtype.unsigned else 0
    t = x.t ^ flip if flip else x.t
    for bound, f in ((lo, torch.maximum), (hi, torch.minimum)):
        if bound is None:
            continue
        bt = (_convert_keep(bound, x.dtype).t if isinstance(bound, Array)
              else _scalar_tensor(bound, x.dtype))
        t = f(t, bt ^ flip if flip else bt)
    return Array(t ^ flip if flip else t, x.dtype, x.weak)


# ---------------------------------------------------------------------------
# shapes, makers, joins
# ---------------------------------------------------------------------------

def ndim(x) -> int:
    return x.ndim if isinstance(x, Array) else np.ndim(x) \
        if isinstance(x, (int, np.ndarray, np.integer)) else 0


def shape(x) -> Tuple[int, ...]:
    return x.shape if isinstance(x, Array) else np.shape(x)


def reshape(x, shape) -> Array:
    return asarray(x).reshape(shape)


def zeros(shape, dtype: DType = int32) -> Array:
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    if not shape:
        # A scalar zero is a constant in the reference (no broadcast).
        return Array(_scalar_tensor(0, dtype), dtype, const=True)
    _eq(1)
    return Array(torch.zeros(shape, dtype=dtype.torch), dtype)


def arange(n: int, dtype: DType = int32) -> Array:
    _eq(1)
    return Array(torch.arange(n, dtype=torch.int32), dtype)


def _common(xs: Sequence) -> Tuple[list, DType]:
    xs = [asarray(x) for x in xs]
    dt, weak = xs[0].dtype, xs[0].weak
    for x in xs[1:]:
        dt, weak = _promote(Array(x.t, dt, weak), x)
    return [_convert_keep(x, dt) for x in xs], dt


def stack(xs: Sequence, axis: int = 0) -> Array:
    xs, dt = _common(xs)
    _eq(len(xs) + 1)
    return Array(torch.stack([x.t for x in xs], dim=axis), dt)


def concatenate(xs: Sequence, axis: int = 0) -> Array:
    xs, dt = _common(xs)
    _eq(1)
    return Array(torch.cat([x.t for x in xs], dim=axis), dt)


# ---------------------------------------------------------------------------
# traced indexing
# ---------------------------------------------------------------------------

def _is_dynamic(key) -> bool:
    if isinstance(key, Array):
        return True
    return isinstance(key, tuple) and any(isinstance(k, Array) for k in key)


def _index_words(i, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """An index of an axis of ``n`` as ``(int64 index wrapped once when
    negative, in-range flag)``; an unsigned index never wraps."""
    i = asarray(i)
    if i.dtype is bool_:
        i = _convert(i, int32)
    if i.dtype.unsigned:
        x = u32.wide(i.t)
    else:
        _eq(3)                               # lt, add, select_n
        x = i.t.to(torch.int64)
        x = torch.where(x < 0, x + n, x)
    return x, (x >= 0) & (x < n)


def _linear(arr: Array, key) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Row-major index over the leading ``len(key)`` axes: ``(clamped
    index, in-range flag, axes)``."""
    key = key if isinstance(key, tuple) else (key,)
    lin, ok = None, None
    for ax, k in enumerate(key):
        n = arr.shape[ax]
        x, good = _index_words(k, n)
        x = torch.clamp(x, 0, n - 1)
        lin = x if lin is None else lin * n + x
        ok = good if ok is None else ok & good
    return lin, ok, len(key)


def _take(arr: Array, key) -> Array:
    """``arr[key]`` with traced indices: each wraps once, then clamps
    (a gather)."""
    lin, _, axes = _linear(arr, key)
    _eq(2)                                   # dynamic_slice, squeeze
    rest = arr.shape[axes:]
    flat = arr.t.reshape(-1, *rest)
    got = torch.index_select(flat, 0, lin.reshape(-1))
    return Array(got.reshape(tuple(lin.shape) + tuple(rest)), arr.dtype,
                 arr.weak)


def _scatter(arr: Array, key, v) -> Array:
    """``arr.at[key].set(v)`` with drop semantics (a scatter): each index
    wraps once; a write with any index still out of range lands in a
    spare row that is cut off.  ``key`` may also be a vector of positions
    along axis 0."""
    v = asarray(v) if not isinstance(v, Array) else v
    val = _convert_keep(v, arr.dtype).t
    if not _is_dynamic(key):
        key = tuple(asarray(k, int32)
                    for k in (key if isinstance(key, tuple) else (key,)))
    lin, ok, axes = _linear(arr, key)
    # The updates' broadcasts (a concatenate of the indices past one
    # axis) and the scatter.
    _eq(2 if lin.dim() else (2 if axes == 1 else axes + 2))
    rest = arr.shape[axes:]
    n = int(np.prod(arr.shape[:axes], dtype=np.int64))
    flat = arr.t.reshape(n, *rest)
    pos = lin + (n - lin) * torch.logical_not(ok).to(torch.int64)
    pos = pos.reshape(-1)
    ext = torch.cat([flat, torch.zeros((1, *rest), dtype=flat.dtype)])
    src = val.to(flat.dtype).expand(pos.shape[0], *rest)
    out = torch.index_put(ext, (pos,), src)[:n]
    return Array(out.reshape(arr.shape), arr.dtype)
