"""Row indexing with the reference's index semantics, per batch row.

A region walks its arrays with a loop counter that a fault can corrupt,
and torch advanced indexing raises on an out-of-range index, so every
index is brought into range here first, by the rule of the reference
idiom it replaces:

  =========================================  ============  ==============
  reference idiom                            index < 0     index >= n
  =========================================  ============  ==============
  ``a[i]``, ``lax.dynamic_slice``            wraps once    clamps
  (:func:`row_select`, :func:`row_update`,   (below -n:
  :func:`lookup`)                            clamps to 0)
  ``jnp.take(a, i, mode="clip")``            clamps to 0   clamps
  (:func:`take_clip`)
  ``jnp.take(a, i)`` (fill mode)             wraps once;   the fill value
  (:func:`take_fill`)                        below -n the
                                             fill value
  ``a.at[i].set(v, mode="drop")``            wraps once;   the write is
  (:func:`update_drop`)                      below -n the  dropped
                                             write drops
  =========================================  ============  ==============

The fill value is the reference's: ``INT32_MIN`` for an int32 array,
``0xFFFFFFFF`` for a uint32 one (int32 ``-1`` here).

``row_select`` / ``row_update`` are the counterparts of
``coast_tpu/ops/indexing.py``.  As there, each function tags its index
``coast:load_addr`` (a read) or ``coast:store_addr`` (a write) for the
derived dataflow of ``passes/verification.py``: identities unless a lint
capture records (``ops/voters.tag``).  For the roofline's op count
(``voters.priced``) a helper costs what the reference's primitive costs:
the one negative wrap is traced as ops there (a compare, an add and a
select), while the clamp into range, the fill/drop bounds test and its
select happen inside ``dynamic_slice``/``gather``/``scatter`` and count
nothing, so here too.  Every function takes ``mat`` with a
leading row axis ``R`` and indexes its axis 1; ``i`` holds one index a row
(int32 ``[R]``) or, for the ``take`` forms, a vector of them ``[R, K]``.
"""

from __future__ import annotations

import torch

from coast_tpu_torch.ops.voters import priced, tag

_LOAD, _STORE = "coast:load_addr", "coast:store_addr"


@priced(0)
def in_range(i: torch.Tensor, n: int) -> torch.Tensor:
    """Clamp into ``[0, n)``, the clamp inside the reference's
    ``dynamic_slice``/``gather`` (no op of its own there)."""
    return torch.clamp(i, 0, n - 1)


@priced(0)
def _bounded(ok: torch.Tensor, got: torch.Tensor,
             other: torch.Tensor) -> torch.Tensor:
    """``got`` where the index was in range (``ok``, broadcast), else
    ``other`` (the fill word, or the old element of a dropped write):
    inside the reference's gather/scatter mode."""
    return torch.where(ok, got, other)


@priced(0)
def _in_bounds(c: torch.Tensor, n: int, ok=None) -> torch.Tensor:
    """``c`` within ``[0, n)`` (and ``ok``): the bounds test of the
    reference's fill/drop modes."""
    return (c >= 0) & (c < n) if ok is None else ok & (c >= 0) & (c < n)


@priced(0)
def _flat_index(flat: torch.Tensor, c: torch.Tensor, n: int
                ) -> torch.Tensor:
    """Row-major index of one more axis (the scatter's own arithmetic)."""
    return flat * n + torch.clamp(c, 0, n - 1)


def clamp_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """One negative wrap, then clamp into ``[0, n)``; int64 for indexing."""
    i = i.to(torch.int64)
    return in_range(torch.where(i < 0, i + n, i), n)


def row_select(mat: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``mat[r, clamp(i[r])]`` for every row ``r`` (``i`` [R] or [R, K])."""
    return _gather(mat, clamp_index(tag(i, _LOAD), mat.shape[1]))


def row_update(mat: torch.Tensor, row: torch.Tensor,
               i: torch.Tensor) -> torch.Tensor:
    """A copy of ``mat`` with ``mat[r, clamp(i[r])] = row[r]``."""
    ic = clamp_index(tag(i, _STORE), mat.shape[1])
    out = mat.clone()
    out[torch.arange(mat.shape[0], device=mat.device), ic] = row
    return out


def take_clip(mat: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``jnp.take(mat[r], i[r], axis=0, mode="clip")`` for every row:
    ``i`` is clamped into ``[0, n)``, a negative index reads element 0.
    ``i`` ``[R]`` gives ``[R, *mat.shape[2:]]``; ``[R, K]`` gives
    ``[R, K, *mat.shape[2:]]``."""
    ic = in_range(tag(i, _LOAD).to(torch.int64), mat.shape[1])
    return _gather(mat, ic)


def take_fill(mat: torch.Tensor, i: torch.Tensor,
              unsigned: bool = False) -> torch.Tensor:
    """``jnp.take(mat[r], i[r], axis=0)`` (fill mode) for every row: one
    negative wrap, then an index outside ``[0, n)`` reads the fill value
    (``INT32_MIN``, or ``0xFFFFFFFF`` for a uint32 array)."""
    n = mat.shape[1]
    i = tag(i, _LOAD).to(torch.int64)
    i = torch.where(i < 0, i + n, i)
    ok = _in_bounds(i, n)
    got = _gather(mat, in_range(i, n))
    fill = torch.full((), -1 if unsigned else -2**31, dtype=mat.dtype,
                      device=mat.device)
    return _bounded(ok.view(*ok.shape, *([1] * (got.dim() - ok.dim()))),
                    got, fill)


def update_drop(mat: torch.Tensor, i: torch.Tensor,
                value: torch.Tensor) -> torch.Tensor:
    """A copy of ``mat`` with ``mat[r].at[i[r]].set(value[r],
    mode="drop")`` for every row.  ``i`` ``[R]`` indexes axis 1;
    ``i`` ``[R, 2]`` indexes axes 1 and 2 together (``mat.at[i0, i1]``).
    Each index wraps once when negative; a write with any index still
    outside its axis is dropped.  ``value`` is ``[R, *rest]`` for the
    element (row) written."""
    i = tag(i, _STORE).to(torch.int64)
    axes = 1 if i.dim() == 1 else i.shape[1]
    cols = i.view(i.shape[0], axes)
    ok = torch.ones(i.shape[0], dtype=torch.bool, device=mat.device)
    flat = torch.zeros(i.shape[0], dtype=torch.int64, device=mat.device)
    for a in range(axes):
        n = mat.shape[1 + a]
        c = cols[:, a]
        c = torch.where(c < 0, c + n, c)
        ok = _in_bounds(c, n, ok)
        flat = _flat_index(flat, c, n)
    view = mat.reshape(mat.shape[0], -1, *mat.shape[1 + axes:])
    old = _gather(view, flat)
    new = _bounded(ok.view(-1, *([1] * (old.dim() - 1))),
                   value.to(mat.dtype).expand_as(old), old)
    out = view.clone()
    out[torch.arange(mat.shape[0], device=mat.device), flat] = new
    return out.view(mat.shape)


def lookup(table: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``table[i]`` for a constant (unbatched) table and a per-row index
    of any shape: ``a[i]``'s rule, one negative wrap, then a clamp."""
    return table[clamp_index(tag(i, _LOAD), table.shape[0])]


def _gather(mat: torch.Tensor, ic: torch.Tensor) -> torch.Tensor:
    """``mat[r, ic[r]]`` (``ic`` [R]) or ``mat[r, ic[r, k]]`` ([R, K])."""
    rows = torch.arange(mat.shape[0], device=mat.device)
    if ic.dim() == 1:
        return mat[rows, ic]
    return mat[rows[:, None], ic]
