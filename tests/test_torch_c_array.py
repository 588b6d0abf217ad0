"""The C front end's words (``coast_tpu_torch/frontend/c_array.py``)
against ``jax.numpy`` / ``jax.lax`` on the same seeded numpy inputs: the
integer edge values of XLA (division and remainder by zero, INT_MIN / -1,
shift counts outside [0, 31]), unsigned compares, jnp's dtype promotion,
and traced indexing (a read wraps once then clamps, a write out of range
is dropped).  Exact, bit for bit.  A ``cuda`` test holds the card's
values to the CPU's."""

import numpy as np
import pytest
import torch

from coast_tpu_torch.frontend import c_array as cnp

INT_MIN = -2**31


def _pairs(seed=0, n=64):
    """int32 words with zeros, -1, INT_MIN and INT_MAX in both columns."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    b = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    edges = np.array([0, -1, 1, INT_MIN, 2**31 - 1, 7, -7], np.int32)
    a[:len(edges)] = edges
    b[:len(edges)] = [0, 0, 0, -1, 0, -1, 2]
    b[10:14] = 0
    a[20:27] = INT_MIN
    b[20:27] = edges
    return a, b


def _arr(x, dt, device="cpu"):
    return cnp.Array(torch.from_numpy(x.copy()).to(device), dt)


def _np(a):
    return a.t.cpu().numpy()


def _jnp(x, dt):
    import jax.numpy as jnp
    return jnp.asarray(x.view(np.uint32) if dt == "uint32" else x)


def _words(x):
    return np.asarray(x).view(np.int32) if np.asarray(x).dtype in (
        np.uint32, np.int32) else np.asarray(x)


# The compiler lowers a signed ``/`` through lax.div, so jnp's signed
# ``//`` has no counterpart.
@pytest.mark.parametrize("op,dt", [("div", "int32"), ("rem", "int32"),
                                   ("%", "int32"), ("div", "uint32"),
                                   ("rem", "uint32"), ("//", "uint32"),
                                   ("%", "uint32")])
def test_division_gives_xla_values(op, dt):
    import jax
    a, b = _pairs(1)
    dtype = cnp.int32 if dt == "int32" else cnp.uint32
    x, y = _arr(a, dtype), _arr(b, dtype)
    ja, jb = _jnp(a, dt), _jnp(b, dt)
    got = {"div": cnp.div, "rem": cnp.rem, "//": lambda p, q: p // q,
           "%": lambda p, q: p % q}[op](x, y)
    want = jax.jit({"div": jax.lax.div, "rem": jax.lax.rem,
                    "//": lambda p, q: p // q,
                    "%": lambda p, q: p % q}[op])(ja, jb)
    assert got.dtype is dtype
    np.testing.assert_array_equal(_np(got), _words(want))


@pytest.mark.parametrize("dt", ["int32", "uint32"])
@pytest.mark.parametrize("op", ["<<", ">>"])
def test_shifts_give_xla_values(op, dt):
    import jax
    a, _ = _pairs(2)
    counts = np.arange(-3, 61, dtype=np.int32)
    dtype = cnp.int32 if dt == "int32" else cnp.uint32
    x, s = _arr(a, dtype), _arr(counts, dtype)
    ja, js = _jnp(a, dt), _jnp(counts, dt)
    got = (x << s) if op == "<<" else (x >> s)
    want = jax.jit(lambda p, q: (p << q) if op == "<<" else (p >> q))(ja, js)
    np.testing.assert_array_equal(_np(got), _words(want))


def test_promotion_and_unsigned_compares():
    import jax.numpy as jnp
    a, b = _pairs(3)
    u, i = _arr(a, cnp.uint32), _arr(b, cnp.int32)
    ju, ji = jnp.asarray(a.view(np.uint32)), jnp.asarray(b)
    for got, want in (((u + i), (ju + ji)), ((u < i), (ju < ji)),
                      ((u < u), (ju < ju)), ((u + 5), (ju + 5)),
                      ((i >> u), (ji >> ju)), ((u * u), (ju * ju)),
                      (cnp.clip(u, 3, cnp.uint32(2**31)),
                       jnp.clip(ju, 3, jnp.uint32(2**31))),
                      (cnp.where(u > i, u, i), jnp.where(ju > ji, ju, ji))):
        assert got.dtype.name == str(want.dtype)
        np.testing.assert_array_equal(_np(got), _words(want))


def test_traced_indexing_wraps_once_clamps_and_drops():
    import jax
    import jax.numpy as jnp
    base = np.arange(20, dtype=np.int32).reshape(4, 5)
    for i, j in [(-1, -1), (-5, 2), (-6, 9), (4, 0), (2, 3), (9, -9)]:
        got = _arr(base, cnp.int32)[cnp.int32(i), cnp.int32(j)]
        want = jax.jit(lambda m, p, q: m[p, q])(jnp.asarray(base),
                                                jnp.int32(i), jnp.int32(j))
        assert int(_np(got)) == int(want), (i, j)
        got = _arr(base, cnp.int32).at[cnp.int32(i), cnp.int32(j)].set(
            cnp.int32(-7))
        want = jax.jit(lambda m, p, q: m.at[p, q].set(-7))(
            jnp.asarray(base), jnp.int32(i), jnp.int32(j))
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    flat = np.zeros(8, np.uint32)
    got = _arr(flat.view(np.int32), cnp.uint32).at[
        cnp.int32(5) + cnp.arange(6)].set(cnp.uint32(9))
    want = jnp.asarray(flat).at[5 + jnp.arange(6)].set(9, mode="drop")
    np.testing.assert_array_equal(_np(got), _words(want))


@pytest.mark.cuda
def test_the_card_gives_the_cpus_values():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    a, b = _pairs(4)
    for dt in (cnp.int32, cnp.uint32):
        for f in (cnp.div, cnp.rem, lambda p, q: p % q,
                  lambda p, q: p << q, lambda p, q: p >> q):
            want = _np(f(_arr(a, dt), _arr(b, dt)))
            got = _np(f(_arr(a, dt, "cuda"), _arr(b, dt, "cuda")))
            np.testing.assert_array_equal(got, want)
