"""A data-dependent ``loops.while_loop`` nested in a ``loops.scan`` body
(``frontend/loops.LoopOp``) against the reference's ``lax.while_loop``
inside ``lax.scan``: Euclid's gcd of each pair of two seeded uint32 word
arrays (zeros among them), lifted by both packages' ``lift_fn``.  Equal:
leaf names and kinds, ``arg_leaves``, the output words, and TMR and DWC
campaigns of 256 rows at seed 3 (codes, errors, corrected, counts)."""

import numpy as np
import pytest
import torch

from coast_tpu_torch import DWC, TMR
from coast_tpu_torch.frontend import lift_fn, loops
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.ops import u32

torch.set_num_threads(1)


def _data():
    rng = np.random.default_rng(11)
    k = rng.integers(1, 1 << 8, 16)
    a = (k * rng.integers(1, 1 << 20, 16)).astype(np.uint32)
    b = (k * rng.integers(1, 1 << 20, 16)).astype(np.uint32)
    a[3], b[7] = 0, 0
    return a, b


def _urem(x, y):
    """``lax.rem`` of uint32 words (``x rem 0`` is ``x``)."""
    xs, ys = u32.wide(x), u32.wide(y)
    r = torch.remainder(xs, torch.where(ys == 0, 1, ys))
    return u32.word(torch.where(ys == 0, xs, r))


def port_fn(a, b):
    def sbody(acc, ab):
        g, _ = loops.while_loop(lambda c: c[1] != 0,
                                lambda c: (c[1], _urem(c[0], c[1])), ab)
        return acc ^ g, g
    return loops.scan(sbody, torch.zeros((), dtype=torch.int32), (a, b))


def ref_fn(a, b):
    import jax
    import jax.numpy as jnp

    def sbody(acc, ab):
        g, _ = jax.lax.while_loop(lambda c: c[1] != 0,
                                  lambda c: (c[1], jax.lax.rem(c[0], c[1])),
                                  ab)
        return acc ^ g, g
    return jax.lax.scan(sbody, jnp.uint32(0), (a, b))


_LIFTED = {}


def lifted():
    if not _LIFTED:
        import jax.numpy as jnp
        from coast_tpu.frontend import lift_fn as jlift_fn
        a, b = _data()
        _LIFTED["ref"] = jlift_fn("gcdn", ref_fn, jnp.asarray(a),
                                  jnp.asarray(b))
        _LIFTED["port"] = lift_fn("gcdn", port_fn, a, b, device="cpu")
    return _LIFTED["ref"], _LIFTED["port"]


def test_leaves_and_output_equal_the_reference():
    import math
    ref, port = lifted()
    assert {k: s.kind for k, s in port.spec.items()} == \
        {k: s.kind for k, s in ref.spec.items()}
    assert port.meta["arg_leaves"] == ref.meta["arg_leaves"]
    st = port.run_unprotected("cpu")
    got = port.output({k: v.unsqueeze(0) for k, v in st.items()})[0]
    want = np.asarray(ref.output(ref.run_unprotected())).view(np.uint32)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    a, b = _data()
    gs = [math.gcd(int(x), int(y)) for x, y in zip(a, b)]
    assert list(want[-16:]) == gs


def test_the_body_holds_one_loop_operation():
    """The while is one loop operation of the body, run once a trip."""
    _, port = lifted()
    seen = []
    orig = loops.LoopOp.run_rows

    def spy(self, *a, **k):
        seen.append(self)
        return orig(self, *a, **k)

    loops.LoopOp.run_rows = spy
    try:
        port.run_unprotected("cpu")
    finally:
        loops.LoopOp.run_rows = orig
    assert len(seen) == 16 and len({id(op) for op in seen}) == 1


@pytest.mark.parametrize("strategy", ["TMR", "DWC"])
def test_campaign_equals_the_reference(strategy):
    from coast_tpu import DWC as JDWC, TMR as JTMR
    from coast_tpu.inject.campaign import CampaignRunner as JRunner
    ref, port = lifted()
    jstrat, strat = {"TMR": (JTMR, TMR), "DWC": (JDWC, DWC)}[strategy]
    a = JRunner(jstrat(ref)).run(256, seed=3, batch_size=256)
    b = CampaignRunner(strat(port, device="cpu")).run(256, seed=3,
                                                      batch_size=256)
    np.testing.assert_array_equal(b.codes, a.codes)
    np.testing.assert_array_equal(b.errors, a.errors)
    np.testing.assert_array_equal(b.corrected, a.corrected)
    assert b.counts == a.counts
