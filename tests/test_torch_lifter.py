"""The port's region lifters (``coast_tpu_torch/frontend``), held against
the reference's (``coast_tpu/frontend/lifter.py``) case by case: every
case of ``tests/test_lifter.py``.

Each whole function is written twice, with ``jax.lax`` and with the
port's ``frontend.loops``, over the same numpy inputs, and both are
lifted.  The lifted regions must have equal leaf names, kinds,
``nominal_steps``, ``max_steps``, ``meta["arg_leaves"]`` and output words;
their 128-row TMR campaigns at one seed equal codes, errors and steps.
uint32 words are int32 tensors in the port, so the torch twins use
unsigned helpers where a flipped sign bit would change the result
(remainder, sort).  Every program here is integer: equality is bit for
bit.  Everything runs on the CPU (``device="cpu"``).
"""

import numpy as np
import pytest
import torch

from coast_tpu_torch import (DWC, TMR, KIND_CTRL, KIND_MEM, KIND_REG, KIND_RO,
                             LeafSpec, ProtectionConfig, protect)
from coast_tpu_torch.frontend import LiftError, lift_c, lift_fn, lift_step
from coast_tpu_torch.frontend import loops
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.models import REGISTRY
from coast_tpu_torch.ops.indexing import row_select, row_update

torch.set_num_threads(1)

I32 = torch.int32


def t32(a) -> torch.Tensor:
    """numpy uint32 words as an int32 tensor."""
    return torch.from_numpy(np.array(np.asarray(a, np.uint32).view(np.int32)))


def urem(x, y):
    """``lax.rem`` of uint32 words (XLA: ``x % 0 == x``)."""
    xs = x.to(torch.int64) & 0xFFFFFFFF
    ys = y.to(torch.int64) & 0xFFFFFFFF
    r = torch.remainder(xs, torch.where(ys == 0, 1, ys))
    return torch.where(ys == 0, xs, r).to(I32)


def usort(x):
    """``jnp.sort`` of uint32 words."""
    return torch.sort(x ^ -2**31).values ^ -2**31


# ---------------------------------------------------------------------------
# the functions, twice
# ---------------------------------------------------------------------------

def _jax_fns():
    import jax
    import jax.numpy as jnp

    def fnv(data, key):
        def body(acc, x):
            acc = (acc ^ x) * jnp.uint32(16777619) + key
            return acc, acc
        final, trace = jax.lax.scan(body, jnp.uint32(2166136261), data)
        return final ^ jnp.uint32(0xFFFFFFFF), trace[-1]

    def gcd(a, b):
        def cond(c):
            return c[1] != 0

        def body(c):
            x, y = c
            return (y, jax.lax.rem(x, y))
        g, _ = jax.lax.while_loop(cond, body, (a, b))
        return g

    def two_phase(data, key):
        scale = key * jnp.uint32(3)

        def body1(acc, x):
            acc = acc + x
            return acc, acc
        tot, prefix = jax.lax.scan(body1, jnp.uint32(0), data * scale)
        shifted = prefix + tot

        def body2(acc, x):
            acc = acc ^ x
            return acc, acc * jnp.uint32(2)
        h, doubled = jax.lax.scan(body2, key, shifted)
        return h + scale, doubled

    def mid_crossing(data, key):
        scale = key + jnp.uint32(7)

        def body1(acc, x):
            acc = acc + x
            return acc, acc
        tot, _ = jax.lax.scan(body1, jnp.uint32(0), data)
        mid = tot ^ scale

        def body2(acc, x):
            return acc + x * mid, acc
        h, trace = jax.lax.scan(body2, jnp.uint32(1), data)
        return h + mid, trace

    def gcd_scan(a, b, data):
        def cond(c):
            return c[1] != 0

        def body(c):
            x, y = c
            return (y, jax.lax.rem(x, y))
        g, _ = jax.lax.while_loop(cond, body, (a, b))

        def sbody(acc, x):
            return acc + x * g, acc
        tot, trace = jax.lax.scan(sbody, jnp.uint32(0), data)
        return tot, trace

    def sorty(data):
        def body(acc, x):
            return acc + x, acc
        tot, trace = jax.lax.scan(body, jnp.uint32(0), data)
        return jnp.sort(trace) + tot

    def suffix_sums(data):
        def body(acc, x):
            acc = acc + x
            return acc, acc
        tot, sums = jax.lax.scan(body, jnp.uint32(0), data, reverse=True)
        return tot, sums

    def zero_trip(data, empty):
        def body(acc, x):
            return acc + x, acc
        tot, _ = jax.lax.scan(body, jnp.uint32(0), data)

        def body2(acc, x):
            return acc ^ x, acc
        h, _ = jax.lax.scan(body2, tot, empty)

        def body3(acc, x):
            return acc + 2 * x, acc
        g, _ = jax.lax.scan(body3, h, data)
        return g

    return dict(fnv=fnv, gcd=gcd, two_phase=two_phase,
                mid_crossing=mid_crossing, gcd_scan=gcd_scan, sorty=sorty,
                suffix_sums=suffix_sums, zero_trip=zero_trip)


def fnv(data, key):
    def body(acc, x):
        acc = (acc ^ x) * 16777619 + key
        return acc, acc
    final, trace = loops.scan(body, torch.tensor(-2128831035, dtype=I32),
                              data)
    return final ^ -1, trace[-1]


def gcd(a, b):
    def cond(c):
        return c[1] != 0

    def body(c):
        x, y = c
        return (y, urem(x, y))
    g, _ = loops.while_loop(cond, body, (a, b))
    return g


def two_phase(data, key):
    scale = key * 3

    def body1(acc, x):
        acc = acc + x
        return acc, acc
    tot, prefix = loops.scan(body1, torch.tensor(0, dtype=I32), data * scale)
    shifted = prefix + tot

    def body2(acc, x):
        acc = acc ^ x
        return acc, acc * 2
    h, doubled = loops.scan(body2, key, shifted)
    return h + scale, doubled


def mid_crossing(data, key):
    scale = key + 7

    def body1(acc, x):
        acc = acc + x
        return acc, acc
    tot, _ = loops.scan(body1, torch.tensor(0, dtype=I32), data)
    mid = tot ^ scale

    def body2(acc, x):
        return acc + x * mid, acc
    h, trace = loops.scan(body2, torch.tensor(1, dtype=I32), data)
    return h + mid, trace


def gcd_scan(a, b, data):
    def cond(c):
        return c[1] != 0

    def body(c):
        x, y = c
        return (y, urem(x, y))
    g, _ = loops.while_loop(cond, body, (a, b))

    def sbody(acc, x):
        return acc + x * g, acc
    tot, trace = loops.scan(sbody, torch.tensor(0, dtype=I32), data)
    return tot, trace


def sorty(data):
    def body(acc, x):
        return acc + x, acc
    tot, trace = loops.scan(body, torch.tensor(0, dtype=I32), data)
    return usort(trace) + tot


def suffix_sums(data):
    def body(acc, x):
        acc = acc + x
        return acc, acc
    return loops.scan(body, torch.tensor(0, dtype=I32), data, reverse=True)


def zero_trip(data, empty):
    def body(acc, x):
        return acc + x, acc
    tot, _ = loops.scan(body, torch.tensor(0, dtype=I32), data)

    def body2(acc, x):
        return acc ^ x, acc
    h, _ = loops.scan(body2, tot, empty)

    def body3(acc, x):
        return acc + 2 * x, acc
    g, _ = loops.scan(body3, h, data)
    return g


TORCH = dict(fnv=fnv, gcd=gcd, two_phase=two_phase,
             mid_crossing=mid_crossing, gcd_scan=gcd_scan, sorty=sorty,
             suffix_sums=suffix_sums, zero_trip=zero_trip)


def _fnv_data():
    return (np.arange(64, dtype=np.uint32) * np.uint32(2654435761)) \
        & np.uint32(0xFFFF)


def _mp_data():
    return (np.arange(12, dtype=np.uint32) * np.uint32(2654435761)) \
        & np.uint32(0x3FF)


U = np.uint32
ARGS = {
    "fnv": lambda: (_fnv_data(), U(17)),
    "gcd": lambda: (U(462), U(1071)),
    "two_phase": lambda: (_mp_data(), U(5)),
    "mid_crossing": lambda: (_mp_data(), U(9)),
    "gcd_scan": lambda: (U(462), U(1071), _mp_data()),
    "sorty": lambda: (_mp_data(),),
    "suffix_sums": lambda: (_mp_data(),),
    "zero_trip": lambda: (_mp_data(), np.zeros((0,), np.uint32)),
}
CASES = sorted(ARGS)


def _ref_lift(case):
    import jax.numpy as jnp
    from coast_tpu.frontend import lift_fn as jlift_fn
    args = [jnp.asarray(a) for a in ARGS[case]()]
    return jlift_fn(case, _jax_fns()[case], *args)


def _port_lift(case):
    return lift_fn(case, TORCH[case], *ARGS[case](), device="cpu")


_CACHE = {}


def lifted(case):
    if case not in _CACHE:
        _CACHE[case] = (_ref_lift(case), _port_lift(case))
    return _CACHE[case]


def layout(region, image):
    return ({k: v.kind for k, v in region.spec.items()},
            region.nominal_steps, region.max_steps,
            dict(region.meta.get("arg_leaves", {})),
            {k: tuple(v.shape) for k, v in image.items()},
            region.meta.get("stepped_epilogue"), region.meta.get("phases"),
            region.meta.get("loops", region.meta.get("loop")))


def port_words(region):
    st = region.run_unprotected("cpu")
    out = region.output({k: v.unsqueeze(0) for k, v in st.items()})[0]
    return out.numpy().view(np.uint32)


def ref_words(region):
    return np.asarray(region.output(region.run_unprotected())).view(np.uint32)


# ---------------------------------------------------------------------------
# lift_fn parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_lift_fn_layout_equals_the_reference(case):
    ref, port = lifted(case)
    assert list(port.spec) == list(ref.spec)
    assert layout(port, port.init("cpu")) == layout(ref, ref.init())


@pytest.mark.parametrize("case", CASES)
def test_lift_fn_output_equals_the_reference_and_eager(case):
    import jax
    ref, port = lifted(case)
    want = np.concatenate([np.asarray(o).reshape(-1).view(np.uint32)
                           for o in jax.tree.leaves(
                               jax.jit(_jax_fns()[case])(
                                   *ARGS[case]()))])
    np.testing.assert_array_equal(ref_words(ref), want)
    np.testing.assert_array_equal(port_words(port), want)
    eager = TORCH[case](*[t32(a) for a in ARGS[case]()])
    got = np.concatenate([o.reshape(-1).numpy().view(np.uint32)
                          for o in loops.flatten(eager)[0]])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_lift_fn_tmr_campaign_equals_the_reference(case):
    from coast_tpu import TMR as JTMR
    from coast_tpu.inject.campaign import CampaignRunner as JRunner
    ref, port = lifted(case)
    a = JRunner(JTMR(ref)).run(128, seed=5, batch_size=128)
    b = CampaignRunner(TMR(port, device="cpu")).run(128, seed=5,
                                                    batch_size=128)
    np.testing.assert_array_equal(a.codes, b.codes)
    np.testing.assert_array_equal(a.errors, b.errors)
    np.testing.assert_array_equal(a.steps, b.steps)
    assert a.counts == b.counts


def test_lift_fn_scan_protection():
    _, r = lifted("fnv")
    tmr = TMR(r, device="cpu")
    assert int(tmr.run(None)["errors"]) == 0
    flip = {"leaf_id": tmr.leaf_order.index("c0"), "lane": 2, "word": 0,
            "bit": 9, "t": 11}
    assert int(tmr.run(flip)["errors"]) == 0
    up = protect(r, ProtectionConfig(num_clones=1), device="cpu")
    assert int(up.run({**flip, "lane": 0})["errors"]) > 0


def test_lift_fn_while():
    _, r = lifted("gcd")
    assert {k: v.kind for k, v in r.spec.items()} == {"c0": KIND_REG,
                                                      "c1": KIND_CTRL}
    rec = TMR(r, device="cpu").run(None)
    assert int(rec["errors"]) == 0 and bool(rec["done"])
    assert int(port_words(r)[0]) == 21


def test_lift_fn_two_phase_protection():
    _, r = lifted("two_phase")
    tmr = TMR(r, device="cpu")
    assert int(tmr.run(None)["errors"]) == 0
    flip = {"leaf_id": tmr.leaf_order.index("p1_c0"), "lane": 1, "word": 0,
            "bit": 3, "t": 15}
    rec = tmr.run(flip)
    assert int(rec["errors"]) == 0 and int(rec["corrected"]) > 0
    up = protect(r, ProtectionConfig(num_clones=1), device="cpu")
    assert int(up.run({**flip, "lane": 0})["errors"]) > 0


def test_lift_fn_multi_phase_graph_and_cfcss():
    _, r = lifted("two_phase")
    assert r.graph.names == ["entry", "loop0", "inter0", "loop1", "inter1",
                             "exit"]
    prog = protect(r, ProtectionConfig(num_clones=3, cfcss=True),
                   device="cpu")
    rec = prog.run(None)
    assert int(rec["errors"]) == 0 and not bool(rec["cfc_fault"])


def test_lift_fn_g_leaf_injectable():
    _, r = lifted("two_phase")
    tmr = TMR(r, device="cpu")
    flip = {"leaf_id": tmr.leaf_order.index("g0"), "lane": 0, "word": 0,
            "bit": 1, "t": 2}
    assert int(tmr.run(flip)["errors"]) > 0


def test_lift_fn_heavy_epilogue_is_stepped():
    from coast_tpu_torch import unprotected
    _, r = lifted("sorty")
    assert r.meta.get("stepped_epilogue") is True
    st = r.init("cpu")
    assert "_outbuf" in st and "_phase" in st
    up = unprotected(r, device="cpu")
    fault = {"leaf_id": up.leaf_order.index("c0"), "lane": 0, "word": 0,
             "bit": 7, "t": 2}
    assert int(up.run(fault)["errors"]) > 0
    assert int(TMR(r, device="cpu").run(fault)["errors"]) == 0


def test_lift_fn_dwc_and_campaign_classes():
    _, r = lifted("two_phase")
    res = CampaignRunner(TMR(r, device="cpu")).run(128, seed=5,
                                                   batch_size=128)
    fired = {k: v for k, v in res.counts.items() if k != "cache_invalid"}
    assert sum(fired.values()) == 128
    assert res.counts["success"] + res.counts["corrected"] \
        > res.counts["sdc"]
    rec = DWC(r, device="cpu").run(None)
    assert int(rec["errors"]) == 0 and not bool(rec["dwc_fault"])


def test_loops_run_eagerly_outside_a_lift():
    """Outside a lift the combinators are jax.lax's semantics: stacked
    outputs in iteration order, a reverse scan included."""
    data = t32(_mp_data())
    tot, sums = suffix_sums(data)
    want = np.cumsum(_mp_data()[::-1])[::-1].astype(np.uint32)
    np.testing.assert_array_equal(sums.numpy().view(np.uint32), want)
    assert int(tot) == int(want[0])
    assert int(gcd(torch.tensor(462, dtype=I32),
                   torch.tensor(1071, dtype=I32))) == 21


def test_lift_fn_data_dependent_index_in_the_body():
    """A body that indexes a capture with a carry: the replay runs it per
    row, and the counter and the index carry derive as ``ctrl``."""
    table = t32((np.arange(16, dtype=np.uint32) * U(40503)) & U(0xFFF))

    def walk(table, start):
        def body(c, _):
            i, acc = c
            v = table[i]
            return ((v & 15), acc + v), v
        (i, acc), trace = loops.scan(body, (start, torch.tensor(0, dtype=I32)),
                                     None, length=20)
        return acc, trace
    r = lift_fn("walk", walk, table, U(3), device="cpu")
    kinds = {k: v.kind for k, v in r.spec.items()}
    assert kinds["c0"] == KIND_CTRL and kinds["c1"] == KIND_REG
    assert kinds["k0"] == KIND_RO and kinds["y0"] == KIND_MEM
    acc, trace = walk(table, torch.tensor(3, dtype=I32))
    want = np.concatenate([acc.reshape(-1).numpy(), trace.numpy()])
    np.testing.assert_array_equal(port_words(r).view(np.int32), want)
    res = CampaignRunner(TMR(r, device="cpu")).run(96, seed=2, batch_size=96)
    assert sum(res.counts.values()) == 96


# ---------------------------------------------------------------------------
# lift_step
# ---------------------------------------------------------------------------

_N = 16


def _jax_user_region():
    import jax
    import jax.numpy as jnp
    from coast_tpu.frontend import lift_step as jlift_step

    def init():
        return {"data": jnp.arange(_N, dtype=jnp.uint32) * 7 + 3,
                "out": jnp.zeros(_N, jnp.uint32),
                "i": jnp.int32(0),
                "acc": jnp.uint32(0)}

    def step(s, t):
        x = jax.lax.dynamic_index_in_dim(s["data"], s["i"], keepdims=False)
        acc = s["acc"] + x * x
        out = jax.lax.dynamic_update_index_in_dim(s["out"], acc, s["i"],
                                                  axis=0)
        return {"data": s["data"], "out": out, "i": s["i"] + 1, "acc": acc}

    return jlift_step("sumsq", step, init, done=lambda s: s["i"] >= _N)


def _user_region():
    def init(dev):
        return {"data": torch.arange(_N, dtype=I32, device=dev) * 7 + 3,
                "out": torch.zeros(_N, dtype=I32, device=dev),
                "i": torch.zeros((), dtype=I32, device=dev),
                "acc": torch.zeros((), dtype=I32, device=dev)}

    def step(s, t):
        x = row_select(s["data"], s["i"])
        acc = s["acc"] + x * x
        out = row_update(s["out"], acc, s["i"])
        return {"out": out, "i": s["i"] + 1, "acc": acc}

    return lift_step("sumsq", step, init, done=lambda s: s["i"] >= _N,
                     device="cpu")


def test_lift_new_function_classification():
    r = _user_region()
    ref = _jax_user_region()
    kinds = {k: v.kind for k, v in r.spec.items()}
    assert kinds == {"data": KIND_RO, "out": KIND_MEM, "i": KIND_CTRL,
                     "acc": KIND_REG}
    assert kinds == {k: v.kind for k, v in ref.spec.items()}
    assert (r.nominal_steps, r.max_steps) == (ref.nominal_steps,
                                              ref.max_steps) == (16, 48)
    assert r.meta["lifted"]


def test_lift_new_function_campaign_equals_the_reference():
    from coast_tpu import DWC as JDWC, TMR as JTMR
    from coast_tpu.inject.campaign import CampaignRunner as JRunner
    r, ref = _user_region(), _jax_user_region()
    for jmake, make in ((JTMR, TMR), (JDWC, DWC)):
        a = JRunner(jmake(ref)).run(128, seed=4, batch_size=128)
        b = CampaignRunner(make(r, device="cpu")).run(128, seed=4,
                                                      batch_size=128)
        np.testing.assert_array_equal(a.codes, b.codes)
        np.testing.assert_array_equal(a.errors, b.errors)
        np.testing.assert_array_equal(a.steps, b.steps)


def test_lift_new_function_protection_works():
    r = _user_region()
    tmr = TMR(r, device="cpu")
    rec = tmr.run(None)
    assert int(rec["errors"]) == 0 and bool(rec["done"])
    flip = {"leaf_id": tmr.leaf_order.index("acc"), "lane": 1, "word": 0,
            "bit": 5, "t": 3}
    rec = tmr.run(flip)
    assert int(rec["errors"]) == 0 and int(rec["corrected"]) > 0
    up = protect(r, ProtectionConfig(num_clones=1), device="cpu")
    assert int(up.run({**flip, "lane": 0})["errors"]) > 0
    rec = DWC(r, device="cpu").run({**flip, "lane": 0})
    assert bool(rec["dwc_fault"]) or int(rec["errors"]) == 0


def test_lifted_region_supports_cfcss():
    r = _user_region()
    prog = protect(r, ProtectionConfig(num_clones=3, cfcss=True),
                   device="cpu")
    rec = prog.run(None)
    assert int(rec["errors"]) == 0 and not bool(rec["cfc_fault"])
    res = CampaignRunner(prog).run(96, seed=1, batch_size=96)
    assert sum(res.counts.values()) == 96


_REDERIVE = [("matrixMultiply", ("first", "second")),
             ("crc16", ("msg",)), ("quicksort", ("array",))]


@pytest.mark.parametrize("model,annos", _REDERIVE,
                         ids=[m for m, _ in _REDERIVE])
def test_rederived_spec_kinds_match_hand_spec(model, annos):
    hand = REGISTRY[model]()
    lifted_r = lift_step(
        hand.name + "_lifted", hand.step, hand.init, done=hand.done,
        check=hand.check, output=hand.output, max_steps=hand.max_steps,
        annotations={a: LeafSpec(KIND_MEM) for a in annos},
        default_xmr=hand.default_xmr, device="cpu")
    assert lifted_r.nominal_steps == hand.nominal_steps
    assert {k: lifted_r.spec[k].kind for k in hand.spec} \
        == {k: v.kind for k, v in hand.spec.items()}


# ---------------------------------------------------------------------------
# refusals: the reference's messages
# ---------------------------------------------------------------------------

def _messages(jcall, tcall):
    from coast_tpu.frontend import LiftError as JLiftError
    with pytest.raises(JLiftError) as want:
        jcall()
    with pytest.raises(LiftError) as got:
        tcall()
    return str(want.value), str(got.value)


def test_lift_fn_requires_a_loop():
    import jax.numpy as jnp
    from coast_tpu.frontend import lift_fn as jlift_fn
    want, got = _messages(
        lambda: jlift_fn("flat", lambda x: x * 2 + 1, jnp.uint32(3)),
        lambda: lift_fn("flat", lambda x: x * 2 + 1, U(3), device="cpu"))
    assert got == want.replace("lax.scan/lax.while_loop",
                               "loops.scan/loops.while_loop").replace(
        "with lax.scan/while_loop", "with loops.scan/while_loop")
    assert "no top-level loops.scan" in got


def _scalar_read_cases(np_mod, scan):
    """Functions that read a loop value as a Python one: a slice bound and
    a shift count in the body, a branch in the body and in the epilogue.
    ``np_mod``/``scan`` make the torch or the JAX twin."""
    def sliced(x):
        def body(i, _):
            return i + 1, x[i:i + 2].sum()
        return scan(body, np_mod.int32(0), None, length=4)

    def rolled(x):
        def body(i, _):
            return i + 1, np_mod.roll(x, int(i))[0]
        return scan(body, np_mod.int32(0), None, length=4)

    def branch(x):
        def body(c, v):
            return (c + v if c > 3 else c - v), c
        return scan(body, np_mod.int32(0), x)

    def branch_after(x):
        def body(c, v):
            return c + v, c
        c, ys = scan(body, np_mod.int32(0), x)
        return ys if c > 3 else ys + 1
    return {"slice": sliced, "roll": rolled, "branch": branch,
            "branch_after": branch_after}


@pytest.mark.parametrize("case", ["slice", "roll", "branch",
                                  "branch_after"])
def test_lift_fn_refuses_a_tensor_read_as_a_python_value(case):
    """A loop value used as a Python int or bool would bake the lift-time
    run's value into every step and row: the port refuses it, as the
    reference's trace does."""
    import jax.numpy as jnp
    from jax import lax

    from coast_tpu.frontend import lift_fn as jlift_fn

    class _T:
        @staticmethod
        def int32(v):
            return torch.tensor(v, dtype=I32)
        roll = staticmethod(torch.roll)
    x = np.arange(8, dtype=np.uint32)
    with pytest.raises(Exception):
        jlift_fn(case, _scalar_read_cases(jnp, lax.scan)[case],
                 jnp.asarray(x))
    with pytest.raises(LiftError) as got:
        lift_fn(case, _scalar_read_cases(_T, loops.scan)[case], t32(x),
                device="cpu")
    assert "read as a Python value" in str(got.value)


def test_lift_step_rejects_non_32bit_state():
    import jax.numpy as jnp
    from coast_tpu.frontend import lift_step as jlift_step
    want, got = _messages(
        lambda: jlift_step(
            "bad", lambda s, t: {"x": s["x"] + 1, "i": s["i"] + 1},
            lambda: {"x": jnp.zeros(4, jnp.uint8), "i": jnp.int32(0)},
            done=lambda s: s["i"] >= 4),
        lambda: lift_step(
            "bad", lambda s, t: {"x": s["x"] + 1, "i": s["i"] + 1},
            lambda dev: {"x": torch.zeros(4, dtype=torch.uint8),
                         "i": torch.zeros((), dtype=I32)},
            done=lambda s: s["i"] >= 4, device="cpu"))
    assert got == want and "32-bit" in got


def test_lift_step_rejects_unknown_annotation():
    import jax.numpy as jnp
    from coast_tpu.frontend import lift_step as jlift_step
    from coast_tpu.ir.region import LeafSpec as JLeafSpec
    want, got = _messages(
        lambda: jlift_step("bad", lambda s, t: {"i": s["i"] + 1},
                           lambda: {"i": jnp.int32(0)},
                           done=lambda s: s["i"] >= 4,
                           annotations={"nope": JLeafSpec("mem")}),
        lambda: lift_step("bad", lambda s, t: {"i": s["i"] + 1},
                          lambda dev: {"i": torch.zeros((), dtype=I32)},
                          done=lambda s: s["i"] >= 4,
                          annotations={"nope": LeafSpec(KIND_MEM)},
                          device="cpu"))
    assert got == want and "unknown leaf" in got


def test_lift_step_rejects_nontermination():
    import jax.numpy as jnp
    from coast_tpu.frontend import lift_step as jlift_step
    want, got = _messages(
        lambda: jlift_step("hang", lambda s, t: {"i": s["i"]},
                           lambda: {"i": jnp.int32(0)},
                           done=lambda s: s["i"] >= 4, step_cap=1 << 10),
        lambda: lift_step("hang", lambda s, t: {"i": s["i"]},
                          lambda dev: {"i": torch.zeros((), dtype=I32)},
                          done=lambda s: s["i"] >= 4, step_cap=1 << 10,
                          device="cpu"))
    assert got == want and "did not terminate" in got


def test_lift_c_refuses_naming_its_item(tmp_path):
    """A ``.c`` program the reference refuses, the port refuses alike: a
    missing file (FileNotFoundError naming it) and a construct outside
    the restricted-C subset (the same CLiftError and message)."""
    pytest.importorskip("pycparser")
    from coast_tpu.frontend import lift_c as jlift_c
    from coast_tpu.models import resolve_region as jresolve_region
    from coast_tpu_torch.models import resolve_region
    with pytest.raises(FileNotFoundError) as want:
        jresolve_region("prog.c")
    with pytest.raises(FileNotFoundError) as got:
        resolve_region("prog.c", device="cpu")
    assert str(got.value) == str(want.value) == "prog.c"
    src = tmp_path / "bad.c"
    src.write_text("int x;\nint main() {\nagain: x += 1;\n"
                   "    if (x < 10) goto again;\n    return 0;\n}\n")
    with pytest.raises(Exception) as want:
        jlift_c("bad", [str(src)])
    with pytest.raises(Exception) as got:
        lift_c("bad", [str(src)], device="cpu")
    assert type(got.value).__name__ == type(want.value).__name__ \
        == "CLiftError"
    assert str(got.value) == str(want.value)
    assert "backward goto" in str(got.value)


def test_frontend_all_is_the_reference():
    import coast_tpu.frontend as jfront
    import coast_tpu_torch.frontend as front
    assert front.__all__ == jfront.__all__


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda")


@pytest.mark.cuda
def test_loops_scan_lift_on_the_card(cuda):
    """A lifted scan runs its TMR build on the card through K1, and its
    records equal the CPU build's."""
    from coast_tpu_torch.ops import hopper_voters
    r = lift_fn("fnv", fnv, *ARGS["fnv"](), device="cuda")
    np.testing.assert_array_equal(port_words(r), ref_words_np("fnv"))
    before = hopper_voters.LAUNCHES
    a = CampaignRunner(TMR(r)).run(256, seed=5, batch_size=256)
    assert hopper_voters.LAUNCHES > before
    b = CampaignRunner(TMR(r, device="cpu")).run(256, seed=5,
                                                 batch_size=256)
    np.testing.assert_array_equal(a.codes, b.codes)
    np.testing.assert_array_equal(a.steps, b.steps)


def ref_words_np(case):
    """The eager torch result as u32 words."""
    eager = TORCH[case](*[t32(a) for a in ARGS[case]()])
    return np.concatenate([o.reshape(-1).numpy().view(np.uint32)
                           for o in loops.flatten(eager)[0]])
