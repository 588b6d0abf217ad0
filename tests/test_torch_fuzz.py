"""The port's fuzz tier (``coast_tpu_torch/testing/fuzz.py``) against the
reference's (``coast_tpu/testing/fuzz.py``), seeds 0-11.

The same seed builds the same program in both packages: ``random_region``
gives the reference's spec, steps and init words, and the same output
under every strategy; ``random_fn`` gives the reference's ``jax.jit(fn)``
result, bit for bit; and both packages' lifters give the same layout and
kinds for it (``lift_fn``) and for the random region (``lift_step``).
Every oracle of ``fuzz_one`` / ``fuzz_lifter_one`` passes, and the CLI
prints ``Success!``.  Everything runs on the CPU.
"""

import numpy as np
import pytest
import torch

from coast_tpu_torch.frontend import lift_fn, lift_step
from coast_tpu_torch.testing import fuzz

torch.set_num_threads(1)

SEEDS = list(range(12))

# seed -> {leaf: (kind the port's lift_step derives, why)} (ROADMAP Queue
# C).  Empty: with the reference's join of same-signature selects
# (``passes/verification._trip_flow(join_where=True)``), seed 7's ``r1``
# reaches the scatter's operand through a select that never reads it, as
# in the reference's shared ``_where`` sub-jaxpr, and derives ``mem``.
PINNED = {}


def _ref():
    from coast_tpu.testing import fuzz as jfuzz
    return jfuzz


def _words(x) -> np.ndarray:
    return np.asarray(x).reshape(-1).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_random_region_is_the_reference_program(seed):
    import jax
    from coast_tpu import unprotected as junprotected
    from coast_tpu_torch import unprotected
    want = _ref().random_region(seed)
    got = fuzz.random_region(seed)
    assert list(got.spec) == list(want.spec)
    assert {k: v.kind for k, v in got.spec.items()} \
        == {k: v.kind for k, v in want.spec.items()}
    assert (got.nominal_steps, got.max_steps) \
        == (want.nominal_steps, want.max_steps)
    jinit, init = want.init(), got.init("cpu")
    for k in want.spec:
        np.testing.assert_array_equal(_words(init[k].numpy()),
                                      _words(jinit[k]))
    ref_out = jax.jit(junprotected(want).run)()["output"]
    out = unprotected(got, device="cpu").run()["output"]
    np.testing.assert_array_equal(_words(out.numpy()), _words(ref_out))


@pytest.mark.parametrize("seed", SEEDS)
def test_random_fn_is_the_reference_function(seed):
    import jax
    jfn, jargs = _ref().random_fn(seed)
    fn, args = fuzz.random_fn(seed)
    assert [tuple(a.shape) for a in args] \
        == [tuple(np.shape(a)) for a in jargs]
    for a, ja in zip(args, jargs):
        np.testing.assert_array_equal(_words(a.numpy()), _words(ja))
    want = np.concatenate([_words(w) for w in jax.jit(jfn)(*jargs)])
    got = np.concatenate([_words(w.numpy()) for w in fn(*args)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_lifted_kinds_equal_the_reference(seed):
    from coast_tpu.frontend import lift_fn as jlift_fn
    from coast_tpu.frontend import lift_step as jlift_step
    jfn, jargs = _ref().random_fn(seed)
    fn, args = fuzz.random_fn(seed)
    want = jlift_fn(f"f{seed}", jfn, *jargs)
    got = lift_fn(f"f{seed}", fn, *args, device="cpu")
    assert {k: v.kind for k, v in got.spec.items()} \
        == {k: v.kind for k, v in want.spec.items()}
    assert list(got.spec) == list(want.spec)
    assert (got.nominal_steps, got.max_steps, got.meta["arg_leaves"]) \
        == (want.nominal_steps, want.max_steps, want.meta["arg_leaves"])
    assert got.meta.get("stepped_epilogue") \
        == want.meta.get("stepped_epilogue")
    jhand, hand = _ref().random_region(seed), fuzz.random_region(seed)
    want = jlift_step(f"s{seed}", jhand.step, jhand.init, done=jhand.done)
    got = lift_step(f"s{seed}", hand.step, hand.init, done=hand.done,
                    device="cpu")
    want_kinds = {k: v.kind for k, v in want.spec.items()}
    for leaf, (kind, _) in PINNED.get(seed, {}).items():
        assert got.spec[leaf].kind == kind != want_kinds[leaf]
        want_kinds[leaf] = kind
    assert {k: v.kind for k, v in got.spec.items()} == want_kinds
    assert (got.nominal_steps, got.max_steps) \
        == (want.nominal_steps, want.max_steps)


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_oracles_pass(seed):
    fuzz.fuzz_one(seed, device="cpu")
    fuzz.fuzz_lifter_one(seed, device="cpu")


def test_fuzz_deterministic():
    from coast_tpu_torch import unprotected
    r1, r2 = fuzz.random_region(42), fuzz.random_region(42)
    o1 = unprotected(r1, device="cpu").run()["output"]
    o2 = unprotected(r2, device="cpu").run()["output"]
    assert torch.equal(o1, o2)


def test_fuzz_cli_reports_success(capsys):
    assert fuzz.main(["-n", "2", "-seed", "3", "-d", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Success!" in out and "seed 4: ok" in out


def test_fuzz_cli_modes(capsys):
    assert fuzz.main(["-n", "1", "-seed", "9", "-mode", "lifter",
                      "-d", "cpu"]) == 0
    assert fuzz.main(["-n", "1", "-seed", "9", "-mode", "region",
                      "-d", "cpu"]) == 0
    assert capsys.readouterr().out.count("Success!") == 2
