"""Function scope and segmented scheduling of the port against the JAX
reference, on nestedCalls.

Against the reference in the same process: the region (init image,
declared dataflow against the reference's ``analyze()`` with the raw
functions bound, fault-free final state); the run records of the seven
scope classes under TMR and DWC over a seeded schedule, ``sync_count``
included (each call-boundary vote is one sync), and the fused engine
equal to the unfused one; the classes' fault behaviour (skip-lib as a
single point of failure, the DWC call-boundary latch); segmented (``-s``)
records equal the interleaved engine's and the reference's, and ``-s``
refuses the cross-lane classes with the reference's message; the
verification errors; the boundary transforms and ``coast_h``.
"""

import numpy as np
import pytest
import torch

import coast_tpu_torch as ct
from coast_tpu_torch.interface.config import ScopeConfig
from coast_tpu_torch.interop import state_to_numpy
from coast_tpu_torch.models import REGISTRY
from coast_tpu_torch.passes.verification import SoRViolation, analyze
from test_torch_cfcss import (assert_records_equal, jrecords, schedule_cols,
                              trecords)

torch.set_num_threads(1)

SCOPES = {
    "default": {},
    "ignoreFns": {"ignore_fns": ("fold",)},
    "skipLibCalls": {"skip_lib_calls": ("fold",)},
    "replicateFnCalls": {"replicate_fn_calls": ("fold",)},
    "protectedLibFn": {"protected_lib_fns": ("fold",)},
    "cloneAfterCall": {"clone_after_call_fns": ("fold",)},
    "cloneReturn": {"clone_return_fns": ("fold",)},
    "mixIgnoredFoldProtected": {"ignore_fns": ("mix",),
                                "protected_lib_fns": ("fold",)},
}


def _jregion(name="nestedCalls"):
    from coast_tpu.models import REGISTRY as JREGISTRY
    return JREGISTRY[name]()


def _programs(strategy, name="nestedCalls", **kw):
    import coast_tpu
    return (getattr(coast_tpu, strategy)(_jregion(name), **kw),
            getattr(ct, strategy)(REGISTRY[name](), device="cpu", **kw))


def _flip(prog, lane, leaf="acc", t=2, bit=4):
    cols = schedule_cols(prog, 0, 0, [(leaf, lane, 0, bit, t)])
    return {k: v[0] for k, v in trecords(prog, cols).items()}


def test_region_equals_reference():
    import jax
    from coast_tpu.passes.verification import analyze as janalyze
    region, jregion = REGISTRY["nestedCalls"](), _jregion()
    assert region.wants_fns() and sorted(region.functions) == sorted(
        jregion.functions)
    want, got = janalyze(jregion), analyze(region)
    assert (got.written, got.deps, got.load_addr, got.store_addr) == (
        want.written, want.deps, want.load_addr, want.store_addr)
    init = state_to_numpy(region.init("cpu"), region)
    for k, v in jregion.init().items():
        np.testing.assert_array_equal(init[k], np.asarray(v), err_msg=k)
        assert init[k].dtype == np.asarray(v).dtype, k
    final = state_to_numpy(region.run_unprotected("cpu"), region)
    for k, v in jax.jit(jregion.run_unprotected)().items():
        np.testing.assert_array_equal(final[k], np.asarray(v), err_msg=k)
    one = {k: v.unsqueeze(0) for k, v in region.run_unprotected(
        "cpu").items()}
    assert int(region.check(one)[0]) == 0


@pytest.mark.parametrize("strategy", ["TMR", "DWC"])
@pytest.mark.parametrize("scope", sorted(SCOPES))
def test_scope_records_equal_reference(scope, strategy):
    jprog, tprog = _programs(strategy, count_syncs=True, **SCOPES[scope])
    assert tprog.fn_scope == jprog.fn_scope
    assert tprog.leaf_order == jprog.leaf_order
    cols = schedule_cols(tprog, 128, 5, [("acc", lane, 0, bit, t)
                                         for lane in range(
                                             tprog.cfg.num_clones)
                                         for bit in (31, 4) for t in (2, 9)])
    got = trecords(tprog, cols)
    assert_records_equal(got, jrecords(jprog, cols), f"{scope} {strategy}")
    fused = getattr(ct, strategy)(REGISTRY["nestedCalls"](), device="cpu",
                                  count_syncs=True, fuse_step=True,
                                  **SCOPES[scope])
    assert fused.fuse_plan_info.frozen_leaves == frozenset(
        fused.region.spec)
    assert_records_equal(trecords(fused, cols), got, "fused")


def test_sync_counts_count_call_boundary_votes():
    """-ignoreFns adds one argument vote a call a step, -protectedLibFn an
    argument and a result vote; skip-lib and clone-after-call none."""
    def syncs(**kw):
        prog = ct.TMR(REGISTRY["nestedCalls"](), device="cpu",
                      count_syncs=True, **kw)
        return int(prog.run()["sync_count"])
    base, n = syncs(), REGISTRY["nestedCalls"]().nominal_steps
    assert syncs(**SCOPES["ignoreFns"]) == base + n
    assert syncs(**SCOPES["protectedLibFn"]) == base + 2 * n
    assert syncs(**SCOPES["skipLibCalls"]) == base
    assert syncs(**SCOPES["cloneAfterCall"]) == base


def test_skip_lib_is_a_single_point_of_failure():
    """A lane-0 fault reaches every lane through the single unsynced call:
    an SDC despite TMR, which the default replicated call masks."""
    prog = ct.TMR(REGISTRY["nestedCalls"](), device="cpu",
                  **SCOPES["skipLibCalls"])
    assert int(_flip(prog, lane=0)["errors"]) > 0
    assert int(_flip(ct.TMR(REGISTRY["nestedCalls"](), device="cpu"),
                     lane=0)["errors"]) == 0


def test_ignored_call_repairs_and_dwc_latches_at_the_boundary():
    prog = ct.TMR(REGISTRY["nestedCalls"](), device="cpu",
                  **SCOPES["ignoreFns"])
    rec = _flip(prog, lane=2)
    assert int(rec["errors"]) == 0 and int(rec["corrected"]) >= 1
    rec = _flip(ct.DWC(REGISTRY["nestedCalls"](), device="cpu",
                       **SCOPES["ignoreFns"]), lane=1)
    assert bool(rec["dwc_fault"])


@pytest.mark.parametrize("strategy", ["TMR", "DWC"])
@pytest.mark.parametrize("name,scope", [
    ("matrixMultiply", "default"), ("crc16", "default"),
    ("nestedCalls", "default"), ("nestedCalls", "cloneReturn"),
    ("nestedCalls", "replicateFnCalls")])
def test_segmented_equals_interleaved_and_reference(name, scope, strategy):
    kw = dict(count_syncs=True, **SCOPES[scope])
    jprog, seg = _programs(strategy, name, segmented=True, **kw)
    inter = getattr(ct, strategy)(REGISTRY[name](), device="cpu", **kw)
    cols = schedule_cols(seg, 96, 6)
    got = trecords(seg, cols)
    assert_records_equal(got, trecords(inter, cols), "segmented")
    assert_records_equal(got, jrecords(jprog, cols), "reference")


@pytest.mark.parametrize("scope", ["ignoreFns", "skipLibCalls",
                                   "protectedLibFn", "cloneAfterCall"])
def test_segmented_refuses_cross_lane_classes(scope):
    import coast_tpu
    with pytest.raises(ValueError) as want:
        coast_tpu.TMR(_jregion(), segmented=True, **SCOPES[scope])
    with pytest.raises(ValueError) as got:
        ct.TMR(REGISTRY["nestedCalls"](), device="cpu", segmented=True,
               **SCOPES[scope])
    assert str(got.value) == str(want.value)
    assert "segmented" in str(got.value)
    # One lane has no cross-lane sync to lose.
    ct.unprotected(REGISTRY["nestedCalls"](), device="cpu", segmented=True,
                   **SCOPES[scope])


VERIFY_CASES = [
    {"ignore_fns": ("nope",)}, {"skip_lib_calls": ("nope",)},
    {"replicate_fn_calls": ("nope",)}, {"clone_fns": ("nope",)},
    {"clone_return_fns": ("nope",)}, {"clone_after_call_fns": ("nope",)},
    {"protected_lib_fns": ("nope",)}, {"isr_functions": ("uart_isr",)},
    {"runtime_init_globals": ("nope",)},
    {"ignore_fns": ("nope",), "isr_functions": ("h",),
     "runtime_init_globals": ("gone",)},
]


@pytest.mark.parametrize("kw", VERIFY_CASES,
                         ids=["-".join(sorted(kw)) for kw in VERIFY_CASES])
def test_verification_errors_equal_reference(kw):
    import coast_tpu
    from coast_tpu.passes.verification import SoRViolation as JSoRViolation
    with pytest.raises(JSoRViolation) as want:
        coast_tpu.TMR(_jregion(), **kw)
    with pytest.raises(SoRViolation) as got:
        ct.TMR(REGISTRY["nestedCalls"](), device="cpu", **kw)
    assert got.value.errors == want.value.errors


def test_known_names_verify_clean_and_fn_lists_on_a_region_without_them():
    ct.TMR(REGISTRY["nestedCalls"](), device="cpu",
           runtime_init_globals=("out",), clone_fns=("mix",))
    with pytest.raises(SoRViolation, match="no function named 'fold'"):
        ct.TMR(REGISTRY["matrixMultiply"](), device="cpu",
               protected_lib_fns=("fold",))


def test_scope_config_forwards_fn_lists_with_the_reference_precedence():
    sc = ScopeConfig()
    sc.merge_cl({"ignoreFns": ["fold"], "protectedLibFn": ["mix"]})
    prog = ct.TMR(REGISTRY["nestedCalls"](), device="cpu",
                  **sc.protection_overrides())
    assert prog.fn_scope == {"fold": "ignored", "mix": "protected_lib"}
    sc = ScopeConfig()
    sc.merge_cl({"cloneAfterCall": ["fold"]})
    cfg = ct.ProtectionConfig(**sc.protection_overrides())
    assert cfg.fn_scope_of("fold") == "clone_after_call"
    import coast_tpu
    for kw in SCOPES.values():
        jcfg, tcfg = coast_tpu.ProtectionConfig(**kw), ct.ProtectionConfig(
            **kw)
        assert tcfg.fn_lists() == jcfg.fn_lists()
        for name in ("mix", "fold"):
            assert tcfg.fn_scope_of(name) == jcfg.fn_scope_of(name)


# -- the boundary transforms and coast_h -------------------------------------

def _rows(seed, rows=5):
    rng = np.random.RandomState(seed)
    return rng.randint(-2**31, 2**31, size=(rows, 4)).astype(np.int32)


def test_boundary_transforms_equal_reference():
    import jax.numpy as jnp
    from coast_tpu.interface import wrappers as JW
    from coast_tpu_torch.interface import wrappers as W

    def f(a, b):
        return a ^ (b * 3)

    def jf(a, b):
        return a ^ (b * 3)

    a, b = _rows(1), _rows(2)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for n in (2, 3):
        voted, mis = W.protected_lib(f, n)(ta, tb)
        for r in range(len(a)):
            jv, jm = JW.protected_lib(jf, n)(jnp.asarray(a[r]),
                                             jnp.asarray(b[r]))
            np.testing.assert_array_equal(voted[r].numpy(), np.asarray(jv))
            assert bool(mis[r]) == bool(jm)
        lanes = np.stack([a] * n, axis=1)
        lanes[1, n - 1, 2] ^= 1 << 7           # one lane of one row differs
        got = W.replicated_return(f, n, no_xmr_args=(1,))(
            torch.from_numpy(lanes), tb)
        got2 = W.no_xmr_arg(1)(f, n)(torch.from_numpy(lanes), tb)
        np.testing.assert_array_equal(got.numpy(), got2.numpy())
        for r in range(len(a)):
            want = JW.replicated_return(jf, n, no_xmr_args=(1,))(
                jnp.asarray(lanes[r]), jnp.asarray(b[r]))
            np.testing.assert_array_equal(got[r].numpy(), np.asarray(want))
        with pytest.raises(ValueError, match="lane axis"):
            W.replicated_return(f, n)(ta, tb)
        fanned = W.clone_after_call(f, n)(ta, tb)
        assert fanned.shape == (len(a), n, 4) and fanned.is_contiguous()
        for r in range(len(a)):
            want = JW.clone_after_call(jf, n)(jnp.asarray(a[r]),
                                              jnp.asarray(b[r]))
            np.testing.assert_array_equal(fanned[r].numpy(), np.asarray(want))
    assert W.protected_lib(f).__name__ == "f_COAST_WRAPPER"
    assert W.replicated_return(f).__name__ == "f.RR"
    with pytest.raises(ValueError):
        W.protected_lib(f, 1)


def test_coast_h_macros_equal_reference():
    from coast_tpu import coast_h as jh
    from coast_tpu_torch import coast_h
    assert coast_h.__all__ == jh.__all__
    spec = coast_h.LeafSpec(kind="ctrl")
    assert coast_h.xMR(spec).xmr is True and coast_h.xMR(spec).kind == "ctrl"
    assert coast_h.NO_xMR(kind="mem").xmr is False
    assert coast_h.VOLATILE(spec).no_verify is True
    for macro in ("xMR", "NO_xMR", "VOLATILE"):
        got = getattr(coast_h, macro)(kind="reg")
        want = getattr(jh, macro)(kind="reg")
        assert (got.kind, got.xmr, got.no_verify) == (want.kind, want.xmr,
                                                     want.no_verify)
