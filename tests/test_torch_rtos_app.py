"""rtos_app of the port against the JAX reference: the canonical scope
configuration (``rtos/functions.config`` plus ``rtos/Makefile``'s CL
lists, through ``interface/config.py``) resolves every one of the twelve
functions as the reference does; the region equals the reference's; the
run records under the canonical TMR and DWC builds (``-countSyncs``)
equal the reference's row by row, and the fused engine the unfused one;
the UART mirror stays outside the sphere of replication; the scope
choices buy the reference's fault behaviour.
"""

import os

import numpy as np
import pytest
import torch

import coast_tpu_torch as ct
from coast_tpu_torch.interface.config import parse_config_file
from coast_tpu_torch.interop import state_to_numpy
from coast_tpu_torch.models import REGISTRY
from coast_tpu_torch.passes.verification import SoRViolation, analyze
from test_torch_cfcss import (assert_records_equal, jrecords, schedule_cols,
                              trecords)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "rtos", "functions.config")

# The CL half of the canonical config (rtos/Makefile OPT_FLAGS).
CL_LISTS = {
    "cloneFns": ["run_mm", "run_crc", "heartbeat"],
    "protectedLibFn": ["ring_push"],
    "cloneAfterCall": ["rng_next"],
    "cloneGlbls": ["ring"],
}


def _overrides(parse):
    scope = parse(CONFIG, required=True)
    scope.merge_cl({k: list(v) for k, v in CL_LISTS.items()})
    return scope.protection_overrides()


def _programs(num_clones, **kw):
    import coast_tpu
    from coast_tpu.interface.config import parse_config_file as jparse
    from coast_tpu.models import REGISTRY as JREGISTRY
    jprog = coast_tpu.protect(JREGISTRY["rtos_app"](),
                              coast_tpu.ProtectionConfig(
                                  num_clones=num_clones, count_syncs=True,
                                  **_overrides(jparse), **kw))
    tprog = ct.protect(REGISTRY["rtos_app"](), ct.ProtectionConfig(
        num_clones=num_clones, count_syncs=True,
        **_overrides(parse_config_file), **kw), device="cpu")
    return jprog, tprog


def test_canonical_config_resolves_every_function():
    jprog, tprog = _programs(3)
    assert tprog.fn_scope == jprog.fn_scope
    assert set(tprog.fn_scope) == set(REGISTRY["rtos_app"]().functions)
    assert len(tprog.fn_scope) == 12
    assert tprog.fn_scope["rng_next"] == "clone_after_call"
    assert tprog.fn_scope["ring_push"] == "protected_lib"
    assert not tprog.replicated["uart"] and tprog.replicated["ring"]
    assert tprog.replicated == jprog.replicated
    assert tprog.injectable_sections() == jprog.injectable_sections()


def test_region_equals_reference():
    import jax
    from coast_tpu.models import REGISTRY as JREGISTRY
    from coast_tpu.passes.verification import analyze as janalyze
    region, jregion = REGISTRY["rtos_app"](), JREGISTRY["rtos_app"]()
    want, got = janalyze(jregion), analyze(region)
    assert (got.written, got.deps, got.load_addr, got.store_addr) == (
        want.written, want.deps, want.load_addr, want.store_addr)
    assert list(region.spec) == list(jregion.spec)
    assert sorted(region.functions) == sorted(jregion.functions)
    final = state_to_numpy(region.run_unprotected("cpu"), region)
    for k, v in jax.jit(jregion.run_unprotected)().items():
        np.testing.assert_array_equal(final[k], np.asarray(v), err_msg=k)
    one = {k: torch.from_numpy(v).unsqueeze(0) for k, v in final.items()}
    assert int(region.check(one)[0]) == 0


@pytest.mark.parametrize("strategy", ["TMR", "DWC"])
def test_canonical_records_equal_reference(strategy):
    jprog, tprog = _programs(3 if strategy == "TMR" else 2)
    cols = schedule_cols(tprog, 160, 9, [
        ("seed", 0, 0, 5, 5), ("acc_crc", 1, 0, 9, 7), ("tick", 1, 0, 31, 3),
        ("widx", 0, 0, 30, 11), ("ring", 1, 3, 11, 20), ("uart", 0, 2, 8, 9)])
    got = trecords(tprog, cols)
    assert_records_equal(got, jrecords(jprog, cols), strategy)
    assert got["sync_count"].max() > 0
    fused = ct.protect(tprog.region, ct.ProtectionConfig(
        num_clones=tprog.cfg.num_clones, count_syncs=True, fuse_step=True,
        **_overrides(parse_config_file)), device="cpu")
    assert_records_equal(trecords(fused, cols), got, "fused")


def _one(prog, leaf, lane, word, bit, t):
    cols = schedule_cols(prog, 0, 0, [(leaf, lane, word, bit, t)])
    return {k: v[0] for k, v in trecords(prog, cols).items()}


def test_uart_outside_sor_and_the_scope_choices():
    """A lane flip in a replicated source is voted before the single UART
    store, so the mirror stays clean; the single entropy stream of
    -cloneAfterCall=rng_next is the accepted single point of failure
    (masked under the default build); DWC detects a ring lane flip."""
    tprog = _programs(3)[1]
    rec = _one(tprog, "acc_crc", 1, 0, 9, 7)
    assert int(rec["errors"]) == 0 and int(rec["corrected"]) > 0
    assert int(_one(tprog, "seed", 0, 0, 5, 5)["errors"]) > 0
    default = ct.TMR(REGISTRY["rtos_app"](), device="cpu")
    assert int(_one(default, "seed", 0, 0, 5, 5)["errors"]) == 0
    assert bool(_one(_programs(2)[1], "ring", 1, 3, 11, 20)["dwc_fault"])


def test_isr_key_in_a_config_file_refused(tmp_path):
    p = tmp_path / "functions.config"
    p.write_text("isrFunctions = FreeRTOS_IRQ_Handler\n")
    scope = parse_config_file(str(p), required=True)
    with pytest.raises(SoRViolation, match="isrFunctions"):
        ct.protect(REGISTRY["rtos_app"](), ct.ProtectionConfig(
            **scope.protection_overrides()), device="cpu")
