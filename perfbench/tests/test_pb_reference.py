"""The plain reference against hand-worked cases and against the port on
the CPU at a tiny batch."""

import numpy as np
import pytest
import torch

from perfbench import traffic as traffic_mod
from perfbench.reference import engine, mm


def _faults(rows):
    """Fault columns ``[rows, 1]`` from ``(leaf, lane, word, bit, t)``."""
    arr = np.asarray(rows, np.int64).reshape(len(rows), 5, 1)
    return {k: torch.as_tensor(arr[:, i]) for i, k in
            enumerate(engine.FAULT_KEYS)}


def test_lcg_is_glibc_rand():
    # glibc's TYPE_0 rand(): x = x * 1103515245 + 12345 mod 2^31, >> 16.
    x, out = 42, []
    for _ in range(3):
        x = (x * 1103515245 + 12345) % 2 ** 31
        out.append((x >> 16) & 0x7FFF)
    assert mm.lcg(42, 3, 15).tolist() == out
    assert np.array_equal(mm._lcg_fast(42, 9000, 15), mm.lcg(42, 9000, 15))


def test_fault_free_product_mod_2_32():
    region = mm.make(9)
    a = mm.lcg(42, 81, 15).reshape(9, 9)
    b = mm.lcg(43, 81, 15).reshape(9, 9)
    want = [[sum(int(a[i, k]) * int(b[k, j]) for k in range(9)) % 2 ** 32
             for j in range(9)] for i in range(9)]
    assert region.image["golden"].astype(np.int64).tolist() == want
    ref = engine.Reference(region, "cpu")
    rec = ref.run(_faults([(0, 0, 0, 0, -1)]))     # t = -1 never fires
    assert rec["code"].tolist() == [engine.SUCCESS]
    assert rec["errors"].tolist() == [0]
    assert rec["corrected"].tolist() == [0]
    assert rec["steps"].tolist() == [18]


def test_one_replica_flip_is_voted_away():
    region = mm.make(9)
    names = region.leaf_names
    results = names.index("results")
    # Lane 1 of results, row 0 word 3, after row 0 was stored (t = 2): the
    # store-data vote of that step repairs it.
    rec = engine.Reference(region, "cpu").run(
        _faults([(results, 1, 3, 5, 2)]))
    assert rec["code"].tolist() == [engine.CORRECTED]
    assert rec["errors"].tolist() == [0]
    assert rec["corrected"].tolist() == [1]
    assert rec["steps"].tolist() == [18]


def test_a_flip_of_the_shared_golden_copy_is_an_sdc():
    region = mm.make(9)
    rec = engine.Reference(region, "cpu").run(
        _faults([(region.leaf_names.index("golden"), 0, 40, 7, 0)]))
    assert rec["code"].tolist() == [engine.SDC]
    assert rec["errors"].tolist() == [1]


def _port_records(port_region, fused, cols, model):
    from coast_tpu_torch.inject.campaign import CampaignRunner
    from coast_tpu_torch.passes import strategies

    from perfbench import harness
    prog = strategies.TMR(port_region, device="cpu", fuse_step=fused)
    runner = CampaignRunner(prog, fault_model=model)
    tr = traffic_mod.Traffic("t", "multibit" if cols["t"].shape[1] > 1
                             else "single", cols["t"].shape[1], 128,
                             len(cols["t"]), "dense", 1)
    res = runner.run_schedule(harness.to_schedule(cols, tr, 1),
                              batch_size=128)
    return prog, res


@pytest.mark.parametrize("fused,k", [(True, 1), (False, 1), (True, 4)])
def test_matches_the_port_mm9(fused, k):
    from coast_tpu_torch.inject.schedule import FaultModel
    from coast_tpu_torch.models import REGISTRY

    from perfbench import harness
    region = mm.make(9)
    tr = traffic_mod.Traffic("t", "multibit" if k > 1 else "single", k,
                             128, 384, "dense", 1)
    cols = traffic_mod.draw_pool(11, engine.layout(region),
                                 region.nominal_steps, tr)[0]
    model = FaultModel.multibit(k) if k > 1 else FaultModel.single()
    prog, res = _port_records(REGISTRY["matrixMultiply"](), fused, cols,
                              model)
    assert [tuple(x) for x in prog.injectable_sections()] == \
        engine.layout(region)
    rec = engine.Reference(region, "cpu").run_blocks(
        {k_: cols[k_].astype(np.int64) for k_ in engine.FAULT_KEYS}, 100)
    assert harness.compare(res, rec) == {"rows_differ": 0, "count_diff": 0}
    assert set(np.unique(rec["code"])) >= {engine.CORRECTED, engine.SDC}


@pytest.mark.parametrize("operands", ["bf16", "f32"])
def test_matches_the_port_blocked_f32(operands):
    """The blocked float build at a small side (the 1024 build's code path:
    store windows, bfloat16 operands)."""
    from coast_tpu_torch.inject.schedule import FaultModel
    from coast_tpu_torch.models import mm256

    from perfbench import harness
    region = mm.make(64, 16, "f32", operands)
    tr = traffic_mod.Traffic("t", "single", 1, 128, 256, "dense", 1)
    cols = traffic_mod.draw_pool(12, engine.layout(region),
                                 region.nominal_steps, tr)[0]
    _, res = _port_records(mm256.make_region(
        side=64, block=16, bf16_matmul=operands == "bf16"), False, cols,
        FaultModel.single())
    rec = engine.Reference(region, "cpu").run_blocks(
        {k: cols[k].astype(np.int64) for k in engine.FAULT_KEYS}, 64)
    assert harness.compare(res, rec) == {"rows_differ": 0, "count_diff": 0}


def test_multibit_draws_distinct_bits_of_one_word():
    region = mm.make(9)
    tr = traffic_mod.Traffic("t", "multibit", 4, 64, 4096, "sparse", 1)
    cols = traffic_mod.draw_pool(2 ** 31 + 5, engine.layout(region),
                                 region.nominal_steps, tr)[0]
    bits = cols["bit"]
    assert bits.shape == (4096, 4) and bits.min() >= 0 and bits.max() < 32
    assert all(len(set(r)) == 4 for r in bits.tolist())
    for k in ("leaf_id", "lane", "word", "t"):
        assert (cols[k] == cols[k][:, :1]).all()
    again = traffic_mod.draw_pool(2 ** 31 + 5, engine.layout(region),
                                  region.nominal_steps, tr)[0]
    assert all(np.array_equal(cols[k], again[k]) for k in cols)
