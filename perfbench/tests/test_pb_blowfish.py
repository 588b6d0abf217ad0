"""The plain Blowfish reference against the published vector, its own
oracle, hand-placed faults and the port on the CPU.  A row runs all
1,171 steps, so the campaigns here are small."""

import functools

import numpy as np
import pytest
import torch

from perfbench import harness, traffic as traffic_mod
from perfbench.reference import blowfish, engine


def _faults(rows):
    """Fault columns ``[rows, 1]`` from ``(leaf, lane, word, bit, t)``."""
    arr = np.asarray(rows, np.int64).reshape(len(rows), 5, 1)
    return {k: torch.as_tensor(arr[:, i]) for i, k in
            enumerate(engine.FAULT_KEYS)}


def test_published_zero_key_vector():
    assert blowfish.pi_words(2) == [0x243F6A88, 0x85A308D3]
    p, s = blowfish.tables(bytes(8))
    assert blowfish.encrypt(p, s, 0, 0) == (0x4EF99745, 0x6198DD78)


def test_fault_free_run_voted_flip_and_plaintext_sdc():
    region = blowfish.make()
    assert region.image["S"].shape == (1024,)
    assert region.nominal_steps == 1171 and region.max_steps == 1179
    golden = blowfish.cfb64(blowfish.KEY, blowfish.corpus())
    assert golden.shape == (650, 2)
    names = region.leaf_names
    rec = engine.Reference(region, "cpu").run(_faults([
        (0, 0, 0, 0, -1),                        # t = -1 never fires
        # Lane 1 of an S-box word in the CFB phase: the step's commit
        # votes repair S and what lane 1 computed from it.
        (names.index("S"), 1, 100, 7, 600),
        # The plaintext of block 500 (read at step 1021), flipped at step
        # 10: the one shared copy, so every lane encrypts it.
        (names.index("plain"), 0, 1000, 3, 10)]))
    assert rec["code"].tolist() == [engine.SUCCESS, engine.CORRECTED,
                                    engine.SDC]
    # The fault-free ciphertext equals the oracle's, word for word.
    assert rec["errors"].tolist()[:2] == [0, 0]
    assert rec["errors"][2] > 0
    assert rec["corrected"][0] == 0 and rec["corrected"][1] > 0
    assert rec["steps"].tolist() == [1171] * 3


@functools.lru_cache(maxsize=1)
def _campaign():
    """32 rows of a drawn single-bit campaign, the first twelve moved
    onto ``i``, ``chain``, ``P`` and ``plain`` (seeded lanes, words, bits
    and steps; one flip of ``i``'s sign bit), and the reference's
    records."""
    region = blowfish.make()
    tr = traffic_mod.Traffic("t", "single", 1, 32, 32, "dense", 1)
    cols = traffic_mod.draw_pool(2 ** 33 + 7, engine.layout(region),
                                 region.nominal_steps, tr)[0]
    rng = np.random.default_rng(5)
    targets = ["i"] * 4 + ["chain"] * 4 + ["P"] * 2 + ["plain"] * 2
    for r, name in enumerate(targets):
        leaf = region.leaf(name)
        cols["leaf_id"][r] = cols["section"][r] = region.leaf_names.index(
            name)
        cols["lane"][r] = rng.integers(leaf.lanes)
        cols["word"][r] = rng.integers(leaf.words)
        cols["bit"][r] = rng.integers(32)
        cols["t"][r] = rng.integers(region.nominal_steps)
    cols["bit"][0] = 31
    faults = {k: cols[k].astype(np.int64) for k in engine.FAULT_KEYS}
    rec = engine.Reference(region, "cpu").run_blocks(faults, 32)
    return tr, cols, faults, rec


@pytest.mark.parametrize("fused", [True, False])
def test_matches_the_port(fused):
    from coast_tpu_torch.inject.campaign import CampaignRunner
    from coast_tpu_torch.inject.schedule import FaultModel
    from coast_tpu_torch.models import REGISTRY
    from coast_tpu_torch.passes import strategies

    tr, cols, _, rec = _campaign()
    prog = strategies.TMR(REGISTRY["chstone_blowfish"](), device="cpu",
                          fuse_step=fused)
    assert [tuple(x) for x in prog.injectable_sections()] == \
        engine.layout(blowfish.make())
    runner = CampaignRunner(prog, fault_model=FaultModel.single())
    res = runner.run_schedule(harness.to_schedule(cols, tr, 1),
                              batch_size=32)
    assert harness.compare(res, rec) == {"rows_differ": 0, "count_diff": 0}
    assert set(np.unique(rec["code"])) >= {engine.CORRECTED, engine.SDC}


def test_float32_control_differs():
    """The F function's additions carried in float32 garble the key
    schedule: the control differs from the stated reference on rows."""
    _, _, faults, rec = _campaign()
    low = engine.Reference(blowfish.make("float32"), "cpu").run(
        {k: torch.as_tensor(v[:2]) for k, v in faults.items()})
    assert (low["errors"].numpy() != rec["errors"][:2]).all()
    assert (low["code"].numpy() == engine.SDC).all()
    with pytest.raises(ValueError):
        blowfish.make("bfloat16")
