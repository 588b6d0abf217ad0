"""CFCSS (BASELINE config 5) of the port against the JAX reference.

Against the reference in the same process: the signature assignment
(``native.cfcss_assign``) on every ported region's block graph at two
seeds, and its refusals; the memory map of a CFCSS program (section order
and words); the run records of TMR+CFCSS, DWC+CFCSS and standalone CFCSS
(``num_clones=1``) on matrixMultiply, crc16, chstone_mips and crazyCF,
row by row, over a seeded schedule plus flips into the signature tracker,
the previous-block word and a control leaf, high bits included; a
``sections=["cfcss"]`` campaign's counts; and the fused engine equal to
the unfused one.  The block graphs themselves are held against the
reference in ``tests/test_torch_cfcss_graphs.py``.

The record helpers here are shared with the other item-13 test files.
"""

import numpy as np
import pytest
import torch

import coast_tpu_torch as ct
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.inject.mem import MemoryMap
from coast_tpu_torch.inject.schedule import generate
from coast_tpu_torch.models import REGISTRY
from coast_tpu_torch.native import cfcss_assign
from coast_tpu_torch.passes.cfcss import G_LEAF, PREV_LEAF, apply_cfcss
from test_torch_cfcss_graphs import GRAPH_NAMES

torch.set_num_threads(1)

RECORD_KEYS = ("errors", "corrected", "steps", "sync_count", "done",
               "dwc_fault", "cfc_fault", "output")
FAULT_KEYS = ("leaf_id", "lane", "word", "bit", "t")


# -- shared record helpers ---------------------------------------------------

def schedule_cols(prog, n, seed, extra=()):
    """``n`` seeded single-flip rows of ``prog``'s memory map, then the
    ``extra`` rows ``(leaf name, lane, word, bit, t)``, as int32 columns."""
    s = generate(MemoryMap(prog), n, seed, prog.region.nominal_steps)
    cols = {k: np.asarray(getattr(s, k), np.int32) for k in FAULT_KEYS}
    if extra:
        rows = np.array([(prog.leaf_order.index(leaf), *rest)
                         for leaf, *rest in extra], np.int32)
        for i, k in enumerate(FAULT_KEYS):
            cols[k] = np.concatenate([cols[k], rows[:, i]])
    return cols


def jrecords(jprog, cols):
    """The reference's run records of every row (one vmapped run)."""
    import jax
    import jax.numpy as jnp
    out = jax.jit(jax.vmap(jprog.run))(
        {k: jnp.asarray(v) for k, v in cols.items()})
    return {k: np.asarray(out[k]) for k in RECORD_KEYS}


def trecords(prog, cols):
    """The port's run records of every row (one batch)."""
    out = prog.run_batch(cols)
    return {k: out[k].numpy() for k in RECORD_KEYS}


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


def assert_records_equal(got, want, what=""):
    for k in RECORD_KEYS:
        g, w = _bits(got[k]), _bits(want[k])
        assert g.shape == w.shape, (what, k)
        bad = (g != w).reshape(len(g), -1).any(axis=1)
        assert not bad.any(), f"{what} {k} differs on rows " \
            f"{np.flatnonzero(bad)[:10].tolist()}"


# -- the signature assignment ------------------------------------------------

DIAMOND = [(0, 1), (0, 2), (1, 3), (2, 3), (3, 1)]  # fan-in at 3 and 1


def _assert_tables_equal(got, want):
    for k in ("sigs", "diffs", "fanin", "dedge"):
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["attempts"] == want["attempts"]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", GRAPH_NAMES)
def test_assignment_equals_reference(name, seed):
    from coast_tpu.native import cfcss_assign as jassign
    graph = REGISTRY[name]().graph
    _assert_tables_equal(cfcss_assign(graph.n, graph.edges, seed=seed),
                         jassign(graph.n, graph.edges, seed=seed))


@pytest.mark.parametrize("seed", [3, 11, 2**64 - 1])
def test_assignment_sound_and_equal_on_a_diamond(seed):
    from coast_tpu.native import cfcss_assign as jassign
    t = cfcss_assign(4, DIAMOND, seed=seed)
    _assert_tables_equal(t, jassign(4, DIAMOND, seed=seed))
    sigs, diffs, fanin, dedge = t["sigs"], t["diffs"], t["fanin"], t["dedge"]
    assert len(set(sigs.tolist())) == 4
    assert fanin[3] and fanin[1] and not fanin[2]
    for u in range(4):
        for v in range(4):
            g = sigs[u] ^ diffs[v] ^ (dedge[u, v] if fanin[v] else 0)
            assert (g == sigs[v]) == ((u, v) in DIAMOND)


@pytest.mark.parametrize("n,edges,bits", [
    (3, [(0, 5)], 16), (3, [(-1, 1)], 16), (0, [], 16), (4, DIAMOND, 1),
    (4, DIAMOND, 33), (300, [(0, v) for v in range(1, 300)], 8)])
def test_assignment_rejects_what_the_reference_rejects(n, edges, bits):
    from coast_tpu.native import cfcss_assign as jassign
    with pytest.raises(ValueError) as want:
        jassign(n, edges, seed=0, sig_bits=bits)
    with pytest.raises(ValueError) as got:
        cfcss_assign(n, edges, seed=0, sig_bits=bits)
    assert str(got.value) == str(want.value)


# -- the program: memory map and records ------------------------------------

CASES = ("matrixMultiply", "crc16", "chstone_mips", "crazyCF")
CLONES = {"TMR": 3, "DWC": 2, "standalone": 1}


def _programs(name, clones, **kw):
    import coast_tpu
    cfg = dict(num_clones=CLONES[clones], cfcss=True, count_syncs=True, **kw)
    jprog = coast_tpu.protect(_jregion(name), coast_tpu.ProtectionConfig(
        **cfg))
    tprog = ct.protect(REGISTRY[name](), ct.ProtectionConfig(**cfg),
                       device="cpu")
    return jprog, tprog


def _jregion(name):
    from coast_tpu.models import REGISTRY as JREGISTRY
    return JREGISTRY[name]()


def _targeted(prog):
    """Flips of the tracker, the previous block and the first control
    leaf: high bits (an out-of-range table index), low bits, early and
    late, in the last lane."""
    ctrl = next(k for k in prog.leaf_order if k in prog.region.spec
                and prog.region.spec[k].kind == "ctrl")
    lane = prog.cfg.num_clones - 1
    t_late = prog.region.nominal_steps // 2
    return [(leaf, lane, 0, bit, t)
            for leaf in (G_LEAF, PREV_LEAF, ctrl)
            for bit in (31, 30, 17, 4, 0) for t in (1, t_late)]


@pytest.mark.parametrize("clones", sorted(CLONES))
@pytest.mark.parametrize("name", CASES)
def test_sections_equal_reference(name, clones):
    jprog, tprog = _programs(name, clones)
    assert tprog.leaf_order == jprog.leaf_order
    assert tprog.injectable_sections() == jprog.injectable_sections()
    assert tprog.leaf_order[-2:] == [PREV_LEAF, G_LEAF]
    assert tprog.replicated == jprog.replicated
    assert tprog.sync_tags() >= {("cfcss", G_LEAF)}
    # A seeded schedule lands on the same words.
    from coast_tpu.inject.mem import MemoryMap as JMemoryMap
    from coast_tpu.inject.schedule import generate as jgenerate
    steps = tprog.region.nominal_steps
    want = jgenerate(JMemoryMap(jprog), 300, 3, steps)
    got = generate(MemoryMap(tprog), 300, 3, steps)
    for col in (*FAULT_KEYS, "section_idx"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col),
                                      err_msg=col)


@pytest.mark.parametrize("clones", sorted(CLONES))
@pytest.mark.parametrize("name", CASES)
def test_records_equal_reference(name, clones):
    jprog, tprog = _programs(name, clones)
    cols = schedule_cols(tprog, 96, 5, _targeted(tprog))
    got = trecords(tprog, cols)
    assert_records_equal(got, jrecords(jprog, cols), f"{name} {clones}")
    assert got["cfc_fault"].any()
    fused = _programs(name, clones, fuse_step=True)[1]
    assert fused._fuse_plan is not None
    assert_records_equal(trecords(fused, cols), got, "fused")


def test_lane_local_control_corruption_detected_with_votes_off():
    """mips ``pc`` with ``-noLoadSync``: nothing repairs a flipped lane
    before it steers control, and the per-lane signature check catches
    the teleport, as in the reference; with the vote on, TMR masks it."""
    for kw, caught in (({"no_load_sync": True}, True), ({}, False)):
        jprog, tprog = _programs("chstone_mips", "TMR", **kw)
        cols = schedule_cols(tprog, 0, 0, [("pc", 2, 0, 6, 50)])
        got = trecords(tprog, cols)
        assert_records_equal(got, jrecords(jprog, cols))
        assert bool(got["cfc_fault"][0]) is caught


def test_cfcss_section_campaign_equals_reference():
    """Hits in the CFCSS runtime words are detected or harmless, never
    silent, with the reference's counts."""
    import coast_tpu
    from coast_tpu.inject.campaign import CampaignRunner as JRunner
    want = JRunner(coast_tpu.TMR(_jregion("matrixMultiply"), cfcss=True),
                   sections=["cfcss"]).run(200, seed=13, batch_size=100)
    got = CampaignRunner(ct.TMR(REGISTRY["matrixMultiply"](), device="cpu",
                                cfcss=True),
                         sections=["cfcss"]).run(200, seed=13, batch_size=100)
    assert got.counts == want.counts
    for col in ("codes", "errors", "corrected", "steps"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col))
    assert got.counts["due_abort"] > 0 and got.counts["sdc"] == 0


def test_region_without_graph_rejected():
    region = REGISTRY["matrixMultiply"]()
    region.graph = None
    with pytest.raises(ValueError, match="no block graph"):
        ct.TMR(region, device="cpu", cfcss=True)


def test_apply_cfcss_stacks_onto_a_built_program():
    """``apply_cfcss`` on an unprotected build is the standalone program
    ``ProtectionConfig(num_clones=1, cfcss=True)`` gives."""
    stacked = apply_cfcss(ct.unprotected(REGISTRY["crc16"](), device="cpu"))
    built = ct.protect(REGISTRY["crc16"](),
                       ct.ProtectionConfig(num_clones=1, cfcss=True),
                       device="cpu")
    assert stacked.injectable_sections() == built.injectable_sections()
    cols = schedule_cols(built, 64, 1, _targeted(built))
    assert_records_equal(trecords(stacked, cols), trecords(built, cols))
