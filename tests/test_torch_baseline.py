"""The BASELINE regions of the port against the JAX reference: aes and
sha256 (BASELINE config 2), quicksort (config 3) and the CHStone suite
(config 4).

For every name, against the JAX twin built in the same process: the init
image, the declared dataflow (against the reference's ``analyze()``), the
leaf order, sections, sync tables and seeded schedules, the fused plan,
and the fault-free unprotected final state, bit for bit, which must also
be what each package's host oracle computes; then the records of a
64-row campaign (seed 3, batch 64) under TMR and DWC, equal on every row
with no exemption, and the port's fused engine equal to its unfused one.
Below them, the index rules and unsigned word helpers the regions use,
each against JAX on its edge indices and counts, and the soft-float
against the reference's.

This file holds aes, sha256, quicksort, chstone_mips and chstone_motion.
The other CHStone names are in files of their own, so that ``--dist
loadfile`` spreads their JAX twins (which take up to a minute and a half
each to compile) over workers: ``test_torch_baseline_chstone.py`` (adpcm,
blowfish, gsm, jpeg), ``test_torch_baseline_df.py`` (dfadd, dfmul,
dfdiv), and ``test_torch_baseline_sha.py`` and
``test_torch_baseline_dfsin.py`` with their ``_dwc`` twins (each JAX
campaign of those two compiles for one to two minutes).  They call the
shared checks below.
"""

import hashlib
import importlib

import numpy as np
import pytest
import torch

import coast_tpu_torch as ct
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.inject.mem import MemoryMap
from coast_tpu_torch.inject.schedule import generate
from coast_tpu_torch.interop import state_to_numpy
from coast_tpu_torch.models import CHSTONE, REGISTRY
from coast_tpu_torch.ops import indexing, u32
from coast_tpu_torch.passes.verification import analyze

# The suite runs under xdist, several workers to a host: one intra-op
# thread per worker keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

BASELINE = ("aes", "sha256", "quicksort", *CHSTONE[:-1])
NAMES = ("aes", "sha256", "quicksort", "chstone_mips", "chstone_motion")
STRATEGIES = ("TMR", "DWC")
COLUMNS = ("codes", "errors", "corrected", "steps")
ROWS, SEED, BATCH = 64, 3, 64


# -- shared checks (the two heavy names' files call these too) ---------------

class Results:
    """The JAX twins' results and the port's unfused campaigns, each
    computed once a module."""

    def __init__(self):
        self._memo = {}

    def _get(self, key, make):
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]

    def region(self, name):
        from coast_tpu.models import REGISTRY as JREGISTRY
        return self._get(("region", name), JREGISTRY[name])

    def final(self, name):
        import jax
        region = self.region(name)
        return self._get(("final", name), lambda: {
            k: np.asarray(v)
            for k, v in jax.jit(region.run_unprotected)().items()})

    def campaign(self, name, strategy):
        import coast_tpu
        from coast_tpu.inject.campaign import CampaignRunner as JRunner
        return self._get(("campaign", name, strategy), lambda: JRunner(
            getattr(coast_tpu, strategy)(self.region(name)),
            strategy_name=strategy).run(ROWS, seed=SEED, batch_size=BATCH))

    def port_campaign(self, name, strategy):
        return self._get(("port", name, strategy), lambda: CampaignRunner(
            getattr(ct, strategy)(REGISTRY[name](), device="cpu"),
            strategy_name=strategy).run(ROWS, seed=SEED, batch_size=BATCH))


def _split_pairs(bits):
    hi = (np.asarray(bits, np.uint64) >> np.uint64(32)).astype(np.uint32)
    lo = (np.asarray(bits, np.uint64) & np.uint64(0xFFFFFFFF)).astype(
        np.uint32)
    return np.stack([hi, lo], axis=-1)


def oracle(name, package):
    """The leaves a fault-free run must end with, by ``package``'s own host
    oracle (``coast_tpu`` or ``coast_tpu_torch``)."""
    def mod(path):
        return importlib.import_module(f"{package}.models.{path}")

    if name == "aes":
        m = mod("aes")
        raw = mod("common").lcg_words(31, 32, bits=8)
        key, plain = [int(v) for v in raw[:16]], [int(v) for v in raw[16:]]
        cipher = m._encrypt_host(plain, m._expand_key_host(key))
        return {"cipher": np.asarray(cipher, np.int32),
                "block": np.asarray(plain, np.int32)}
    if name == "sha256":
        digest = hashlib.sha256(mod("sha256").MESSAGE).digest()
        return {"h": np.frombuffer(digest, ">u4").astype(np.uint32)}
    if name == "quicksort":
        m = mod("quicksort")
        vals = mod("common").lcg_words(m.SEED, m.ELEMS, bits=15)
        return {"array": np.sort(vals)[::-1].astype(np.int32)}
    if name == "chstone_mips":
        m = mod("chstone_mips")
        return {"dmem[:8]": np.asarray(m.OUT_DATA, np.int32),
                "n_inst": np.int32(m.N_INST_GOLDEN)}
    if name == "chstone_sha":
        m = mod("chstone.sha")
        return {"digest": np.stack([np.frombuffer(
            hashlib.sha1(m._stream_bytes(k)).digest(), ">u4")
            for k in range(m.N_STREAMS)]).astype(np.uint32)}
    if name == "chstone_blowfish":
        m = mod("chstone.blowfish")
        return {"out": m.golden_reference(m.KEY, m._corpus())}
    if name in ("chstone_adpcm", "chstone_gsm"):
        m = mod(f"chstone.{name[8:]}")
        a, b = m.golden_reference(m.make_input())
        keys = ("compressed", "result") if name == "chstone_adpcm" \
            else ("s", "larc")
        return dict(zip(keys, (a.astype(np.int32), b.astype(np.int32))))
    if name == "chstone_motion":
        m = mod("chstone.motion")
        hist, pmv = m.golden_reference(m.make_stream()[0])
        return {"hist": hist.astype(np.int32), "pmv": pmv.astype(np.int32)}
    if name == "chstone_jpeg":
        m = mod("chstone.jpeg")
        image = m.make_image()
        words, _ = m.encode(np.stack([m._quantise(m._fdct(image[b]))
                                      for b in range(m.NB)]))
        pixels = m.golden_reference(words)[0]
        return {"pixels": pixels.reshape(m.NB, 64).astype(np.int32)}
    m = mod("chstone.dfkernels")
    if name == "chstone_dfsin":
        return {"acc": _split_pairs(m._sin_golden(m._sin_inputs()))}
    op = name[len("chstone_df"):]
    a, b = m._vectors(op)
    return {"z": _split_pairs(mod("chstone.df64").oracle_op(op, a, b))}


def _leaf(state, key):
    if key.endswith("[:8]"):
        return state[key[:-4]][:8]
    return state[key]


def assert_states_equal(port_np, ref_np):
    assert sorted(port_np) == sorted(ref_np)
    for k in ref_np:
        assert port_np[k].dtype == ref_np[k].dtype, k
        assert port_np[k].shape == ref_np[k].shape, k
        np.testing.assert_array_equal(port_np[k].view(np.uint32),
                                      ref_np[k].view(np.uint32), err_msg=k)


def check_init_image(name, ref):
    jr, tr = ref.region(name), REGISTRY[name]()
    assert list(tr.spec) == list(jr.spec)
    assert {k: v.unsigned for k, v in tr.spec.items()} == {
        k: np.asarray(v).dtype == np.uint32 for k, v in jr.init().items()}
    assert_states_equal(state_to_numpy(tr.init("cpu"), tr),
                        {k: np.asarray(v) for k, v in jr.init().items()})
    assert (tr.nominal_steps, tr.max_steps) == (jr.nominal_steps,
                                                 jr.max_steps)
    assert tr.meta["oracle"] == jr.meta["oracle"]


def check_dataflow(name, ref):
    from coast_tpu.passes.verification import analyze as janalyze
    want, got = janalyze(ref.region(name)), analyze(REGISTRY[name]())
    assert got.written == want.written
    assert got.load_addr == want.load_addr
    assert got.store_addr == want.store_addr
    assert got.deps == want.deps


def check_sections_and_schedule(name, strategy, ref):
    import coast_tpu
    from coast_tpu.inject.mem import MemoryMap as JMemoryMap
    from coast_tpu.inject.schedule import generate as jgenerate
    jprog = getattr(coast_tpu, strategy)(ref.region(name), fuse_step=True)
    tprog = getattr(ct, strategy)(REGISTRY[name](), device="cpu",
                                  fuse_step=True)
    assert tprog.leaf_order == jprog.leaf_order
    assert tprog.injectable_sections() == jprog.injectable_sections()
    assert tprog.replicated == jprog.replicated
    assert tprog.step_sync == jprog.step_sync
    assert tprog.pre_sync == jprog.pre_sync
    for field in ("done_leaves", "frozen_leaves", "bounded_scan",
                  "exact_dataflow"):
        assert getattr(tprog.fuse_plan_info, field) == getattr(
            jprog.fuse_plan_info, field), field
    assert tprog._fuse_plan is not None
    jmap, tmap = JMemoryMap(jprog), MemoryMap(tprog)
    assert tmap.total_bits == jmap.total_bits
    steps = ref.region(name).nominal_steps
    for seed in (0, SEED):
        a = jgenerate(jmap, 300, seed, steps)
        b = generate(tmap, 300, seed, steps)
        for col in ("leaf_id", "lane", "word", "bit", "t", "section_idx"):
            np.testing.assert_array_equal(getattr(b, col), getattr(a, col),
                                          err_msg=col)


def check_final_state(name, ref):
    region = REGISTRY[name]()
    final = region.run_unprotected(device="cpu")
    assert_states_equal(state_to_numpy(final, region), ref.final(name))
    one = {k: v.unsqueeze(0) for k, v in final.items()}
    assert int(region.check(one)[0]) == 0
    assert int(ref.region(name).check(ref.final(name))) == 0
    port_np = state_to_numpy(final, region)
    want = oracle(name, "coast_tpu_torch")
    for key, value in oracle(name, "coast_tpu").items():
        np.testing.assert_array_equal(want[key], value, err_msg=key)
        np.testing.assert_array_equal(_leaf(port_np, key), value,
                                      err_msg=key)


def check_campaign(name, strategy, ref):
    want = ref.campaign(name, strategy)
    got = ref.port_campaign(name, strategy)
    assert got.n == want.n == ROWS
    assert got.benchmark == want.benchmark == name
    for col in ("leaf_id", "lane", "word", "bit", "t"):
        np.testing.assert_array_equal(getattr(got.schedule, col),
                                      getattr(want.schedule, col))
    for col in COLUMNS:
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col),
                                      err_msg=col)
    assert got.counts == want.counts


def check_fused(name, strategy, ref):
    prog = getattr(ct, strategy)(REGISTRY[name](), device="cpu",
                                 fuse_step=True)
    assert prog._fuse_plan is not None          # integer leaves only
    fused = CampaignRunner(prog, strategy_name=strategy).run(
        ROWS, seed=SEED, batch_size=BATCH)
    base = ref.port_campaign(name, strategy)    # the unfused engine's
    for col in COLUMNS:
        np.testing.assert_array_equal(getattr(fused, col),
                                      getattr(base, col), err_msg=col)
    assert fused.counts == base.counts


# -- this file's names -----------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    return Results()


@pytest.mark.parametrize("name", NAMES)
def test_init_image_equal(name, ref):
    check_init_image(name, ref)


@pytest.mark.parametrize("name", NAMES)
def test_declared_dataflow_equals_reference_analysis(name, ref):
    check_dataflow(name, ref)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", NAMES)
def test_sections_schedule_and_plan_equal(name, strategy, ref):
    check_sections_and_schedule(name, strategy, ref)


@pytest.mark.parametrize("name", NAMES)
def test_fault_free_final_state_equals_reference_and_oracle(name, ref):
    check_final_state(name, ref)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", NAMES)
def test_campaign_parity(name, strategy, ref):
    check_campaign(name, strategy, ref)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", NAMES)
def test_fused_equals_unfused(name, strategy, ref):
    check_fused(name, strategy, ref)


def test_blowfish_published_vector():
    from coast_tpu_torch.models.chstone import blowfish as bf
    p, s = bf.key_schedule(bytes(8))
    assert bf._encrypt_block(p, s, 0, 0) == (0x4EF99745, 0x6198DD78)
    assert bf.pi_hex_words()[0] == 0x243F6A88     # Blowfish P[0]


def test_jpeg_reconstructs_the_image():
    """The decoded pixels reconstruct the encoder's input within the
    quantisation error: the decode is a real JPEG pipeline."""
    from coast_tpu_torch.models.chstone import jpeg
    region = REGISTRY["chstone_jpeg"]()
    got = region.run_unprotected(device="cpu")["pixels"].numpy()
    img = jpeg.make_image()
    assert np.abs(got.reshape(jpeg.NB, 8, 8) - img).mean() < 8.0


def test_launches_a_step_on_the_largest_sync_point(monkeypatch):
    """chstone_adpcm has the most leaves (17): 16 are replicated (``input``
    is read-only and shared), so its boundary vote is one K1 group of 16
    sites, ``MAX_SITES``, and its commit one of 14; a step makes one K1
    call a sync point (pre-step ``i``, commit, ``done()``'s ``i``)."""
    from coast_tpu_torch.ops import hopper_voters, site_table
    calls = []
    real = hopper_voters.vote_sites

    def counting(sites, n):
        calls.append(len(sites))
        return real(sites, n)

    monkeypatch.setattr(hopper_voters, "vote_sites", counting)
    prog = ct.TMR(REGISTRY["chstone_adpcm"](), device="cpu")
    pstate, flags = prog.init_pstate(2)
    prog.step(pstate, flags, 0)
    assert calls == [1, 14, 1]
    calls.clear()
    prog.boundary_votes(pstate)
    assert calls == [site_table.MAX_SITES] == [16]


# -- the index rules and unsigned words, against JAX -------------------------

EDGE_INDICES = (-2**31, -20, -6, -5, -3, -1, 0, 4, 5, 6, 17, 2**31 - 1)


@pytest.mark.parametrize("i", EDGE_INDICES)
def test_take_and_drop_rules_like_reference(i):
    import jax.numpy as jnp
    a = np.arange(5, dtype=np.int32) * 10 + 1
    au = np.arange(5, dtype=np.uint32) * np.uint32(0x40000001)
    ta = torch.from_numpy(a)[None]
    tau = torch.from_numpy(au.view(np.int32))[None]
    ti = torch.tensor([i], dtype=torch.int32)
    ji = jnp.int32(i)
    assert int(indexing.take_clip(ta, ti)[0]) == int(
        jnp.take(a, ji, mode="clip"))
    assert int(indexing.take_fill(ta, ti)[0]) == int(jnp.take(a, ji))
    assert np.uint32(int(indexing.take_fill(tau, ti, unsigned=True)[0])
                     & 0xFFFFFFFF) == np.asarray(jnp.take(au, ji))
    assert int(indexing.lookup(torch.from_numpy(a), ti)[0]) == int(
        jnp.asarray(a)[ji])
    assert int(indexing.row_select(ta, ti)[0]) == int(jnp.asarray(a)[ji])
    np.testing.assert_array_equal(
        indexing.update_drop(ta, ti, torch.tensor([-7],
                                                  dtype=torch.int32))[0],
        np.asarray(jnp.asarray(a).at[ji].set(-7, mode="drop")))
    # The vector forms: one row, every edge index at once.
    iv = np.asarray(EDGE_INDICES, np.int32)
    np.testing.assert_array_equal(
        indexing.take_clip(ta, torch.from_numpy(iv)[None])[0],
        np.asarray(jnp.take(a, iv, mode="clip")))
    np.testing.assert_array_equal(
        indexing.take_fill(ta, torch.from_numpy(iv)[None])[0],
        np.asarray(jnp.take(a, iv)))


@pytest.mark.parametrize("i0", (-4, -3, -1, 0, 2, 3, 9))
def test_update_drop_2d_like_reference(i0):
    import jax.numpy as jnp
    m = np.arange(12, dtype=np.int32).reshape(3, 4)
    for i1 in (-5, -4, -1, 0, 3, 4, 2**31 - 1):
        want = np.asarray(jnp.asarray(m).at[jnp.int32(i0),
                                            jnp.int32(i1)].set(
            -7, mode="drop"))
        got = indexing.update_drop(
            torch.from_numpy(m)[None],
            torch.tensor([[i0, i1]], dtype=torch.int32),
            torch.tensor([-7], dtype=torch.int32))[0]
        np.testing.assert_array_equal(got, want, err_msg=f"{i0}, {i1}")


WORDS = np.array([0, 1, 5, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xDEADBEEF,
                  0xFFFFFFFE, 0xFFFFFFFF, 0x12345678], np.uint32)
COUNTS = (0, 1, 5, 31, 32, 63, -1, 2**31 - 1)


@pytest.mark.parametrize("n", COUNTS)
def test_u32_shifts_like_reference(n):
    import jax.numpy as jnp
    x = torch.from_numpy(WORDS.view(np.int32))
    tn = torch.full(x.shape, n, dtype=torch.int32)
    un = jnp.uint32(n & 0xFFFFFFFF)
    for got in (u32.lsr(x, n), u32.lsr(x, tn)):
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(jnp.right_shift(WORDS, un)))
    signed = WORDS.view(np.int32)
    for got in (u32.sar(x, n), u32.sar(x, tn)):
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jnp.right_shift(signed, jnp.int32(n))))
    if 0 < n < 32:
        rot_l = (jnp.left_shift(WORDS, un)
                 | jnp.right_shift(WORDS, jnp.uint32(32 - n)))
        np.testing.assert_array_equal(u32.rotl(x, n).numpy().view(np.uint32),
                                      np.asarray(rot_l))
        rot_r = (jnp.right_shift(WORDS, un)
                 | jnp.left_shift(WORDS, jnp.uint32(32 - n)))
        np.testing.assert_array_equal(u32.rotr(x, n).numpy().view(np.uint32),
                                      np.asarray(rot_r))


def test_u32_compares_counts_and_products_like_reference():
    import jax
    import jax.numpy as jnp
    a = np.repeat(WORDS, len(WORDS))
    b = np.tile(WORDS, len(WORDS))
    ta = torch.from_numpy(a.view(np.int32))
    tb = torch.from_numpy(b.view(np.int32))
    np.testing.assert_array_equal(u32.ult(ta, tb).numpy(), a < b)
    np.testing.assert_array_equal(u32.ule(ta, tb).numpy(), a <= b)
    np.testing.assert_array_equal(
        u32.popcount(ta).numpy(),
        np.asarray(jax.lax.population_count(a)).astype(np.int32))
    np.testing.assert_array_equal(
        u32.clz(ta).numpy(), np.asarray(jax.lax.clz(a)).astype(np.int32))
    wide = a.astype(np.uint64) * b.astype(np.uint64)
    np.testing.assert_array_equal(
        u32.umulhi(ta, tb).numpy().view(np.uint32),
        (wide >> np.uint64(32)).astype(np.uint32))
    np.testing.assert_array_equal(
        u32.mullo(ta, tb).numpy().view(np.uint32),
        np.asarray(jnp.asarray(a) * jnp.asarray(b)))
    from coast_tpu.models import chstone_mips as jmips
    np.testing.assert_array_equal(
        u32.umulhi(ta, tb).numpy(),
        np.asarray(jmips._umulhi(jnp.asarray(a.view(np.int32)),
                                 jnp.asarray(b.view(np.int32)))))


@pytest.mark.parametrize("op", ["add", "mul", "div"])
def test_df64_equals_reference_soft_float(op):
    """The limb soft-float on seeded random patterns, the special-value
    matrix, subnormals and near-equal exponents: equal to the reference's
    ``df64`` (traced by JAX) and to numpy's IEEE float64."""
    import jax
    import jax.numpy as jnp
    from coast_tpu.models.chstone import df64 as jdf64
    from coast_tpu.models.chstone.dfkernels import _SPECIALS
    from coast_tpu_torch.models.chstone import df64
    rng = np.random.RandomState(7)
    rand = rng.randint(0, 2**64, (2, 1500), dtype=np.uint64)
    sub = rng.randint(0, 2**52, 300, dtype=np.uint64)
    near = ((rng.randint(1000, 1050, 300).astype(np.uint64) << np.uint64(52))
            | rng.randint(0, 2**52, 300, dtype=np.uint64))
    a = np.concatenate([rand[0], np.repeat(_SPECIALS, len(_SPECIALS)),
                        sub, near, near])
    b = np.concatenate([rand[1], np.tile(_SPECIALS, len(_SPECIALS)),
                        near, sub, near[::-1]])
    ah, al = jdf64.split_bits(a)
    bh, bl = jdf64.split_bits(b)
    zh, zl = jax.jit(jax.vmap(getattr(jdf64, f"f64_{op}")))(
        *(jnp.asarray(x) for x in (ah, al, bh, bl)))
    want = jdf64.join_bits(np.asarray(zh), np.asarray(zl))
    th, tl = getattr(df64, f"f64_{op}")(*(
        u32.wide(torch.from_numpy(x.view(np.int32)))
        for x in (ah, al, bh, bl)))
    got = jdf64.join_bits(th.numpy().astype(np.uint32),
                          tl.numpy().astype(np.uint32))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, df64.oracle_op(op, a, b))
