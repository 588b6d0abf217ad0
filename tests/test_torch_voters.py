"""The PyTorch port's voters against the JAX reference voters.

The port's plain ``vote`` (``coast_tpu_torch/ops/voters.py``) must give
bit-equal voted words and flags to ``coast_tpu.ops.voters.tmr_vote`` /
``dwc_check`` on the same seeded replica sets: int32, uint32 and float32
words, single-lane flips, +-0 and NaN.  The Hopper kernel K1
(``ops/hopper_voters.py``) is held against the plain version on the card by
the tests marked ``cuda``, which skip on a host without one.  The card's
machine has no JAX, so the reference is imported where it is used; there
the kernel tests run alone:

    python -m pytest tests/test_torch_voters.py -m cuda --noconftest -q

The grouped form (``vote_sites``: every replica set of one sync point in
one launch, flags as an int32 ``[S, R]`` block) is held to the reference
site by site: mixed widths, dtypes, windows and DWC flags-only checks.
"""

import itertools
import pathlib
import re

import numpy as np
import pytest
import torch

from coast_tpu_torch.ops import hopper_voters, site_table, voters
from coast_tpu_torch.ops.voters import Site

# The suite runs under xdist, several workers to a host: one intra-op
# thread per worker keeps torch from oversubscribing the cores.
torch.set_num_threads(1)


def replica_set(seed, rows, n, width, dtype):
    """Seeded [rows, n, width]: equal lanes, a one-lane flip in every odd
    row, and for float32 +0/-0 pairs and NaN in every fourth row."""
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        base = rng.standard_normal((rows, width)).astype(np.float32)
    else:
        base = rng.integers(0, 2**32, (rows, width), dtype=np.uint64
                            ).astype(np.uint32).view(dtype)
    lanes = np.repeat(base[:, None, :], n, axis=1)
    bits = lanes.view(np.uint32)
    for r in range(1, rows, 2):
        bits[r, rng.integers(n), rng.integers(width)] ^= np.uint32(
            1 << int(rng.integers(32)))
    if dtype == np.float32:
        for r in range(0, rows, 4):
            w = int(rng.integers(width))
            lanes[r, :, w] = 0.0
            lanes[r, 1, w] = -0.0
            if r % 8 == 0:
                lanes[r, :, (w + 1) % width] = np.nan
    return lanes


def to_port(arr):
    """numpy replica set -> torch (uint32 carried as int32 bits)."""
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(arr))


def reference(arr, n):
    import jax
    import jax.numpy as jnp
    from coast_tpu.ops import voters as jvoters
    fn = jvoters.tmr_vote if n == 3 else jvoters.dwc_check
    voted, mis = jax.vmap(fn)(jnp.asarray(arr))
    return np.asarray(voted), np.asarray(mis)


def bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.uint32)


@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32])
@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("width", [1, 81, 1029])
def test_plain_vote_bit_equal_to_reference(dtype, n, width):
    arr = replica_set(width * 10 + n, 16, n, width, dtype)
    ref_voted, ref_mis = reference(arr, n)
    voted, mis = voters.vote(to_port(arr), n)
    np.testing.assert_array_equal(bits(voted), bits(ref_voted))
    np.testing.assert_array_equal(mis.numpy(), ref_mis)
    # The flags are the point: every odd row has a flipped lane.
    assert ref_mis[1::2].all()


def test_float_specials_follow_ieee():
    # +0 and -0 agree, NaN never does -- the reference compares in the
    # leaf dtype, not bitwise.
    arr = np.zeros((2, 3, 2), np.float32)
    arr[0, 1, 0] = -0.0
    arr[1, :, 1] = np.nan
    voted, mis = voters.vote(to_port(arr), 3)
    assert mis.tolist() == [False, True]
    assert bits(voted)[0, 0] == 0          # lanes 0 and 1 agree: lane 0
    ref_voted, ref_mis = reference(arr, 3)
    np.testing.assert_array_equal(bits(voted), bits(ref_voted))
    np.testing.assert_array_equal(mis.numpy(), ref_mis)


def test_subnormals_compare_exactly_unlike_the_xla_cpu_reference():
    # The name records the divergence this test once pinned (ROADMAP
    # Queue C): the reference's compare reads subnormal operands as zero
    # (XLA flushes them on the CPU, as the TPU does), and the port's voters
    # now do the same, so a mantissa flip of a zero word agrees.  The voted
    # word keeps its raw bits.
    arr = np.zeros((5, 3, 4), np.float32)
    words = arr.view(np.uint32)
    words[0, 1, 2] = 1 << 14                 # bit 14 of +0.0 in lane 1
    words[1, 0, 1] = 7                       # lane 0 subnormal: voted raw
    words[2, 2, 3] = 0x80000001              # -subnormal in lane 2
    words[3, 0, 0], words[3, 1, 0] = 0x00000300, 0x80000005   # two of them
    words[4, 1, 3] = 0x00800000              # the smallest normal differs
    for n in (2, 3):
        ref_voted, ref_mis = reference(arr[:, :n], n)
        voted, mis = voters.vote(to_port(arr[:, :n]), n)
        np.testing.assert_array_equal(bits(voted), bits(ref_voted))
        np.testing.assert_array_equal(mis.numpy(), ref_mis)
    assert ref_mis.tolist() == [False, False, False, False, True]
    assert bits(ref_voted)[1, 1] == 7 and bits(ref_voted)[3, 0] == 0x300


@pytest.mark.parametrize("n", [2, 3])
def test_window_matches_reference_per_row_slices(n):
    arr = replica_set(7, 8, n, 300, np.float32)
    width = 64
    offs = np.random.default_rng(3).integers(0, 300 - width + 1, 8)
    offs[:3] = (-5, 290, 2**31 - 1)      # starts clamp into the lane
    voted, mis = hopper_voters.vote_window(
        to_port(arr), torch.from_numpy(offs.astype(np.int32)), width, n)
    for r, o in enumerate(offs):
        o = min(max(int(o), 0), 300 - width)
        ref_voted, ref_mis = reference(arr[r:r + 1, :, o:o + width], n)
        np.testing.assert_array_equal(bits(voted[r:r + 1]), bits(ref_voted))
        assert bool(mis[r]) == bool(ref_mis[0])


def test_wrapper_takes_the_plain_version_only_for_cpu_tensors():
    arr = to_port(replica_set(11, 4, 3, 33, np.int32))
    before = hopper_voters.LAUNCHES
    voted, mis = hopper_voters.vote(arr, 3)
    pv, pm = voters.vote(arr, 3)
    assert torch.equal(voted, pv) and torch.equal(mis, pm)
    assert hopper_voters.LAUNCHES == before      # no kernel ran
    with pytest.raises(ValueError):
        voters.vote(arr, 4)


# ---------------------------------------------------------------------------
# grouped votes: one call per sync point
# ---------------------------------------------------------------------------

ROWS = 8


def mixed_group(seed, n):
    """A seeded group of sites as one sync point gives them: a scalar, a
    13-word and a 9x9 leaf, a 300-word lane (the kernel's tile path), a
    64-word window of it at clamped per-row offsets, int32/uint32/float32
    words, and DWC flags-only checks beside a written DWC copy.  Returns
    (numpy replica sets, sites)."""
    shapes = [((), np.int32), ((13,), np.float32), ((9, 9), np.uint32),
              ((300,), np.float32), ((300,), np.int32)]
    arrays, sites = [], []
    for j, (shape, dtype) in enumerate(shapes):
        width = int(np.prod(shape, dtype=np.int64))
        arr = replica_set(seed * 10 + j, ROWS, n, width, dtype).reshape(
            (ROWS, n) + shape)
        arrays.append(arr)
        sites.append(Site(to_port(arr), copy=bool(j % 2)))
    offs = np.random.default_rng(seed).integers(0, 300 - 64 + 1, ROWS)
    offs[:3] = (-5, 290, 2**31 - 1)
    arrays.append((arrays[-1], offs))
    sites.append(Site(sites[-1].lanes, torch.from_numpy(offs.astype(np.int32)),
                      64, copy=n == 2 and seed % 2 == 0))
    return arrays, sites


def reference_site(arr, n, width=64):
    """The reference voter over one site, windows cut out row by row."""
    if isinstance(arr, tuple):
        arr, offs = arr
        cut = np.stack([arr[r, :, min(max(int(o), 0), arr.shape[2] - width):]
                        [:, :width] for r, o in enumerate(offs)])
        return reference(cut, n)
    return reference(arr, n)


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("n", [2, 3])
def test_vote_sites_bit_equal_to_reference_per_site(n, seed):
    arrays, sites = mixed_group(seed, n)
    before = hopper_voters.LAUNCHES
    voted, flags = hopper_voters.vote_sites(sites, n)
    assert hopper_voters.LAUNCHES == before       # CPU: the plain version
    assert flags.dtype == torch.int32 and flags.shape == (len(sites), ROWS)
    for s, (arr, site, got) in enumerate(zip(arrays, sites, voted)):
        ref_voted, ref_mis = reference_site(arr, n)
        np.testing.assert_array_equal(flags[s].numpy(), ref_mis.astype(
            np.int32), err_msg=f"site {s}")
        if n == 2 and not site.copy:
            if site.offsets is None:       # flags only: the lane-0 view
                assert got.data_ptr() == site.lanes[:, 0].data_ptr()
            else:
                assert got is None
                continue
        elif n == 2:
            assert got.data_ptr() != site.lanes.data_ptr()
        np.testing.assert_array_equal(bits(got), bits(ref_voted).reshape(
            bits(got).shape), err_msg=f"site {s}")
    # Every odd row carries a flipped lane in every whole-leaf site.
    assert flags[:5, 1::2].all()


def test_site_record_matches_the_cuda_struct():
    """``site_table.SITE`` packs ``coast::Site`` of ``csrc/vote_word.cuh``
    field for field: the header is the one source of the layout."""
    header = (pathlib.Path(site_table.__file__).parent.parent / "csrc"
              / "vote_word.cuh").read_text()
    body = re.search(r"struct Site \{(.*?)\};", header, re.S).group(1)
    lines = [line.split("//")[0].strip() for line in body.splitlines()]
    decls = [line for line in lines if line]
    assert [d.rstrip(";").split()[-1].lstrip("*") for d in decls] == [
        "src", "mask", "out", "voted", "offsets", "flag", "width",
        "lane_stride", "row_stride", "tiles", "first_block", "is_float",
        "group"]
    code = {"int": "i", "long": "q"}          # pointers pack as "Q"
    fmt = "".join("Q" if "*" in d else code[d.split()[0]] for d in decls)
    assert struct_format(fmt) == site_table.SITE.format
    assert site_table.SITE.size == 96 and "sizeof(Site) == 96" in header
    assert f"kMaxSites = {site_table.MAX_SITES};" in header


def struct_format(codes):
    """"QQi" -> "<2Q1i": run-length form of a struct code string."""
    return "<" + "".join(f"{len(list(g))}{c}"
                         for c, g in itertools.groupby(codes))


def test_output_buffer_is_one_allocation_carved_at_16_bytes():
    out = site_table.Buffer(3 * 5)
    a = out.take(7)
    b = out.take(4)
    assert (a, b) == (16, 24) and out.words == 28
    out.allocate(torch.device("cpu"))
    flags = out.flags(3, 5)
    x = out.view((7,), a, torch.int32)
    y = out.view((2, 2), b, torch.float32)
    assert flags.shape == (3, 5) and y.dtype == torch.float32
    for t in (flags, x, y):
        assert t.untyped_storage().data_ptr() == out.buf.data_ptr()
        assert t.is_contiguous()
        assert (t.data_ptr() - out.buf.data_ptr()) % 16 == 0


def test_wrapper_checks_refuse_what_the_kernel_does_not_take():
    lanes = torch.zeros((4, 3, 8), dtype=torch.int32)
    cpu = torch.device("cpu")
    with pytest.raises(ValueError):
        site_table.check_group("K1", 17, 3)            # over 16 sites
    with pytest.raises(ValueError):
        site_table.check_group("K1", 0, 3)
    with pytest.raises(ValueError):
        site_table.check_group("K1", 2, 4)
    with pytest.raises(ValueError):                    # not a CUDA tensor
        site_table.check_lanes("K1", lanes, 3, cpu, 4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host; K1 runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("width", [1, 81, 131072 + 3])
def test_kernel_bit_equal_to_plain_on_card(cuda, dtype, n, width):
    lanes = to_port(replica_set(width + n, 8, n, width, dtype)).to(cuda)
    before = hopper_voters.LAUNCHES
    kv, km = hopper_voters.vote(lanes, n)
    pv, pm = voters.vote(lanes, n)
    assert hopper_voters.LAUNCHES == before + 1
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))
    assert torch.equal(km, pm)
    width_w = max(1, width // 3)
    offs = torch.arange(8, dtype=torch.int32, device=cuda) % (
        width - width_w + 1)
    offs[:2] = torch.tensor([-7, width], dtype=torch.int32)   # clamp
    kv, km = hopper_voters.vote_window(lanes, offs, width_w, n)
    pv, pm = voters.vote(voters.window(lanes, offs, width_w), n)
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))
    assert torch.equal(km, pm)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    lanes = torch.zeros((4, 3, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        hopper_voters.vote(lanes.to(torch.int64), 3)
    with pytest.raises(ValueError):
        hopper_voters.vote(lanes, 2)                 # n != num_clones
    strided = torch.zeros((4, 8, 3), dtype=torch.int32,
                          device=cuda).permute(0, 2, 1)
    with pytest.raises(ValueError):
        hopper_voters.vote(strided, 3)               # not contiguous


def card_group(cuda, n):
    """The seeded mixed group on the card, plus a site wide enough for
    several tiles a row (131075 words, unaligned lanes)."""
    _, sites = mixed_group(6 + n, n)
    sites = [Site(s.lanes.to(cuda), None if s.offsets is None
                  else s.offsets.to(cuda), s.width, s.copy) for s in sites]
    wide = to_port(replica_set(9, ROWS, n, 131072 + 3, np.float32)).to(cuda)
    sites.insert(2, Site(wide, copy=True))
    offs = torch.arange(ROWS, dtype=torch.int32, device=cuda) * 4099 - 3
    sites.append(Site(wide, offs, 40000, copy=True))
    return sites


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3])
def test_grouped_kernel_bit_equal_to_plain_on_card(cuda, n):
    sites = card_group(cuda, n)
    before = hopper_voters.LAUNCHES
    voted, flags = hopper_voters.vote_sites(sites, n)
    assert hopper_voters.LAUNCHES == before + 1
    p_voted, p_flags = voters.vote_sites(sites, n)
    assert torch.equal(flags, p_flags)
    for got, want in zip(voted, p_voted):
        assert (got is None) == (want is None)
        if got is not None:
            assert got.shape == want.shape and got.dtype == want.dtype
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_grouped_kernel_refuses_bad_tables(cuda):
    lanes = torch.zeros((4, 3, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        hopper_voters.vote_sites([Site(lanes)] * 17, 3)
    with pytest.raises(ValueError):                       # R differs
        hopper_voters.vote_sites([Site(lanes), Site(lanes[:2])], 3)
    with pytest.raises(ValueError):                       # n differs
        hopper_voters.vote_sites([Site(lanes), Site(lanes[:, :2])], 3)
    with pytest.raises(ValueError):                       # a CPU site
        hopper_voters.vote_sites([Site(lanes), Site(lanes.cpu())], 3)
    with pytest.raises(TypeError):
        hopper_voters.vote_sites([Site(lanes), Site(lanes.long())], 3)
    with pytest.raises(ValueError):                       # bad window
        hopper_voters.vote_sites([Site(lanes, torch.zeros(
            4, dtype=torch.int32, device=cuda), 9)], 3)
