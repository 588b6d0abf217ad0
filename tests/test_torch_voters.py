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
"""

import numpy as np
import pytest
import torch

from coast_tpu_torch.ops import hopper_voters, voters

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
