"""The vote bytes at one hand-computed site, and the kernel grouping."""

import numpy as np

from perfbench import kernels, roofline
from perfbench.reference import mm

# A vote of W words: 3 W words read, W written, one flag word: 16 W + 4 B.
I_OR_PHASE = 16 * 1 + 4        # 20
RESULTS_9 = 16 * 81 + 4        # 1,300
ACC_9 = 16 * 9 + 4             # 148
TRIP_9 = I_OR_PHASE + RESULTS_9 + 2 * I_OR_PHASE   # pre i; results, i, phase
BOUNDARY_9 = 3 * RESULTS_9 + ACC_9 + 2 * I_OR_PHASE  # first/second/results


def test_mm9_unfused_one_row():
    got = roofline.campaign_bytes(mm.make(9), False, np.array([18]))
    assert got == {kernels.K1: 18 * TRIP_9 + BOUNDARY_9, kernels.K2: 0}
    assert 18 * TRIP_9 + BOUNDARY_9 == 28568


def test_mm9_fused_moves_the_repaired_votes_to_k2():
    got = roofline.campaign_bytes(mm.make(9), True, np.array([18, 10]))
    assert got == {kernels.K1: 2 * BOUNDARY_9, kernels.K2: 28 * TRIP_9}


def test_mm1024_store_window_counts_only_store_steps():
    region = mm.make(1024, 128, "f32", "bf16")
    window = 16 * 128 * 1024 + 4
    leaf = 16 * 1024 * 1024 + 4
    boundary = 3 * leaf + (16 * 128 * 1024 + 4) + 2 * I_OR_PHASE
    got = roofline.campaign_bytes(region, False, np.array([16]))
    assert got[kernels.K1] == 16 * 3 * I_OR_PHASE + 8 * window + boundary
    assert got[kernels.K2] == 0


def test_share():
    assert roofline.share_pct(3.35e12, 2.0) == 50.0
    assert roofline.share_pct(1.0, 0.0) is None


def test_kernel_names_by_layer():
    assert kernels.layer_of("void vote_kernel<3>(coast::Site const*)") == \
        kernels.K1
    assert kernels.layer_of("commit_kernel<3>") == kernels.K2
    assert kernels.layer_of("sm90_xmma_gemm_f32f32_tf32f32_f32") == \
        kernels.GEMM
    assert kernels.layer_of("Memcpy DtoH (Device -> Pageable)") == \
        kernels.MEMCPY
    assert kernels.layer_of(
        "void at::native::vectorized_elementwise_kernel<4>") == \
        kernels.ELEMENTWISE
