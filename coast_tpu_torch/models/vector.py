"""simd and scalarize: the vector-dataflow benchmarks as torch regions.

The counterpart of ``coast_tpu/models/vector.py`` (simd.c and
tests/scalarize/): regions whose leaves are whole vectors updated each
step, so every vote is an elementwise compare of a vector.

* ``simd``: 16 uint32 lanes (int32 words here), 64 steps of add with the
  vector rolled by one, a rotate left by 7 and an XOR with the step.
* ``scalarize``: an f32 x 8 axpy chain, 48 steps of ``y = a * x + y``
  and ``x = 0.75 * x``.  The product and the sum are two operators (the
  port rounds twice, on either device).  Its initial ``x`` is the f32
  words of ``jnp.linspace(0.1, 1.0, 8)`` as the reference's programs
  compute it (under ``jit``; word 1 is one ulp above the eager
  ``jnp.linspace``'s), carried as a word table: ``torch.linspace`` and
  ``np.linspace`` round other words differently.  The golden starts
  from ``np.linspace``, as the reference's does, and the check has the
  reference's 1e-4 tolerance.  :func:`order_sensitive` names the flips
  whose records may differ from the reference's.

Their block graphs (``graph``, read by CFCSS) are the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from coast_tpu_torch.interop import state_from_numpy
from coast_tpu_torch.ir.graph import loop_graph
from coast_tpu_torch.ir.region import KIND_CTRL, KIND_MEM, LeafSpec, Region
from coast_tpu_torch.models.common import Consts
from coast_tpu_torch.ops.u32 import const, lsr
from coast_tpu_torch.passes.verification import RegionDataflow

W = 16
N_STEPS = 64
FW = 8
F_STEPS = 48

# jnp.linspace(0.1, 1.0, 8, dtype=float32) under jit, word for word.
X0_BITS = (0x3DCCCCCD, 0x3E6A0EA2, 0x3EB6DB6E, 0x3EF8AF8C,
           0x3F1D41D4, 0x3F3E2BE3, 0x3F5F15F2, 0x3F800000)
A = 1.0009765625          # exactly representable in f32
MANTISSA_BITS = 23

# Each equal to the reference's analyze() (pinned in
# tests/test_torch_corpus.py and tests/test_torch_corpus_float.py).
SIMD_DATAFLOW = RegionDataflow(
    written=frozenset({"i", "v"}),
    deps={"v": frozenset({"v"}), "i": frozenset({"i"})})
SCALARIZE_DATAFLOW = RegionDataflow(
    written=frozenset({"i", "x", "y"}),
    deps={"x": frozenset({"x"}), "y": frozenset({"x", "y"}),
          "i": frozenset({"i"})})


def _simd_golden() -> np.ndarray:
    v = np.arange(W, dtype=np.uint64) * 2654435761 % (1 << 32)
    k = np.uint64(0x9E3779B9)
    for t in range(N_STEPS):
        v = (v + np.roll(v, 1) + k) % (1 << 32)
        v = ((v << np.uint64(7)) | (v >> np.uint64(25))) % (1 << 32)
        v = v ^ np.uint64(t)
    return v.astype(np.uint32)


def make_simd_region() -> Region:
    golden = _simd_golden()
    init_v = (np.arange(W, dtype=np.uint64) * 2654435761
              % (1 << 32)).astype(np.uint32)
    image = {"v": init_v, "i": np.int32(0)}
    consts = Consts(golden=golden)

    def init(device):
        return state_from_numpy(image, device)

    def step(state, t):
        v = state["v"]
        v = v + torch.roll(v, 1, dims=1) + const(0x9E3779B9)
        v = (v << 7) | lsr(v, 25)
        return {"v": v ^ t, "i": state["i"] + 1}

    def done(state):
        return state["i"] >= N_STEPS

    def check(state):
        want = consts.on(state["v"].device).golden
        return (state["v"] != want).sum(dim=1).to(torch.int32)

    return Region(
        name="simd",
        init=init,
        step=step,
        done=done,
        check=check,
        output=lambda s: s["v"],
        nominal_steps=N_STEPS,
        max_steps=N_STEPS + 8,
        spec={"v": LeafSpec(KIND_MEM, unsigned=True),
              "i": LeafSpec(KIND_CTRL)},
        default_xmr=True,
        graph=loop_graph("vloop", "i", N_STEPS),
        meta={"dataflow": SIMD_DATAFLOW},
    )


def _scalarize_golden() -> np.ndarray:
    x = np.linspace(0.1, 1.0, FW).astype(np.float32)
    y = np.ones(FW, np.float32)
    a = np.float32(A)
    for _ in range(F_STEPS):
        y = np.float32(a) * x + y
        x = np.float32(0.75) * x
    return np.concatenate([x, y])


def make_scalarize_region() -> Region:
    golden = _scalarize_golden()
    image = {"x": np.asarray(X0_BITS, np.uint32).view(np.float32),
             "y": np.ones(FW, np.float32), "i": np.int32(0)}
    consts = Consts(golden=golden)

    def init(device):
        return state_from_numpy(image, device)

    def step(state, t):
        x = state["x"]
        y = A * x + state["y"]
        return {"x": 0.75 * x, "y": y, "i": state["i"] + 1}

    def done(state):
        return state["i"] >= F_STEPS

    def check(state):
        got = torch.cat([state["x"], state["y"]], dim=1)
        want = consts.on(got.device).golden
        return ((got - want).abs() > 1e-4).sum(dim=1).to(torch.int32)

    return Region(
        name="scalarize",
        init=init,
        step=step,
        done=done,
        check=check,
        output=lambda s: torch.cat([s["x"], s["y"]], dim=1).view(
            torch.int32),
        nominal_steps=F_STEPS,
        max_steps=F_STEPS + 8,
        spec={"x": LeafSpec(KIND_MEM), "y": LeafSpec(KIND_MEM),
              "i": LeafSpec(KIND_CTRL)},
        default_xmr=True,
        graph=loop_graph("axpy", "i", F_STEPS),
        meta={"dataflow": SCALARIZE_DATAFLOW},
    )


def order_sensitive(leaf_order, leaf_id: np.ndarray,
                    bit: np.ndarray) -> np.ndarray:
    """Rows of a scalarize schedule whose record may legitimately differ
    between frameworks: a flip below the f32 exponent of ``x`` or ``y``.
    XLA contracts the batched step's ``a * x + y`` into one fused
    multiply-add (one rounding) where the port rounds the product and the
    sum, and whether a perturbation that small survives the sum's
    rounding (so a second vote repairs ``y``) depends on which."""
    ids = [leaf_order.index(n) for n in ("x", "y") if n in leaf_order]
    return np.isin(np.asarray(leaf_id), ids) & (np.asarray(bit)
                                                < MANTISSA_BITS)
