"""train_mlp: a protected training step as a multi-phase region.

The counterpart of ``coast_tpu/train/mlp.py``.  A 2-layer f32 MLP (6 -> 8
-> 4, full batch of 8 samples) trained for ``ITERS`` iterations; each
iteration is three protected micro-steps, the region's phases:

    phase 0 (fwd):    loss <- MSE(forward(params, x), y); the loss monitor
                      compares it with the golden loss trajectory.
    phase 1 (bwd):    grads <- ``grad_step``, the gradient taken inside the
                      lanes: one ``torch.func.grad`` a row of the ``[R, ...]``
                      arguments (``torch.func.vmap``).  Under full TMR
                      every replica differentiates its own copy; under
                      :func:`selective_xmr` the sub-function is
                      ``-skipLibCalls``-scoped and runs once, on lane 0.
    phase 2 (commit): the optimizer update (SGD with momentum, or Adam) on
                      the parameter and optimizer-state leaves; the
                      region's ``store_slice`` hints gate their votes to
                      this phase.

Parameters are ``KIND_PARAM``, optimizer state ``KIND_OPT_STATE``, the data
``KIND_RO``, the live loss and gradients ``KIND_REG`` registers, the
iteration and phase counters and the loss monitor ``KIND_CTRL``.

**The golden trajectory** is this port's own: the final parameters of the
engine's fault-free unprotected run of the region built without a golden,
on the device the region's image is made for (``init(device)``), and the
per-iteration losses of the same fault-free program.  ``check()`` compares
the final weights bit for bit with the golden leaves, so the golden must
come from the device and the program that runs the campaign: it is cached
per optimizer and device (:func:`golden`).  ``train_probe`` splits a
weight SDC into a transient loss perturbation the training absorbed
(re-converged for the final ``HEAL_WINDOW`` iterations) and a persistent
divergence.

The image, the hyper-parameters, Adam's bias-correction power tables (a
table, as the reference keeps them, not ``torch.pow``), the operator order
of every update and the analytic FLOPs are the reference's; the float
results agree with it within rounding.  The products and sums run in a
fixed order through elementwise ops only (:func:`_mm`, whose gradient
:class:`_Affine` gives in the same form), and Adam's divisions and square
root are correctly rounded (:func:`_div`, :func:`_sqrt`), so a row's bits
do not depend on the batch's row count, and the card and the host give
the same bits.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from coast_tpu_torch import device as device_mod
from coast_tpu_torch.interop import state_from_numpy
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_OPT_STATE, KIND_PARAM,
                                       KIND_REG, KIND_RO, LeafSpec, Region,
                                       rows)
from coast_tpu_torch.models.common import Consts, lcg_words
from coast_tpu_torch.ops.indexing import lookup, take_clip
from coast_tpu_torch.passes.verification import RegionDataflow

# Model and data geometry.
B, IN, HID, OUT = 8, 6, 8, 4
ITERS = 12
PHASES = 3
FWD, BWD, COMMIT = 0, 1, 2
SEED = 7

# Optimizer hyper-parameters.
LR = 0.05
MOMENTUM = 0.9
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

# Adam's bias-correction powers B^(it+1), an f32 table indexed by the
# iteration.
_ADAM_B1_POW = np.cumprod(np.full(64, ADAM_B1, np.float64)).astype(np.float32)
_ADAM_B2_POW = np.cumprod(np.full(64, ADAM_B2, np.float64)).astype(np.float32)
_POWERS = Consts(b1=_ADAM_B1_POW, b2=_ADAM_B2_POW)

# Loss-trajectory monitor: "self-healed" means the loss stayed within TOL
# of the golden trajectory for the final HEAL_WINDOW iterations.
TOL_REL = 0.10
TOL_ABS = 1e-3
HEAL_WINDOW = 3

_PARAM_NAMES = ("w1", "b1", "w2", "b2")
_PARAM_SHAPES = {"w1": (IN, HID), "b1": (HID,),
                 "w2": (HID, OUT), "b2": (OUT,)}


def _f32_fill(seed: int, shape, scale: float) -> np.ndarray:
    """Deterministic f32 values in [-scale, scale) from the shared LCG: the
    reference's bits."""
    n = int(np.prod(shape))
    raw = lcg_words(seed, n).astype(np.float32)     # 15-bit ints
    vals = (raw / 16384.0 - 1.0) * scale
    return np.asarray(vals.reshape(shape), np.float32)


def _mm(a, b):
    """``a [..., M, K] @ b [..., K, N]`` in a fixed order: k ascending, one
    rounded product and one rounded sum a term.  Only elementwise ops, so
    every row gets the same bits whatever the number of rows, on the card
    and on the host (a library product or reduction may pick another
    summation order for another batch count, and ``check()`` compares
    weights bit for bit)."""
    out = a[..., :, :1] * b[..., :1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return out


def _sum_rows(a):
    """``a [..., M, N]`` summed over M, in order."""
    out = a[..., 0, :]
    for i in range(1, a.shape[-2]):
        out = out + a[..., i, :]
    return out


def _div(a, b):
    """``a / b`` correctly rounded on any device: the f64 quotient of two
    f32 values rounds to the f32 one (53 >= 2 * 24 + 2 bits)."""
    return (a.double() / b.double()).float()


def _sqrt(a):
    """``sqrt(a)`` correctly rounded on any device, as :func:`_div`: the
    card's f32 ``torch.sqrt`` differs from the host's in the last bit."""
    return torch.sqrt(a.double()).float()


class _Affine(torch.autograd.Function):
    """``x @ w + b`` forward and backward through :func:`_mm` and
    :func:`_sum_rows` (no library product or reduction on either side)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, w, b):
        return _mm(x, w) + b

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, _ = inputs
        ctx.save_for_backward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = (_mm(g, w.transpose(-1, -2)) if ctx.needs_input_grad[0]
              else None)
        return gx, _mm(x.transpose(-1, -2), g), _sum_rows(g)


def _forward_loss(w1, b1, w2, b2, x, y):
    """MSE of the 2-layer relu MLP for ONE row (unbatched arguments): the
    loss of the fwd phase, of ``grad_step`` and of the golden run."""
    h = torch.relu(_Affine.apply(x, w1, b1))
    d = _Affine.apply(h, w2, b2) - y
    per_out = _sum_rows(d * d)
    total = per_out[..., 0]
    for j in range(1, OUT):
        total = total + per_out[..., j]
    return total / (B * OUT)


_loss_rows = torch.func.vmap(_forward_loss)
_grad_rows = torch.func.vmap(torch.func.grad(_forward_loss,
                                             argnums=(0, 1, 2, 3)))


def grad_step(w1, b1, w2, b2, x, y):
    """Backward pass: the gradients of every row's loss w.r.t. its
    parameters, one ``torch.func.grad`` a row of the ``[R, ...]``
    arguments.  A named sub-function, so the engine can scope it:
    replicated (full TMR differentiates per lane) or ``-skipLibCalls``
    (selective xMR computes it once)."""
    return _grad_rows(w1, b1, w2, b2, x, y)


def _opt_leaf_names(optimizer: str) -> Tuple[str, ...]:
    names = tuple(f"m_{p}" for p in _PARAM_NAMES)
    if optimizer == "adam":
        names += tuple(f"v_{p}" for p in _PARAM_NAMES)
    return names


def _image(optimizer: str, gold) -> Dict[str, np.ndarray]:
    """The region's init image: the reference's, the golden leaves from
    ``gold`` (None: zeros, the proto build the golden run uses)."""
    f32 = np.float32
    params = {
        name: _f32_fill(SEED + 2 + i, shape,
                        0.5 / float(np.sqrt(shape[0] if len(shape) > 1
                                            else HID)))
        for i, (name, shape) in enumerate(_PARAM_SHAPES.items())}
    image = {
        **params,
        "x": _f32_fill(SEED, (B, IN), 1.0),
        "y": _f32_fill(SEED + 1, (B, OUT), 1.0),
        **{f"g_{n}": (np.asarray(gold["params"][n], f32) if gold
                      else np.zeros(_PARAM_SHAPES[n], f32))
           for n in _PARAM_NAMES},
        "g_loss": (np.asarray(gold["losses"], f32) if gold
                   else np.zeros(ITERS, f32)),
        **{f"gr_{n}": np.zeros(_PARAM_SHAPES[n], f32) for n in _PARAM_NAMES},
        **{f"m_{n}": np.zeros(_PARAM_SHAPES[n], f32) for n in _PARAM_NAMES},
        "loss": f32(0),
        "it": np.int32(0),
        "phase": np.int32(0),
        "heal": np.int32(0),
        "dev": np.int32(0),
    }
    if optimizer == "adam":
        image.update({f"v_{n}": np.zeros(_PARAM_SHAPES[n], f32)
                      for n in _PARAM_NAMES})
    return image


def _dataflow(optimizer: str) -> RegionDataflow:
    """The reference's analyze() of the region (pinned in
    tests/test_torch_train.py)."""
    fwd = frozenset({"b1", "b2", "phase", "w1", "w2", "x", "y"})
    monitor = fwd | {"g_loss", "heal", "it", "loss"}
    deps = {n: frozenset({n}) for n in ("phase", "x", "y", "g_loss",
                                        *(f"g_{p}" for p in _PARAM_NAMES))}
    deps.update({"loss": fwd | {"loss"}, "heal": monitor,
                 "dev": monitor | {"dev"}, "it": monitor | {"dev"}})
    commit = (monitor | {"dev"}) if optimizer == "adam" else fwd
    for p in _PARAM_NAMES:
        deps[f"gr_{p}"] = fwd | {f"gr_{p}"}
        state = {f"gr_{p}", f"m_{p}"}
        if optimizer == "adam":
            state.add(f"v_{p}")
            deps[f"v_{p}"] = fwd | {f"gr_{p}", f"v_{p}"}
        deps[p] = deps[f"m_{p}"] = commit | state
    written = {"dev", "heal", "it", "loss", "phase",
               *(f"{k}{p}" for k in ("", "gr_", "m_") for p in _PARAM_NAMES)}
    if optimizer == "adam":
        written.update(f"v_{p}" for p in _PARAM_NAMES)
    return RegionDataflow(
        written=frozenset(written), deps=deps,
        load_addr=(monitor | {"dev"}) if optimizer == "adam"
        else frozenset({"it"}))


def _build(optimizer: str, gold_of) -> Region:
    """The region; ``gold_of(device)`` gives the golden ``{params,
    losses}`` for an image on that device (None: the proto build the
    golden run uses, whose golden leaves are zeros)."""
    if optimizer not in ("sgd", "adam"):
        raise ValueError(f"unknown optimizer {optimizer!r} "
                         "(one of: sgd, adam)")
    adam = optimizer == "adam"

    def init(device):
        gold = gold_of(device) if gold_of is not None else None
        return state_from_numpy(_image(optimizer, gold), device)

    def step(s, t, fns):
        phase, it = s["phase"], s["it"]
        params = [s[n] for n in _PARAM_NAMES]

        # Phase 0: forward and the loss-trajectory monitor.
        in_fwd = phase == FWD
        loss = torch.where(in_fwd, _loss_rows(*params, s["x"], s["y"]),
                           s["loss"])
        gl = take_clip(s["g_loss"], torch.clamp(it, 0, ITERS - 1))
        within = (loss - gl).abs() <= TOL_ABS + TOL_REL * gl.abs()
        heal = torch.where(in_fwd, torch.where(within, s["heal"] + 1, 0),
                           s["heal"])
        dev = torch.where(in_fwd, torch.maximum(
            s["dev"], (~within).to(torch.int32)), s["dev"])

        # Phase 1: backward, the gradient inside the lanes.
        g = fns.grad_step(*params, s["x"], s["y"])
        in_bwd = phase == BWD
        grads = {n: torch.where(rows(in_bwd, gv), gv, s[f"gr_{n}"])
                 for n, gv in zip(_PARAM_NAMES, g)}

        # Phase 2: the optimizer commit.
        in_commit = phase == COMMIT
        out = {}
        if adam:
            idx = torch.clamp(it, 0, _ADAM_B1_POW.shape[0] - 1)
            tables = _POWERS.on(it.device)
            b1p, b2p = lookup(tables.b1, idx), lookup(tables.b2, idx)
        for n in _PARAM_NAMES:
            p, gr, m = s[n], grads[n], s[f"m_{n}"]
            commit = rows(in_commit, p)
            if adam:
                v = s[f"v_{n}"]
                m_new = ADAM_B1 * m + (1.0 - ADAM_B1) * gr
                v_new = ADAM_B2 * v + (1.0 - ADAM_B2) * gr * gr
                mhat = _div(m_new, 1.0 - rows(b1p, m))
                vhat = _div(v_new, 1.0 - rows(b2p, v))
                p_new = p - _div(LR * mhat, _sqrt(vhat) + ADAM_EPS)
                out[f"v_{n}"] = torch.where(commit, v_new, v)
            else:
                m_new = MOMENTUM * m + gr
                p_new = p - LR * m_new
            out[n] = torch.where(commit, p_new, p)
            out[f"m_{n}"] = torch.where(commit, m_new, m)

        return {
            **out,
            **{f"gr_{n}": grads[n] for n in _PARAM_NAMES},
            "loss": loss,
            "heal": heal,
            "dev": dev,
            "it": torch.where(in_commit, it + 1, it),
            "phase": torch.where(phase >= COMMIT, 0, phase + 1),
        }

    def check(s):
        """Bit-exact final-weight compare with the golden weights (int32
        views, so a NaN-poisoned weight still counts)."""
        err = 0
        for n in _PARAM_NAMES:
            bad = s[n].view(torch.int32) != s[f"g_{n}"].view(torch.int32)
            err = err + bad.reshape(bad.shape[0], -1).sum(dim=1)
        return err.to(torch.int32)

    def output(s):
        return torch.cat([s[n].view(torch.int32).reshape(s[n].shape[0], -1)
                          for n in _PARAM_NAMES], dim=1)

    def train_probe(s):
        """0: the loss trajectory never left tolerance; 1: it deviated and
        was back within tolerance for the final HEAL_WINDOW iterations;
        2: still diverged at the end."""
        healed = s["heal"] >= HEAL_WINDOW
        return torch.where(s["dev"] == 0, 0,
                           torch.where(healed, 1, 2)).to(torch.int32)

    opt_names = _opt_leaf_names(optimizer)
    spec = {
        **{n: LeafSpec(KIND_PARAM) for n in _PARAM_NAMES},
        **{n: LeafSpec(KIND_OPT_STATE) for n in opt_names},
        "x": LeafSpec(KIND_RO), "y": LeafSpec(KIND_RO),
        **{f"g_{n}": LeafSpec(KIND_RO) for n in _PARAM_NAMES},
        "g_loss": LeafSpec(KIND_RO),
        **{f"gr_{n}": LeafSpec(KIND_REG) for n in _PARAM_NAMES},
        "loss": LeafSpec(KIND_REG),
        "it": LeafSpec(KIND_CTRL),
        "phase": LeafSpec(KIND_CTRL),
        "heal": LeafSpec(KIND_CTRL),
        "dev": LeafSpec(KIND_CTRL),
    }

    # Selective votes: every param/opt-state commit vote gated to the
    # optimizer phase -- one whole-leaf vote a training iteration.
    def _commit_hint(shape):
        def hint(view, t, _starts=(0,) * len(shape), _sizes=tuple(shape)):
            return _starts, _sizes, view["phase"] == COMMIT
        return hint

    store_slice = {n: _commit_hint(_PARAM_SHAPES[n]) for n in _PARAM_NAMES}
    store_slice.update({n: _commit_hint(_PARAM_SHAPES[n[2:]])
                        for n in opt_names})

    shapes = {k: v.shape for k, v in _image(optimizer, None).items()}
    total_words = sum(int(np.prod(s)) for s in shapes.values())
    opt_words = sum(int(np.prod(shapes[n])) for n in opt_names)
    param_words = sum(int(np.prod(_PARAM_SHAPES[n])) for n in _PARAM_NAMES)

    # Analytic FLOPs a training iteration (MACs x 2).
    fwd_flops = 2.0 * B * (IN * HID + HID * OUT)
    bwd_flops = 2.0 * fwd_flops
    update_flops = float((5 if adam else 3) * param_words)

    return Region(
        name="train_mlp" if optimizer == "sgd" else "train_mlp_adam",
        init=init,
        step=step,
        done=lambda s: s["it"] >= ITERS,
        check=check,
        output=output,
        nominal_steps=PHASES * ITERS,
        max_steps=2 * PHASES * ITERS,
        spec=spec,
        default_xmr=True,
        functions={"grad_step": grad_step},
        train_probe=train_probe,
        meta={
            "oracle": "Number of errors: 0",
            "store_slice": store_slice,
            "state_bytes": 4 * total_words,
            "opt_state_bytes": 4 * opt_words,
            "param_bytes": 4 * param_words,
            "train": {
                "optimizer": optimizer,
                "iters": ITERS,
                "phases": PHASES,
                "heal_window": HEAL_WINDOW,
                "tol_rel": TOL_REL,
                "tol_abs": TOL_ABS,
                "selective_skip": ("grad_step",),
                "flops": {"fwd": fwd_flops, "bwd": bwd_flops,
                          "update": update_flops},
            },
            "dataflow": _dataflow(optimizer),
        },
    )


_GOLDEN: Dict[Tuple[str, str], Dict[str, object]] = {}


def golden(optimizer: str, device=device_mod.DEFAULT) -> Dict[str, object]:
    """The fault-free training trajectory on ``device``: ``params`` (the
    final weights of the engine's unprotected run of the proto region,
    numpy f32) and ``losses`` (the loss of every iteration).  Cached per
    optimizer and device."""
    dev = device_mod.resolve(device)
    key = (optimizer, str(dev))
    if key in _GOLDEN:
        return _GOLDEN[key]
    from coast_tpu_torch.passes.strategies import unprotected
    proto = _build(optimizer, None)
    prog = unprotected(proto, device=dev)
    rec = prog.run_batch(batch=1, return_state=True)
    if not bool(rec["done"][0]):
        raise AssertionError(
            f"golden {optimizer} proto run did not halt in "
            f"{proto.nominal_steps} steps")
    # The losses: the same fault-free program stepped on its own; the loss
    # leaf written at each iteration's fwd micro-step is that iteration's.
    state = {k: v.unsqueeze(0) for k, v in proto.init(dev).items()}
    step = proto.bound_step()
    losses = []
    for t in range(proto.nominal_steps):
        state = {**state, **step(state, t)}
        losses.append(state["loss"][0])
    per_iter = torch.stack(losses)[::PHASES][:ITERS].cpu().numpy()
    if not per_iter[-1] < per_iter[0]:
        raise AssertionError(
            f"golden {optimizer} training did not reduce the loss "
            f"({per_iter[0]} -> {per_iter[-1]})")
    gold = {"params": {n: rec["final_state"][n][0].cpu().numpy()
                       for n in _PARAM_NAMES},
            "losses": per_iter}
    _GOLDEN[key] = gold
    return gold


def make_train_region(optimizer: str = "sgd") -> Region:
    """The registry's factory: ``train_mlp`` (SGD with momentum) or
    ``train_mlp_adam``."""
    return _build(optimizer, lambda device: golden(optimizer, device))


def make_region() -> Region:
    return make_train_region("sgd")


def make_region_adam() -> Region:
    return make_train_region("adam")


def selective_xmr(region: Region, device=device_mod.DEFAULT, **overrides):
    """Selective xMR: TMR over the persistent training state with the
    backward pass computed once (``grad_step`` ``-skipLibCalls``-scoped,
    on lane 0's arguments); the store-slice hints gate the param and
    opt-state votes to the update commit."""
    from coast_tpu_torch.passes.strategies import TMR
    skip = tuple(region.meta["train"]["selective_skip"])
    return TMR(region, device=device, skip_lib_calls=skip, **overrides)


def flops_overhead(region: Region, num_clones: int,
                   selective: bool = False) -> float:
    """FLOPs a training iteration of a strategy relative to the
    unprotected step: lanes x (fwd + update) plus bwd per lane (full
    replication) or once (selective xMR)."""
    f = region.meta["train"]["flops"]
    base = f["fwd"] + f["bwd"] + f["update"]
    lanes = max(1, int(num_clones))
    bwd_lanes = 1 if selective else lanes
    return (lanes * (f["fwd"] + f["update"]) + bwd_lanes * f["bwd"]) / base
