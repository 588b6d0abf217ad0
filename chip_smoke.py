#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (coast_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, with one visible CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every kernel from coast_tpu_torch/csrc with nvcc (sm_90a);
  3. K1 (the vote kernel) against its plain PyTorch version on the card:
     seeded replica sets, n in {2, 3}, int32 and float32 with +-0 and NaN,
     several widths and the per-row window form; then the main path's
     shapes for TMR and DWC (boundary vote and store-slice window at the
     campaign's window starts).  Voted words and flags must be bit-equal.
     Then its time at those shapes beside its bound (bytes / 3.35 TB/s)
     and the plain version's time;
  4. the main path: matrixMultiply1024 under TMR and DWC on the card -- a
     clean fault-free record, then a 1024-injection campaign each, which
     must go through the kernel (launch count > 0);
  5. the first 8 rows of each schedule again on the CPU (plain voters):
     records equal outside the rows whose f32 rounding order may differ;
  6. matrixMultiply (9x9) TMR, 16384 injections.

It prints the kernel table as one JSON line before the last and
``{"ok": true, "device": {...}}`` as the last line.  It imports nothing of
JAX or of the coast_tpu package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of one ``fn()`` call (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def replica_set(rng, rows: int, n: int, width: int, dtype: str):
    """Seeded ``[rows, n, width]`` words: every lane a copy of one image,
    then single-lane flips in every odd row, and for float32 the specials
    (+0 beside -0 must agree, NaN never agrees) in every fourth row."""
    if dtype == "float32":
        base = rng.standard_normal((rows, width)).astype(np.float32)
    else:
        base = rng.integers(-2**31, 2**31, (rows, width), dtype=np.int64
                            ).astype(np.int32)
    lanes = np.repeat(base[:, None, :], n, axis=1)
    bits = lanes.view(np.int32)
    for r in range(1, rows, 2):
        bits[r, rng.integers(n), rng.integers(width)] ^= np.int32(
            1 << int(rng.integers(31)))
    if dtype == "float32":
        for r in range(0, rows, 4):
            w = rng.integers(width)
            lanes[r, :, w] = 0.0
            lanes[r, 1, w] = -0.0
            if r % 8 == 0 and width > 1:
                lanes[r, :, (w + 1) % width] = np.nan
    return lanes


def compare(torch, kernel, plain, what: str) -> float:
    """Fail unless the kernel's ``(voted, flags)`` are bit-equal to the
    plain version's; return the max |difference| of the voted values."""
    (kv, km), (pv, pm) = kernel, plain
    torch.cuda.synchronize()
    if not (torch.equal(kv.view(torch.int32), pv.view(torch.int32))
            and torch.equal(km, pm)):
        fail(f"K1 differs from its plain version: {what}")
    diff = (kv.double() - pv.double()).abs()
    diff = diff[~diff.isnan()]
    return float(diff.max()) if diff.numel() else 0.0


def check_k1(torch, hv, voters) -> float:
    """Phase 3a: kernel vs plain, bit-equal.  Returns max |difference|."""
    rng = np.random.default_rng(1234)
    worst = 0.0
    cases = 0
    for width, rows in ((1, 64), (81, 64), (131072, 8), (1048576 + 3, 4)):
        for n in (2, 3):
            for dtype in ("int32", "float32"):
                host = replica_set(rng, rows, n, width, dtype)
                lanes = torch.from_numpy(host).cuda()
                worst = max(worst, compare(
                    torch, hv.vote(lanes, n), voters.vote(lanes, n),
                    f"width {width} n {n} {dtype}"))
                # The per-row window form: read in place at row offsets.
                width_w = max(1, width // 3)
                offs = torch.from_numpy(rng.integers(
                    0, width - width_w + 1, rows).astype(np.int32)).cuda()
                worst = max(worst, compare(
                    torch, hv.vote_window(lanes, offs, width_w, n),
                    voters.vote(voters.window(lanes, offs, width_w), n),
                    f"window {width_w} of {width} n {n} {dtype}"))
                cases += 2
    log(f"K1 bit-equal to its plain version on {cases} seeded cases "
        f"(n 2/3, int32/float32 with +-0 and NaN, widths 1..1048579, "
        f"window form)")
    return worst


def main_shape_lanes(torch, rows: int, n: int, words: int,
                     offs) -> "torch.Tensor":
    """A seeded ``[rows, n, words]`` f32 replica set on the card, with
    every mark inside each row's store-slice window (start ``offs[r]``):
    a single-lane flip in every odd row, +0 beside -0 in every fourth row
    and a NaN in every eighth."""
    gen = torch.Generator(device="cuda").manual_seed(7 + n)
    lanes = torch.randn((rows, 1, words), generator=gen, device="cuda"
                        ).expand(rows, n, words).contiguous()
    r = torch.arange(rows, device="cuda")
    start = offs.long()
    odd = r[1::2]
    lanes[odd, odd % n, start[odd] + odd] += 1.0
    fourth = r[0::4]
    lanes[fourth, :, start[fourth] + 1] = 0.0
    lanes[fourth, 1, start[fourth] + 1] = -0.0
    eighth = r[0::8]
    lanes[eighth, :, start[eighth] + 2] = float("nan")
    return lanes


def time_k1(torch, hv, voters) -> dict:
    """Phase 3b: K1 at the main path's shapes (matrixMultiply1024, batch
    128), for TMR (n 3) and DWC (n 2): the boundary vote of a 1024x1024
    f32 leaf and the store-slice vote of a 128-row window of it, at the
    window starts the campaign gives (row r: (r % 8) * 131072).  Each is
    first held bit-equal to its plain version, then timed.  Returns the
    TMR boundary vote's numbers for the kernel table."""
    rows, words, width = 128, 1024 * 1024, 128 * 1024
    offs = (torch.arange(rows, device="cuda", dtype=torch.int32) % 8) * width
    res = {"max_abs_err": 0.0}
    for n in (3, 2):
        lanes = main_shape_lanes(torch, rows, n, words, offs)
        err = max(
            compare(torch, hv.vote(lanes, n), voters.vote(lanes, n),
                    f"boundary vote [{rows}, {n}, {words}] f32"),
            compare(torch, hv.vote_window(lanes, offs, width, n),
                    voters.vote(voters.window(lanes, offs, width), n),
                    f"store-slice vote [{rows}, {n}, window {width} of "
                    f"{words}] f32"))
        res["max_abs_err"] = max(res["max_abs_err"], err)
        ms = time_ms(torch, lambda: hv.vote(lanes, n))
        plain_ms = time_ms(torch, lambda: voters.vote(lanes, n))
        bound_ms = (rows * n * words * 4 + rows * words * 4 + rows * 4
                    ) / H100_BYTES_PER_S * 1e3
        log(f"K1 boundary vote [{rows}, {n}, {words}] f32: bit-equal, "
            f"{ms:.4f} ms (bound {bound_ms:.4f} ms by bytes, "
            f"{bound_ms / ms:.1%} of it); plain version {plain_ms:.4f} ms")
        if n == 3:
            res.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        win_ms = time_ms(torch, lambda: hv.vote_window(lanes, offs, width, n))
        win_plain = time_ms(torch, lambda: voters.vote(
            voters.window(lanes, offs, width), n))
        win_bound = (rows * n * width * 4 + rows * width * 4 + rows * 4
                     ) / H100_BYTES_PER_S * 1e3
        log(f"K1 store-slice vote [{rows}, {n}, window {width} of {words}] "
            f"f32: bit-equal, {win_ms:.4f} ms (bound {win_bound:.4f} ms by "
            f"bytes); plain version (gather + vote) {win_plain:.4f} ms")
        del lanes
        torch.cuda.empty_cache()
    return res


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not importable")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke needs a card")
    try:
        from coast_tpu_torch import DWC, TMR, build
        from coast_tpu_torch.inject.campaign import CampaignRunner
        from coast_tpu_torch.models import REGISTRY
        from coast_tpu_torch.models.mm256 import order_sensitive
        from coast_tpu_torch.ops import hopper_voters as hv
        from coast_tpu_torch.ops import voters
        from coast_tpu_torch.ops.bitflip import noop_fault
    except ImportError as e:
        fail(f"coast_tpu_torch is not importable ({e}); run from the root of "
             "a checkout")
    if "jax" in sys.modules or any(m.startswith("coast_tpu.")
                                   for m in sys.modules):
        fail("the port pulled in jax or the coast_tpu package")

    # 1. Card and versions.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # 2. Build.
    t0 = time.perf_counter()
    outputs = build.build_all()
    log(f"built {sorted(outputs)} in {time.perf_counter() - t0:.1f} s")
    for name, out in outputs.items():
        for line in out.strip().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # 3. K1 against its plain version.
    worst = check_k1(torch, hv, voters)
    k1 = time_k1(torch, hv, voters)
    k1["max_abs_err"] = max(k1["max_abs_err"], worst)

    # 4. Main path: matrixMultiply1024 under TMR and DWC on the card.
    region = REGISTRY["matrixMultiply1024"]()
    results = {}
    hv.LAUNCHES = 0
    for strat in (TMR, DWC):
        prog = strat(region)
        rec = prog.run(noop_fault())
        clean = (int(rec["errors"]) == 0 and bool(rec["done"])
                 and int(rec["steps"]) == 16 and int(rec["corrected"]) == 0
                 and not bool(rec["dwc_fault"]))
        if not clean:
            fail(f"{strat.__name__} fault-free record is not clean: "
                 f"{ {k: v.tolist() for k, v in rec.items() if v.dim() == 0} }")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = hv.LAUNCHES
        res = CampaignRunner(prog, strategy_name=strat.__name__).run(
            1024, seed=1, batch_size=128)
        launches = hv.LAUNCHES - before
        if launches <= 0:
            fail(f"the {strat.__name__} campaign launched K1 no time")
        if sum(v for k, v in res.counts.items() if k != "cache_invalid") \
                != res.n:
            fail(f"{strat.__name__} counts do not sum to {res.n}")
        log(f"matrixMultiply1024 {strat.__name__}: {res.counts} "
            f"{res.injections_per_sec:.1f} inj/s ({res.seconds:.2f} s), "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"K1 launches {launches} [{card}]")
        results[strat] = res
    main_launches = hv.LAUNCHES
    if main_launches <= 0:
        fail("the main path launched K1 no time")

    # 5. Cross-check against the CPU (plain voters).
    exempt_total = exempt_differ = 0
    for strat, res in results.items():
        sub = res.schedule.slice(0, 8)
        cpu_prog = strat(region, device="cpu")
        cpu = CampaignRunner(cpu_prog).run_schedule(sub, batch_size=8)
        exempt = order_sensitive(cpu_prog.leaf_order, sub.leaf_id, sub.bit)
        exempt_total += int(exempt.sum())
        differ = np.zeros(8, bool)
        for col in ("codes", "errors", "corrected", "steps"):
            differ |= getattr(res, col)[:8] != getattr(cpu, col)
            if differ[~exempt].any():
                fail(f"{strat.__name__} {col} differ between card and CPU: "
                     f"{getattr(res, col)[:8]} vs {getattr(cpu, col)}")
        exempt_differ += int(differ.sum())
    log(f"CPU cross-check: 16 rows, {exempt_total} exempt (mantissa flips "
        f"of first/second/acc), the rest equal; {exempt_differ} of the "
        "exempt rows differ")

    # 6. matrixMultiply (9x9) TMR, the bench workload.
    hv.LAUNCHES = 0
    mm = CampaignRunner(TMR(REGISTRY["matrixMultiply"]()),
                        strategy_name="TMR").run(16384, seed=1,
                                                 batch_size=4096)
    log(f"matrixMultiply TMR: {mm.counts} {mm.injections_per_sec:.1f} inj/s "
        f"({mm.seconds:.2f} s), K1 launches {hv.LAUNCHES} [{card}]")

    log(json.dumps({"kernels": [{
        "name": "vote",
        "route": "cuda",
        "source": "coast_tpu_torch/csrc/vote.cu",
        "replaces": "coast_tpu/ops/pallas_voters.py:86",
        "launches": main_launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
