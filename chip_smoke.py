#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (coast_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, with one visible CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every kernel from coast_tpu_torch/csrc with nvcc (sm_90a);
  3. K1 (the vote kernel) against its plain PyTorch version on the card:
     seeded replica sets, n in {2, 3}, int32 and float32 with +-0 and NaN,
     several widths and the per-row window form; grouped launches
     (``vote_sites``) of mixed widths (1 to 1048579), dtypes, windows and
     DWC flags-only checks; then the main path's shapes for TMR and DWC
     (boundary vote and store-slice window at the campaign's window
     starts).  Voted words and flags must be bit-equal.  Then its time at
     those shapes beside its bound (bytes / 3.35 TB/s) and the plain
     version's time, and at the grouped shapes of the engine's sync points
     (the 9x9 pre-step, commit and boundary groups at batch 4096, the
     matrixMultiply1024 boundary group at batch 128): per call (CUDA
     events) and device only (torch.profiler), beside the same sites as
     groups of one (one launch a leaf, the per-leaf form);
  4. the main path: matrixMultiply1024 under TMR and DWC on the card -- a
     clean fault-free record, then a 1024-injection campaign each, which
     must go through the kernel (launch count > 0);
  5. the first 8 rows of each schedule again on the CPU (plain voters):
     records equal outside the rows whose f32 rounding order may differ;
  6. matrixMultiply (9x9) TMR, 16384 injections;
  7. the fused engine (fuse_step=True) and K2, the fused commit kernel:
     (a) K2 against its plain version on the card, bit-equal: seeded
         replica sets, n in {2, 3}, int32 and float32 with +-0, NaN and
         subnormals, no mask and masks with several flipped words a row,
         widths 1 to 1048579, and the fused path's shapes ([4096, 3, 81]
         results, [4096, 3, 1] scalars, [4096, 3, 13] crc16 msg); grouped
         launches (``commit_sites``) of mixed widths, dtypes and masks;
         then its time at [128, 3, 1048576] f32 and [4096, 3, 81] int32
         beside its bytes bound, the plain version's time and the time of
         what it replaces (K1 + the materialised repair), and at the fused
         9x9 pre-step and commit groups, per call and device only, beside
         the groups of one;
     (b) the fused path: matrixMultiply and crc16 under TMR and DWC, 16384
         injections at batch 4096, five pairs of unfused and fused runs
         in alternating order; records equal on every row, K1 and K2
         launched exactly once per sync point (per loop trip: mm TMR 3 K1
         unfused, 2 K2 fused; and one K1 a batch at the boundary);
     (c) the float gate: matrixMultiply1024 under fuse_step=True keeps the
         unfused program;
  8. the device-only times of phases 3 and 7a (torch.profiler, 200 calls
     each), taken after every campaign: a profiler session leaves launch
     overhead behind that would slow the campaigns run after it.

It prints the kernel table as one JSON line before the last (``ms``,
``plain_ms`` and ``bound_ms`` at the flagship shape, as before; every
timed shape, grouped ones included, under ``shapes``) and
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


def compare(torch, kernel, plain, what: str, name: str = "K1") -> float:
    """Fail unless the kernel's outputs (words..., flags) are bit-equal to
    the plain version's; return the max |difference| of the words."""
    torch.cuda.synchronize()
    worst = 0.0
    *kwords, km = kernel
    *pwords, pm = plain
    if not torch.equal(km, pm):
        fail(f"{name} flags differ from its plain version: {what}")
    for kv, pv in zip(kwords, pwords):
        if kv.shape != pv.shape or not torch.equal(kv.view(torch.int32),
                                                   pv.view(torch.int32)):
            fail(f"{name} differs from its plain version: {what}")
        diff = (kv.double() - pv.double()).abs()
        diff = diff[~diff.isnan()]
        if diff.numel():
            worst = max(worst, float(diff.max()))
    return worst


def compare_group(torch, got, want, what: str, name: str) -> float:
    """Fail unless a grouped call's outputs (lists of tensors or None per
    site, then the [S, R] flag block) are bit-equal to the plain
    version's; return the max |difference| of the words."""
    torch.cuda.synchronize()
    *got_lists, got_flags = got
    *want_lists, want_flags = want
    if not torch.equal(got_flags, want_flags):
        fail(f"{name} flags differ from its plain version: {what}")
    words_got = [t for lst in got_lists for t in lst]
    words_want = [t for lst in want_lists for t in lst]
    if [t is None for t in words_got] != [t is None for t in words_want]:
        fail(f"{name} returns other outputs than its plain version: {what}")
    pairs = [(g, w) for g, w in zip(words_got, words_want) if g is not None]
    return max([compare(torch, (g, want_flags), (w, want_flags), what, name)
                for g, w in pairs] or [0.0])


def device_ms(torch, fn, calls: int = 200):
    """Device time of one ``fn()`` call: the summed self time of every
    device activity (kernels and memsets) over ``calls`` calls under
    torch.profiler, over ``calls``.  None when the profiler saw none."""
    from coast_tpu_torch.breakdown import kernel_times
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(k["us"] for k in kernel_times(prof))
    return us / calls / 1e3 if us > 0 else None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def defer_device_ms(later: list, name: str, record: dict, key: str,
                    fn) -> None:
    """Queue the device-only time of ``fn`` for ``record[key]``.  Phase 8
    runs the queue after every campaign: a torch.profiler session leaves
    launch overhead behind that slows the campaigns run after it."""
    record[key] = None
    later.append((name, record, key, fn))


def time_group(torch, later: list, name: str, label: str, grouped, leaves,
               plain, bound_bytes: int, card: str, iters: int = 50) -> dict:
    """One grouped launch (``grouped``) timed per call (CUDA events around
    one call, host work included), beside the same sites as groups of one
    (``leaves``: one launch a leaf, the per-leaf form), the plain version
    and the bytes bound of the group; the device-only times of the first
    two (torch.profiler over 200 calls) are queued for phase 8."""
    res = {"shape": label,
           "ms": time_ms(torch, grouped, iters),
           "per_leaf_ms": time_ms(torch, leaves, iters),
           "plain_ms": time_ms(torch, plain, max(5, iters // 5)),
           "bound_ms": bound_bytes / H100_BYTES_PER_S * 1e3}
    defer_device_ms(later, name, res, "device_ms", grouped)
    defer_device_ms(later, name, res, "per_leaf_device_ms", leaves)
    log(f"{name} {label}: one launch {res['ms']:.4f} ms per call; groups "
        f"of one {res['per_leaf_ms']:.4f} ms per call; plain "
        f"{res['plain_ms']:.4f} ms; bound {res['bound_ms']:.4f} ms by "
        f"bytes [{card}]")
    return res


def k1_bytes(sites, n: int) -> int:
    """Bytes a grouped vote must move: every lane word read once, each
    written voted word (TMR, or a DWC copy) and each flag written once."""
    total = 0
    for site in sites:
        rows = site.lanes.shape[0]
        width = site.width or site.lanes.numel() // (rows * n)
        total += rows * n * width * 4 + rows * 4
        if n == 3 or site.copy:
            total += rows * width * 4
    return total


def k2_bytes(sites, n: int) -> int:
    """Bytes a grouped fused commit must move: lanes (and masks) read
    once, the repaired lanes, the voted words and the flags written once."""
    total = 0
    for lanes, masks in sites:
        rows, words = lanes.shape[0], lanes.numel()
        total += (2 + (masks is not None)) * words * 4 + words // n * 4
        total += rows * 4
    return total


def mark_rows(torch, pstate, names, n: int) -> None:
    """Flip one word of one lane in every odd row of every named leaf, so
    the timed groups carry miscompares (odd rows) beside agreement."""
    for k, name in enumerate(names):
        words = pstate[name].view(torch.int32).view(
            pstate[name].shape[0], n, -1)
        words[1::2, (k + 1) % n, 0] ^= 1 << 5


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
    return max(worst, check_k1_groups(torch, hv, voters))


def check_k1_groups(torch, hv, voters) -> float:
    """Phase 3a, grouped: one launch over sites of mixed width (1, 13, 81
    as 9x9, 131072 or 1048579 words) and dtype, per-row windows of the
    widest, written DWC copies beside flags-only checks; bit-equal to the
    plain ``voters.vote_sites``."""
    rng = np.random.default_rng(99)
    worst = 0.0
    cases = 0
    for rows, wide in ((64, 131072), (4, 1048576 + 3)):
        for n in (2, 3):
            sites = []
            for j, (width, dtype, shape) in enumerate((
                    (1, "int32", ()), (13, "float32", (13,)),
                    (81, "int32", (9, 9)), (wide, "float32", (wide,)),
                    (wide, "int32", (wide,)))):
                host = replica_set(rng, rows, n, width, dtype)
                lanes = torch.from_numpy(host).cuda().view(
                    (rows, n) + shape)
                sites.append(voters.Site(lanes, copy=bool(j % 2)))
            for j, width in enumerate((7, wide // 3)):
                offs = torch.from_numpy(rng.integers(
                    -9, wide, rows).astype(np.int32)).cuda()
                sites.append(voters.Site(sites[3 + j].lanes, offs, width,
                                         copy=bool(j)))
            worst = max(worst, compare_group(
                torch, hv.vote_sites(sites, n), voters.vote_sites(sites, n),
                f"group of {len(sites)} sites, rows {rows}, n {n}", "K1"))
            cases += 1
    log(f"K1 grouped launches bit-equal to the plain vote_sites on {cases} "
        "seeded groups (widths 1..1048579 in one launch, int32 and float32, "
        "windows, DWC copies and flags-only checks)")
    return worst


def time_k1_groups(torch, later, hv, voters, TMR, DWC, REGISTRY, card):
    """Phase 3c: K1 at the grouped shapes of the engine's sync points --
    the 9x9 unfused step's pre-step and commit groups (and the commit's
    81-word leaf alone) and its boundary group (TMR and DWC) at batch
    4096, the matrixMultiply1024 boundary
    group at batch 128 (TMR and DWC) -- each first held bit-equal to the
    plain version.  Returns the timing records."""
    Site = voters.Site
    out = []
    cases = [("matrixMultiply", 4096, TMR, "pre-step", ("i",)),
             ("matrixMultiply", 4096, TMR, "commit", ("results",)),
             ("matrixMultiply", 4096, TMR, "commit",
              ("results", "i", "phase")),
             ("matrixMultiply", 4096, TMR, "boundary", None),
             ("matrixMultiply", 4096, DWC, "boundary", None),
             ("matrixMultiply1024", 128, TMR, "boundary", None),
             ("matrixMultiply1024", 128, DWC, "boundary", None)]
    for bench, rows, strat, point, names in cases:
        prog = strat(REGISTRY[bench]())
        n = prog.cfg.num_clones
        pstate, _ = prog.init_pstate(rows)
        names = names or [k for k in pstate if prog.replicated[k]]
        mark_rows(torch, pstate, names, n)
        sites = [Site(pstate[k]) for k in names]
        shapes = ", ".join(str(list(pstate[k].shape)) for k in names)
        dtype = "f32" if pstate[names[0]].is_floating_point() else "int32"
        label = (f"{bench} {strat.__name__} {point} "
                 + (f"group {{{shapes}}} {dtype}" if len(names) > 1
                    else f"{shapes} {dtype}"))
        compare_group(torch, hv.vote_sites(sites, n),
                      voters.vote_sites(sites, n), label, "K1")
        big = rows < 4096
        out.append(time_group(
            torch, later, "K1", label,
            lambda sites=sites, n=n: hv.vote_sites(sites, n),
            lambda sites=sites, n=n: [hv.vote(site.lanes, n)
                                      for site in sites],
            lambda: voters.vote_sites(sites, n), k1_bytes(sites, n), card,
            iters=20 if big else 50))
        del prog, pstate, sites
        torch.cuda.empty_cache()
    return out


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


def bound_ms_dwc(rows: int, words: int) -> float:
    """The flags-only DWC vote's bound: two lanes read, a flag a row."""
    return (rows * 2 * words * 4 + rows * 4) / H100_BYTES_PER_S * 1e3


def time_k1(torch, later, hv, voters) -> dict:
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
        # TMR writes its voted copy; the whole-leaf DWC vote is flags only.
        bound_ms = (rows * n * words * 4 + rows * words * 4 + rows * 4
                    ) / H100_BYTES_PER_S * 1e3
        if n == 2:
            bound_ms = bound_ms_dwc(rows, words)
        log(f"K1 boundary vote [{rows}, {n}, {words}] f32: bit-equal, "
            f"{ms:.4f} ms (bound {bound_ms:.4f} ms by bytes, "
            f"{bound_ms / ms:.1%} of it); plain version {plain_ms:.4f} ms")
        record = {"shape": f"boundary [{rows}, {n}, {words}] f32", "ms": ms,
                  "plain_ms": plain_ms, "bound_ms": bound_ms}
        defer_device_ms(later, "K1", record, "device_ms",
                        lambda lanes=lanes, n=n: hv.vote(lanes, n))
        res.setdefault("shapes", []).append(record)
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
        record = {"shape": f"store-slice window [{rows}, {n}, {width} of "
                           f"{words}] f32", "ms": win_ms,
                  "plain_ms": win_plain, "bound_ms": win_bound}
        defer_device_ms(later, "K1", record, "device_ms",
                        lambda lanes=lanes, n=n: hv.vote_window(
                            lanes, offs, width, n))
        res["shapes"].append(record)
        del lanes
        torch.cuda.empty_cache()
    return res


def commit_set(rng, rows: int, n: int, width: int, dtype: str):
    """Seeded ``[rows, n, width]`` words and int32 flip masks for K2: the
    replica set of :func:`replica_set`, three mask flips in every row, and
    for float32 a subnormal beside zeros in one lane and a mask flip that
    turns a zero into a subnormal (both agree under the reference's
    compare)."""
    lanes = replica_set(rng, rows, n, width, dtype)
    bits = lanes.view(np.uint32)
    masks = np.zeros(lanes.shape, np.uint32)
    row = np.repeat(np.arange(rows), 3)
    np.bitwise_xor.at(masks, (row, rng.integers(n, size=3 * rows),
                              rng.integers(width, size=3 * rows)),
                      np.left_shift(np.uint32(1), rng.integers(
                          32, size=3 * rows).astype(np.uint32)))
    if dtype == "float32":
        r = np.arange(rows)

        def subnormals():
            return np.left_shift(np.uint32(1), rng.integers(
                23, size=rows).astype(np.uint32))

        w = rng.integers(width, size=rows)
        bits[r, :, w] = 0
        bits[r, r % n, w] = subnormals()
        w = rng.integers(width, size=rows)
        bits[r, :, w] = 0
        masks[r, (r + 1) % n, w] ^= subnormals()
    return lanes, masks.view(np.int32)


def check_k2(torch, fs) -> float:
    """Phase 7a: K2 vs its plain version, bit-equal, with and without masks.
    Returns the max |difference| of the output words."""
    rng = np.random.default_rng(4321)
    worst = 0.0
    cases = 0
    sets = [(64, width) for width in (1, 13, 81)]
    sets += [(8, 131072), (4, 1048576 + 3)]
    # The fused path's shapes: mm's results and scalars, crc16's message.
    sets += [(4096, 81), (4096, 1), (4096, 13)]
    for rows, width in sets:
        for n in (2, 3):
            for dtype in ("int32", "float32"):
                host, host_masks = commit_set(rng, rows, n, width, dtype)
                lanes = torch.from_numpy(host).cuda()
                masks = torch.from_numpy(host_masks).cuda()
                if width == 1:
                    lanes, masks = lanes[:, :, 0], masks[:, :, 0]
                for m in (None, masks):
                    worst = max(worst, compare(
                        torch, fs.vote_flip_commit(lanes, m, n),
                        fs.plain_vote_flip_commit(lanes, m, n),
                        f"[{rows}, {n}, {width}] {dtype} "
                        f"{'masked' if m is not None else 'no mask'}", "K2"))
                    cases += 1
    log(f"K2 bit-equal to its plain version on {cases} seeded cases (n 2/3, "
        "int32/float32 with +-0, NaN and subnormals, with and without "
        "masks, widths 1..1048579, the fused path's [4096, n, 81/1/13])")
    return max(worst, check_k2_groups(torch, fs))


def check_k2_groups(torch, fs) -> float:
    """Phase 7a, grouped: one launch over sites of mixed width (1, 13, 81,
    131072 or 1048579 words), dtype and mask; bit-equal to the plain
    ``plain_commit_sites``."""
    rng = np.random.default_rng(77)
    worst = 0.0
    cases = 0
    for rows, wide in ((64, 131072), (4, 1048576 + 3), (4096, 81)):
        for n in (2, 3):
            sites = []
            for j, (width, dtype) in enumerate((
                    (1, "int32"), (13, "float32"), (81, "int32"),
                    (wide, "float32"), (wide, "int32"))):
                host, host_masks = commit_set(rng, rows, n, width, dtype)
                lanes = torch.from_numpy(host).cuda()
                masks = torch.from_numpy(host_masks).cuda()
                if width == 1:
                    lanes, masks = lanes[:, :, 0], masks[:, :, 0]
                sites.append((lanes, masks if j % 2 else None))
            worst = max(worst, compare_group(
                torch, fs.commit_sites(sites, n),
                fs.plain_commit_sites(sites, n),
                f"group of {len(sites)} sites, rows {rows}, n {n}", "K2"))
            cases += 1
    log(f"K2 grouped launches bit-equal to the plain commit_sites on {cases} "
        "seeded groups (widths 1..1048579 in one launch, int32 and float32, "
        "with and without masks)")
    return worst


def time_k2_groups(torch, later, fs, TMR, REGISTRY, card):
    """Phase 7a, grouped timing: K2 at the fused 9x9 TMR step's pre-step
    and commit groups at batch 4096, each first held bit-equal to the
    plain version.  Returns the timing records."""
    prog = TMR(REGISTRY["matrixMultiply"](), fuse_step=True)
    pstate, _ = prog.init_pstate(4096)
    out = []
    for point, names in (("pre-step", ("i",)),
                         ("commit", ("results", "i", "phase"))):
        mark_rows(torch, pstate, names, 3)
        sites = [(pstate[k], None) for k in names]
        shapes = ", ".join(str(list(pstate[k].shape)) for k in names)
        label = (f"matrixMultiply TMR fused {point} "
                 + (f"group {{{shapes}}} int32" if len(names) > 1
                    else f"{shapes} int32"))
        compare_group(torch, fs.commit_sites(sites, 3),
                      fs.plain_commit_sites(sites, 3), label, "K2")
        out.append(time_group(
            torch, later, "K2", label,
            lambda sites=sites: fs.commit_sites(sites, 3),
            lambda sites=sites: [fs.vote_flip_commit(lanes, None, 3)
                                 for lanes, _ in sites],
            lambda: fs.plain_commit_sites(sites, 3), k2_bytes(sites, 3),
            card))
    return out


K2_SHAPES = ((128, 1048576, "float32"), (4096, 81, "int32"))


def time_k2(torch, later, fs, hv, repair, card: str) -> dict:
    """Phase 7a, timing: K2 (TMR, as the engine calls it, and masked) at
    [128, 3, 1048576] f32 and at the fused path's [4096, 3, 81] int32,
    beside its bytes bound, its plain version and K1 + the materialised
    repair it replaces.  Returns the flagship shape's numbers, with every
    shape's under "shapes"."""
    rng = np.random.default_rng(11)
    res, shapes = {}, []
    for rows, width, dtype in K2_SHAPES:
        if dtype == "float32":
            one = rng.standard_normal((rows, 1, width), dtype=np.float32)
        else:
            one = rng.integers(-2**31, 2**31, (rows, 1, width),
                               dtype=np.int32)
        lanes = torch.from_numpy(one).cuda().expand(rows, 3, width)
        lanes = lanes.contiguous()
        lanes.view(torch.int32)[1::2, 1, 7 % width] ^= 1 << 9
        masks = torch.zeros_like(lanes, dtype=torch.int32)
        masks[::3, 2, 3 % width] = 1 << 4
        what = f"[{rows}, 3, {width}] {dtype}"
        err = max(compare(torch, fs.vote_flip_commit(lanes, None, 3),
                          fs.plain_vote_flip_commit(lanes, None, 3), what,
                          "K2"),
                  compare(torch, fs.vote_flip_commit(lanes, masks, 3),
                          fs.plain_vote_flip_commit(lanes, masks, 3),
                          what + " masked", "K2"))
        iters = 20 if width > 81 else 200
        ms = time_ms(torch, lambda: fs.vote_flip_commit(lanes, None, 3),
                     iters)
        plain_ms = time_ms(
            torch, lambda: fs.plain_vote_flip_commit(lanes, None, 3), iters)
        k1_ms = time_ms(torch, lambda: repair(hv.vote(lanes, 3)[0],
                                              lanes.shape), iters)
        masked_ms = time_ms(torch, lambda: fs.vote_flip_commit(lanes, masks,
                                                               3), iters)
        words = rows * width
        # 3W read, 3W repaired + W voted written, a flag word a row; a
        # mask adds 3W read.
        bound_ms = (words * 4 * 7 + rows * 4) / H100_BYTES_PER_S * 1e3
        masked_bound = bound_ms + words * 4 * 3 / H100_BYTES_PER_S * 1e3
        log(f"K2 TMR {what}: bit-equal, {ms:.4f} ms (bound {bound_ms:.4f} "
            f"ms by bytes, {bound_ms / ms:.1%} of it); plain version "
            f"{plain_ms:.4f} ms; K1 + repair (what it replaces) "
            f"{k1_ms:.4f} ms; masked {masked_ms:.4f} ms (bound "
            f"{masked_bound:.4f} ms) [{card}]")
        record = {"shape": f"TMR {what}", "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": bound_ms, "k1_repair_ms": k1_ms}
        defer_device_ms(later, "K2", record, "device_ms",
                        lambda lanes=lanes: fs.vote_flip_commit(lanes, None,
                                                                3))
        shapes.append(record)
        if dtype == "float32":      # the flagship shape: the JSON's numbers
            res = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "k1_repair_ms": k1_ms, "shapes": shapes}
        res["max_abs_err"] = max(res.get("max_abs_err", 0.0), err)
        del lanes, masks, one
        torch.cuda.empty_cache()
    return res


# Grouped launches a loop trip, (K1, K2), per campaign and engine (fused or
# not): one per sync point that has sites.  mm TMR: pre-step, commit and
# the done() view's vote of ``i`` unfused; the pre-step and commit fused
# commits fused (done() reuses the commit's vote).  crc16 has no commit
# vote; its fused done() view still votes ``i`` on K1.  DWC: the pre-step
# and commit checks, flags only.  The boundary adds one K1 a batch.
PER_TRIP = {("matrixMultiply", "TMR"): {False: (3, 0), True: (0, 2)},
            ("matrixMultiply", "DWC"): {False: (2, 0), True: (2, 0)},
            ("crc16", "TMR"): {False: (2, 0), True: (1, 1)},
            ("crc16", "DWC"): {False: (1, 0), True: (1, 0)}}


def count_trips(prog) -> list:
    """Count the engine's loop trips (``step`` calls) on ``prog``."""
    trips = [0]
    step = prog.step

    def counting(*args):
        trips[0] += 1
        return step(*args)

    prog.step = counting
    return trips


def fused_path(torch, TMR, DWC, CampaignRunner, REGISTRY, hv, hc,
               card: str, pairs: int = 5) -> None:
    """Phase 7b: the fused engine on matrixMultiply and crc16.  After a
    warm-up of each engine, ``pairs`` pairs of campaigns, unfused and
    fused, alternating which runs first.  Fails unless every run's records
    equal the first run's and every run launched K1 and K2 exactly as
    ``PER_TRIP`` says, plus one K1 a batch at the boundary."""
    cols = ("codes", "errors", "corrected", "steps")
    for bench in ("matrixMultiply", "crc16"):
        region = REGISTRY[bench]()
        for strat in (TMR, DWC):
            name = f"{bench} {strat.__name__}"
            progs = {False: strat(region), True: strat(region,
                                                       fuse_step=True)}
            if progs[True]._fuse_plan is None:
                fail(f"{name}: fuse_step=True built no fused plan")
            runners = {f: CampaignRunner(p, strategy_name=strat.__name__)
                       for f, p in progs.items()}
            for f in (False, True):
                runners[f].run(4096, seed=0, batch_size=4096)
            trips = {f: count_trips(p) for f, p in progs.items()}
            rates = {False: [], True: []}
            launches = {False: [0, 0], True: [0, 0]}
            base = None
            for i in range(pairs):
                for f in ((False, True) if i % 2 == 0 else (True, False)):
                    k1, k2, t0 = hv.LAUNCHES, hc.LAUNCHES, trips[f][0]
                    res = runners[f].run(16384, seed=1, batch_size=4096)
                    got = (hv.LAUNCHES - k1, hc.LAUNCHES - k2)
                    per_k1, per_k2 = PER_TRIP[bench, strat.__name__][f]
                    n_trips = trips[f][0] - t0
                    want = (per_k1 * n_trips + 16384 // 4096,
                            per_k2 * n_trips)
                    if got != want:
                        fail(f"{name} fuse_step={f}: K1, K2 launches {got} "
                             f"over {n_trips} loop trips, not {want}")
                    launches[f][0] += got[0]
                    launches[f][1] += got[1]
                    rates[f].append(res.injections_per_sec)
                    if base is None:
                        base = res
                    elif res.counts != base.counts or not all(
                            np.array_equal(getattr(res, c), getattr(base, c))
                            for c in cols):
                        fail(f"{name}: fuse_step={f} records differ from "
                             "the unfused engine's")
            wins = sum(f > u for u, f in zip(rates[False], rates[True]))
            log(f"{name} {pairs} x 16384 inj at batch 4096 per engine: "
                f"{base.counts}; records equal fused vs unfused; "
                f"fused faster in {wins} of {pairs} pairs [{card}]")
            for f, label in ((False, "unfused"), (True, "fused")):
                log(f"  {label}: median "
                    f"{statistics.median(rates[f]):.1f} inj/s, runs "
                    f"{' / '.join(f'{r:.1f}' for r in rates[f])}; K1 "
                    f"{launches[f][0]}, K2 {launches[f][1]} launches over "
                    f"{trips[f][0]} loop trips "
                    f"({PER_TRIP[bench, strat.__name__][f]} a trip, one K1 "
                    "a batch at the boundary)")


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
        from coast_tpu_torch.ops import fused_step as fs
        from coast_tpu_torch.ops import hopper_commit as hc
        from coast_tpu_torch.ops import hopper_voters as hv
        from coast_tpu_torch.ops import voters
        from coast_tpu_torch.ops.bitflip import noop_fault
        from coast_tpu_torch.passes.dataflow_protection import _repair
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

    # 3. K1 against its plain version, its time per leaf and per group.
    worst = check_k1(torch, hv, voters)
    later = []       # device-only timings, run in phase 8
    k1 = time_k1(torch, later, hv, voters)
    k1["max_abs_err"] = max(k1["max_abs_err"], worst)
    k1["shapes"] = time_k1_groups(torch, later, hv, voters, TMR, DWC,
                                  REGISTRY, card) + k1["shapes"]

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
        # The campaign's own peak: phase 8's inputs are held meanwhile.
        held = torch.cuda.memory_allocated()
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
            f"peak {(torch.cuda.max_memory_allocated() - held) / 2**30:.2f}"
            f" GiB, "
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

    # 7. The fused engine and K2.
    k2 = time_k2(torch, later, fs, hv, _repair, card)
    k2["max_abs_err"] = max(k2["max_abs_err"], check_k2(torch, fs))
    k2["shapes"] = time_k2_groups(torch, later, fs, TMR, REGISTRY, card) \
        + k2["shapes"]
    hv.LAUNCHES = hc.LAUNCHES = 0
    fused_path(torch, TMR, DWC, CampaignRunner, REGISTRY, hv, hc, card)
    fused_launches = hc.LAUNCHES
    if fused_launches <= 0 or hv.LAUNCHES <= 0:
        fail("the fused path launched K1 or K2 no time")
    big = TMR(region, fuse_step=True)
    if big._fuse_plan is not None or big.fuse_plan_info.exact_dataflow:
        fail("matrixMultiply1024 (float32 leaves) built a fused plan")
    log("matrixMultiply1024 TMR fuse_step=True: no fused plan (float "
        "leaves), the unfused program runs")

    # 8. Device-only times, after every campaign (see defer_device_ms).
    for name, record, key, fn in later:
        record[key] = device_ms(torch, fn)
        log(f"{name} {record['shape']}: {key} {fmt_ms(record[key])} a call "
            f"(torch.profiler, 200 calls) [{card}]")
    later.clear()

    log(json.dumps({"kernels": [{
        "name": "vote",
        "route": "cuda",
        "source": "coast_tpu_torch/csrc/vote.cu",
        "replaces": "coast_tpu/ops/pallas_voters.py:87",
        "launches": main_launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "shapes": k1["shapes"],
    }, {
        "name": "commit",
        "route": "cuda",
        "source": "coast_tpu_torch/csrc/commit.cu",
        "replaces": "coast_tpu/ops/fused_step.py:373",
        "launches": fused_launches,
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "shapes": k2["shapes"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
