"""Recorded differential C-fuzz sweep.

The counterpart of the reference's ``scripts/c_fuzz_sweep.py``: it runs
the differential fuzzer (``coast_tpu_torch.testing.c_fuzz``: a generated
program's gcc ground truth against its ``lift_c`` run, the whole
observable state compared) over a seed range and writes a record with

  * the ENVELOPE HASH (sha256 of the port's generator source), so a
    recorded sweep is tied to the generator that produced it: editing the
    envelope invalidates earlier evidence and restarts the record, and a
    record of the reference's generator never merges into the port's;
  * the exact seed ranges that passed, merged across resumed runs;
  * any failures with their error text (the seed replays the failure:
    ``python -m coast_tpu_torch.testing.c_fuzz -seed N -d cpu``).

Resumable: progress is flushed every --chunk seeds, and a rerun skips
seeds already recorded under the same envelope hash.  The lifted
programs run on the card unless ``-d cpu``; ``-j N`` checks each chunk's
seeds in N worker processes, as ``c_fuzz -j`` does, and each seed's
gcc, lift and run seconds go to stderr.

Usage: python -m coast_tpu_torch.scripts.c_fuzz_sweep [--start 0]
       [-n 1000] [--chunk 50] [-d cpu] [-j N]
       [--out build/studies/c_fuzz_sweep.json]
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import sys
import time
from typing import Dict, List

from coast_tpu_torch import device as device_mod
from coast_tpu_torch.scripts import common

GENERATOR = "coast_tpu_torch/testing/c_fuzz.py"
GEN_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "testing", "c_fuzz.py")


def envelope_sha() -> str:
    with open(GEN_SRC, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()[:16]


def merge_ranges(ranges):
    """Merge [lo, hi) pairs."""
    out = []
    for lo, hi in sorted(ranges):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def covered(ranges, seed: int) -> bool:
    return any(lo <= seed < hi for lo, hi in ranges)


def check_seeds(seeds: List[int], device: str) -> Dict[int, dict]:
    """seed -> ``{"times": ...}`` or ``{"error": ...}``: a divergence is
    recorded, not fatal."""
    from coast_tpu_torch.testing.c_fuzz import check_seed
    out = {}
    for seed in seeds:
        try:
            out[seed] = {"times": check_seed(seed, device=device)}
        except Exception as e:  # noqa: BLE001 -- recorded, not fatal
            out[seed] = {"error": str(e)[:500]}
    return out


def _worker_seeds(seeds: List[int], device: str) -> Dict[int, dict]:
    import torch
    torch.set_num_threads(1)        # the workers share the host's cores
    return check_seeds(seeds, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("-n", type=int, default=1000)
    ap.add_argument("--chunk", type=int, default=50)
    ap.add_argument("--out", default=common.default_out(
        "c_fuzz_sweep.json"))
    ap.add_argument("-d", "--device", default="cuda", choices=("cuda", "cpu"),
                    help="device the lifted programs run on (default the "
                         "card)")
    ap.add_argument("-j", type=int, default=1, metavar="N",
                    help="check each chunk's seeds in N worker processes")
    args = ap.parse_args(argv)
    device_mod.resolve(args.device)

    sha = envelope_sha()
    art = {"generator": GENERATOR, "envelope_sha": sha, "ranges": [],
           "n_pass": 0, "failures": [], "seconds": 0.0}
    if os.path.exists(args.out):
        try:
            with open(args.out) as fh:
                prev = json.load(fh)
            if prev.get("envelope_sha") == sha:
                art = prev
            else:
                print(f"# envelope changed ({prev.get('envelope_sha')} -> "
                      f"{sha}); prior record invalidated", file=sys.stderr)
        except (json.JSONDecodeError, OSError):
            pass

    def flush(pending_lo, next_seed):
        if next_seed > pending_lo:
            art["ranges"] = merge_ranges(
                art["ranges"] + [[pending_lo, next_seed]])
        art["n_pass"] = sum(hi - lo for lo, hi in art["ranges"]) \
            - len({f["seed"] for f in art["failures"]
                   if covered(art["ranges"], f["seed"])})
        art["date"] = datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds")
        common.write_record(args.out, art)

    pool = None
    if args.j > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        pool = ProcessPoolExecutor(
            max_workers=args.j,
            mp_context=multiprocessing.get_context("spawn"))

    def run_chunk(seeds: List[int]) -> Dict[int, dict]:
        if pool is None:
            return check_seeds(seeds, args.device)
        futures = [pool.submit(_worker_seeds, seeds[k::args.j], args.device)
                   for k in range(args.j) if seeds[k::args.j]]
        got = {}
        for f in futures:
            got.update(f.result())
        return got

    try:
        t0 = time.perf_counter()
        lo = args.start
        end = args.start + args.n
        todo = [s for s in range(args.start, end)
                if not covered(art["ranges"], s)]
        done = 0
        for k in range(0, len(todo), args.chunk):
            seeds = todo[k:k + args.chunk]
            for seed, got in sorted(run_chunk(seeds).items()):
                if "error" in got:
                    art["failures"].append({"seed": seed,
                                            "error": got["error"]})
                    print(f"# seed {seed}: FAIL", file=sys.stderr,
                          flush=True)
                else:
                    t = got["times"]
                    print(f"# seed {seed}: gcc {t['gcc']:.2f} s, lift "
                          f"{t['lift']:.2f} s, run {t['run']:.2f} s",
                          file=sys.stderr, flush=True)
            done += len(seeds)
            art["seconds"] = round(
                art.get("seconds", 0.0) + time.perf_counter() - t0, 1)
            t0 = time.perf_counter()
            next_seed = seeds[-1] + 1 if k + args.chunk < len(todo) else end
            flush(lo, next_seed)
            lo = next_seed
            print(f"# {done}/{len(todo)} ({len(art['failures'])} failures)",
                  file=sys.stderr, flush=True)
        art["seconds"] = round(
            art.get("seconds", 0.0) + time.perf_counter() - t0, 1)
        flush(lo, end)
    finally:
        if pool is not None:
            pool.shutdown()
    print(json.dumps({"envelope_sha": sha, "n_pass": art["n_pass"],
                      "n_fail": len(art["failures"]),
                      "ranges": art["ranges"]}))
    return 1 if art["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
