"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Needs as many NVIDIA cards as the cell asks for; without them it exits
with code 2 and prints no result.  The last line of standard output is
the result (JSON); the numbers the check compared, each beside its limit,
are the last lines of standard error.
"""

import os
import sys
import time

T_START = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Build and kernel caches at fixed places inside the checkout, so that
# only a checkout's first run builds.
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = os.path.join(ROOT, "build", _sub)
os.environ["USE_FLAX"] = "0"
# One process with few host threads: the host's share of a campaign is
# single-threaded numpy work, and idle worker threads only add noise.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "2"
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse
    import json
    from pathlib import Path

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    bench = Path(ROOT) / "BENCHMARK.json"
    cell = harness.load_cell(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              "card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        out, info = harness.run_cell(bench, args.workload, args.seed,
                                     args.seconds, bool(args.trace),
                                     device="cuda:0", t_start=T_START)
    except harness.CellError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 3
    print(json.dumps(info), file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"{k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
