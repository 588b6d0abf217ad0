"""Differential fuzzing of the restricted-C frontend against gcc.

The counterpart of ``coast_tpu/testing/c_fuzz.py``: its generator emits
the reference's source for every seed, byte for byte, and the lifted
program runs on the port's device (the card unless ``-d cpu``).

The hand-picked reference sources (mm.c, crc16.c, ...) pin the frontend
to four real programs; this tier pins its SEMANTICS broadly: a seeded
generator emits random programs inside the documented envelope
(frontend/c_lifter.py) -- 32-bit and narrow integer globals, for loops
over arrays, if/else, ternaries, compound assignment, helper-function
calls, pointer walks with ``*p++`` and ``while (length--)`` -- and each
program is

  1. compiled NATIVELY with gcc and executed (the ground-truth C
     implementation; the reference's own guests are gcc/llvm-compiled),
  2. ingested with ``lift_c`` and stepped to completion,

and every printf'd value must match bit-for-bit.  The generated
programs end by printing each written global's checksum plus every
scalar accumulator, so the whole observable state is compared, not just
a final value.

gcc flags pin the implementation-defined corners to the model's
semantics (which follow the reference's ARM targets): ``-fwrapv``
(signed wraparound mod 2^32 -- the 32-bit lane model) and
``-funsigned-char`` (plain char is unsigned on ARM AAPCS).

Deterministic per seed: ``python -m coast_tpu_torch.testing.c_fuzz -seed
7 -d cpu`` replays a failure; the failing source is printed.  ``-j N``
checks the seeds in N worker processes.  A run that passes every seed
prints ``Success!`` last; the seconds of each seed's gcc run, lift and
lifted run (and each worker's start-up) go to stderr.
"""

from __future__ import annotations

import argparse
import os
import random
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

_TYPES = [
    ("unsigned int", "uint32", False),
    ("int", "int32", False),
    ("uint8_t", "uint8", True),
    ("uint16_t", "uint16", True),
    ("short", "int16", True),
    ("int8_t", "int8", True),
]


class _Gen:
    def __init__(self, seed: int):
        self.r = random.Random(seed)
        self.arrays: List[Tuple[str, str, int]] = []   # (name, ctype, size)
        self.lines: List[str] = []
        self.printed = 0

    def _expr(self, depth, names):
        """Random integer expression over ``names`` (all promoted reads)."""
        r = self.r
        if depth <= 0 or r.random() < 0.3:
            if names and r.random() < 0.7:
                return r.choice(names)
            return str(r.randrange(0, 2**31 - 1)) + "u"
        a = self._expr(depth - 1, names)
        b = self._expr(depth - 1, names)
        op = r.choice(["+", "-", "*", "^", "&", "|", "<<", "?"])
        if op == "<<":
            # Shift only on an unsigned operand by a literal amount:
            # everything else is UB or sign-implementation territory.
            return f"((unsigned int)({a}) << {r.randrange(0, 8)})"
        if op == "?":
            c = self._expr(depth - 1, names)
            return f"(({a}) > ({b}) ? ({c}) : ({b}))"
        return f"(({a}) {op} ({b}))"

    def source(self) -> str:
        r = self.r
        g: List[str] = ["#include <stdio.h>",
                        "typedef unsigned char uint8_t;",
                        "typedef unsigned short uint16_t;",
                        "typedef unsigned int uint32_t;",
                        "typedef signed char int8_t;"]
        n_arrays = r.randrange(2, 4)
        for ai in range(n_arrays):
            ctype, _, _ = r.choice(_TYPES)
            size = r.randrange(4, 11)
            init = ", ".join(str(r.randrange(-100, 1000))
                             for _ in range(r.randrange(1, size + 1)))
            self.arrays.append((f"a{ai}", ctype, size))
            g.append(f"{ctype} a{ai}[{size}] = {{{init}}};")
        g.append("unsigned int acc0 = 0;")
        g.append("unsigned int acc1 = 1;")
        # A global array for pointer re-seating (local pointers may only
        # seat on globals; seating on a LOCAL array refuses by design).
        g.append("unsigned int rs[6] = {"
                 + ", ".join(str(r.randrange(1, 500))
                             for _ in range(6)) + "};")
        # Same-shaped partner for the union-pointer block (a pointer
        # seated on rs OR ua per traced branch).
        g.append("unsigned int ua[6] = {"
                 + ", ".join(str(r.randrange(1, 500))
                             for _ in range(6)) + "};")
        # Named 'b' ON PURPOSE: it collides with MIXM's second parameter,
        # so passing it as the FIRST argument pins simultaneous (non-
        # sequential) macro substitution.
        g.append(f"unsigned int b = {r.randrange(1, 10000)}u;")

        # A function-like macro used in expressions (simultaneous,
        # escape-safe substitution; the second parameter's name 'b'
        # deliberately collides with common argument text).
        mk = r.randrange(0, 6)
        g.append(f"#define MIXM(a, b) (((a) ^ ((unsigned int)(b) "
                 f"<< {mk})) + {r.randrange(1, 999)}u)")

        # A mix helper (exercises call inlining + promotions).
        k, c = r.randrange(0, 8), r.randrange(1, 99999)
        g.append(f"unsigned int mix(unsigned int a, unsigned int b) "
                 f"{{ return (a ^ ((unsigned int)(b) << {k})) + {c}u; }}")
        # A writer helper taking an array by reference and storing
        # through a walked pointer (deref stores + copy-in/out when the
        # caller passes a LOCAL array).
        g.append("void scale(unsigned int *p, uint8_t length, "
                 "unsigned int v) { while (length--) { "
                 "*p = (*p ^ v) + (unsigned int)sizeof(length); p++; } }")
        # Early-return helper over a walked pointer: the returning
        # iteration's tail (the mutation after the return point) must be
        # masked exactly as C does.
        g.append("unsigned int seek(unsigned int *p, uint8_t n, "
                 "unsigned int v) { uint8_t i; "
                 "for (i = 0; i < n; i++) { "
                 "if ((p[i] & 7u) == (v & 7u)) return v + (unsigned int)i; "
                 "p[i] = p[i] + 11u; } "
                 "return v ^ 21u; }")
        # A pointer-walk helper per array element type in use (exercises
        # *p++ / while (length--) / narrow deref promotion).
        walked_types = sorted({t for _, t, _ in self.arrays}
                              | {"unsigned int"})
        for t in walked_types:
            g.append(
                f"unsigned int walk_{t.replace(' ', '_')}"
                f"({t} *p, uint8_t length) {{ unsigned int s = 0; "
                f"while (length--) {{ s += (unsigned int)*p++; }} "
                f"return s; }}")

        body: List[str] = ["  int i;"]
        # A local array filled in a loop then passed BY REFERENCE to the
        # walker and the deref-store writer (copy-in/copy-out path).
        lsize = r.randrange(3, 8)
        body.append(f"  unsigned int lbuf[{lsize}] = "
                    f"{{{r.randrange(1, 50)}}};")
        body.append(f"  for (i = 0; i < {lsize}; i++) "
                    f"{{ lbuf[i] = lbuf[i] + (unsigned int)i * 3u; }}")
        body.append(f"  scale(lbuf, {r.randrange(1, lsize + 1)}, "
                    f"{r.randrange(1, 1000)}u);")
        body.append(f"  acc1 += walk_unsigned_int(lbuf, "
                    f"{r.randrange(1, lsize + 1)}) + "
                    f"(unsigned int)sizeof(lbuf) + (unsigned int)'A';")
        # Guaranteed macro-hazard exercise each seed: first argument is
        # the identifier 'b' (collides with the second parameter), the
        # second is a comma-bearing nested call into mix().
        body.append(f"  acc0 ^= MIXM(b, mix(acc1, "
                    f"{r.randrange(0, 99)}u));")
        # Early return through a walked pointer (data-dependent exit).
        body.append(f"  acc1 += seek(lbuf, {lsize}, acc0);")
        # Mid-loop conditional break with a data-dependent threshold and
        # work after the break point (both must be masked on the broken
        # iteration, incl. the i++).
        body.append(f"  for (i = 0; i < {lsize}; i++) {{ "
                    f"acc0 += lbuf[i]; "
                    f"if ((acc0 & {r.randrange(3, 31)}u) == 1u) break; "
                    f"acc1 ^= acc0 + (unsigned int)i; }}")
        body.append("  acc1 += (unsigned int)i;")
        for name, ctype, size in self.arrays:
            names = [f"{name}[i]", "(unsigned int)i", "acc0", "acc1"]
            stmts = []
            if r.random() < 0.8:
                stmts.append(f"{name}[i] = {self._expr(2, names)};")
            aop = r.choice(["+=", "^=", "|=", "&="])
            stmts.append(f"acc0 {aop} (unsigned int)({self._expr(1, names)});")
            if r.random() < 0.5:
                stmts.append(f"if (({name}[i] & 1) == 1) "
                             f"{{ acc1 += {self._expr(1, names)}; }} "
                             f"else {{ acc1 ^= acc0; }}")
            body.append(f"  for (i = 0; i < {size}; i++) {{ "
                        + " ".join(stmts) + " }")
            body.append(f"  acc1 += walk_{ctype.replace(' ', '_')}"
                        f"({name}, {r.randrange(1, size + 1)});")
            if r.random() < 0.5:
                body.append(f"  acc0 ^= MIXM(acc1, {r.randrange(0, 99)});")
        # switch dispatch in a loop: stacked labels, a default, and
        # break-terminated cases -- the desugared if-chain must match
        # C's dispatch exactly, including the evaluate-once control.
        mask = r.choice([3, 7])
        body.append(f"  for (i = 0; i < {lsize}; i++) {{ "
                    f"switch (lbuf[i] & {mask}u) {{ "
                    f"case 0: case 1: acc0 += {r.randrange(1, 99)}u; break; "
                    f"case 2: acc1 ^= acc0 + (unsigned int)i; break; "
                    f"case 3: acc0 ^= acc1 >> {r.randrange(1, 5)}; break; "
                    f"default: acc1 += 3u; break; }} }}")
        # do..while: body-first execution, side-effected counter.
        body.append(f"  {{ unsigned int dwc = {r.randrange(1, 6)}u; "
                    f"do {{ acc0 += dwc * 7u; dwc--; }} "
                    f"while (dwc != 0u); }}")
        # long long round trip: signed and unsigned 32x32->64 products
        # with both halves extracted (the limb-pair model vs gcc's
        # native 64-bit arithmetic).
        body.append(f"  {{ long long h; unsigned long long u; "
                    f"h = (long long)(int)acc0 * "
                    f"(long long)(int)(acc1 ^ {r.randrange(1, 999)}u); "
                    f"acc0 ^= (unsigned int)(h & 0x00000000ffffffffULL); "
                    f"acc1 += (unsigned int)(h >> 32); "
                    f"u = (unsigned long long)acc0 * "
                    f"(unsigned long long)b; "
                    f"acc0 += (unsigned int)(u >> 32); "
                    f"acc1 ^= (unsigned int)(u & 0xffffffffULL); }}")
        # Pointer re-seating on a global: seat, walk, re-seat, index.
        body.append(f"  {{ unsigned int *rp; rp = rs; "
                    f"acc0 += *rp++; rp = rp + {r.randrange(1, 3)}; "
                    f"acc1 ^= *rp; rp = rs; acc0 += rp[{r.randrange(0, 5)}]"
                    f" + rp[1]; *rp = acc0 & 1023u; }}")
        # Forward goto over live work (the CHStone adpcm/dfdiv shape):
        # the skipped statements must be masked exactly per the
        # data-dependent predicate, including a skipped array store.
        body.append(f"  if ((acc0 & {r.choice([3, 7, 15])}u) == "
                    f"{r.randrange(0, 3)}u) goto fskip; "
                    f"acc1 += {r.randrange(1, 999)}u; "
                    f"rs[{r.randrange(0, 6)}] ^= acc1; "
                    f"acc0 = acc0 * 5u + 1u; "
                    f"fskip: acc0 ^= {r.randrange(1, 99)}u;")
        # Union pointer: seated on DIFFERENT same-shaped globals per
        # traced branch (jpeg huffman-table shape); writes through the
        # branch-seated pointer must split back to the right member.
        body.append(f"  {{ unsigned int *up; int ui; "
                    f"for (ui = 0; ui < {lsize}; ui++) {{ "
                    f"if ((lbuf[ui] & {r.choice([1, 3])}u) == 0u) "
                    f"{{ up = rs; }} else {{ up = ua; }} "
                    f"up[ui % 6] = up[ui % 6] * 3u + (unsigned int)ui; }} }}")
        # 64-bit limb ARITHMETIC chain (not just one product): a long
        # long accumulator looped over an array with add/sub/shift and
        # a 64-bit comparison driving control flow -- the limb-pair
        # carry/borrow/shift model vs gcc's native 64-bit.
        body.append(f"  {{ long long s64; int li; s64 = 0; "
                    f"for (li = 0; li < {lsize}; li++) {{ "
                    f"s64 += (long long)(int)lbuf[li] * "
                    f"(long long)({r.randrange(3, 1000)} - (int)(li * 7)); "
                    f"s64 -= (long long)(int)acc0; }} "
                    # Shift through unsigned: s64 << k on a negative
                    # value is UB in ISO C; the round-trip is the
                    # defined spelling of the same bit pattern (and what
                    # the limb model computes).
                    f"s64 = (long long)((unsigned long long)s64 "
                    f"<< {r.randrange(1, 5)}); "
                    f"if (s64 > (long long){r.randrange(100, 100000)}) "
                    f"{{ acc0 ^= 77u; }} "
                    f"acc0 += (unsigned int)(s64 & 0xffffffffULL); "
                    f"acc1 ^= (unsigned int)((unsigned long long)s64 >> 32);"
                    f" }}")
        # Checksums: the whole written state becomes observable output
        # (rs/ua included -- the re-seating and union-pointer blocks
        # deref-store into them).
        self.arrays.append(("rs", "unsigned int", 6))
        self.arrays.append(("ua", "unsigned int", 6))
        for name, _, size in self.arrays:
            body.append(f"  {{ unsigned int chk = 0; "
                        f"for (i = 0; i < {size}; i++) "
                        f"{{ chk ^= (unsigned int){name}[i]; }} "
                        f'printf("%u\\n", chk); }}')
            self.printed += 1
        # lbuf's FULL checksum: scale()'s deref-store tail must be
        # observable even where the walk length is shorter.
        body.append(f"  {{ unsigned int lchk = 0; "
                    f"for (i = 0; i < {lsize}; i++) "
                    f"{{ lchk ^= lbuf[i]; }} "
                    f'printf("%u\\n", lchk); }}')
        body.append('  printf("%u\\n", acc0);')
        body.append('  printf("%u\\n", acc1);')
        self.printed += 3
        g.append("int main() {")
        if r.random() < 0.5:
            # Run-once loop idiom (sha256.c main): the body -- prints
            # included -- inlines into the enclosing scope.
            g.append("  while (1) {")
            g.extend(body)
            g.append("  break;")
            g.append("  }")
        else:
            g.extend(body)
        g.append("  return 0;")
        g.append("}")
        return "\n".join(g) + "\n"


def run_native(src_path: str, workdir: str) -> List[int]:
    exe = os.path.join(workdir, "native")
    subprocess.run(
        ["gcc", "-O1", "-fwrapv", "-funsigned-char", "-o", exe, src_path],
        check=True, capture_output=True)
    out = subprocess.run([exe], check=True, capture_output=True,
                         text=True, timeout=30)
    return [int(line) for line in out.stdout.split()]


def run_lifted(src_path: str, n_printed: int, device: str = "cuda",
               times: Optional[Dict[str, float]] = None) -> List[int]:
    """The last ``n_printed`` output words of the lifted program, run to
    its end on ``device``; ``times`` gets the lift's and the run's
    seconds."""
    from coast_tpu_torch.frontend.c_lifter import lift_c

    t0 = time.perf_counter()
    region = lift_c("fuzz", [src_path], device=device)
    t1 = time.perf_counter()
    final = region.run_unprotected(device)
    out = region.output({k: v.unsqueeze(0) for k, v in final.items()})[0]
    out = out.cpu().numpy().view(np.uint32)
    if times is not None:
        times.update(lift=t1 - t0, run=time.perf_counter() - t1)
    return [int(v) for v in out[-n_printed:]]


def check_seed(seed: int, keep: bool = False,
               device: str = "cuda") -> Dict[str, float]:
    """Raises AssertionError (with the source) on any divergence; returns
    the seconds of gcc's build and run, of the lift and of the lifted
    run."""
    gen = _Gen(seed)
    src = gen.source()
    times: Dict[str, float] = {}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, f"fuzz_{seed}.c")
        with open(path, "w") as f:
            f.write(src)
        t0 = time.perf_counter()
        native = run_native(path, d)
        times["gcc"] = time.perf_counter() - t0
        lifted = run_lifted(path, gen.printed, device, times)
    if native != lifted:
        raise AssertionError(
            f"seed {seed}: gcc {native} != lifted {lifted}\n--- source ---\n"
            + src)
    return times


def _seed_line(seed: int, times: Dict[str, float]) -> str:
    return (f"seed {seed}: gcc {times['gcc']:.2f} s, lift "
            f"{times['lift']:.2f} s, run {times['run']:.2f} s")


def _check_chunk(seeds: List[int], device: str, submitted: float) -> dict:
    """A worker process's seeds, on one host thread (the workers share
    the host's cores), with its start-up's seconds from ``submitted``
    (the parent's clock): to this call (the interpreter and torch), and
    to the device's first tensor."""
    import torch
    t0 = time.time()
    torch.set_num_threads(1)
    torch.zeros(1, device=device)
    t1 = time.time()
    return {"start": t0 - submitted, "device": t1 - t0,
            "seeds": {s: check_seed(s, device=device) for s in seeds},
            "end": time.time() - submitted}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-seed", type=int, default=0)
    ap.add_argument("-n", type=int, default=20)
    ap.add_argument("-d", "--device", default="cuda",
                    help="device the lifted programs run on (default the "
                         "card; 'cpu' for the host)")
    ap.add_argument("-j", type=int, default=1, metavar="N",
                    help="check the seeds in N worker processes")
    args = ap.parse_args(argv)
    seeds = list(range(args.seed, args.seed + args.n))
    if args.j <= 1:
        for s in seeds:
            times = check_seed(s, device=args.device)
            print(_seed_line(s, times), file=sys.stderr)
            print(f"seed {s}: ok")
    else:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        chunks = [seeds[k::args.j] for k in range(args.j)]
        with ProcessPoolExecutor(
                max_workers=args.j,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            futures = [pool.submit(_check_chunk, c, args.device,
                                   time.time()) for c in chunks if c]
            for k, f in enumerate(futures):
                w = f.result()      # a divergence raises, with its source
                print(f"worker {k}: started {w['start']:.2f} s, "
                      f"{args.device} ready {w['device']:.2f} s later, done "
                      f"{w['end']:.2f} s after its submission",
                      file=sys.stderr)
                for s, times in w["seeds"].items():
                    print(f"worker {k} {_seed_line(s, times)}",
                          file=sys.stderr)
        for s in seeds:
            print(f"seed {s}: ok")
    print("Success!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
