"""Region fuzzing: the llvm-stress tier (unittest/llvm-stress.py:27-77).

The counterpart of ``coast_tpu/testing/fuzz.py``.  Random *stepped
regions* -- random uint32 dataflow over randomly-kinded state leaves with
a loop-carried program counter -- held to three oracles:

  1. every strategy (unprotected / TMR / DWC / TMR+CFCSS / segmented TMR /
     TMR without memory replication) builds and runs to completion;
  2. protection does not change semantics: every strategy's output equals
     the unprotected output;
  3. a single bit flip in one replica lane under TMR is voted away.

And random whole functions through ``lift_fn`` (main loop written with
``frontend.loops.scan``), and the random regions re-derived by
``lift_step`` with no hand-written spec: the lifted output equals the
function's eager result, every strategy keeps it, TMR masks a flip.

The same seed builds the same program as the reference: the numpy
``RandomState`` draws are made in the reference's order.  uint32 words are
int32 tensors here (``>>`` is ``ops/u32.lsr``).  Deterministic per seed,
so any failure is replayable:
``python -m coast_tpu_torch.testing.fuzz -seed 12345 -n 1 [-d cpu]``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

W = 8           # words per vector leaf (static shapes throughout)
MAX_OPS = 12    # random ops per step


def _words(a) -> torch.Tensor:
    """numpy uint32 words as an int32 tensor."""
    return torch.from_numpy(np.array(np.asarray(a, np.uint32).view(np.int32)))


def random_region(seed: int):
    """Build a random region from a seed: a random op mix over random
    operands, shaped as a stepped region."""
    from coast_tpu_torch.ir.graph import BlockGraph, pick
    from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_REG,
                                           KIND_RO, LeafSpec, Region)
    from coast_tpu_torch.ops.indexing import row_update
    from coast_tpu_torch.ops.u32 import lsr

    rng = np.random.RandomState(seed)
    n_mem = rng.randint(1, 4)
    n_reg = rng.randint(1, 3)
    steps = int(rng.randint(8, 33))

    leaves: Dict[str, LeafSpec] = {"pc": LeafSpec(KIND_CTRL)}
    init_vals: Dict[str, np.ndarray] = {"pc": np.int32(0)}
    for i in range(n_mem):
        leaves[f"m{i}"] = LeafSpec(KIND_MEM, unsigned=True)
        init_vals[f"m{i}"] = rng.randint(0, 2**32, W, np.uint32)
    for i in range(n_reg):
        leaves[f"r{i}"] = LeafSpec(KIND_REG, unsigned=True)
        init_vals[f"r{i}"] = rng.randint(0, 2**32, W, np.uint32)
    leaves["ro"] = LeafSpec(KIND_RO, unsigned=True)
    init_vals["ro"] = rng.randint(0, 2**32, W, np.uint32)

    data_leaves = [n for n in leaves if n != "pc"]
    writable = [n for n in data_leaves if n != "ro"]

    # A random straight-line op list, chosen once at build time.
    ops: List[tuple] = []
    for _ in range(rng.randint(3, MAX_OPS + 1)):
        kind = rng.choice(["add", "sub", "mul", "xor", "and", "or",
                           "shl", "shr", "rot", "sel", "gather", "scatter"])
        dst = rng.choice(writable)
        srcs = [rng.choice(data_leaves) for _ in range(3)]
        k = int(rng.randint(0, 32))
        ops.append((kind, dst, srcs, k))

    image = {k: (torch.tensor(int(v), dtype=torch.int32) if k == "pc"
                 else _words(v)) for k, v in init_vals.items()}

    def init(device):
        return {k: v.to(device).clone() for k, v in image.items()}

    def step(state, t):
        s = dict(state)
        for kind, dst, (a, b, c), k in ops:
            va, vb, vc = s[a], s[b], s[c]
            if kind == "add":
                out = va + vb
            elif kind == "sub":
                out = va - vb
            elif kind == "mul":
                out = va * vb
            elif kind == "xor":
                out = va ^ vb
            elif kind == "and":
                out = va & vb
            elif kind == "or":
                out = va | vb
            elif kind == "shl":
                out = va << (k % 31 + 1)
            elif kind == "shr":
                out = lsr(va, k % 31 + 1)
            elif kind == "rot":
                r = k % 31 + 1
                out = (va << r) | lsr(va, 32 - r)
            elif kind == "sel":
                out = torch.where((va & 1) == 1, vb, vc)
            elif kind == "gather":
                idx = torch.remainder(
                    torch.arange(W, dtype=torch.int32, device=vb.device)
                    + s["pc"][:, None] + k, W)
                out = torch.gather(vb, 1, idx.to(torch.int64))
            else:  # scatter
                slot = torch.remainder(s["pc"] + k, W)
                out = row_update(s[dst], vb[:, k % W], slot)
            s[dst] = out
        s["pc"] = state["pc"] + 1
        return {k: v for k, v in s.items() if v is not state[k]}

    def done(state):
        return state["pc"] >= steps

    def check(state):
        # The oracle is cross-strategy output equality (held by the
        # driver), not an in-region golden value.
        return torch.zeros(state["pc"].shape[0], dtype=torch.int32,
                           device=state["pc"].device)

    def output(state):
        return torch.cat([state[n].reshape(state[n].shape[0], -1)
                          for n in sorted(data_leaves)]
                         + [state["pc"].reshape(-1, 1)], dim=1)

    graph = BlockGraph(
        names=["entry", "body", "exit"],
        edges=[(0, 1), (1, 1), (1, 2)],
        block_of=lambda s: pick(s["pc"] >= steps, 2, 1))

    return Region(
        name=f"fuzz{seed}",
        init=init,
        step=step,
        done=done,
        check=check,
        output=output,
        nominal_steps=steps,
        max_steps=2 * steps,
        spec=leaves,
        default_xmr=True,
        graph=graph,
    )


def fuzz_one(seed: int, device="cuda") -> None:
    """Run the full oracle for one seed; raises AssertionError on any
    divergence."""
    from coast_tpu_torch import DWC, TMR, unprotected

    region = random_region(seed)
    region.validate()
    golden = unprotected(region, device=device).run()["output"].cpu()

    progs = {
        "TMR": TMR(region, device=device),
        "DWC": DWC(region, device=device),
        "TMR-s": TMR(region, device=device, segmented=True),
        "TMR+CFCSS": TMR(region, device=device, cfcss=True),
        "TMR-noMem": TMR(region, device=device, no_mem_replication=True),
    }
    for name, prog in progs.items():
        rec = prog.run()
        assert bool(rec["done"]), f"seed {seed}: {name} did not terminate"
        assert not bool(rec["dwc_fault"]), f"seed {seed}: {name} false DWC"
        assert not bool(rec["cfc_fault"]), f"seed {seed}: {name} false CFC"
        got = rec["output"].cpu()
        assert torch.equal(got, golden), (
            f"seed {seed}: {name} changed semantics "
            f"(first diff at {int(torch.nonzero(got != golden)[0])})")

    # Single-lane flip under TMR must be voted away.
    _assert_flip_masked(progs["TMR"], region, golden,
                        np.random.RandomState(seed ^ 0x5EED), seed)


def _assert_flip_masked(prog, region, golden, rng, seed) -> None:
    """Random single-lane flip into a replicated leaf under TMR: the
    output must still equal the fault-free golden image."""
    repl = [n for n in prog.leaf_order if prog.replicated.get(n)]
    leaf = repl[rng.randint(len(repl))]
    words = int(region.init("cpu")[leaf].numel()) or 1
    fault = {"leaf_id": prog.leaf_order.index(leaf),
             "lane": int(rng.randint(1, 3)),
             "word": int(rng.randint(words)),
             "bit": int(rng.randint(32)),
             "t": int(rng.randint(region.nominal_steps))}
    got = prog.run(fault)["output"].cpu()
    assert torch.equal(got, golden), (
        f"seed {seed}: TMR failed to mask a single-lane flip in {leaf}")


# ---------------------------------------------------------------------------
# Lifter fuzzing
# ---------------------------------------------------------------------------

_FN_OPS = ("add", "xor", "mul", "or", "and", "shl", "shr", "sub")


def random_fn(seed: int):
    """A random function with a ``loops.scan`` main loop: random uint32
    dataflow over loop carries (+ optional scanned inputs), random stacked
    outputs, and a post-loop epilogue.  Returns ``(fn, example_args)``,
    the arguments int32 tensors holding the words."""
    from coast_tpu_torch.frontend import loops
    from coast_tpu_torch.ops.u32 import lsr

    rng = np.random.RandomState(seed ^ 0x11F7E4)
    n_carry = int(rng.randint(1, 4))
    n_xs = int(rng.randint(0, 3))
    length = int(rng.randint(4, 25))
    n_ops = int(rng.randint(3, MAX_OPS))
    prog = []
    n_vals = n_carry + n_xs
    for _ in range(n_ops):
        op = _FN_OPS[rng.randint(len(_FN_OPS))]
        a = int(rng.randint(n_vals))
        b = int(rng.randint(n_vals))
        sh = int(rng.randint(1, 31))
        prog.append((op, a, b, sh))
        n_vals += 1
    carry_picks = [int(rng.randint(n_vals)) for _ in range(n_carry)]
    y_pick = int(rng.randint(n_vals))

    def fn(*args):
        c0 = args[:n_carry]
        xs = args[n_carry:]

        def body(carry, x):
            vals = list(carry) + ([] if x is None else list(x))
            for op, a, b, sh in prog:
                va, vb = vals[a], vals[b]
                if op == "add":
                    vals.append(va + vb)
                elif op == "sub":
                    vals.append(va - vb)
                elif op == "xor":
                    vals.append(va ^ vb)
                elif op == "mul":
                    vals.append(va * vb)
                elif op == "or":
                    vals.append(va | vb)
                elif op == "and":
                    vals.append(va & vb)
                elif op == "shl":
                    vals.append(va << sh)
                else:
                    vals.append(lsr(va, sh))
            new_carry = tuple(vals[i] for i in carry_picks)
            return new_carry, vals[y_pick]

        final, ys = loops.scan(
            body, tuple(c0), tuple(xs) if xs else None,
            length=length if not xs else None)
        # Epilogue: fold the stacked outputs into the result.
        return tuple(f ^ -1515870811 for f in final) + (ys[-1],)  # 0xA5A5A5A5

    args = tuple(torch.tensor(int(v), dtype=torch.int32)
                 for v in rng.randint(0, 2**32, n_carry,
                                      np.uint32).view(np.int32))
    args += tuple(_words(rng.randint(0, 2**32, length, np.uint32))
                  for _ in range(n_xs))
    return fn, args


def fuzz_lifter_one(seed: int, device="cuda") -> None:
    """lift_fn + lift_step soundness for one seed."""
    from coast_tpu_torch import DWC, TMR, unprotected
    from coast_tpu_torch.frontend import lift_fn, lift_step

    # -- whole-function lifting --------------------------------------------
    fn, args = random_fn(seed)
    with torch.no_grad():
        want = torch.cat([w.reshape(-1) for w in fn(*args)])
    region = lift_fn(f"fuzzfn{seed}", fn, *args, device=device)
    final = region.run_unprotected(device)
    got = region.output({k: v.unsqueeze(0) for k, v in final.items()})[0]
    assert torch.equal(got.cpu(), want), (
        f"seed {seed}: lift_fn changed the function's result")

    for name, prog in (("TMR", TMR(region, device=device)),
                       ("DWC", DWC(region, device=device))):
        rec = prog.run()
        assert int(rec["errors"]) == 0, f"seed {seed}: lift_fn {name} broke"
        assert bool(rec["done"])

    # -- step lifting with no hand-written spec ----------------------------
    hand = random_region(seed)
    lifted = lift_step(f"fuzzstep{seed}", hand.step, hand.init,
                       done=hand.done, device=device)
    golden = unprotected(lifted, device=device).run()["output"].cpu()
    prog = TMR(lifted, device=device)
    rec = prog.run()
    assert int(rec["errors"]) == 0, f"seed {seed}: lift_step TMR broke"

    _assert_flip_masked(prog, lifted, golden,
                        np.random.RandomState(seed ^ 0x11F7), seed)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="random-region fuzzing")
    parser.add_argument("-n", type=int, default=10, help="number of seeds")
    parser.add_argument("-seed", type=int, default=0, help="first seed")
    parser.add_argument("-mode", choices=("region", "lifter", "all"),
                        default="all")
    parser.add_argument("-d", "--device", default="cuda",
                        help="cuda (the card, default) or cpu")
    args = parser.parse_args(argv)

    for seed in range(args.seed, args.seed + args.n):
        try:
            if args.mode in ("region", "all"):
                fuzz_one(seed, args.device)
            if args.mode in ("lifter", "all"):
                fuzz_lifter_one(seed, args.device)
        except AssertionError as e:
            print(f"FAILED: {e}")
            return 1
        print(f"seed {seed}: ok")
    print("Success!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
