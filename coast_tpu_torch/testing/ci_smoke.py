"""Protection-regression-CI smoke driver (unittest/cfg/fast.yml row).

The counterpart of ``coast_tpu/testing/ci_smoke.py``, with its oracles,
on the card (or the host with ``-d cpu``).  Regression-checks the
``python -m coast_tpu_torch ci`` contract (prints ``Success!`` for the
harness driver oracle,
``coast_tpu_torch.testing.harness.run_drivers``):

  1. **baseline** -- two targets (mm x TMR, crc16 x DWC) run as full
     equivalence-reduced fleet campaigns into a baseline artifact.
  2. **no-op check** -- re-checking the unchanged tree re-injects ZERO
     rows on every target and passes (exit 0), and the refreshed
     artifact it produces is itself checkable.
  3. **weakened build** -- the seeded protection-weakening edit (the
     lint sweep's dropped-commit-vote regression seed:
     ``prog.step_sync["results"] = False`` on the TMR build) must
     change section fingerprints, re-inject only the affected target's
     sections, and FAIL the check with a per-class drift verdict
     (exit 1) while the untouched DWC target stays consistent.
"""

from __future__ import annotations

from typing import List, Optional

from coast_tpu_torch.testing import device_arg


def main(argv: Optional[List[str]] = None) -> int:
    device = device_arg(argv, "protection-regression-CI smoke")
    from coast_tpu_torch.ci import engine
    from coast_tpu_torch.inject.spec import CampaignSpec

    specs = [
        CampaignSpec("matrixMultiply", 512, seed=7, opt_passes="-TMR",
                     batch_size=256, equiv=True),
        CampaignSpec("crc16", 512, seed=7, opt_passes="-DWC",
                     batch_size=256, equiv=True),
    ]

    # 1. baseline
    doc = engine.build_baseline(specs, device=device)
    if len(doc["targets"]) != 2:
        print(f"baseline has {len(doc['targets'])} targets; want 2")
        return 1
    for tid, block in doc["targets"].items():
        if not block["section_fingerprints"]:
            print(f"{tid}: baseline carries no section fingerprints")
            return 1
    print(f"baseline built: {sorted(doc['targets'])}")

    # 2. no-op check: zero rows re-injected, exit 0
    report = engine.check_baseline(doc, device=device)
    if report.exit_code != engine.EXIT_PASS:
        print(f"no-op check FAILED:\n{report.format()}")
        return 1
    for t in report.targets:
        if t.reinjected_rows != 0 or t.changed_sections:
            print(f"no-op check re-injected rows: {t.target} "
                  f"{t.reinjected_rows} ({t.changed_sections})")
            return 1
    print("no-op check: 0 rows re-injected on every target; PASS")

    # ... and the refreshed artifact is itself a valid splice base.
    report2 = engine.check_baseline(report.refreshed, device=device)
    if report2.exit_code != engine.EXIT_PASS or any(
            t.reinjected_rows for t in report2.targets):
        print(f"refreshed-baseline check FAILED:\n{report2.format()}")
        return 1
    print("refreshed baseline checks clean")

    # 3. weakened TMR build must drift (and only it)
    def weaken(prog):
        if prog.region.name == "matrixMultiply" \
                and prog.step_sync.get("results"):
            prog.step_sync["results"] = False

    weak = engine.check_baseline(doc, program_hook=weaken,
                                 device=device)
    if weak.exit_code != engine.EXIT_DRIFT:
        print(f"weakened build did NOT drift:\n{weak.format()}")
        return 1
    by_target = {t.target: t for t in weak.targets}
    mm_t = next(t for tid, t in by_target.items()
                if tid.startswith("matrixMultiply|"))
    crc_t = next(t for tid, t in by_target.items()
                 if tid.startswith("crc16|"))
    if not mm_t.drift or not mm_t.changed_sections \
            or not mm_t.reinjected_rows:
        print(f"weakened mm target did not re-inject/drift: "
              f"{mm_t}")
        return 1
    if crc_t.drift or crc_t.reinjected_rows:
        print(f"untouched crc16 target drifted: {crc_t}")
        return 1
    print(f"weakened build: DRIFT on {mm_t.target} "
          f"(sections {mm_t.changed_sections}, "
          f"{mm_t.reinjected_rows} rows re-injected); "
          "crc16 stayed consistent")
    print("Success!")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main(sys.argv[1:]))
