"""Sparse-collect smoke driver (unittest/cfg/fast.yml row).

The counterpart of ``coast_tpu/testing/sparse_smoke.py``:

  * dense and sparse collection at the same seed produce IDENTICAL
    classification counts and the identical interesting-row set (rows
    whose class is outside success/corrected);
  * the measured host<->device transfer bytes shrink;
  * a journaled sparse campaign killed mid-run resumes bit-for-bit, and
    a dense runner refuses the sparse journal;
  * a tiny interesting-row buffer capacity falls back to dense fetch for
    overflowing batches without changing any result.

Prints ``Success!``.
"""

from __future__ import annotations

import os
import sys
import tempfile
from typing import List, Optional

import numpy as np

from coast_tpu_torch.testing import Kill, device_arg, kill_after


def main(argv: Optional[List[str]] = None) -> int:
    device = device_arg(argv, "sparse-collect smoke")
    from coast_tpu_torch import TMR
    from coast_tpu_torch.inject.campaign import CampaignRunner
    from coast_tpu_torch.inject.journal import JournalMismatchError
    from coast_tpu_torch.models import mm

    region = mm.make_region()
    dense = CampaignRunner(TMR(region, device=device), strategy_name="TMR")
    sparse = CampaignRunner(TMR(region, device=device), strategy_name="TMR",
                            collect="sparse")

    a = dense.run(240, seed=17, batch_size=48)
    b = sparse.run(240, seed=17, batch_size=48)
    assert a.counts == b.counts, (a.counts, b.counts)
    interesting = np.flatnonzero(a.codes > 1)
    assert np.array_equal(interesting, b.interesting_rows), \
        "sparse interesting-row set diverged from dense"
    for col in ("codes", "errors", "corrected", "steps"):
        assert np.array_equal(getattr(a, col)[interesting],
                              getattr(b, col)), col
    dense_bytes = a.transfer["up"] + a.transfer["down"]
    sparse_bytes = b.transfer["up"] + b.transfer["down"]
    assert sparse_bytes < dense_bytes, (dense_bytes, sparse_bytes)
    print(f"# host bytes: dense {dense_bytes} -> sparse {sparse_bytes} "
          f"({dense_bytes / max(sparse_bytes, 1):.1f}x)")

    # Overflow fallback: a 2-row buffer cannot hold the interesting rows
    # of any batch here, so every batch takes the dense-fetch fallback.
    tiny = CampaignRunner(TMR(region, device=device), collect="sparse",
                          sparse_capacity=2)
    c = tiny.run(240, seed=17, batch_size=48)
    assert c.counts == a.counts
    assert np.array_equal(c.interesting_rows, interesting)

    # Kill + resume, bit-for-bit; dense refuses the sparse journal.
    with tempfile.TemporaryDirectory() as d:
        jpath = os.path.join(d, "sparse.journal")
        beats = {"n": 0}
        try:
            CampaignRunner(TMR(region, device=device),
                           collect="sparse").run(
                240, seed=17, batch_size=48, journal=jpath,
                progress=kill_after(beats))
            raise AssertionError("kill hook never fired")
        except Kill:
            pass
        resumed = CampaignRunner(TMR(region, device=device),
                                 collect="sparse").run(
            240, seed=17, batch_size=48, journal=jpath)
        assert resumed.counts == b.counts
        assert np.array_equal(resumed.interesting_rows, b.interesting_rows)
        for col in ("codes", "errors", "corrected", "steps"):
            assert np.array_equal(getattr(resumed, col),
                                  getattr(b, col)), col
        try:
            CampaignRunner(TMR(region, device=device)).run(
                240, seed=17, batch_size=48, journal=jpath)
            raise AssertionError("dense resume of a sparse journal "
                                 "must refuse")
        except JournalMismatchError:
            pass

    print("Success!")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
