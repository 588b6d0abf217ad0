"""The port's MWTF report on the training region against the reference's
(``scripts/mwtf_report.py --benchmarks train_mlp``), on the CPU.

A train row adds the selective-xMR strategy and the analytic FLOPs
column, which equals the reference's.  Its campaigns are held by the
train regions' stated rule (``tests/test_torch_train.py``): XLA and the
port round the same f32 chain in other orders, and on some hosts the
reference's own fault-free TMR and DWC rows read ``train_self_heal``, so
the converged classes (success, corrected, train_self_heal) are pooled
and every class's 95 % Wilson interval must overlap the reference's.
"""

import json

import pytest
import torch

from coast_tpu_torch.obs.convergence import interval_table, intervals_overlap
from coast_tpu_torch.scripts import mwtf_report

torch.set_num_threads(1)

CONVERGED = ("success", "corrected", "train_self_heal")
STRATS = ("unprotected", "DWC", "TMR", "selective-xMR")


def coarse(counts):
    out = {k: v for k, v in counts.items()
           if k not in CONVERGED and k != "cache_invalid"}
    out["converged"] = sum(counts[k] for k in CONVERGED)
    return out


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    import jax
    import jax.extend
    from scripts import mwtf_report as ref
    tmp = tmp_path_factory.mktemp("mwtf_train")
    argv = ["-n", "128", "--batch", "128", "--benchmarks", "train_mlp",
            "--cpu"]
    assert mwtf_report.main(argv + ["--out", str(tmp / "port.json")]) == 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "Jaxpr", jax.extend.core.Jaxpr, raising=False)
        assert ref.main(argv + ["--out", str(tmp / "ref.json")]) == 0
    return (json.loads((tmp / "port.json").read_text())["benchmarks"][
        "train_mlp"], json.loads((tmp / "ref.json").read_text())[
        "benchmarks"]["train_mlp"])


def test_train_row_keys_and_analytic_flops(records):
    got, want = records
    assert sorted(got) == sorted(want)
    assert sorted(got["campaigns"]) == sorted(STRATS)
    assert got["flops_overhead_source"] == want["flops_overhead_source"] \
        == "analytic"
    assert got["flops_overhead"] == want["flops_overhead"]
    for strat in STRATS:
        assert set(got["campaigns"][strat]) == set(want["campaigns"][strat])
        assert sum(got["campaigns"][strat].values()) == 128


@pytest.mark.parametrize("strat", STRATS)
def test_train_campaigns_within_the_train_tolerance(records, strat):
    got, want = records
    a = interval_table(coarse(got["campaigns"][strat]))
    b = interval_table(coarse(want["campaigns"][strat]))
    for k in a:
        assert intervals_overlap(a[k], b[k]), (strat, k, got["campaigns"],
                                               want["campaigns"])
    assert got["campaigns"][strat]["sdc"] == 0
    if strat != "unprotected":
        vs = got[f"vs_unprotected_{strat}"]
        assert set(vs) == set(want[f"vs_unprotected_{strat}"])
