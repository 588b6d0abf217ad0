"""The port's gcc-differential fuzz tier (``coast_tpu_torch/testing/
c_fuzz.py``) against the reference's (``coast_tpu/testing/c_fuzz.py``).

For each seed the port's generator must emit the reference's source byte
for byte; ``check_seed`` (gcc ``-O1 -fwrapv -funsigned-char`` against the
port's lifted run, on the CPU) must pass for the reference's tier-1 seeds
0-7 (``test_torch_c_fuzz_ref.py``: the port's lifted output words equal
the reference's for the same programs).
"""

import shutil

import pytest

pycparser = pytest.importorskip("pycparser")

if shutil.which("gcc") is None:                     # pragma: no cover
    pytest.skip("gcc not available", allow_module_level=True)


@pytest.mark.parametrize("seed", range(32))
def test_generator_emits_the_reference_source(seed):
    from coast_tpu.testing.c_fuzz import _Gen as JGen
    from coast_tpu_torch.testing.c_fuzz import _Gen
    want, got = JGen(seed), _Gen(seed)
    assert got.source() == want.source()
    assert got.printed == want.printed


@pytest.mark.parametrize("seed", range(8))
def test_differential_vs_gcc(seed):
    from coast_tpu_torch.testing.c_fuzz import check_seed
    check_seed(seed, device="cpu")


def test_cli_prints_success(capsys):
    from coast_tpu_torch.testing.c_fuzz import main
    assert main(["-seed", "3", "-n", "2", "-d", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == ["seed 3: ok", "seed 4: ok", "Success!"]


def test_cli_in_worker_processes(capsys):
    from coast_tpu_torch.testing.c_fuzz import main
    assert main(["-seed", "0", "-n", "2", "-d", "cpu", "-j", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == ["seed 0: ok", "seed 1: ok", "Success!"]
