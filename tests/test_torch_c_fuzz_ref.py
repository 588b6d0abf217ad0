"""The fuzz tier's programs lifted by both packages: for the reference's
tier-1 seeds 0-3 (``_ref_b.py``: 4-7), the port's lifted output words
(``c_fuzz.run_lifted`` on the CPU) equal the reference's ``lift_c``
program run fault-free (``tests/test_torch_c_fuzz.py`` holds the
generator and the gcc differential)."""

import shutil

import pytest

pycparser = pytest.importorskip("pycparser")

if shutil.which("gcc") is None:                     # pragma: no cover
    pytest.skip("gcc not available", allow_module_level=True)


SEEDS = range(4)


@pytest.mark.parametrize("seed", SEEDS)
def test_lifted_output_equals_the_reference(seed, tmp_path):
    import numpy as np
    from coast_tpu.frontend.c_lifter import lift_c as jlift_c
    from coast_tpu_torch.testing.c_fuzz import _Gen, run_lifted
    gen = _Gen(seed)
    path = tmp_path / f"fuzz_{seed}.c"
    path.write_text(gen.source())
    ref = jlift_c("fuzz", [str(path)])
    want = np.asarray(ref.output(ref.run_unprotected())).astype(np.uint32)
    assert run_lifted(str(path), gen.printed, device="cpu") == \
        [int(v) for v in want[-gen.printed:]]
