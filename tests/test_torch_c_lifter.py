"""The port's restricted-C front end (``coast_tpu_torch/frontend/c_*``),
held against the reference's (``coast_tpu/frontend/c_lifter.py``) on the
same sources in the same process.

The sources are every inline C program of ``tests/test_c_lifter.py``
(read from that file, so the two never drift) and the three programs of
``tests/c_sources/``.  For each, both packages lift it with ``lift_c``.
Where the reference refuses, the port refuses with the same error class
and message.  Where it lifts, these are equal:

  * the leaves: names, kinds, ``xmr`` and ``unsigned`` (the reference's
    dtype is uint32), and ``nominal_steps`` / ``max_steps``;
  * ``meta``: sources, source_paths, coast_annotations, global_xmr,
    observed_globals, print_strings and arg_leaves;
  * the initial image (``interop.state_to_numpy``) and the fault-free
    output words;
  * TMR and DWC campaigns of 256 rows at seed 3: codes, errors,
    corrected and counts.

The dataflow is integer, so every comparison is exact.  The cases are
split over ``tests/test_torch_c_lifter*.py`` so that no file runs long
under ``--dist loadfile``; this file holds the shared helpers and the
three sources of ``tests/c_sources/`` (``_cli.py`` the CLI twins).
"""

import ast
import os
import subprocess
import warnings

import numpy as np
import pytest
import torch

pytest.importorskip("pycparser")

from coast_tpu_torch import DWC, TMR, interop                 # noqa: E402
from coast_tpu_torch.inject.campaign import CampaignRunner    # noqa: E402

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
C_SOURCES = os.path.join(HERE, "c_sources")
META_KEYS = ("sources", "source_paths", "coast_annotations", "global_xmr",
             "observed_globals", "print_strings", "arg_leaves")
ROWS, SEED = 256, 3


def inline_sources():
    """``[(case, text)]``: each C program written inline in
    ``tests/test_c_lifter.py`` (a string holding ``main(``), named after
    its test."""
    with open(os.path.join(HERE, "test_c_lifter.py")) as fh:
        tree = ast.parse(fh.read())
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        texts = [c.value for c in ast.walk(fn)
                 if isinstance(c, ast.Constant) and isinstance(c.value, str)
                 and "main(" in c.value]
        for k, text in enumerate(texts):
            name = fn.name[len("test_"):]
            out.append((name if len(texts) == 1 else f"{name}_{k}", text))
    return out


INLINE = dict(inline_sources())
# A source whose campaign does not finish in the reference either: a fault
# that flips a high bit of g makes f's nested ``while (g--)`` run for about
# 2^31 trips inside one step (the reference's own campaign ran past 300 s
# on the CPU without finishing).  Its lift, image and output are compared.
NO_CAMPAIGN = frozenset({"break_return_side_effecting_cond_exact_1"})
FILES = {name: os.path.join(C_SOURCES, f"{name}.c")
         for name in ("mm9", "crc16", "gcd")}


def _outcome(fn):
    """``("ok", region, warnings)`` or ``("err", class name, message)``."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            region = fn()
        except Exception as e:            # the refusal is compared
            return ("err", type(e).__name__, str(e))
    return ("ok", region, sorted(str(w.message) for w in caught))


_PAIRS = {}


def source_path(case, tmp_root):
    if case in FILES:
        return FILES[case]
    path = os.path.join(tmp_root, f"{case}.c")
    if not os.path.exists(path):
        with open(path, "w") as fh:
            fh.write(INLINE[case])
    return path


def pair(case, tmp_root):
    """The reference's and the port's lift of one case (cached)."""
    if case not in _PAIRS:
        from coast_tpu.frontend.c_lifter import lift_c as jlift_c
        from coast_tpu_torch.frontend import lift_c
        path = source_path(case, tmp_root)
        name = f"{case}_c"
        _PAIRS[case] = (_outcome(lambda: jlift_c(name, [path])),
                        _outcome(lambda: lift_c(name, [path],
                                                device="cpu")))
    return _PAIRS[case]


@pytest.fixture(scope="module")
def tmp_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("c_src"))


def leaves(region, image):
    return {k: (s.kind, s.xmr, s.unsigned, tuple(image[k].shape))
            for k, s in region.spec.items()}


def ref_leaves(region):
    image = {k: np.asarray(v) for k, v in region.init().items()}
    return {k: (s.kind, s.xmr, image[k].dtype == np.uint32,
                tuple(image[k].shape)) for k, s in region.spec.items()}


def meta_of(region):
    return {k: region.meta.get(k) for k in META_KEYS}


def port_words(region):
    st = region.run_unprotected("cpu")
    out = region.output({k: v.unsqueeze(0) for k, v in st.items()})[0]
    return out.numpy().view(np.uint32)


def ref_words(region):
    return np.asarray(region.output(region.run_unprotected())).view(
        np.uint32)


def _refusal(outcome):
    """A refusal with the lifting API named alike (the reference's
    message names ``lax.scan``, the port's ``loops.scan``)."""
    kind, cls, msg = outcome
    return kind, cls, msg.replace("loops.", "lax.")


def both(case, tmp_root):
    """The two regions of a case, or None where the reference refuses it
    (and then the port refuses it alike)."""
    ref, port = pair(case, tmp_root)
    if ref[0] == "err":
        assert port[0] == "err" and _refusal(port) == _refusal(ref), port
        return None
    assert port[0] == "ok", port
    return ref[1], port[1]


def check_refusal(case, tmp_root):
    ref, port = pair(case, tmp_root)
    if ref[0] == "ok":
        assert port[0] == "ok", port
        assert port[2] == ref[2]          # the same warnings
        return
    assert port[0] == "err" and _refusal(port) == _refusal(ref), port


def check_layout(case, tmp_root):
    got = both(case, tmp_root)
    if got is None:
        return
    ref, port = got
    assert list(port.spec) == list(ref.spec)
    assert leaves(port, port.init("cpu")) == ref_leaves(ref)
    assert (port.nominal_steps, port.max_steps) == (ref.nominal_steps,
                                                    ref.max_steps)
    assert meta_of(port) == meta_of(ref)


def check_image_and_output(case, tmp_root):
    got = both(case, tmp_root)
    if got is None:
        return
    ref, port = got
    want = {k: np.asarray(v) for k, v in ref.init().items()}
    got = interop.state_to_numpy(port.init("cpu"), port)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k
    np.testing.assert_array_equal(port_words(port), ref_words(ref))


def check_campaign(case, tmp_root, strategy):
    from coast_tpu import DWC as JDWC, TMR as JTMR
    from coast_tpu.inject.campaign import CampaignRunner as JRunner
    got = both(case, tmp_root)
    if got is None:
        return
    ref, port = got
    jstrat, strat = {"TMR": (JTMR, TMR), "DWC": (JDWC, DWC)}[strategy]
    a = JRunner(jstrat(ref)).run(ROWS, seed=SEED, batch_size=ROWS)
    b = CampaignRunner(strat(port, device="cpu")).run(ROWS, seed=SEED,
                                                      batch_size=ROWS)
    np.testing.assert_array_equal(b.codes, a.codes)
    np.testing.assert_array_equal(b.errors, a.errors)
    np.testing.assert_array_equal(b.corrected, a.corrected)
    assert b.counts == a.counts


# ---------------------------------------------------------------------------
# the three sources of tests/c_sources
# ---------------------------------------------------------------------------

def _gcc_prints(path, tmp_root):
    import shutil
    if shutil.which("gcc") is None:
        pytest.skip("gcc not available")
    exe = os.path.join(tmp_root, os.path.basename(path) + ".bin")
    subprocess.run(["gcc", "-O1", "-fwrapv", "-funsigned-char", "-w", "-o",
                    exe, path], check=True)
    out = subprocess.run([exe], check=True, capture_output=True, text=True)
    return [int(w) for w in out.stdout.split() if w.lstrip("-").isdigit()]


def oracle(case):
    """The value each source prints last, from the port's own models."""
    if case == "mm9":
        from coast_tpu_torch.models import mm
        return [mm.make_region().meta["golden_xor"], 0]
    if case == "crc16":
        from coast_tpu_torch.models import crc16
        return [crc16.GOLDEN]
    import math
    text = open(FILES["gcd"]).read()
    body = text.split("a_in[N] = {", 1)[1]
    a = [int(w.rstrip("u")) for w in
         body.split("}", 1)[0].replace(",", " ").split()]
    body = text.split("b_in[N] = {", 1)[1]
    b = [int(w.rstrip("u")) for w in
         body.split("}", 1)[0].replace(",", " ").split()]
    gs = [math.gcd(x, y) for x, y in zip(a, b)]
    x = 0
    for g in gs:
        x ^= g
    return [x, sum(gs) & 0xFFFFFFFF]


@pytest.mark.parametrize("case", sorted(FILES))
def test_source_lifts_alike(case, tmp_root):
    check_refusal(case, tmp_root)
    check_layout(case, tmp_root)


@pytest.mark.parametrize("case", sorted(FILES))
def test_source_image_and_output(case, tmp_root):
    check_image_and_output(case, tmp_root)


@pytest.mark.parametrize("case", sorted(FILES))
def test_source_oracle_and_gcc(case, tmp_root):
    """The printed words end with the oracle, in both packages, and equal
    what the program prints compiled by gcc."""
    ref, port = both(case, tmp_root)
    want = oracle(case)
    got = [int(w) for w in port_words(port)[-len(want):]]
    assert got == want
    assert [int(w) for w in ref_words(ref)[-len(want):]] == want
    assert _gcc_prints(FILES[case], tmp_root) == want


@pytest.mark.parametrize("strategy", ["TMR", "DWC"])
@pytest.mark.parametrize("case", sorted(FILES))
def test_source_campaign(case, strategy, tmp_root):
    check_campaign(case, tmp_root, strategy)


def test_gcd_has_a_nested_data_dependent_while(tmp_root):
    """gcd's Euclid loop is one loop operation of the first phase's body
    (not unrolled: its trip count is data), and the step runs it."""
    from coast_tpu_torch.frontend import loops
    _, port = both("gcd", tmp_root)
    assert port.meta["loops"] == ["scan", "scan"]
    rec = TMR(port, device="cpu").run(None)
    assert int(rec["errors"]) == 0 and bool(rec["done"])
    seen = []
    orig = loops.LoopOp.run_rows

    def spy(self, *a, **k):
        seen.append(self)
        return orig(self, *a, **k)

    loops.LoopOp.run_rows = spy
    try:
        port_words(port)
    finally:
        loops.LoopOp.run_rows = orig
    assert len({id(op) for op in seen}) == 1
    assert len(seen) >= 64                    # one a trip of the phase
