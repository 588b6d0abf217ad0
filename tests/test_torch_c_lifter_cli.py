"""The ``.c`` paths of the port's CLIs against the reference's CLIs on
the sources of ``tests/c_sources``: ``opt`` (its printed record, a missing
file, a refused source) and the supervisor (line 1 of a reference-format
log names the source, and the records are the reference's); ``_cli_b.py``
the lint, the advisor and a harness ``.c`` entry.  Every CLI runs in this
process, the port's with ``device="cpu"``."""

import os

import pytest

pytest.importorskip("pycparser")

from test_torch_c_lifter import FILES                       # noqa: E402


def _call(fn, *args, **kwargs):
    """``(exit code, stdout, stderr)`` of an in-process CLI ``main``."""
    import contextlib
    import io
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = fn(*args, **kwargs)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("case", sorted(FILES))
def test_opt_tmr_on_a_c_source_prints_as_the_reference(case):
    from coast_tpu.opt import main as jopt
    from coast_tpu_torch.opt import main as opt
    argv = ["-TMR", "-countErrors", FILES[case]]
    want = _call(jopt, argv)
    got = _call(opt, argv, device="cpu")
    assert got[:2] == want[:2]
    assert "E: 0" in got[1]


def test_opt_missing_c_file_exits_2_as_the_reference(tmp_path):
    from coast_tpu.opt import main as jopt
    from coast_tpu_torch.opt import main as opt
    argv = ["-TMR", str(tmp_path / "nope.c")]
    want = _call(jopt, argv)
    got = _call(opt, argv, device="cpu")
    assert got == want
    assert got[0] == 2 and "does not exist" in got[2]


@pytest.mark.parametrize("text", ["int main() { goto x; x: return 0; }",
                                  "int main( {"])
def test_opt_refusal_of_a_c_source_as_the_reference(tmp_path, text):
    from coast_tpu.opt import main as jopt
    from coast_tpu_torch.opt import main as opt
    src = tmp_path / "bad.c"
    src.write_text(text)
    want = _call(jopt, ["-TMR", str(src)])
    got = _call(opt, ["-TMR", str(src)], device="cpu")
    assert got[0] == want[0] == 1
    assert got[2].replace("loops.", "lax.") == want[2]


def test_supervisor_reference_log_names_the_source(tmp_path):
    """Line 1 of a reference-format log is the C source, in both
    packages, and the records are the reference's."""
    import json
    from coast_tpu.inject.supervisor import main as jsup
    from coast_tpu_torch.inject.supervisor import main as sup
    src = FILES["crc16"]
    logs = {}
    for key, fn in (("ref", jsup), ("port", sup)):
        d = tmp_path / key
        d.mkdir()
        rc, _, _ = _call(fn, ["-f", src, "-t", "64", "--batch-size", "64",
                              "-l", str(d), "--log-format", "reference",
                              "-d", "cpu"])
        assert rc == 0
        with open(d / "crc16_TMR_memory.json") as fh:
            assert fh.readline().strip() == os.path.realpath(src)
            logs[key] = json.load(fh)
    def strip(rows):
        out = []
        for r in rows:
            r = {k: v for k, v in r.items() if k != "timestamp"}
            r["result"] = {k: v for k, v in r["result"].items()
                           if k != "timestamp"}
            out.append(r)
        return out

    assert strip(logs["port"]) == strip(logs["ref"])
