"""The port's native ndjson encoder (``csrc/ndjson.cpp`` through
``coast_tpu_torch.native``) against its Python formatter and the
reference's.

On seeded column sets that hold every class code (the DUE sub-buckets
and the training refinements included), negative and extreme words,
cache-invalid rows (``t < 0``) and leaf names that need JSON escaping,
the native bytes equal the port's Python formatter's, the reference's
Python formatter's and the reference's native encoder's.  A campaign's
dense ndjson log is byte for byte the Python formatter's one-shot,
streamed in ragged batches, resumed from a journal and empty, and the
dense rows really went through the library (its row counter).  A buffer
too short for the rows makes the encoder return -1 and the caller retry
fewer rows; a bad code or leaf id returns -2; a failed ``g++`` build
raises, and nothing falls back to Python.
"""

import ctypes
import json

import numpy as np
import pytest
import torch

import coast_tpu_torch as ct
from coast_tpu_torch import build, native
from coast_tpu_torch.inject import logs
from coast_tpu_torch.inject.campaign import CampaignRunner
from coast_tpu_torch.models import REGISTRY

torch.set_num_threads(1)

TS = "2026-01-01 00:00:00.000000"
# JSON-escaping cases: a quote, a backslash, control characters and
# non-ASCII (escaped as \\u00e9 by json.dumps).
NAMES = ("results", 'quo"te', "back\\slash", "tab\there", "nl\nx",
         "ctl\x01", "café", "")
KINDS = ("mem", "reg", "ctrl", "ro", "stack", "odd\"kind", "mem", "reg")


def column_set(n, seed):
    """Seeded int32 columns: every class code, full-range words and
    counts, a share of cache-invalid rows."""
    rng = np.random.RandomState(seed)
    i32 = np.iinfo(np.int32)
    col = {k: rng.randint(i32.min, i32.max, n, dtype=np.int64).astype(
        np.int32) for k in ("lane", "word", "bit", "errors", "corrected",
                            "steps")}
    col["leaf_id"] = rng.randint(0, len(NAMES), n).astype(np.int32)
    col["code"] = (np.arange(n) % 10).astype(np.int32)
    t = rng.randint(-3, 5000, n).astype(np.int32)
    t[:4] = (-1, i32.min, 0, i32.max)
    col["t"] = t
    col["word"][:3] = (i32.min, -1, i32.max)
    return col


def tables():
    kinds = [json.dumps(k)[1:-1] for k in KINDS]
    names = [json.dumps(k)[1:-1] for k in NAMES]
    return kinds, names


def native_rows(col, lo=0, hi=None, **kw):
    out = []
    native.ndjson_stream_rows(lo, len(col["code"]) if hi is None else hi,
                              col, *tables(), TS, out.append, **kw)
    return b"".join(out)


def python_rows(module, col, num0=0):
    out = []
    module._ndjson_rows_py({k: v.tolist() for k, v in col.items()},
                           dict(enumerate(KINDS)), dict(enumerate(NAMES)),
                           TS, num0, out.append)
    return "".join(out).encode()


def test_every_code_and_escaped_names_equal_both_formatters():
    from coast_tpu.inject import logs as jlogs
    from coast_tpu import native as jnative
    col = column_set(4000, seed=3)
    got = native_rows(col)
    assert got == python_rows(logs, col)
    assert got == python_rows(jlogs, col)
    assert jnative.native_available()
    ref = []
    assert jnative.ndjson_stream_rows(0, 4000, col, *tables(), TS,
                                      ref.append)
    assert got == b"".join(ref)
    lines = got.decode().splitlines()
    assert len(lines) == 4000
    rows = [json.loads(line) for line in lines]
    assert {r["number"] for r in rows} == set(range(4000))
    assert rows[5]["symbol"] == NAMES[col["leaf_id"][5]] or \
        col["t"][5] < 0
    assert any(r["section"] == "cache-invalid" for r in rows)
    keys = {next(iter(r["result"])) for r in rows}
    assert {"stackOverflow", "assertion", "selfHeal", "trainSdc",
            "invalid", "trap", "type", "timestamp"} <= keys


def test_batches_equal_the_whole_columns():
    """Ragged batches through the per-batch entry, numbered from their
    base, concatenate to the whole columns' rows."""
    col = column_set(1000, seed=4)
    whole = native_rows(col)
    out, lo = [], 0
    for size in (1, 63, 7, 0, 129, 300, 500):
        part = {k: v[lo:lo + size] for k, v in col.items()}
        native.ndjson_stream_batch(lo, part, *tables(), TS, out.append)
        lo += size
    assert lo == 1000
    assert b"".join(out) == whole
    # Sub-ranges of the one-shot entry too.
    assert native_rows(col, 0, 400) + native_rows(col, 400, 1000) == whole


def test_short_buffer_retries_fewer_rows():
    col = column_set(50, seed=5)
    lib = native._ndjson_lib()
    n_leaves, kinds, names, ts_b, _ = native._tables(*tables(), TS)
    cols = native._int32_columns(col)
    size = 900                      # two or three lines, never ten
    buf = ctypes.create_string_buffer(size)

    def encode(i, j, code=None, cap=size):
        args = [cols[k] if k != "code" or code is None else code
                for k in native._NDJSON_COLUMNS]
        return lib.coast_ndjson_encode(i, j, *args, n_leaves, kinds, names,
                                       ts_b, buf, cap)

    assert encode(0, 10) == -1
    assert encode(0, 1) > 0
    bad = cols["code"].copy()
    bad[2] = 10
    assert encode(2, 3, code=bad) == -2
    assert encode(0, 1, cap=-1) == -2
    out = []
    native._drain_encoded(encode, 0, 50, 10, buf, out.append)
    assert len(out) > 5             # every chunk of 10 was halved
    assert b"".join(out) == native_rows(col)
    with pytest.raises(RuntimeError, match="rc=-1"):
        native._drain_encoded(lambda i, j: encode(i, j, cap=10), 0, 5, 2,
                              buf, out.append)


def test_hundred_thousand_rows_equal_python():
    col = column_set(100_000, seed=6)
    before = native.ENCODED_ROWS
    got = native_rows(col, chunk_bytes=1 << 20)
    assert native.ENCODED_ROWS - before == 100_000
    assert got == python_rows(logs, col)


@pytest.fixture(scope="module")
def runner():
    prog = ct.TMR(REGISTRY["matrixMultiply"](), device="cpu")
    return CampaignRunner(prog, strategy_name="TMR")


def _log(path):
    """(summary without its stage timings, row bytes) of an ndjson log."""
    head, rows = path.read_bytes().split(b"\n", 1)
    summary = json.loads(head)["summary"]
    summary.pop("stages", None)
    return summary, rows


@pytest.mark.parametrize("n", (150, 0))
def test_campaign_logs_equal_python_oneshot_streamed_resumed(
        n, runner, tmp_path, monkeypatch):
    """One-shot (native) = one-shot (Python formatter) = streamed in
    ragged batches = resumed from a journal after a kill, byte for byte
    (the summary header's stage timings aside); the dense rows went
    through the library."""
    monkeypatch.setattr(logs, "_timestamp", lambda: TS)
    res = runner.run(n, seed=3, batch_size=64)
    before = native.ENCODED_ROWS
    logs.write_ndjson(res, runner.mmap, str(tmp_path / "native.json"))
    assert native.ENCODED_ROWS - before == n
    logs._write_ndjson_py(res, runner.mmap, TS, str(tmp_path / "py.json"))
    summary, rows = _log(tmp_path / "native.json")
    assert (summary, rows) == _log(tmp_path / "py.json")
    assert len(rows.splitlines()) == n

    w = logs.StreamLogWriter(str(tmp_path / "stream.json"), runner.mmap)
    streamed = runner.run(n, seed=3, batch_size=64, stream=w)
    w.finish(streamed)
    assert _log(tmp_path / "stream.json")[1] == rows
    assert native.ENCODED_ROWS - before == 2 * n

    if n:
        class Kill(Exception):
            pass

        def kill_on_second(done, counts):
            if done >= 128:
                raise Kill

        journal = str(tmp_path / "j.ndjson")
        w2 = logs.StreamLogWriter(str(tmp_path / "killed.json"),
                                  runner.mmap)
        with pytest.raises(Kill):
            runner.run(n, seed=3, batch_size=64, journal=journal,
                       progress=kill_on_second, stream=w2)
        w2.abort()
        w3 = logs.StreamLogWriter(str(tmp_path / "resumed.json"),
                                  runner.mmap)
        resumed = runner.run(n, seed=3, batch_size=64, journal=journal,
                             stream=w3)
        w3.finish(resumed)
        assert _log(tmp_path / "resumed.json")[1] == rows


def test_campaign_rows_equal_the_reference(runner, tmp_path, monkeypatch):
    """The same seeded campaign through both packages' dense ndjson
    writers (each package's native encoder): equal rows."""
    import coast_tpu
    from coast_tpu.inject import logs as jlogs
    from coast_tpu.inject.campaign import CampaignRunner as JRunner
    from coast_tpu.models import REGISTRY as JREGISTRY
    monkeypatch.setattr(logs, "_timestamp", lambda: TS)
    monkeypatch.setattr(jlogs, "_timestamp", lambda: TS)
    res = runner.run(200, seed=5, batch_size=64)
    jrunner = JRunner(coast_tpu.TMR(JREGISTRY["matrixMultiply"]()),
                      strategy_name="TMR")
    jres = jrunner.run(200, seed=5, batch_size=64)
    logs.write_ndjson(res, runner.mmap, str(tmp_path / "port.json"))
    jlogs.write_ndjson(jres, jrunner.mmap, str(tmp_path / "ref.json"))
    assert _log(tmp_path / "port.json")[1] == _log(tmp_path / "ref.json")[1]


def test_sparse_rows_keep_the_python_formatter(tmp_path, monkeypatch):
    monkeypatch.setattr(logs, "_timestamp", lambda: TS)
    prog = ct.TMR(REGISTRY["crc16"](), device="cpu")
    r = CampaignRunner(prog, strategy_name="TMR", collect="sparse")
    res = r.run(200, seed=3, batch_size=64)
    before = native.ENCODED_ROWS
    logs.write_ndjson(res, r.mmap, str(tmp_path / "sparse.json"))
    assert native.ENCODED_ROWS == before
    rows = _log(tmp_path / "sparse.json")[1].splitlines()
    assert len(rows) == len(res.codes)


def test_failed_build_raises(tmp_path, monkeypatch, runner):
    """A source g++ refuses raises with the compiler's message; the log
    writer raises too, and the old log stays as it was."""
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "ndjson.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(build, "CSRC", tmp_path / "src")
    monkeypatch.setattr(build, "HOST_BUILD_DIR", tmp_path / "host")
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for "
                                           "csrc/ndjson.cpp"):
        build.load_host("ndjson")
    path = tmp_path / "log.json"
    path.write_text("old log\n")
    res = runner.run(10, seed=1, batch_size=10)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        logs.write_ndjson(res, runner.mmap, str(path))
    assert path.read_text() == "old log\n"
    assert [p.name for p in (tmp_path / "host").iterdir()] == []
