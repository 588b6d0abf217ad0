"""The host-side core: the numpy seed streams, the native ndjson log
encoder and the CFCSS signature assignment.

The counterpart of ``coast_tpu/native/__init__.py``.  The reference runs
its seed streams in a C++ core when it is built and falls back to numpy
with bit-identical results; the port keeps the numpy bodies only.
:func:`splitmix_fill` is the stream every seeded schedule draws from, and
:func:`fault_expand` turns a base single-site schedule into the extra rows
of its flip groups (``inject/schedule.FaultModel``), drawing from a
derived stream keyed by :data:`FAULT_EXPAND_SALT`.

:func:`ndjson_stream_rows` and :func:`ndjson_stream_batch` format dense
campaign rows as InjectionLog ndjson lines in C++ (``csrc/ndjson.cpp``,
built with ``g++`` at first use by ``build.load_host``), byte for byte
the Python formatter of ``inject/logs.py``.  A ``ctypes`` call releases
the interpreter lock, so the streaming writer's thread encodes while the
campaign's step loop dispatches.  A failed build raises; nothing falls
back to the Python formatter.  :func:`ndjson_classify_stream` is the read
side, the class counts of a dense ndjson log in the same library
(``coast_ndjson_classify``), which ``analysis/json_parser.py`` takes for
a dense ndjson file.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Mapping, Sequence, Tuple

import numpy as np

_SPLITMIX_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MASK64 = 0xFFFFFFFFFFFFFFFF

#: Derived-stream salt of the flip-group expansion: its draws come from
#: ``_splitmix_at(seed, FAULT_EXPAND_SALT)``, so they never collide with the
#: base schedule's own (seed, counter) stream.
FAULT_EXPAND_SALT = 0x5EEDFA11

_FAULT_KINDS = ("multibit", "cluster", "burst")


def splitmix_fill(seed: int, n: int) -> np.ndarray:
    """n counter-mode splitmix64 draws (uint64): value i is the finalizer
    of ``seed + (i + 1) * golden``."""
    seed = seed & _MASK64
    with np.errstate(over="ignore"):
        idx = np.arange(1, n + 1, dtype=np.uint64)
        z = np.uint64(seed) + idx * _SPLITMIX_GOLDEN
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _splitmix_at(seed: int, i: int) -> int:
    """Value ``i`` of the ``seed`` stream (a Python int)."""
    z = (seed + (i + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fault_expand(seed: int, kind: str, sites: int, span: int, window: int,
                 steps: int, base: Mapping[str, np.ndarray],
                 sec_tables: Sequence[np.ndarray]
                 ) -> Tuple[np.ndarray, ...]:
    """Expand a base single-site schedule into its extra flip-group rows.

    ``base`` holds int32 columns (leaf_id, lane, word, bit, t,
    section_idx), one row per injection; ``sec_tables`` is
    ``MemoryMap.section_tables()``: ``(bits_end, leaf, lanes, words)``.
    Returns ``(group, leaf_id, lane, word, bit, t)`` int32 arrays of length
    ``n * (sites - 1)``, site-major within an injection: extra row
    ``i * (sites - 1) + (j - 1)`` is injection i's site j."""
    if kind not in _FAULT_KINDS:
        raise KeyError(kind)
    n = len(base["leaf_id"])
    m = n * (sites - 1)
    cols = {k: np.ascontiguousarray(base[k], np.int32)
            for k in ("leaf_id", "lane", "word", "bit", "t", "section_idx")}
    bits_end = np.ascontiguousarray(sec_tables[0], np.int64)
    sec_leaf, sec_lanes, sec_words = (
        np.ascontiguousarray(a, np.int32) for a in sec_tables[1:])
    exp_seed = _splitmix_at(seed & _MASK64, FAULT_EXPAND_SALT)
    extras = sites - 1
    group = np.repeat(np.arange(n, dtype=np.int32), extras)
    i = group.astype(np.int64)                    # base row per extra row
    j = np.tile(np.arange(1, sites, dtype=np.int64), n)   # site index
    if kind == "multibit":
        u = splitmix_fill(exp_seed, n)
        stride = (1 + 2 * (u % np.uint64(16)))[i]
        bit = ((cols["bit"][i].astype(np.uint64)
                + j.astype(np.uint64) * stride) % np.uint64(32))
        return (group, cols["leaf_id"][i], cols["lane"][i],
                cols["word"][i], bit.astype(np.int32), cols["t"][i])
    # Extra row r (site-major: r = i*extras + (j-1) = 0..m-1 in order)
    # consumes stream draws 2r and 2r+1.
    u = splitmix_fill(exp_seed, 2 * m) if m else np.zeros(0, np.uint64)
    u0, u1 = u[0::2], u[1::2]
    if kind == "cluster":
        s = cols["section_idx"][i]
        words = sec_words[s].astype(np.uint64)
        lw = sec_lanes[s].astype(np.uint64) * words
        phys = (cols["lane"][i].astype(np.uint64) * words
                + cols["word"][i].astype(np.uint64)
                + np.uint64(1) + u0 % np.uint64(span)) % lw
        return (group, cols["leaf_id"][i],
                (phys // words).astype(np.int32),
                (phys % words).astype(np.int32),
                (u1 % np.uint64(32)).astype(np.int32), cols["t"][i])
    # burst: a fresh uniform location over the whole map, clustered time.
    total_bits = np.uint64(bits_end[-1])
    flat = (u0 % total_bits).astype(np.int64)
    s = np.searchsorted(bits_end, flat, side="right")
    start = np.where(s == 0, 0, bits_end[np.maximum(s - 1, 0)])
    off = flat - start
    per_lane = sec_words[s].astype(np.int64) * 32
    t0 = cols["t"][i].astype(np.int64)
    tj = np.minimum(t0 + (u1 % np.uint64(window)).astype(np.int64),
                    steps - 1)
    return (group, sec_leaf[s].astype(np.int32),
            (off // per_lane).astype(np.int32),
            ((off % per_lane) // 32).astype(np.int32),
            (off % 32).astype(np.int32),
            np.where(t0 < 0, t0, tj).astype(np.int32))



def cfcss_assign(n: int, edges, seed: int = 0, sig_bits: int = 16) -> dict:
    """CFCSS signature assignment over a block graph (node 0 = entry):
    ``dict(sigs, diffs, fanin, dedge, attempts)``, equal to the
    reference's.  Unique random signatures from the ``seed + attempt``
    stream, the designated-predecessor differences, the fan-in adjusters
    folded into per-edge words (``dedge[u, v]``), then the soundness check
    (no illegal jump ``u -> v`` may verify); a failed check draws again,
    at most 64 times.  Host-side, once a program."""
    seed = seed & _MASK64
    edges = np.ascontiguousarray(np.asarray(edges, np.int32).reshape(-1, 2))
    if n <= 0 or not (1 < sig_bits <= 32):
        raise ValueError("cfcss_assign failed (rc=-2)")
    if np.any(edges < 0) or np.any(edges >= n):
        raise ValueError("cfcss_assign failed (rc=-2)")
    mask = 0xFFFFFFFF if sig_bits == 32 else (1 << sig_bits) - 1
    for attempt in range(64):
        used = set()
        sigs = np.zeros(n, np.uint32)
        ctr = 0
        for v in range(n):
            spins = 0
            while True:
                s = _splitmix_at(seed + attempt, ctr) & mask
                ctr += 1
                spins += 1
                if s not in used:
                    break
                if spins > mask + 8:
                    raise ValueError("cfcss_assign failed (rc=-1)")
            used.add(s)
            sigs[v] = s

        is_edge = np.zeros((n, n), bool)
        u0 = np.full(n, -1, np.int32)
        pred_count = np.zeros(n, np.int32)
        for u, v in edges:
            if is_edge[u, v]:
                continue
            is_edge[u, v] = True
            pred_count[v] += 1
            if u0[v] < 0 or u < u0[v]:
                u0[v] = u
        fanin = pred_count > 1
        diffs = np.where(u0 >= 0, sigs[np.maximum(u0, 0)] ^ sigs, sigs)
        dedge = np.zeros((n, n), np.uint32)
        for u, v in edges:
            if fanin[v]:
                dedge[u, v] = sigs[u0[v]] ^ sigs[u]

        g = sigs[:, None] ^ diffs[None, :]          # illegal jump u -> v
        if not np.logical_and(~is_edge, g == sigs[None, :]).any():
            return {"sigs": sigs, "diffs": diffs.astype(np.uint32),
                    "fanin": fanin, "dedge": dedge, "attempts": attempt + 1}
    raise ValueError("cfcss_assign failed (rc=-1)")

# -- the native ndjson encoder ------------------------------------------------

_NDJSON_COLUMNS = ("leaf_id", "lane", "word", "bit", "t", "code", "errors",
                   "corrected", "steps")
#: Rows the native encoder has formatted in this process (a test reads
#: it to see that a dense log went through the library).
ENCODED_ROWS = 0


def _ndjson_lib() -> ctypes.CDLL:
    from coast_tpu_torch import build
    lib = build.load_host("ndjson")
    if not getattr(lib, "coast_typed", False):
        i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        strs = ctypes.POINTER(ctypes.c_char_p)
        for fn in (lib.coast_ndjson_encode, lib.coast_ndjson_encode_rows):
            fn.argtypes = [ctypes.c_int64, ctypes.c_int64, *([i32] * 9),
                           ctypes.c_int32, strs, strs, ctypes.c_char_p,
                           ctypes.c_char_p, ctypes.c_int64]
            fn.restype = ctypes.c_int64
        i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.coast_ndjson_classify.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, i64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.coast_ndjson_classify.restype = ctypes.c_int64
        lib.coast_typed = True
    return lib


def _tables(kind_by_leaf, name_by_leaf, ts: str):
    """The C string tables of one campaign and the advisory bound on one
    line's length (the writer checks every write; see _drain_encoded)."""
    n_leaves = len(kind_by_leaf)
    kinds = (ctypes.c_char_p * n_leaves)(*(s.encode() for s in kind_by_leaf))
    names = (ctypes.c_char_p * n_leaves)(*(s.encode() for s in name_by_leaf))
    ts_b = ts.encode()
    longest = max([len(ts_b)] + [len(s) for s in kinds]
                  + [len(s) for s in names])
    line_bound = 320 + 2 * len(ts_b) + 3 * longest + 9 * 20
    return n_leaves, kinds, names, ts_b, line_bound


def _int32_columns(col) -> dict:
    return {k: np.ascontiguousarray(col[k], np.int32)
            for k in _NDJSON_COLUMNS}


def ndjson_stream_rows(lo: int, hi: int, col: Mapping[str, np.ndarray],
                       kind_by_leaf: Sequence[str],
                       name_by_leaf: Sequence[str], ts: str,
                       write: Callable[[bytes], object],
                       chunk_bytes: int = 32 << 20) -> None:
    """Rows [lo, hi) of whole-campaign columns (``col``: int32 arrays by
    the names of ``_NDJSON_COLUMNS``) as ndjson lines numbered by row,
    handed to ``write`` a bounded chunk at a time.  ``kind_by_leaf`` /
    ``name_by_leaf`` are JSON-escaped strings indexed by leaf id."""
    lib = _ndjson_lib()
    n_leaves, kinds, names, ts_b, line_bound = _tables(
        kind_by_leaf, name_by_leaf, ts)
    cols = _int32_columns(col)
    buf = ctypes.create_string_buffer(chunk_bytes)

    def encode(i, j):
        return lib.coast_ndjson_encode(
            i, j, *(cols[k] for k in _NDJSON_COLUMNS), n_leaves, kinds,
            names, ts_b, buf, chunk_bytes)

    _drain_encoded(encode, lo, hi, max(1, chunk_bytes // line_bound), buf,
                   write)


def ndjson_stream_batch(number_base: int, col: Mapping[str, np.ndarray],
                        kind_by_leaf: Sequence[str],
                        name_by_leaf: Sequence[str], ts: str,
                        write: Callable[[bytes], object],
                        chunk_bytes: int = 32 << 20) -> None:
    """ONE collected batch's rows as ndjson lines numbered
    ``number_base``...: byte for byte the same rows of
    :func:`ndjson_stream_rows` over the whole campaign's columns.  The
    buffer is sized to the batch (bounded by ``chunk_bytes``): a
    zero-filled 32 MiB a batch would cost more than the encode."""
    lib = _ndjson_lib()
    n_leaves, kinds, names, ts_b, line_bound = _tables(
        kind_by_leaf, name_by_leaf, ts)
    cols = _int32_columns(col)
    n = len(cols["code"])
    buf_bytes = int(min(chunk_bytes, line_bound * max(n, 1) + 4096))
    buf = ctypes.create_string_buffer(buf_bytes)

    def encode(i, j):
        # Rows [i, j) of the batch: the column base and the number base
        # move together, so chunking does not show in the output.
        return lib.coast_ndjson_encode_rows(
            j - i, number_base + i,
            *(cols[k][i:j] for k in _NDJSON_COLUMNS), n_leaves, kinds,
            names, ts_b, buf, buf_bytes)

    _drain_encoded(encode, 0, n, max(1, buf_bytes // line_bound), buf,
                   write)


def _drain_encoded(encode, lo: int, hi: int, rows_per_chunk: int, buf,
                   write) -> None:
    """Encode rows [lo, hi) in chunks of ``rows_per_chunk``, halving a
    chunk that overflowed the buffer (the encoder returns -1), and hand
    each encoded chunk to ``write``."""
    global ENCODED_ROWS
    i = lo
    while i < hi:
        j = min(hi, i + rows_per_chunk)
        wrote = encode(i, j)
        while wrote == -1 and j - i > 1:
            j = i + max(1, (j - i) // 2)
            wrote = encode(i, j)
        if wrote < 0:
            raise RuntimeError(
                f"coast_ndjson_encode failed (rc={wrote}) on rows "
                f"[{i}, {j})")
        write(ctypes.string_at(buf, wrote))
        ENCODED_ROWS += j - i
        i = j


#: Lines the native classifier has read in this process (a test reads it to
#: see that a summary went through the library).
CLASSIFIED_LINES = 0


def ndjson_classify_stream(read_chunk, chunk_bytes: int = 32 << 20):
    """Classify InjectionLog ndjson rows with ``coast_ndjson_classify``.

    ``read_chunk(n)`` returns up to n bytes (an open binary file's
    ``read``); a partial trailing line is carried into the next chunk.
    Returns ``(counts[NUM_CLASSES], step_sum, step_n, n_lines)``; raises
    ValueError if a line is not InjectionLog-shaped (the caller falls back
    to the Python parser).  A failed build of the library raises."""
    global CLASSIFIED_LINES
    from coast_tpu_torch.inject.classify import NUM_CLASSES
    lib = _ndjson_lib()
    counts = np.zeros(NUM_CLASSES, np.int64)
    step_sum = ctypes.c_int64(0)
    step_n = ctypes.c_int64(0)
    total = 0
    carry = b""
    while True:
        chunk = read_chunk(chunk_bytes)
        if not chunk:
            buf, carry = carry, b""
        else:
            data = carry + chunk
            cut = data.rfind(b"\n")
            if cut < 0:
                carry = data
                continue
            buf, carry = data[:cut + 1], data[cut + 1:]
        if buf:
            got = lib.coast_ndjson_classify(
                buf, len(buf), counts, ctypes.byref(step_sum),
                ctypes.byref(step_n))
            if got < 0:
                raise ValueError("not an InjectionLog ndjson stream")
            total += got
        if not chunk:
            break
    CLASSIFIED_LINES += total
    return counts, int(step_sum.value), int(step_n.value), total
