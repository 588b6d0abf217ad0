"""CHStone ``blowfish`` as a stepped program, in plain torch.

Written from the Blowfish description (Schneier, FSE 1993) and CHStone's
``blowfish`` C sources (``BF_set_key``, ``BF_encrypt``,
``BF_cfb64_encrypt``): an 18-word P-array and four 256-word S-boxes,
initialised from pi's fractional hex words and then keyed; a 16-round
Feistel network whose F function is ``((S0[a] + S1[b]) ^ S2[c]) + S3[d]``
over the bytes ``a b c d`` of its input; CFB64 over the plaintext.

The run is 1,171 steps, one encryption of the 64-bit chaining block
each:

* steps 0..520 are ``BF_set_key``'s expansion: the encryption of the
  chaining block fills the next P pair (steps 0..8) or S pair (steps
  9..520) and becomes the next chaining block;
* steps 521..1170 are ``BF_cfb64_encrypt`` over 650 blocks of 8 bytes:
  the encrypted ivec xor the plaintext block is the ciphertext, stored in
  ``out`` and chained as the next ivec.

The key (``TPUcoastBlowfish66``, 18 bytes) and the 5,200-byte text are
the campaign's own, not CHStone's byte arrays; the sizes are CHStone's.
The golden ciphertext is made here by a host oracle (plain Python
integers), and the self check counts ``out`` words that differ from it.

Where a fault can make them matter, the step keeps these rules of the
program under test (each written down because a corrupted ``i`` or
chaining word reaches it):

* the table write index: a negative one wraps once, one past the array
  is dropped (the write leaves the table as it was);
* the schedule index is ``i`` clamped into [0, 520] and the block index
  ``i - 521`` clamped into [0, 649];
* the P pair is written while ``i < 521`` and the clamped index is below
  9, the S pair while ``i < 521`` and it is 9 or more, ``out`` while
  ``i >= 521``;
* the chaining block is reset to the zero ivec on the step where ``i``
  is 520, the crossing into CFB;
* ``i`` counts up by one, wrapping at 2^31, and ``done`` is ``i >= 1171``.

``precision`` is what the F function adds in: ``"stated"`` is uint32
mod 2^32; ``"float32"`` (the control) carries its two additions in
float32, which loses the low bits of 32-bit words.  Nothing else changes
with it.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from perfbench.reference.engine import (KIND_CTRL, KIND_MEM, KIND_RO, Leaf,
                                        Region)

KEY = b"TPUcoastBlowfish66"
TEXT = (b"The quick brown fox jumps over the lazy dog. "
        b"Pack my box with five dozen liquor jugs. ")
DATA_BYTES = 5200
BLOCKS = DATA_BYTES // 8                   # 650 CFB64 blocks
KEY_STEPS = (18 + 1024) // 2               # 521 encryptions fill P and S
STEPS = KEY_STEPS + BLOCKS                 # 1,171
P_PAIRS = 18 // 2                          # the first 9 fill P
ROUNDS = 16
M32 = 0xFFFFFFFF
PRECISIONS = ("stated", "float32")


# -- host oracle --------------------------------------------------------------
def pi_words(n: int) -> List[int]:
    """The first ``n`` 32-bit words of pi's fractional part in hex, from
    Machin's formula pi = 16 atan(1/5) - 4 atan(1/239) in fixed point."""
    bits = 32 * n + 64                     # 64 guard bits
    one = 1 << bits

    def atan_inv(x: int) -> int:
        power = one // x                   # one / x^(2k+1)
        total, k = 0, 0
        while power:
            term = power // (2 * k + 1)
            total = total + term if k % 2 == 0 else total - term
            power //= x * x
            k += 1
        return total

    frac = 16 * atan_inv(5) - 4 * atan_inv(239) - 3 * one
    return [(frac >> (bits - 32 * (j + 1))) & M32 for j in range(n)]


def _f(s: List[int], x: int) -> int:
    a, b, c, d = x >> 24, (x >> 16) & 255, (x >> 8) & 255, x & 255
    return ((((s[a] + s[256 + b]) & M32) ^ s[512 + c]) + s[768 + d]) & M32


def encrypt(p: List[int], s: List[int], left: int, right: int
            ) -> Tuple[int, int]:
    """CHStone's ``BF_encrypt``: ``l ^= p[0]``, then sixteen ``BF_ENC``
    half-rounds alternating halves, then ``r ^= p[17]``; the output block
    is ``(r, l)``."""
    l, r = left ^ p[0], right
    for k in range(1, ROUNDS + 1):
        if k % 2:
            r ^= p[k] ^ _f(s, l)
        else:
            l ^= p[k] ^ _f(s, r)
    return r ^ p[ROUNDS + 1], l


def keyed_p(key: bytes) -> List[int]:
    """pi's first 18 words xor the key, read as big-endian words and
    repeated cyclically (``BF_set_key``'s first loop)."""
    words = pi_words(18)
    cyc = [key[j % len(key)] for j in range(4 * 18)]
    return [w ^ int.from_bytes(bytes(cyc[4 * k:4 * k + 4]), "big")
            for k, w in enumerate(words)]


def tables(key: bytes) -> Tuple[List[int], List[int]]:
    """The keyed P-array and S-boxes after the whole expansion."""
    p, s = keyed_p(key), pi_words(18 + 1024)[18:]
    block = (0, 0)
    for k in range(KEY_STEPS):
        block = encrypt(p, s, *block)
        table, at = (p, 2 * k) if k < P_PAIRS else (s, 2 * (k - P_PAIRS))
        table[at], table[at + 1] = block
    return p, s


def cfb64(key: bytes, data: bytes) -> np.ndarray:
    """``BF_cfb64_encrypt`` from the zero ivec: uint32 ``[blocks, 2]``."""
    p, s = tables(key)
    iv, out = (0, 0), []
    for b in range(0, len(data), 8):
        ks = encrypt(p, s, *iv)
        iv = (int.from_bytes(data[b:b + 4], "big") ^ ks[0],
              int.from_bytes(data[b + 4:b + 8], "big") ^ ks[1])
        out.append(iv)
    return np.array(out, np.uint32)


def corpus() -> bytes:
    return (TEXT * (DATA_BYTES // len(TEXT) + 1))[:DATA_BYTES]


# -- the stepped program ------------------------------------------------------
def _word(x: torch.Tensor) -> torch.Tensor:
    """int64 (any value) -> the int32 word of its low 32 bits."""
    x = x & M32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _u(x: torch.Tensor) -> torch.Tensor:
    """An int32 word as its uint32 value in int64."""
    return x.to(torch.int64) & M32


def _add(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a + b`` of uint32 values held in int64, mod 2^32."""
    if precision == "float32":
        total = a.to(torch.float32) + b.to(torch.float32)
        return total.to(torch.float64).remainder(2.0 ** 32).to(torch.int64)
    return (a + b) & M32


def _f_rows(s: torch.Tensor, x: torch.Tensor, precision: str
            ) -> torch.Tensor:
    """F of every row's ``x`` (uint32 in int64) on its own S-boxes
    ``s`` (int32 ``[R, 1024]``)."""
    idx = torch.stack([x >> 24, ((x >> 16) & 255) + 256,
                       ((x >> 8) & 255) + 512, (x & 255) + 768], dim=1)
    w = _u(s.gather(1, idx))
    return _add(_add(w[:, 0], w[:, 1], precision) ^ w[:, 2], w[:, 3],
                precision)


def _encrypt_rows(p: torch.Tensor, s: torch.Tensor, left: torch.Tensor,
                  right: torch.Tensor, precision: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`encrypt` of every row on its own tables (uint32 in int64)."""
    pw = _u(p)
    l, r = left ^ pw[:, 0], right
    for k in range(1, ROUNDS + 1):
        if k % 2:
            r = r ^ pw[:, k] ^ _f_rows(s, l, precision)
        else:
            l = l ^ pw[:, k] ^ _f_rows(s, r, precision)
    return r ^ pw[:, ROUNDS + 1], l


def _store_pair(table: torch.Tensor, at: torch.Tensor, pair: torch.Tensor,
                enable: torch.Tensor) -> torch.Tensor:
    """A copy of ``table`` ``[R, n]`` with ``table[r, at[r] + j] =
    pair[r, j]`` (``pair`` ``[R, 2]``) where ``enable``; each index wraps
    once when negative and is dropped outside ``[0, n)``."""
    n = table.shape[1]
    out = table.clone()
    rows = torch.arange(table.shape[0], device=table.device)
    for j in range(2):
        idx = at + j
        idx = torch.where(idx < 0, idx + n, idx)
        ok = enable & (idx >= 0) & (idx < n)
        col = idx.clamp(0, n - 1)
        out[rows, col] = torch.where(ok, pair[:, j], out[rows, col])
    return out


def _store_block(out: torch.Tensor, blk: torch.Tensor, ct: torch.Tensor,
                 enable: torch.Tensor) -> torch.Tensor:
    """A copy of ``out`` ``[R, blocks, 2]`` with block ``blk[r]`` set to
    ``ct[r]`` where ``enable`` (``blk`` is in range)."""
    res = out.clone()
    rows = torch.arange(out.shape[0], device=out.device)
    res[rows, blk] = torch.where(enable[:, None], ct, out[rows, blk])
    return res


def make(precision: str = "stated", name: str = "chstone_blowfish"
         ) -> Region:
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    data = corpus()
    golden = cfb64(KEY, data)
    image = {
        "plain": np.frombuffer(data, ">u4").astype(np.uint32)
                   .reshape(BLOCKS, 2),
        "P": np.array(keyed_p(KEY), np.uint32),
        "S": np.array(pi_words(18 + 1024)[18:], np.uint32),
        "out": np.zeros((BLOCKS, 2), np.uint32),
        "chain": np.zeros(2, np.uint32),
        "i": np.int32(0),
    }
    golden_words = torch.as_tensor(golden.view(np.int32))

    def step(state, t):
        i = state["i"].to(torch.int64)
        chain = _u(state["chain"])
        xl, xr = _encrypt_rows(state["P"], state["S"], chain[:, 0],
                               chain[:, 1], precision)
        pair = torch.stack([xl, xr], dim=1)
        keying = i < KEY_STEPS
        k = i.clamp(0, KEY_STEPS - 1)
        in_p = k < P_PAIRS
        words = _word(pair)
        new_p = _store_pair(state["P"], 2 * k, words, keying & in_p)
        new_s = _store_pair(state["S"], 2 * (k - P_PAIRS), words,
                            keying & ~in_p)
        blk = (i - KEY_STEPS).clamp(0, BLOCKS - 1)
        rows = torch.arange(i.shape[0], device=i.device)
        ct = _u(state["plain"][rows, blk]) ^ pair
        new_out = _store_block(state["out"], blk, _word(ct), ~keying)
        nxt = torch.where(keying[:, None], pair, ct)
        nxt = torch.where((i == KEY_STEPS - 1)[:, None],
                          torch.zeros_like(nxt), nxt)
        return {"P": new_p, "S": new_s, "out": new_out,
                "chain": _word(nxt), "i": _word(i + 1)}

    def done(view):
        return view["i"] >= STEPS

    def check(view):
        bad = view["out"] != golden_words.to(view["out"].device)
        return bad.reshape(bad.shape[0], -1).sum(dim=1).to(torch.int32)

    return Region(
        name=name,
        leaves=[Leaf("plain", KIND_RO, (BLOCKS, 2)),
                Leaf("P", KIND_MEM, (18,)),
                Leaf("S", KIND_MEM, (1024,)),
                Leaf("out", KIND_MEM, (BLOCKS, 2)),
                Leaf("chain", KIND_MEM, (2,)),
                Leaf("i", KIND_CTRL, ())],
        image=image, step=step, done=done, check=check,
        output_words=2 * BLOCKS, nominal_steps=STEPS, max_steps=STEPS + 8,
        # The tables and the chaining block form the S-box and P
        # addresses, ``i`` every load and store address.
        load_addr=frozenset({"P", "S", "chain", "i"}),
        store_addr=frozenset({"i"}),
        written=frozenset({"P", "S", "out", "chain", "i"}),
        done_leaves=("i",))
