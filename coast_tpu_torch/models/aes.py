"""aes: AES-128 encrypt then decrypt of one block as a torch region
(BASELINE config 2, -TMR; also in the CHStone suite, config 4).

The counterpart of ``coast_tpu/models/aes.py``: one region step per AES
round (11 encrypt + 11 decrypt = 22 steps), the ciphertext checked against
the one a host-side AES model gives, the decrypted block against the
plaintext.  SubBytes is a per-row gather from the injectable S-box
leaves, ShiftRows a static permutation, MixColumns GF(2^8) arithmetic on
int32 bytes.  Every byte is masked to 8 bits where it is read (the
reference's uchar semantics once a flip lands); the round-key and S-box
reads are ``jnp.take(mode="clip")``: a negative index reads entry 0.
Its block graph (``graph``, read by CFCSS) is the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from coast_tpu_torch.interop import state_from_numpy
from coast_tpu_torch.ir.graph import BlockGraph, pick
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_RO,
                                       LeafSpec, Region)
from coast_tpu_torch.models.common import Consts, lcg_words
from coast_tpu_torch.ops.indexing import take_clip
from coast_tpu_torch.passes.verification import RegionDataflow

# Equal to the reference's analyze() (pinned in tests/test_torch_baseline.py).
DATAFLOW = RegionDataflow(
    written=frozenset({"block", "cipher", "phase", "round"}),
    deps={
        "block": frozenset({"block", "cipher", "inv_sbox", "phase", "rk",
                            "round", "sbox"}),
        "cipher": frozenset({"block", "cipher", "inv_sbox", "phase", "rk",
                             "round", "sbox"}),
        "rk": frozenset({"rk"}),
        "sbox": frozenset({"sbox"}),
        "inv_sbox": frozenset({"inv_sbox"}),
        "gold_cipher": frozenset({"gold_cipher"}),
        "gold_plain": frozenset({"gold_plain"}),
        "round": frozenset({"phase", "round"}),
        "phase": frozenset({"phase", "round"}),
    },
    load_addr=frozenset({"block", "round"}),
    store_addr=frozenset())

# -- host-side AES-128 model (the golden's oracle) ---------------------------


def _gen_sbox():
    exp = [0] * 256
    log = [0] * 256
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x ^= ((x << 1) ^ (0x1B if x & 0x80 else 0)) & 0xFF
    sbox = [0] * 256
    for a in range(256):
        inv = 0 if a == 0 else exp[(255 - log[a]) % 255]
        s = inv
        for _ in range(4):
            inv = ((inv << 1) | (inv >> 7)) & 0xFF
            s ^= inv
        sbox[a] = s ^ 0x63
    inv_sbox = [0] * 256
    for a, v in enumerate(sbox):
        inv_sbox[v] = a
    return sbox, inv_sbox


SBOX, INV_SBOX = _gen_sbox()
assert SBOX[0x00] == 0x63 and SBOX[0x01] == 0x7C and SBOX[0x53] == 0xED

# flat[r + 4c] = AES state s[r][c]; ShiftRows: s'[r][c] = s[r][(c+r)%4].
_SHIFT_PERM = [(i % 4) + 4 * (((i // 4) + (i % 4)) % 4) for i in range(16)]
_INV_SHIFT_PERM = [(i % 4) + 4 * (((i // 4) - (i % 4)) % 4)
                   for i in range(16)]


def _xt(b):
    return ((b << 1) ^ (0x1B if b & 0x80 else 0)) & 0xFF


def _gmul(b, k):
    acc = 0
    cur = b
    while k:
        if k & 1:
            acc ^= cur
        cur = _xt(cur)
        k >>= 1
    return acc


def _mixcols_host(flat):
    coef = [2, 3, 1, 1]
    out = [0] * 16
    for c in range(4):
        col = flat[4 * c:4 * c + 4]
        for r in range(4):
            out[4 * c + r] = (_gmul(col[0], coef[(0 - r) % 4])
                              ^ _gmul(col[1], coef[(1 - r) % 4])
                              ^ _gmul(col[2], coef[(2 - r) % 4])
                              ^ _gmul(col[3], coef[(3 - r) % 4]))
    return out


def _expand_key_host(key):
    w = [list(key[4 * i:4 * i + 4]) for i in range(4)]
    rcon = 1
    for i in range(4, 44):
        tmp = list(w[i - 1])
        if i % 4 == 0:
            tmp = tmp[1:] + tmp[:1]
            tmp = [SBOX[b] for b in tmp]
            tmp[0] ^= rcon
            rcon = _xt(rcon)
        w.append([w[i - 4][j] ^ tmp[j] for j in range(4)])
    return [[b for word in w[4 * r:4 * r + 4] for b in word]
            for r in range(11)]


def _encrypt_host(block, rks):
    b = [x ^ k for x, k in zip(block, rks[0])]
    for r in range(1, 11):
        b = [SBOX[x] for x in b]
        b = [b[_SHIFT_PERM[i]] for i in range(16)]
        if r < 10:
            b = _mixcols_host(b)
        b = [x ^ k for x, k in zip(b, rks[r])]
    return b


# -- device-side round functions ---------------------------------------------


def _g2(x):
    return ((x << 1) & 0xFF) ^ torch.where((x & 0x80) != 0, 0x1B, 0).to(
        x.dtype)


def _gmul_dev(v, k):
    """GF(2^8) ``v * k`` for the MixColumns coefficients, as the
    reference's chains of ``_g2`` (the same bytes for any input byte)."""
    if k == 1:
        return v
    if k == 2:
        return _g2(v)
    if k == 3:
        return _g2(v) ^ v
    g4 = _g2(_g2(v))
    g8 = _g2(g4)
    return {9: g8 ^ v, 11: g8 ^ _g2(v) ^ v, 13: g8 ^ g4 ^ v,
            14: g8 ^ g4 ^ _g2(v)}[k]


def _mix(flat, coef):
    cols = flat.reshape(flat.shape[0], 4, 4)      # [:, c] = AES column c
    out = []
    for r in range(4):
        acc = torch.zeros_like(cols[:, :, 0])
        for j in range(4):
            acc = acc ^ _gmul_dev(cols[:, :, j], coef[(j - r) % 4])
        out.append(acc)
    return torch.stack(out, dim=2).reshape(flat.shape[0], 16)


def make_region() -> Region:
    raw = lcg_words(31, 32, bits=8)
    key = [int(v) for v in raw[:16]]
    plain = [int(v) for v in raw[16:]]
    rks_host = _expand_key_host(key)
    gold_cipher = _encrypt_host(plain, rks_host)
    image = {
        "block": np.asarray(plain, np.int32),
        "cipher": np.zeros(16, np.int32),
        "rk": np.asarray(rks_host, np.int32),          # [11, 16]
        "sbox": np.asarray(SBOX, np.int32),
        "inv_sbox": np.asarray(INV_SBOX, np.int32),
        "gold_cipher": np.asarray(gold_cipher, np.int32),
        "gold_plain": np.asarray(plain, np.int32),
        "round": np.int32(0),
        "phase": np.int32(0),
    }
    perms = Consts(shift=_SHIFT_PERM, inv_shift=_INV_SHIFT_PERM)

    def init(device):
        return state_from_numpy(image, device)

    def step(state, t):
        blk = state["block"] & 0xFF             # uchar semantics on a flip
        rnd, phase = state["round"], state["phase"]
        rk_r = take_clip(state["rk"], rnd) & 0xFF
        sb = state["sbox"] & 0xFF
        isb = state["inv_sbox"] & 0xFF
        rnd_c = rnd[:, None]
        p = perms.on(blk.device)

        # Encrypt round (phase 0): round 0 the initial ARK, 10 the final.
        shifted = take_clip(sb, blk)[:, p.shift]
        mixed = torch.where(rnd_c < 10, _mix(shifted, [2, 3, 1, 1]),
                            shifted)
        enc_out = torch.where(rnd_c == 0, blk ^ rk_r, mixed ^ rk_r)

        # Decrypt round (phase 1): round 10 the initial ARK, 0 the final.
        ark = take_clip(isb, blk[:, p.inv_shift]) ^ rk_r
        dec_out = torch.where(rnd_c == 10, blk ^ rk_r, torch.where(
            rnd_c > 0, _mix(ark, [14, 11, 13, 9]), ark))

        enc_phase, dec_phase = phase == 0, phase == 1
        active = phase < 2
        new_blk = torch.where(enc_phase[:, None], enc_out, torch.where(
            dec_phase[:, None], dec_out, blk))
        enc_last = enc_phase & (rnd >= 10)
        dec_last = dec_phase & (rnd <= 0)
        cipher = torch.where(enc_last[:, None], new_blk, state["cipher"])
        new_round = torch.where(
            enc_phase, torch.where(enc_last, 10, rnd + 1).to(torch.int32),
            torch.where(dec_phase, rnd - 1, rnd))
        new_phase = torch.where(enc_last, 1, torch.where(
            dec_last, 2, phase)).to(torch.int32)
        act = active[:, None]
        return {
            "block": torch.where(act, new_blk, state["block"]),
            "cipher": torch.where(act, cipher, state["cipher"]),
            "round": torch.where(active, new_round, rnd),
            "phase": torch.where(active, new_phase, phase),
        }

    def done(state):
        return state["phase"] >= 2

    def check(state):
        e = (state["cipher"] != state["gold_cipher"]).sum(dim=1)
        d = (state["block"] != state["gold_plain"]).sum(dim=1)
        return (e + d).to(torch.int32)

    def output(state):
        return torch.cat([state["cipher"], state["block"]], dim=1)

    return Region(
        name="aes",
        init=init,
        step=step,
        done=done,
        check=check,
        output=output,
        nominal_steps=22,
        max_steps=88,
        spec={
            "block": LeafSpec(KIND_MEM),
            "cipher": LeafSpec(KIND_MEM),
            "rk": LeafSpec(KIND_MEM),
            "sbox": LeafSpec(KIND_RO),
            "inv_sbox": LeafSpec(KIND_RO),
            # Golden vectors live outside the protected compute (__NO_xMR
            # in spirit); never written, so read-only (still injectable).
            "gold_cipher": LeafSpec(KIND_RO),
            "gold_plain": LeafSpec(KIND_RO),
            "round": LeafSpec(KIND_CTRL),
            "phase": LeafSpec(KIND_CTRL),
        },
        default_xmr=True,
        graph=BlockGraph(
            names=["entry", "encrypt", "decrypt", "exit"],
            edges=[(0, 1), (1, 1), (1, 2), (2, 2), (2, 3)],
            block_of=lambda s: pick(s["phase"] >= 2, 3,
                                    pick(s["phase"] == 0, 1, 2))),
        meta={"oracle": "Number of errors: 0", "dataflow": DATAFLOW},
    )
