"""The one traffic generator: campaign schedules drawn from a seed.

A traffic mix is a data file, ``perfbench/traffic/<name>.json``:

    {"fault_model": {"kind": "single"} | {"kind": "multibit", "k": 4},
     "batch": 1048576, "campaign_n": 4194304, "collect": "sparse",
     "schedules": 4}

Each campaign is ``campaign_n`` injections run at ``batch`` rows a batch
with the runner's ``collect`` mode.  A row is one flip group: its base site
is uniform over every injectable bit of the configuration (every lane of
every leaf, the shared golden copy included) and its step uniform over the
program's nominal runtime; ``multibit(k)`` adds ``k - 1`` further distinct
bits of the same word at the same step.  ``schedules`` distinct campaigns
are drawn in set-up from the seed, and the measured window runs them in
turn, so drawing costs the window nothing and every seed draws the same
sizes.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

SITE_KEYS = ("leaf_id", "lane", "word", "bit", "t")
KINDS = ("single", "multibit")


@dataclasses.dataclass(frozen=True)
class Traffic:
    name: str
    kind: str
    k: int
    batch: int
    campaign_n: int
    collect: str
    schedules: int

    @property
    def sites(self) -> int:
        return self.k if self.kind == "multibit" else 1


def load(root: Path, name: str) -> Traffic:
    with open(root / "traffic" / f"{name}.json") as f:
        raw = json.load(f)
    model = raw["fault_model"]
    kind = model["kind"]
    if kind not in KINDS:
        raise ValueError(f"traffic {name}: fault model {kind!r} is not one "
                         f"of {KINDS}")
    k = int(model.get("k", 1))
    if kind == "multibit" and not 2 <= k <= 32:
        raise ValueError(f"traffic {name}: multibit needs 2 <= k <= 32")
    if raw["collect"] not in ("dense", "sparse"):
        raise ValueError(f"traffic {name}: collect is dense or sparse")
    return Traffic(name=name, kind=kind, k=k, batch=int(raw["batch"]),
                   campaign_n=int(raw["campaign_n"]),
                   collect=raw["collect"], schedules=int(raw["schedules"]))


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """Independent generators of one ``--seed`` (any whole number)."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2 ** 64, stream]))


def _distinct_bits(rng: np.random.Generator, base: np.ndarray,
                   extra: int) -> np.ndarray:
    """``extra`` further bits a row, distinct from ``base`` and each other:
    ``[n, extra]``, each uniform over the bits not yet taken (a draw that
    hits a taken bit is drawn again)."""
    taken = np.left_shift(np.int64(1), base.astype(np.int64))
    out = np.empty((base.shape[0], extra), np.int64)
    for j in range(extra):
        pick = rng.integers(0, 32, size=base.shape[0], dtype=np.int64)
        clash = np.flatnonzero((taken >> pick) & 1)
        while clash.size:
            pick[clash] = rng.integers(0, 32, size=clash.size,
                                       dtype=np.int64)
            clash = clash[((taken[clash] >> pick[clash]) & 1) == 1]
        taken |= np.left_shift(np.int64(1), pick)
        out[:, j] = pick
    return out


def draw(rng: np.random.Generator, layout: Sequence[Tuple[str, str, int,
                                                          int]],
         nominal_steps: int, traffic: Traffic, n: int
         ) -> Dict[str, np.ndarray]:
    """One campaign: int32 columns ``[n, sites]`` of ``SITE_KEYS`` plus
    ``section`` ``[n]`` (the layout row of the base site).  ``layout`` is
    ``(name, kind, lanes, words)`` per injectable leaf."""
    bits = np.array([lanes * words * 32 for _, _, lanes, words in layout],
                    np.int64)
    edges = np.cumsum(bits)
    flat = rng.integers(0, int(edges[-1]), size=n, dtype=np.int64)
    sec = np.searchsorted(edges, flat, side="right")
    off = flat - (edges - bits)[sec]
    lane_bits = np.array([w * 32 for _, _, _, w in layout], np.int64)[sec]
    lane, rest = np.divmod(off, lane_bits)
    word, bit = np.divmod(rest, 32)
    t = rng.integers(0, max(nominal_steps, 1), size=n, dtype=np.int64)
    cols = {"leaf_id": sec, "lane": lane, "word": word, "bit": bit, "t": t}
    sites = traffic.sites
    out = {k: np.broadcast_to(v.astype(np.int32)[:, None], (n, sites)).copy()
           for k, v in cols.items()}
    if sites > 1:
        out["bit"][:, 1:] = _distinct_bits(rng, bit, sites - 1)
    out["section"] = sec.astype(np.int32)
    return out


def draw_pool(seed: int, layout, nominal_steps: int,
              traffic: Traffic) -> List[Dict[str, np.ndarray]]:
    """The ``traffic.schedules`` campaigns of one seed."""
    rng = rng_of(seed, 0)
    return [draw(rng, layout, nominal_steps, traffic, traffic.campaign_n)
            for _ in range(traffic.schedules)]
