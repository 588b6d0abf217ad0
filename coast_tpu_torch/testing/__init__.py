"""Test tiers of the port: the fuzz tier (``fuzz.py``), the flag-matrix
harness (``harness.py``) and the smoke drivers of the ported subsystems
(``*_smoke.py``), the counterparts of ``coast_tpu/testing``.  Each driver
prints ``Success!`` for the harness's driver oracle and takes
``-d/--device`` (the card by default, ``cpu`` for the host)."""

import argparse
from typing import List, Optional


def device_arg(argv: Optional[List[str]], description: str) -> str:
    """A driver's ``-d/--device`` flag (default ``cuda``)."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("-d", "--device", default="cuda",
                        help="cuda (the card, default) or cpu")
    return parser.parse_args(argv or []).device


class Kill(Exception):
    """SIGKILL stand-in: aborts a campaign from a progress beat, after the
    preceding batches' journal records are already fsync'd."""


def kill_after(beats: dict, n: int = 2):
    """A progress hook raising :class:`Kill` on its ``n``-th beat."""
    def hook(done, counts):
        beats["n"] += 1
        if beats["n"] >= n:
            raise Kill
    return hook
