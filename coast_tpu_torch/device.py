"""Device selection for the port's entry points.

Every entry point (``ProtectedProgram``, the strategies, ``CampaignRunner``,
``Region.run_unprotected``) runs on the card unless the caller asks for the
CPU.  Asking for the card on a host without one is an error, never a silent
fall back to the CPU: a campaign timed on the host would report a host rate
under the card's name.
"""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev
