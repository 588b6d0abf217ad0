"""What the studies share: the device they run on and their records."""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Optional

import torch

from coast_tpu_torch import device as device_mod

#: Where a study writes its record unless ``--out`` says otherwise.
STUDIES_DIR = Path(__file__).resolve().parents[2] / "build" / "studies"


def default_out(name: str) -> str:
    return str(STUDIES_DIR / name)


def device_block(dev: torch.device) -> Dict[str, Optional[str]]:
    """The record's ``device`` block: the torch version, the device, and
    on the card its name and power limit as nvidia-smi gives them."""
    name = limit = None
    if dev.type == "cuda":
        line = device_mod.card_line()
        if line is None:
            raise RuntimeError("nvidia-smi could not read the card's name "
                               "and power limit")
        name, limit = line.rsplit(", ", 1)
    return {"torch": torch.__version__, "device": str(dev), "name": name,
            "power_limit": limit}


def write_record(path: str, doc: Dict[str, object]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
