"""Run classification: the SDC/DUE taxonomy as per-row codes.

The counterpart of ``coast_tpu/inject/classify.py``, with the same codes
and the same precedence: INVALID > DUE_STACK_OVERFLOW > DUE_ASSERT >
DUE_ABORT > DUE_TIMEOUT > SDC > CORRECTED > SUCCESS.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

SUCCESS = 0
CORRECTED = 1   # TMR voted away a miscompare, output clean
SDC = 2         # silent data corruption
DUE_ABORT = 3   # DWC detected -> abort()
DUE_TIMEOUT = 4  # watchdog bound hit (hang)
INVALID = 5
DUE_STACK_OVERFLOW = 6
DUE_ASSERT = 7
TRAIN_SELF_HEAL = 8
TRAIN_SDC = 9

NUM_CLASSES = 10
CLASS_NAMES = ("success", "corrected", "sdc", "due_abort", "due_timeout",
               "invalid", "due_stack_overflow", "due_assert",
               "train_self_heal", "train_sdc")
BASE_CLASS_NAMES = CLASS_NAMES[:TRAIN_SELF_HEAL]
DUE_CLASSES = ("due_abort", "due_timeout", "due_stack_overflow",
               "due_assert")
SDC_CLASSES = ("sdc", "train_sdc")
COMPLETED_CLASSES = ("success", "corrected", "sdc", "train_self_heal",
                     "train_sdc")


def classify(rec: Dict[str, torch.Tensor], output_words: int) -> torch.Tensor:
    """Run record (per-row tensors from ProtectedProgram.run_batch) ->
    int32 class code per row."""
    errors = rec["errors"]
    invalid = (errors < 0) | (errors > output_words)
    code = torch.where(rec["corrected"] > 0, CORRECTED, SUCCESS)
    code = torch.where(errors > 0, SDC, code)
    code = torch.where(~rec["done"], DUE_TIMEOUT, code)
    code = torch.where(rec["dwc_fault"] | rec["cfc_fault"], DUE_ABORT, code)
    code = torch.where(rec["assert_fault"], DUE_ASSERT, code)
    code = torch.where(rec["stack_fault"], DUE_STACK_OVERFLOW, code)
    code = torch.where(invalid, INVALID, code)
    return code.to(torch.int32)


def histogram(codes: torch.Tensor) -> torch.Tensor:
    """Per-class counts (int64 [NUM_CLASSES])."""
    return torch.bincount(codes.to(torch.int64), minlength=NUM_CLASSES)


def counts_dict(binc, train: bool = False) -> Dict[str, int]:
    """Class histogram -> the counts dict campaigns report: the base class
    names always, a train class only when nonzero (or ``train``)."""
    out = {}
    for i, name in enumerate(CLASS_NAMES):
        if train or i < len(BASE_CLASS_NAMES) or int(binc[i]):
            out[name] = int(binc[i])
    return out


def completed_mask(codes) -> np.ndarray:
    """Rows that completed (reached the result line)."""
    codes = np.asarray(codes)
    return (codes <= SDC) | (codes >= TRAIN_SELF_HEAL)


def weighted_histogram(codes, weights=None) -> np.ndarray:
    """Host-side per-class counts (int64 [NUM_CLASSES]), optionally with
    per-run weights."""
    codes = np.asarray(codes)
    if weights is None:
        return np.bincount(codes, minlength=NUM_CLASSES).astype(np.int64)
    return np.round(np.bincount(
        codes, weights=np.asarray(weights, np.float64),
        minlength=NUM_CLASSES)).astype(np.int64)
