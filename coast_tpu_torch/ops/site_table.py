"""The host side of a grouped K1/K2 launch: the site table and its buffer.

A grouped launch takes a host array of ``coast::Site`` (``csrc/
vote_word.cuh``), packed here with :data:`SITE`, and writes every output of
the call into one ``torch.empty`` buffer of int32 words, carved into views:
the ``[S, R]`` flag block first, then each output at a 16-byte boundary
(the tile path's vector stores need it).  Float32 outputs are float views
of the same storage.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import torch

#: Sites a launch takes (``coast::kMaxSites``).
MAX_SITES = 16
#: ``coast::Site``: six pointers, five int64, two int32 (96 bytes).
SITE = struct.Struct("<6Q5q2i")
_DTYPES = (torch.int32, torch.float32)


def check_lanes(name: str, lanes: torch.Tensor, num_clones: int,
                device: torch.device, rows: int) -> int:
    """Raise unless ``lanes`` is a replica set the kernel takes; return
    its words a lane."""
    if lanes.device != device or device.type != "cuda":
        raise ValueError(f"{name} runs on one CUDA device; got a site on "
                         f"{lanes.device} in a group on {device}")
    if lanes.dtype not in _DTYPES:
        raise TypeError(
            f"{name} takes 32-bit int32/float32 words, not {lanes.dtype}")
    if lanes.dim() < 2 or lanes.shape[1] != num_clones:
        raise ValueError(
            f"{name} takes [R, n, ...] replica sets with n = num_clones "
            f"{num_clones}; got shape {tuple(lanes.shape)}")
    if lanes.shape[0] != rows:
        raise ValueError(f"{name}: every site of a group has R = {rows} "
                         f"rows; got shape {tuple(lanes.shape)}")
    if not lanes.is_contiguous():
        raise ValueError(f"{name} takes contiguous replica sets")
    words = lanes.numel() // max(1, rows * num_clones)
    if words == 0 or rows == 0:
        raise ValueError(f"{name} got an empty replica set "
                         f"{tuple(lanes.shape)}")
    return words


def check_group(name: str, count: int, num_clones: int) -> None:
    if not 0 < count <= MAX_SITES:
        raise ValueError(f"{name} takes 1 to {MAX_SITES} sites a launch, "
                         f"not {count}")
    if num_clones not in (2, 3):
        raise ValueError(f"{name} votes 2 or 3 lanes, not {num_clones}")


def strides(shape: Sequence[int]) -> Tuple[int, ...]:
    """Contiguous strides of ``shape``."""
    out, step = [], 1
    for size in reversed(shape):
        out.append(step)
        step *= size
    return tuple(reversed(out))


def aligned(words: int) -> int:
    """``words`` rounded up to a 16-byte boundary."""
    return (words + 3) & ~3


class Buffer:
    """One int32 allocation for every output of a launch; ``take`` hands out
    word offsets, ``view`` the tensors once it is allocated."""

    def __init__(self, flag_words: int):
        self.words = aligned(flag_words)
        self.buf: Optional[torch.Tensor] = None
        self._float: Optional[torch.Tensor] = None

    def take(self, words: int) -> int:
        at = self.words
        self.words += aligned(words)
        return at

    def allocate(self, device: torch.device) -> int:
        self.buf = torch.empty(self.words, dtype=torch.int32, device=device)
        return self.buf.data_ptr()

    def view(self, shape: Sequence[int], at: int,
             dtype: torch.dtype) -> torch.Tensor:
        base = self.buf
        if dtype == torch.float32:
            if self._float is None:
                self._float = self.buf.view(torch.float32)
            base = self._float
        return base.as_strided(tuple(shape), strides(shape), at)

    def flags(self, count: int, rows: int) -> torch.Tensor:
        return self.buf.as_strided((count, rows), (rows, 1), 0)


def pack(sites: List[tuple]) -> bytes:
    """The host site array: one :data:`SITE` record per tuple."""
    return b"".join(SITE.pack(*s) for s in sites)


def stream(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of ``device``'s current stream (the handle
    alone: ``torch.cuda.current_stream`` builds a Stream object a call)."""
    return torch._C._cuda_getCurrentRawStream(device.index)
