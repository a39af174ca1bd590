"""Packed replica bitmaps on device (population <= 32), counterpart of the
device helpers in ``summerset_tpu/utils/bitmap.py``.

The JAX lanes are uint32; here they are int32 tensors with the same bits.
With R <= 31 no sign bit is ever set, but nothing below relies on that.
"""

from __future__ import annotations

import torch

def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def bits_full(population: int) -> int:
    """All-ones mask for a population, as the int32 with those bits."""
    return _i32((1 << population) - 1)


def bit_of(idx: torch.Tensor) -> torch.Tensor:
    """``1 << idx`` per element (int32 lanes)."""
    return torch.bitwise_left_shift(torch.ones_like(idx, dtype=torch.int32),
                                    idx.to(torch.int32))


def bit_set(lane, idx):
    return lane | bit_of(idx)


def bit_clear(lane, idx):
    return lane & ~bit_of(idx)


def bit_get(lane, idx):
    return ((lane >> idx) & 1).to(torch.bool)


def popcount(lane: torch.Tensor) -> torch.Tensor:
    """Set-bit count per int32 lane (SWAR; torch has no popcount).

    The masks drop every bit an arithmetic shift fills in, so a lane with
    bit 31 set counts exactly as its uint32 reading does."""
    v = lane.to(torch.int32)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    return v & 0x3F
