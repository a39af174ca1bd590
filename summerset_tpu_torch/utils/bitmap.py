"""Fixed-size bitmap keyed by replica ID, counterpart of
``summerset_tpu/utils/bitmap.py``: the host class ``Bitmap`` and the
packed device helpers (population <= 32).

Parity: reference ``src/utils/bitmap.rs:63-146`` (``Bitmap::new/set/get/
count/flip/union/iter``).  The JAX lanes are uint32; here they are int32
tensors with the same bits.  With R <= 31 no sign bit is ever set, but
nothing below relies on that.
"""

from __future__ import annotations

from typing import Iterator, List

import torch

from .errors import SummersetError

MAX_POPULATION = 32  # packed into one int32 lane on device


class Bitmap:
    """Host-side fixed-size bitset keyed by small integer replica IDs."""

    def __init__(self, size: int, ones: bool = False):
        if size <= 0:
            raise SummersetError(f"invalid bitmap size {size}")
        self._size = size
        self._bits: int = (1 << size) - 1 if ones else 0

    @classmethod
    def from_ids(cls, size: int, ids) -> "Bitmap":
        bm = cls(size)
        for i in ids:
            bm.set(i)
        return bm

    @classmethod
    def from_u32(cls, size: int, packed: int) -> "Bitmap":
        bm = cls(size)
        bm._bits = packed & ((1 << size) - 1)
        return bm

    @property
    def size(self) -> int:
        return self._size

    def _check(self, idx: int) -> None:
        if not 0 <= idx < self._size:
            raise SummersetError(f"index {idx} out of bound {self._size}")

    def set(self, idx: int) -> None:
        self._check(idx)
        self._bits |= 1 << idx

    def clear(self, idx: int) -> None:
        self._check(idx)
        self._bits &= ~(1 << idx)

    def get(self, idx: int) -> bool:
        self._check(idx)
        return bool(self._bits >> idx & 1)

    def count(self) -> int:
        return self._bits.bit_count()

    def flip(self) -> None:
        self._bits = ~self._bits & ((1 << self._size) - 1)

    def union(self, other: "Bitmap") -> None:
        if other._size != self._size:
            raise SummersetError("bitmap size mismatch")
        self._bits |= other._bits

    def clear_all(self) -> None:
        self._bits = 0

    def set_all(self) -> None:
        self._bits = (1 << self._size) - 1

    def iter_ones(self) -> Iterator[int]:
        for i in range(self._size):
            if self._bits >> i & 1:
                yield i

    def to_list(self) -> List[bool]:
        return [bool(self._bits >> i & 1) for i in range(self._size)]

    def to_u32(self) -> int:
        return self._bits

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Bitmap)
            and other._size == self._size
            and other._bits == self._bits
        )

    def __hash__(self) -> int:
        return hash((self._size, self._bits))

    def __repr__(self) -> str:
        ones = ",".join(map(str, self.iter_ones()))
        return f"Bitmap({self._size}; {{{ones}}})"


# ---------------------------------------------------------------------------
# Device-side packed-bitmap helpers (int32 lanes, population <= 32)
# ---------------------------------------------------------------------------


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
