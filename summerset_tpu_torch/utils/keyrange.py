"""Key-range maps, counterpart of ``KeyRangeMap`` in
``summerset_tpu/utils/keyrange.py``: the map the resharding plane's
``RangeTable`` keeps its installed ranges in.  ``RespondersConf`` is not
ported here: its one user is the ingress proxy tier.
"""

from __future__ import annotations

import bisect
from typing import Generic, List, Optional, Tuple, TypeVar

from .errors import SummersetError

V = TypeVar("V")

# Keys are strings compared lexicographically; a range is [start, end) with
# end == None meaning unbounded.
KeyRange = Tuple[str, Optional[str]]


class KeyRangeMap(Generic[V]):
    """Map from disjoint half-open string-key ranges to values.

    Stored as a sorted list of (start, end, value); later inserts overwrite
    overlapped portions of earlier ranges (rangemap crate semantics).
    """

    def __init__(self):
        self._ranges: List[Tuple[str, Optional[str], V]] = []
        self._starts: List[str] = []  # parallel column for bisect lookups

    @staticmethod
    def _lt(a: Optional[str], b: Optional[str]) -> bool:
        """Compare range ends where None = +infinity."""
        if a is None:
            return False
        if b is None:
            return True
        return a < b

    def insert(self, start: str, end: Optional[str], value: V) -> None:
        if end is not None and end <= start:
            raise SummersetError(f"invalid key range [{start!r}, {end!r})")
        out: List[Tuple[str, Optional[str], V]] = []
        for s, e, v in self._ranges:
            # keep the non-overlapping parts of (s, e)
            if e is not None and e <= start:
                out.append((s, e, v))
                continue
            if end is not None and s >= end:
                out.append((s, e, v))
                continue
            # overlap: keep left sliver and/or right sliver
            if s < start:
                out.append((s, start, v))
            if end is not None and self._lt(end, e):
                out.append((end, e, v))
        out.append((start, end, value))
        out.sort(key=lambda t: t[0])
        self._ranges = out
        self._starts = [s for s, _, _ in out]

    def get(self, key: str) -> Optional[V]:
        i = bisect.bisect_right(self._starts, key) - 1
        if i < 0:
            return None
        s, e, v = self._ranges[i]
        if key >= s and (e is None or key < e):
            return v
        return None

    def full_range(self, value: V) -> None:
        """Reset to a single range covering all keys."""
        self._ranges = [("", None, value)]
        self._starts = [""]

    def items(self):
        return list(self._ranges)

    def __len__(self) -> int:
        return len(self._ranges)
