"""Key-range maps and responders configuration, counterpart of
``summerset_tpu/utils/keyrange.py``.

Parity: reference ``src/utils/keyrange.rs`` — ``KeyRangeMap`` (rangemap-
backed map from key ranges to values, ``keyrange.rs:316``; the map the
resharding plane's ``RangeTable`` and the ingress proxy's
``RoutingTable`` keep their ranges in) and ``RespondersConf``
(``keyrange.rs:29``: a leader plus per-key-range responder bitmaps with
a config ballot number).  ``Bitmap`` is named in annotations only, so
this module loads without ``torch`` (the ingress proxy runs torch-free).
"""

from __future__ import annotations

import bisect
from typing import TYPE_CHECKING, Generic, List, Optional, Tuple, TypeVar

from .errors import SummersetError

if TYPE_CHECKING:
    from .bitmap import Bitmap

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


class RespondersConf:
    """Leader + per-key-range responders, with a config number (ballot).

    Parity: ``RespondersConf`` (``keyrange.rs:29``).  The device analog
    packs the responder set of each group's active range into an int32
    lane (the QuorumLeases and Bodega kernels); this host class keeps the
    general per-key-range form for the control plane.
    """

    def __init__(self, population: int):
        self.population = population
        self.leader: Optional[int] = None
        self._map: KeyRangeMap["Bitmap"] = KeyRangeMap()
        self.conf_num: int = 0

    def is_leader(self, replica: int) -> bool:
        return self.leader == replica

    def set_leader(self, replica: Optional[int]) -> None:
        if replica is not None and not 0 <= replica < self.population:
            raise SummersetError(f"invalid leader id {replica}")
        self.leader = replica

    def set_responders(
        self, rng: Optional[KeyRange], responders: "Bitmap",
        leader: Optional[int] = None,
    ) -> None:
        if responders.size != self.population:
            raise SummersetError("responders bitmap size mismatch")
        if rng is None:
            self._map.full_range(responders)
        else:
            self._map.insert(rng[0], rng[1], responders)
        if leader is not None:
            self.set_leader(leader)

    def is_responder_by_key(self, key: str, replica: int) -> bool:
        bm = self._map.get(key)
        return bm.get(replica) if bm is not None else False

    def responders_for_key(self, key: str) -> Optional["Bitmap"]:
        return self._map.get(key)

    def __repr__(self) -> str:
        return (
            f"RespondersConf(leader={self.leader}, conf_num={self.conf_num}, "
            f"ranges={len(self._map)})"
        )
