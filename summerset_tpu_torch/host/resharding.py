"""Live keyspace resharding: range split/merge over the ctrl plane.

The port's own copy of ``summerset_tpu/host/resharding.py``, held to it by
``tests/test_torch_resharding.py``; it imports nothing of the JAX package.

The G axis hashes keys to groups (``ServerReplica.group_of``); this module
turns that static placement into a *live* one.  A ``RangeChange`` installs a
key range ``[start, end)`` into an explicit destination group using the same
revoke-then-adopt discipline as ConfChange:

1. **Seal** — every replica stops accepting new ops for the range the moment
   the manager's ``range_change`` ctrl fan-out lands (front-door sheds; the
   shed is client-visible backpressure, never a lost ack).
2. **Barrier** — the adopting leader waits until the source group's log has
   no voted-but-unapplied write to the range (the commit-slot barrier), so
   the handoff snapshot is complete.
3. **Adopt** — a range-filtered KV snapshot plus write-slot watermarks and
   per-group apply floors ride an ``adopt`` command *through the destination
   group's own log*, so adoption is itself replicated, recoverable, and
   ordered against destination traffic.  Once applied, the range serves from
   the destination and the proposer announces installation to the manager,
   which re-announces to proxies/late joiners (the ConfChange re-announce
   path).

Split vs merge is pure policy: both lower to the same install op; a split
moves a hot sub-range off its hash-home, a merge moves a cold installed
range back.  ``RangeHeat`` + ``ResharderPolicy`` close the loop from
per-range heat telemetry to ctrl-plane ``range_change`` requests.

Related work: compartmentalized SMR (arxiv 2012.15762) — the proxy/shard
decomposition this subsystem's routing rides on.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.errors import SummersetError
from ..utils.keyrange import KeyRangeMap


def single_key_range(key: str) -> Tuple[str, str]:
    """The smallest half-open range containing exactly ``key``."""
    return key, key + "\x00"


@dataclasses.dataclass(frozen=True)
class RangeChange:
    """One validated range install request (split or merge).

    ``op`` is advisory ("split" or "merge") — both lower to the same
    install; it selects which counter (``reshard_splits`` /
    ``reshard_merges``) the adoption bumps.  ``end is None`` means
    unbounded.  ``rc_id`` is assigned by the manager (monotone per
    manager lifetime) and is the idempotency key for seal/adopt.
    """

    op: str
    start: str
    end: Optional[str]
    dst_group: int
    rc_id: int = 0

    def validate(self) -> None:
        if self.op not in ("split", "merge"):
            raise SummersetError(f"unknown range op {self.op!r}")
        if not isinstance(self.start, str):
            raise SummersetError("range start must be a string key")
        if self.end is not None and self.end <= self.start:
            raise SummersetError(
                f"invalid key range [{self.start!r}, {self.end!r})")
        if not isinstance(self.dst_group, int) or self.dst_group < 0:
            raise SummersetError(
                f"invalid dst_group {self.dst_group!r}")

    def contains(self, key: str) -> bool:
        return key >= self.start and (self.end is None or key < self.end)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "rc_id": self.rc_id, "op": self.op, "start": self.start,
            "end": self.end, "dst_group": self.dst_group,
        }

    @staticmethod
    def from_payload(payload: dict) -> "RangeChange":
        ch = RangeChange(
            op=str(payload.get("op", "split")),
            start=payload.get("start", ""),
            end=payload.get("end"),
            dst_group=payload.get("dst_group", 0),
            rc_id=int(payload.get("rc_id", 0)),
        )
        ch.validate()
        return ch


class RangeTable:
    """Installed range overrides: key range -> owning group.

    Wraps a :class:`KeyRangeMap` (later installs overwrite overlapped
    portions, rangemap semantics) plus the install entries in ``rc_id``
    order for re-announce / snapshot meta.  Lookup misses fall back to
    the caller's hash placement — the table only ever holds overrides.
    """

    def __init__(self):
        self._map: KeyRangeMap[dict] = KeyRangeMap()
        self._entries: Dict[int, dict] = {}

    def install(self, entry: dict) -> bool:
        """Install an adopted range; idempotent per rc_id.  Returns True
        if this call changed the table."""
        rc_id = int(entry["rc_id"])
        if rc_id in self._entries:
            return False
        self._entries[rc_id] = dict(entry)
        self._map.insert(entry["start"], entry.get("end"), dict(entry))
        return True

    def lookup(self, key: str) -> Optional[dict]:
        return self._map.get(key)

    def group_for(self, key: str) -> Optional[int]:
        e = self._map.get(key)
        return None if e is None else int(e["group"])

    def has(self, rc_id: int) -> bool:
        return int(rc_id) in self._entries

    def entries(self) -> List[dict]:
        """All install entries in rc_id (i.e. adoption) order."""
        return [dict(self._entries[k]) for k in sorted(self._entries)]

    def __len__(self) -> int:
        return len(self._map)


class RangeHeat:
    """Bounded per-key op-count telemetry at an ingress seam.

    Key cardinality is capped; once full, new keys fold into a spill
    bucket so the hot set stays exact while the tail stays bounded.
    Scraped as labeled ``range_heat`` gauges (top-K) plus a bare total.
    """

    SPILL = "__other__"

    def __init__(self, cap: int = 512):
        self.cap = int(cap)
        self._counts: Dict[str, int] = {}

    def note(self, key: str, n: int = 1) -> None:
        c = self._counts
        if key in c:
            c[key] += n
        elif len(c) < self.cap:
            c[key] = n
        else:
            c[self.SPILL] = c.get(self.SPILL, 0) + n

    def top(self, k: int = 8) -> List[Tuple[str, int]]:
        items = [(key, n) for key, n in self._counts.items()
                 if key != self.SPILL]
        items.sort(key=lambda t: (-t[1], t[0]))
        return items[:k]

    def total(self) -> int:
        return sum(self._counts.values())

    def clear(self) -> None:
        self._counts.clear()


class ResharderPolicy:
    """Heat-driven placement: split hot keys off their hash-home, merge
    cold installed ranges back.

    Pure decision logic — the caller scrapes heat, feeds ``decide``, and
    issues the returned :class:`RangeChange` requests over the ctrl
    plane.  One decision per call keeps cutovers serialized (each seals
    its range until adopted; flooding seals would just shed).

    When an autopilot owns this policy (host/autopilot.py) it installs
    ``budget_gate``: ``decide`` consults it with the candidate
    destination group BEFORE committing to a change, so reshard
    decisions answer to the autopilot's per-window actuation budget and
    per-group change cap instead of firing independently — a heat spike
    can no longer race a leader re-placement on the same group.  A
    refused candidate is left untouched (``_moved`` unchanged), so the
    same decision stays available next call.
    """

    def __init__(
        self,
        num_groups: int,
        hash_group,  # Callable[[str], int] — the cluster's hash placement
        hot_frac: float = 0.25,
        cold_frac: float = 0.02,
        min_total: int = 20,
        budget_gate: Optional[Callable[[int], bool]] = None,
    ):
        self.G = int(num_groups)
        self.hash_group = hash_group
        self.hot_frac = float(hot_frac)
        self.cold_frac = float(cold_frac)
        self.min_total = int(min_total)
        self.budget_gate = budget_gate
        self._moved: Dict[str, int] = {}  # key -> installed dst group

    def decide(
        self, heat: Dict[str, int],
    ) -> Optional[RangeChange]:
        """One split or merge decision from a heat scrape, or None.

        Splits take priority: the hottest not-yet-moved key drawing at
        least ``hot_frac`` of total heat moves to the next group round-
        robin from its hash-home.  Otherwise the coldest already-moved
        key below ``cold_frac`` merges back to its hash-home.
        """
        total = sum(heat.values())
        if total < self.min_total or self.G < 2:
            return None
        ranked = sorted(
            ((k, n) for k, n in heat.items()
             if k != RangeHeat.SPILL),
            key=lambda t: (-t[1], t[0]),
        )
        for key, n in ranked:
            if key in self._moved:
                continue
            if n < self.hot_frac * total:
                break  # ranked: nothing below is hotter
            start, end = single_key_range(key)
            dst = (self.hash_group(key) + 1) % self.G
            if self.budget_gate is not None \
                    and not self.budget_gate(dst):
                break  # budget-refused; candidate stays for next call
            self._moved[key] = dst
            return RangeChange("split", start, end, dst)
        for key, n in sorted(ranked, key=lambda t: (t[1], t[0])):
            if key not in self._moved:
                continue
            if n > self.cold_frac * total:
                continue
            home = self.hash_group(key)
            start, end = single_key_range(key)
            if self.budget_gate is not None \
                    and not self.budget_gate(home):
                continue  # budget-refused; candidate stays for next call
            # forget the key entirely: a merged-back key that re-heats
            # must be eligible for a future split (leaving it in _moved
            # mapped to its hash-home would pin it forever)
            del self._moved[key]
            return RangeChange("merge", start, end, home)
        return None
