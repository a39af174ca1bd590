"""Linearizability checking of client-observed KV histories, counterpart
of ``summerset_tpu/utils/linearize.py`` (point reads and writes; the scan
projections are not ported).

Model: each key is an independent register (linearizability is
compositional, Herlihy & Wing §3), puts carry globally unique values, and
unacknowledged operations (timeouts) may or may not have taken effect —
the checker may place them at any point after invocation or drop them.
Shed operations (``shed=True``) were refused before entering the ingress
queue, so the checker never places them.

Algorithm: Wing & Gong tree search with memoization on
(remaining-operation set, register value), per key.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional, Tuple

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class Op:
    """One client-observed operation."""

    client: int
    kind: str                  # "put" | "get"
    key: str
    value: Optional[str]       # put: written value; get: returned value
    t_inv: float
    t_resp: float = INF        # INF = never acknowledged (may have run)
    acked: bool = True         # False: op may be dropped by the checker
    shed: bool = False         # True: refused, guaranteed never executed


def record_put(client: int, key: str, value: str, t_inv: float,
               t_resp: Optional[float], acked: bool) -> Op:
    return Op(client, "put", key, value, t_inv,
              INF if t_resp is None else t_resp, acked)


def record_shed_put(client: int, key: str, value: str, t_inv: float,
                    t_resp: float) -> Op:
    """A put refused by ingress backpressure (``kind="shed"``)."""
    return Op(client, "put", key, value, t_inv, t_resp,
              acked=False, shed=True)


def record_get(client: int, key: str, value: Optional[str], t_inv: float,
               t_resp: float) -> Op:
    return Op(client, "get", key, value, t_inv, t_resp, True)


def check_history(ops: List[Op]) -> Tuple[bool, Optional[str]]:
    """True iff the whole history is linearizable; on failure returns the
    offending key's diagnosis.  Keys are checked independently."""
    by_key: Dict[str, List[Op]] = {}
    for op in ops:
        by_key.setdefault(op.key, []).append(op)
    # the search recurses one frame per placed op
    deepest = max((len(k) for k in by_key.values()), default=0)
    want = 2000 + 4 * deepest
    if sys.getrecursionlimit() < want:
        sys.setrecursionlimit(want)
    for key, kops in by_key.items():
        if not _check_key(kops):
            return False, _diagnose(key, kops)
    return True, None


def _prune_unobserved_unacked(kops: List[Op]) -> List[Op]:
    """Drop unacked puts whose value no get ever returned: the checker
    may always drop an unacked put, and placing a never-read put can only
    restrict later gets, so removal never changes the verdict."""
    read = {o.value for o in kops if o.kind == "get"}
    return [
        o for o in kops
        if o.kind != "put" or o.acked or o.value in read
    ]


def _check_key(kops: List[Op]) -> bool:
    # shed ops are dropped unconditionally: an observation of a shed
    # put's unique value must FAIL the search, not be legalized
    kops = [o for o in kops if not o.shed]
    kops = _prune_unobserved_unacked(kops)
    n = len(kops)
    if n == 0:
        return True
    kops = sorted(kops, key=lambda o: o.t_inv)
    inv = [o.t_inv for o in kops]
    resp = [o.t_resp for o in kops]
    full = frozenset(range(n))
    seen: set = set()

    def search(remaining: frozenset, state: Optional[str]) -> bool:
        if not any(kops[i].acked for i in remaining):
            return True  # everything left is droppable
        sig = (remaining, state)
        if sig in seen:
            return False
        seen.add(sig)
        # an op can go first iff nothing else still pending responded
        # strictly before its invocation (real-time order preservation)
        bar = min(resp[i] for i in remaining)
        for i in sorted(remaining, key=lambda j: inv[j]):
            if inv[i] > bar:
                break
            o = kops[i]
            if o.kind == "put":
                if search(remaining - {i}, o.value):
                    return True
                if not o.acked:
                    # an unacked put may also have never happened
                    if search(remaining - {i}, state):
                        return True
            else:
                if o.value == state and search(remaining - {i}, state):
                    return True
        return False

    return search(full, None)


def _diagnose(key: str, kops: List[Op]) -> str:
    lines = [f"key {key!r}: history not linearizable; ops:"]
    for o in sorted(kops, key=lambda x: x.t_inv):
        end = "∞" if o.t_resp == INF else f"{o.t_resp:.4f}"
        lines.append(
            f"  c{o.client} {o.kind}({o.value}) [{o.t_inv:.4f}, {end}]"
            + (" (shed)" if o.shed else "" if o.acked else " (unacked)")
        )
    return "\n".join(lines)
