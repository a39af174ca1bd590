"""Linearizability checking of client-observed KV histories, counterpart
of ``summerset_tpu/utils/linearize.py`` (the port's own copy).

Model: each key is an independent register (linearizability is
compositional, Herlihy & Wing §3), puts carry globally unique values, and
unacknowledged operations (timeouts) may or may not have taken effect —
the checker may place them at any point after invocation or drop them.
Shed operations (``shed=True``) were refused before entering the ingress
queue, so the checker never places them.  A scan (``record_scan``) is a
multi-key read at one instant: it first faces a cross-key single-point
check, then decomposes into per-key get projections (``_expand_scans``).

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
    kind: str                  # "put" | "get" | "scan"
    key: str                   # scan: the range's inclusive lower bound
    value: Optional[str]       # put: written value; get: returned value
    t_inv: float
    t_resp: float = INF        # INF = never acknowledged (may have run)
    acked: bool = True         # False: op may be dropped by the checker
    shed: bool = False         # True: negatively acked (load shed) —
    #                            guaranteed never executed; the checker
    #                            drops it and may NOT place it
    end: Optional[str] = None  # scan: exclusive upper bound (None = inf)
    items: Optional[tuple] = None  # scan: observed ((key, value), ...)
    truncated: bool = False    # scan: limit hit — the observed span ends
    #                            at the last returned key, not ``end``


def record_put(client: int, key: str, value: str, t_inv: float,
               t_resp: Optional[float], acked: bool) -> Op:
    return Op(client, "put", key, value, t_inv,
              INF if t_resp is None else t_resp, acked)


def record_shed_put(client: int, key: str, value: str, t_inv: float,
                    t_resp: float) -> Op:
    """A put refused by ingress backpressure (``ApiReply(kind="shed")``):
    recorded so overload histories carry the negative acks, excluded by
    the checker on the server's never-proposed guarantee."""
    return Op(client, "put", key, value, t_inv, t_resp,
              acked=False, shed=True)


def record_get(client: int, key: str, value: Optional[str], t_inv: float,
               t_resp: float) -> Op:
    return Op(client, "get", key, value, t_inv, t_resp, True)


def record_scan(client: int, start: str, end: Optional[str],
                items, t_inv: float, t_resp: float,
                truncated: bool = False) -> Op:
    """An acked ordered range read over ``[start, end)``: ``items`` is
    the returned sorted ``(key, value)`` sequence; ``truncated`` marks a
    limit-capped result (absence of keys past the last returned one
    proves nothing).  Shed/timed-out scans are reads — callers simply
    don't record them."""
    return Op(client, "scan", start, None, t_inv, t_resp, True,
              end=end, items=tuple(tuple(i) for i in items),
              truncated=truncated)


def _expand_scans(ops: List[Op]) -> List[Op]:
    """Decompose each scan into synthetic per-key gets at the scan's
    [t_inv, t_resp] window: one get per observed pair, plus one
    ``get = None`` absence witness for every key some put in the history
    wrote that falls inside the scan's *proven* span (up to the last
    returned key when the limit was hit) yet was not returned.  Sound:
    a linearizable scan IS a multi-key read at one point, so each
    projection must linearize as a get; the cross-key single-point
    obligation is checked separately (:func:`_scan_point_violation`)."""
    put_keys = {
        o.key for o in ops if o.kind == "put" and not o.shed
    }
    out: List[Op] = []
    for o in ops:
        if o.kind != "scan":
            out.append(o)
            continue
        if o.shed:
            continue  # a refused read observes (and proves) nothing
        items = o.items or ()
        seen = set()
        for k, v in items:
            seen.add(k)
            out.append(Op(o.client, "get", k, v, o.t_inv, o.t_resp))
        if o.truncated and not items:
            continue  # limit 0-shaped edge: no proven span at all
        hi = items[-1][0] if o.truncated else o.end
        for k in put_keys:
            if k in seen or k < o.key:
                continue
            if o.truncated:
                if k > hi:
                    continue
            elif hi is not None and k >= hi:
                continue
            out.append(Op(o.client, "get", k, None, o.t_inv, o.t_resp))
    return out


def _scan_point_violation(ops: List[Op]) -> Optional[Tuple[Op, str]]:
    """Cross-key single-point check: every scan must admit ONE instant
    inside [t_inv, t_resp] at which every observed value (and proven
    absence) is simultaneously current.  Windows are conservative
    over-approximations — per key, a value's earliest feasible instant
    is its put's invocation, and its latest is the first acked put that
    *definitely* linearizes later (invoked after the observed put's
    response) — so an empty intersection is a real violation (the
    fresh-here-stale-there cut a per-key projection can't see), while a
    non-empty one proves nothing extra (sound, incomplete)."""
    puts_by_key: Dict[str, List[Op]] = {}
    put_by_value: Dict[Optional[str], Op] = {}
    for o in ops:
        if o.kind == "put" and not o.shed:
            puts_by_key.setdefault(o.key, []).append(o)
            put_by_value[o.value] = o
    for o in ops:
        if o.kind != "scan" or o.shed:
            continue
        lo, hi = o.t_inv, o.t_resp
        for k, v in (o.items or ()):
            writer = put_by_value.get(v)
            if writer is None or writer.key != k:
                continue  # the per-key projection fails this one
            lo = max(lo, writer.t_inv)
            gone = writer.t_resp
            for q in puts_by_key.get(k, ()):
                if q is writer or not q.acked:
                    continue
                if q.t_inv >= gone:
                    hi = min(hi, q.t_resp)
            if lo > hi:
                return o, (
                    f"key {k!r}={v!r} current no earlier than "
                    f"{lo:.4f} but another observed key pins the "
                    f"scan before {hi:.4f}"
                )
        if (o.items is not None) and not o.truncated:
            # proven-absent keys: None stops being current once ANY
            # acked put to the key has completed
            seen = {k for k, _ in o.items}
            for k, qs in puts_by_key.items():
                if k in seen or k < o.key:
                    continue
                if o.end is not None and k >= o.end:
                    continue
                for q in qs:
                    if q.acked:
                        hi = min(hi, q.t_resp)
                if lo > hi:
                    return o, (
                        f"key {k!r} observed absent after an acked "
                        f"put to it completed by {hi:.4f} (scan "
                        f"pinned after {lo:.4f})"
                    )
    return None


def check_history(ops: List[Op]) -> Tuple[bool, Optional[str]]:
    """True iff the whole history is linearizable; on failure returns the
    offending key's diagnosis.  Keys are checked independently
    (P-compositionality); scans first face the cross-key single-point
    check, then decompose into per-key read projections."""
    bad = _scan_point_violation(ops)
    if bad is not None:
        scan, why = bad
        return False, (
            f"scan [{scan.key!r}, {scan.end!r}) by c{scan.client} at "
            f"[{scan.t_inv:.4f}, {scan.t_resp:.4f}] admits no single "
            f"linearization point: {why}"
        )
    ops = _expand_scans(ops)
    by_key: Dict[str, List[Op]] = {}
    for op in ops:
        by_key.setdefault(op.key, []).append(op)
    # the per-key search recurses one frame per placed op, so a long
    # soak's hottest zipfian key (thousands of ops) outruns CPython's
    # default 1000-frame limit long before time or memory matter — a
    # clean history resolves greedily in O(n) placements
    deepest = max((len(k) for k in by_key.values()), default=0)
    want = 2000 + 4 * deepest
    if sys.getrecursionlimit() < want:
        sys.setrecursionlimit(want)
    for key, kops in by_key.items():
        ok = _check_key(kops)
        if not ok:
            return False, _diagnose(key, kops)
    return True, None


def _prune_unobserved_unacked(kops: List[Op]) -> List[Op]:
    """Drop unacked puts whose value no get ever returned.

    Sound under the stated model (put values globally unique): the
    checker may always DROP an unacked put, and *placing* a never-read
    put can only restrict later gets — any get sequenced between it and
    the next put would have to return its (unique, never-observed) value,
    a contradiction — so removal never changes the verdict.  This is the
    load-bearing bound for fault-schedule histories: a nemesis soak can
    leave dozens of timed-out (unacked) puts per key, and each one
    otherwise doubles the Wing&Gong search space (observed: a ~70-op
    soak history spinning for minutes at >10GB of memo set)."""
    read = {o.value for o in kops if o.kind == "get"}
    return [
        o for o in kops
        if o.kind != "put" or o.acked or o.value in read
    ]


def _check_key(kops: List[Op]) -> bool:
    # shed ops are dropped BEFORE unacked pruning, and unconditionally:
    # an unacked put whose value was read stays placeable, but a SHED
    # put must never be placed even when observed — the shed reply
    # guarantees it did not execute, so an observation of its unique
    # value must FAIL the search (no remaining put can write it), not
    # be legalized by placement
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
