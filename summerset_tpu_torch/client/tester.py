"""ClientTester: the correctness test suite driven through the manager,
counterpart of ``summerset_tpu/client/tester.py``; the recorded clients
the nemesis and workload planes play against.

Parity: reference ``summerset_client/src/clients/tester.rs`` — the named
tests (tester.rs:20-35) exercised in CI: ``primitive_ops``,
``client_reconnect``, ``non_leader_reset``, ``leader_node_reset``,
``two_nodes_reset``, ``all_nodes_reset``, ``non_leader_pause``,
``leader_node_pause``, ``node_pause_resume``.  Fault injection goes
through the manager control plane (reset = crash-restart, pause/resume —
tester.rs:242-316), i.e. real process control, not mocks.
"""

from __future__ import annotations

import random
import threading
import time
from typing import List, Optional, Tuple

from ..host.messages import CtrlRequest
from ..utils.linearize import (
    record_get, record_put, record_scan, record_shed_put,
)
from ..utils.logging import pf_info, pf_logger
from .drivers import DriverClosedLoop, DriverOpenLoopPaced
from .endpoint import GenericEndpoint

logger = pf_logger("tester")

ALL_TESTS = [
    "primitive_ops",
    "client_reconnect",
    "non_leader_reset",
    "leader_node_reset",
    "two_nodes_reset",
    "all_nodes_reset",
    "non_leader_pause",
    "leader_node_pause",
    "node_pause_resume",
]


# ------------------------------------------------------- nemesis soak plane
def recorded_closed_loop(
    manager_addr: Tuple[str, int],
    ci: int,
    keys: List[str],
    stop: threading.Event,
    ops: list,
    seed: int = 0,
    timeout: float = 3.0,
) -> None:
    """One closed-loop client recording a timed operation history in
    ``utils/linearize`` Op form while faults play (the nemesis soak's
    workload; parity role: the reference tester's checked ops, plus the
    Jepsen-style history recording the TLA+ specs only model).

    Semantics of the record: successes carry [t_inv, t_resp]; a put that
    timed out / disconnected is recorded UNACKED (it may or may not have
    executed — the checker is free to place or drop it); a SHED put is
    recorded as a negative ack (guaranteed never executed — the checker
    excludes it, so a get observing its value is a violation) and the
    client honors the retry-after hint; a redirect is no op at all (the
    server refused without proposing).  Gets that fail observe nothing
    and are not recorded.
    """
    rng = random.Random(seed * 1009 + ci)
    try:
        ep = GenericEndpoint(manager_addr)
        ep.connect()
    except Exception:
        return  # cluster unreachable at spawn: nothing observed
    drv = DriverClosedLoop(ep, timeout=timeout)
    seq = 0
    while not stop.is_set():
        key = keys[seq % len(keys)]
        t0 = time.monotonic()
        if rng.random() < 0.5:
            val = f"c{ci}-{seq}"
            rep = drv.put(key, val)
            t1 = time.monotonic()
            if rep.kind == "success":
                ops.append(record_put(ci, key, val, t0, t1, True))
            elif rep.kind == "shed":
                ops.append(record_shed_put(ci, key, val, t0, t1))
                drv.backoff.sleep_hint(rep.retry_after)
            elif rep.kind in ("timeout", "failure", "disconnect"):
                ops.append(record_put(ci, key, val, t0, None, False))
                drv._failover(rep)
        else:
            rep = drv.get(key)
            t1 = time.monotonic()
            if rep.kind == "success":
                val = rep.result.value if rep.result else None
                ops.append(record_get(ci, key, val, t0, t1))
            elif rep.kind == "shed":
                drv.backoff.sleep_hint(rep.retry_after)
            elif rep.kind in ("timeout", "failure", "disconnect"):
                drv._failover(rep)
        seq += 1
    try:
        ep.leave()
    except Exception:
        pass


def start_recorded_clients(
    manager_addr: Tuple[str, int],
    num_clients: int,
    keys: List[str],
    stop: threading.Event,
    ops: list,
    seed: int = 0,
    timeout: float = 3.0,
) -> List[threading.Thread]:
    """Spawn ``num_clients`` recorder threads (list.append is atomic, so
    they share one ``ops`` list).  Join them after setting ``stop``."""
    threads = [
        threading.Thread(
            target=recorded_closed_loop,
            args=(manager_addr, ci, keys, stop, ops, seed, timeout),
            daemon=True,
        )
        for ci in range(num_clients)
    ]
    for t in threads:
        t.start()
    return threads


# ---------------------------------------------------- workload soak plane
def recorded_open_loop(
    manager_addr: Tuple[str, int],
    ci: int,
    stream,
    rate_of,
    stop: threading.Event,
    ops: list,
    stats: list,
    seed: int = 0,
    timeout: float = 5.0,
) -> None:
    """One OPEN-LOOP client paced by a WorkloadPlan stream: arrivals
    come at ``rate_of()`` reqs/s (the runner's closure over the plan's
    phase table — rate 0 stops issuing, e.g. past the horizon)
    regardless of outstanding replies, with seeded-expovariate
    inter-arrival jitter.  Op kinds/keys/values come from ``stream``
    (``WorkloadPlan.opstream(ci)`` — a pure function of the seed).

    Records the same ``utils/linearize`` history as the closed-loop
    recorder, extended with the overload outcomes: acked ops carry
    [t_inv, t_resp] (their latency IS t_resp - t_inv, which the soak's
    accepted-op p99 reads straight off the history); shed puts are
    recorded as negative acks; arrivals landing inside a shed
    retry-after gate are counted ``held`` and dropped client-side (the
    client half of graceful degradation); expiries record unacked puts.
    Per-client driver counters land in ``stats`` at exit.
    """
    rng = random.Random(seed * 4241 + ci * 97 + 1)
    try:
        ep = GenericEndpoint(manager_addr)
        ep.connect()
    except Exception:
        return  # cluster unreachable at spawn: nothing observed
    drv = DriverOpenLoopPaced(ep, timeout=timeout, seed=seed * 31 + ci)
    # scans are bounded just past the plan's own keyspace: the harness
    # writes bookkeeping keys (warm/calibration/recovery) whose puts the
    # recorded history does not carry, and an unbounded scan straying
    # into them would observe values the checker must call phantom
    plan = getattr(stream, "plan", None)
    if plan is not None and getattr(plan, "trace", None):
        scan_hi = max(k for _, k, _ in plan.trace) + "\x00"
    elif getattr(stream, "keys", None):
        scan_hi = max(stream.keys) + "\x00"
    else:
        scan_hi = None

    def record(info: dict, rep) -> None:
        t1 = time.monotonic()
        if rep.kind == "success":
            if info["kind"] == "put":
                ops.append(record_put(
                    ci, info["key"], info["value"], info["t0"],
                    info["t0"] + rep.latency, True,
                ))
            elif info["kind"] == "scan":
                # acked range read: the observed (key, value) cut joins
                # the history as a multi-key read; a limit-capped result
                # proves absence only up to its last returned key.
                # Shed/timed-out scans observe nothing — not recorded.
                items = (rep.result.items or ()) if rep.result else ()
                limit = int(info.get("limit") or 0)
                ops.append(record_scan(
                    ci, info["key"], info.get("end"), items, info["t0"],
                    info["t0"] + rep.latency,
                    truncated=bool(limit and len(items) >= limit),
                ))
            else:
                val = rep.result.value if rep.result else None
                ops.append(record_get(
                    ci, info["key"], val, info["t0"],
                    info["t0"] + rep.latency,
                ))
        elif rep.kind == "shed" and info["kind"] == "put":
            ops.append(record_shed_put(
                ci, info["key"], info["value"], info["t0"], t1,
            ))
        elif rep.kind == "failure" and info["kind"] == "put":
            # an explicit error reply: conservatively unacked (the
            # reference error path replies without proposing, but the
            # checker need not trust that)
            ops.append(record_put(
                ci, info["key"], info["value"], info["t0"], None, False,
            ))

    def expire() -> None:
        for info in drv.expired():
            if info["kind"] == "put":
                ops.append(record_put(
                    ci, info["key"], info["value"], info["t0"], None,
                    False,
                ))

    t_next = time.monotonic()
    while not stop.is_set():
        now = time.monotonic()
        expire()
        rate = float(rate_of())
        if rate > 0 and now >= t_next:
            if drv.gated(now):
                drv.counts["held"] += 1
            else:
                kind, key, size = stream.next()
                val = None
                if kind == "put":
                    body = f"c{ci}-{drv.next_req}"
                    val = body + "x" * max(0, size - len(body))
                elif kind == "scan":
                    val = size  # scan length rides value -> limit cap
                drv.issue(kind, key, val,
                          end=scan_hi if kind == "scan" else None)
            t_next = now + rng.expovariate(rate)
        budget = (
            min(max(t_next - now, 0.0005), 0.02) if rate > 0 else 0.02
        )
        for info, rep in drv.poll(budget):
            record(info, rep)
    # drain stragglers briefly, then expire what never answered
    t_end = time.monotonic() + min(timeout, 2.0)
    while drv.inflight and time.monotonic() < t_end:
        for info, rep in drv.poll(0.1):
            record(info, rep)
    for info in drv.inflight.values():
        if info["kind"] == "put":
            ops.append(record_put(
                ci, info["key"], info["value"], info["t0"], None, False,
            ))
    drv.inflight.clear()
    stats.append({"ci": ci, **drv.counts})
    try:
        ep.leave()
    except Exception:
        pass


def start_workload_clients(
    manager_addr: Tuple[str, int],
    plan,
    rate_total_of,
    stop: threading.Event,
    ops: list,
    stats: list,
    timeout: float = 5.0,
) -> List[threading.Thread]:
    """Spawn ``plan.clients`` open-loop recorder threads, each driving
    its own ``plan.opstream(ci)`` at an equal share of the total
    offered rate ``rate_total_of()`` (reqs/s)."""
    n = max(1, int(plan.clients))

    def rate_of():
        return float(rate_total_of()) / n

    threads = [
        threading.Thread(
            target=recorded_open_loop,
            args=(manager_addr, ci, plan.opstream(ci), rate_of, stop,
                  ops, stats, plan.seed, timeout),
            daemon=True,
        )
        for ci in range(n)
    ]
    for t in threads:
        t.start()
    return threads


class ClientTester:
    def __init__(self, manager_addr: Tuple[str, int],
                 settle: float = 2.0):
        self.manager_addr = manager_addr
        self.settle = settle

    # ------------------------------------------------------------ helpers
    def _fresh(self) -> Tuple[GenericEndpoint, DriverClosedLoop]:
        ep = GenericEndpoint(self.manager_addr)
        ep.connect()
        # generous per-request timeout: the reset cases recover through
        # WAL replay + mesh rejoin, which stretches well past the default
        # on slow/loaded boxes (checked_* retries spin fast on redirects,
        # so only genuinely dead windows pay this budget)
        return ep, DriverClosedLoop(ep, timeout=8.0)

    def _leader(self, ep: GenericEndpoint) -> Optional[int]:
        info = ep.ctrl.request(CtrlRequest("query_info"))
        return info.leader

    def _reset(self, ep, servers: Optional[List[int]], durable=True):
        ep.ctrl.request(
            CtrlRequest("reset_servers", servers=servers, durable=durable),
            timeout=60,
        )
        time.sleep(self.settle)

    def _pause(self, ep, servers: Optional[List[int]]):
        ep.ctrl.request(CtrlRequest("pause_servers", servers=servers),
                        timeout=60)
        time.sleep(self.settle)

    def _resume(self, ep, servers: Optional[List[int]]):
        ep.ctrl.request(CtrlRequest("resume_servers", servers=servers),
                        timeout=60)
        time.sleep(self.settle)

    # -------------------------------------------------------------- tests
    def primitive_ops(self):
        ep, drv = self._fresh()
        drv.checked_get("job", expect=None)
        drv.checked_put("job", "kv_store")
        drv.checked_get("job", expect="kv_store")
        drv.checked_put("job", "kv_store_2")
        drv.checked_get("job", expect="kv_store_2")
        ep.leave()

    def client_reconnect(self):
        ep, drv = self._fresh()
        drv.checked_put("job", "kv_store")
        ep.leave(keep_ctrl=False)
        ep2, drv2 = self._fresh()
        drv2.checked_get("job", expect="kv_store")
        ep2.leave()

    def non_leader_reset(self):
        ep, drv = self._fresh()
        drv.checked_put("job", "kv_store")
        leader = self._leader(ep) or 0
        victim = next(
            s for s in sorted(ep.servers) if s != leader
        )
        self._reset(ep, [victim])
        ep2, drv2 = self._fresh()
        drv2.checked_get("job", expect="kv_store")
        ep2.leave()
        ep.leave()

    def leader_node_reset(self):
        ep, drv = self._fresh()
        drv.checked_put("job", "kv_store")
        leader = self._leader(ep)
        if leader is None:
            leader = ep.current
        self._reset(ep, [leader])
        ep2, drv2 = self._fresh()
        drv2.checked_get("job", expect="kv_store")
        ep2.leave()
        ep.leave()

    def two_nodes_reset(self):
        ep, drv = self._fresh()
        drv.checked_put("job", "kv_store")
        leader = self._leader(ep) or 0
        others = [s for s in sorted(ep.servers) if s != leader]
        self._reset(ep, others[:1] + [leader])
        ep2, drv2 = self._fresh()
        drv2.checked_get("job", expect="kv_store")
        ep2.leave()
        ep.leave()

    def all_nodes_reset(self):
        ep, drv = self._fresh()
        drv.checked_put("job", "kv_store")
        self._reset(ep, None)
        ep2, drv2 = self._fresh()
        drv2.checked_get("job", expect="kv_store")
        ep2.leave()
        ep.leave()

    def non_leader_pause(self):
        ep, drv = self._fresh()
        drv.checked_put("job", "kv_store")
        leader = self._leader(ep) or 0
        victim = next(s for s in sorted(ep.servers) if s != leader)
        self._pause(ep, [victim])
        drv.checked_put("job", "kv_store_2")
        drv.checked_get("job", expect="kv_store_2")
        self._resume(ep, [victim])
        ep.leave()

    def leader_node_pause(self):
        ep, drv = self._fresh()
        drv.checked_put("job", "kv_store")
        leader = self._leader(ep)
        if leader is None:
            leader = ep.current
        self._pause(ep, [leader])
        ep2, drv2 = self._fresh()
        drv2.checked_get("job", expect="kv_store")
        ep2.leave()
        self._resume(ep, [leader])
        ep.leave()

    def node_pause_resume(self):
        """Pause the *current leader* (whoever inherited leadership from
        earlier churn), write through the survivors, resume, write again.
        The victim is the queried leader — not a fixed id — and the client
        rotates off it on timeout (tester.rs:429-433 reconnects around
        every fault for the same reason)."""
        ep, drv = self._fresh()
        drv.checked_put("job", "kv_store")
        victim = self._leader(ep)
        if victim is None:
            victim = sorted(ep.servers)[-1]
        self._pause(ep, [victim])
        ep.rotate(avoid=victim)
        drv.checked_put("job", "kv_store_2")
        self._resume(ep, [victim])
        drv.checked_put("job", "kv_store_3")
        drv.checked_get("job", expect="kv_store_3")
        ep.leave()

    # ------------------------------------------------------------- runner
    def run_tests(self, names: Optional[List[str]] = None) -> dict:
        results = {}
        for name in names or ALL_TESTS:
            fn = getattr(self, name)
            try:
                fn()
                results[name] = "PASS"
                pf_info(logger, f"test {name}: PASS")
            except Exception as e:
                results[name] = f"FAIL: {e}"
                pf_info(logger, f"test {name}: FAIL ({e})")
        return results
