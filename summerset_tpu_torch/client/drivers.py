"""Closed-loop request driver, counterpart of
``summerset_tpu/client/drivers.py``.

Parity: reference ``summerset_client/src/drivers/closed_loop.rs`` — one
outstanding request with a timeout (``DriverReply::{Success{latency},
Redirect, Timeout}``, drivers/mod.rs:12-40); a success carries the
reply's ``local`` flag (a leased local read), ``scan`` is the ordered
range read, and ``conf_change`` drives a ConfChange to completion.

``DriverOpenLoop`` pipelines issues and acks (open_loop.rs);
``DriverOpenLoopPaced`` is the workload plane's driver
(``host/workload.WorkloadPlan``): arrivals keep coming at the offered
rate regardless of replies, and a shed reply gates issuing until the
server's retry-after hint (with seeded jitter) has elapsed.
"""

from __future__ import annotations

import dataclasses
import random
import socket
import time
from typing import Dict, List, Optional, Tuple

from ..host.statemach import Command, CommandResult
from .endpoint import GenericEndpoint


class Backoff:
    """Jittered exponential backoff for retry loops (full jitter: sleep
    uniform in (0, cur]); the seed keeps a client's delays reproducible."""

    def __init__(self, base: float = 0.05, cap: float = 1.0,
                 seed: int = 0):
        self.base = base
        self.cap = cap
        self._cur = base
        self._rng = random.Random(seed)

    def reset(self) -> None:
        self._cur = self.base

    def sleep(self) -> float:
        d = self._rng.uniform(0.0, self._cur)
        self._cur = min(self._cur * 2.0, self.cap)
        time.sleep(d)
        return d

    def sleep_hint(self, hint_s: float) -> float:
        """Honor a server retry-after hint with jitter (uniform in
        [0.5, 1.5] x hint, capped)."""
        d = min(max(hint_s, 0.001) * self._rng.uniform(0.5, 1.5),
                self.cap)
        time.sleep(d)
        return d


@dataclasses.dataclass
class DriverReply:
    # success | redirect | timeout | failure (server refused) |
    # shed (ingress backpressure: definitely NOT executed) |
    # disconnect (connection dead — reconnect/rotate before retrying)
    kind: str
    latency: float = 0.0          # seconds (success)
    result: Optional[CommandResult] = None
    redirect: Optional[int] = None
    local: bool = False           # served as a leased local read
    retry_after: float = 0.0      # seconds (shed backoff hint)


class DriverClosedLoop:
    def __init__(self, endpoint: GenericEndpoint, timeout: float = 5.0):
        self.ep = endpoint
        self.timeout = timeout
        self.next_req = 0
        self.backoff = Backoff(seed=endpoint.id)

    def _issue(self, cmd: Command) -> DriverReply:
        rid = self.next_req
        self.next_req += 1
        t0 = time.monotonic()
        try:
            self.ep.send_req(rid, cmd)
        except Exception:
            return DriverReply("disconnect")
        deadline = t0 + self.timeout
        while True:
            budget = deadline - time.monotonic()
            if budget <= 0:
                return DriverReply("timeout")
            try:
                rep = self.ep.recv_reply(timeout=budget)
            except socket.timeout:
                # expired with zero frame bytes consumed: the stream is
                # still frame-aligned, a retry in place is safe
                return DriverReply("timeout")
            except Exception:
                # includes a mid-frame timeout: the stream is no longer
                # frame-aligned, the caller must reconnect/rotate
                return DriverReply("disconnect")
            if rep.req_id != rid:
                continue  # stale reply from a previous timeout
            if rep.kind == "redirect":
                self.ep.follow_redirect(rep.redirect, deadline=deadline)
                return DriverReply("redirect", redirect=rep.redirect)
            if rep.kind == "shed":
                return DriverReply(
                    "shed", retry_after=max(rep.retry_after_ms, 1) / 1e3,
                )
            if rep.kind in ("reply", "conf") and rep.success:
                return DriverReply(
                    "success",
                    latency=time.monotonic() - t0,
                    result=rep.result,
                    local=rep.local,
                )
            return DriverReply("failure")

    def get(self, key: str) -> DriverReply:
        return self._issue(Command("get", key))

    def put(self, key: str, value: str) -> DriverReply:
        return self._issue(Command("put", key, value))

    def scan(self, start: str, end: Optional[str] = None,
             limit: int = 0) -> DriverReply:
        """Ordered range read over ``[start, end)``: the reply's
        ``result.items`` is the sorted (key, value) cut."""
        return self._issue(Command("scan", start, end=end,
                                   limit=int(limit)))

    def conf_change(self, conf_delta: dict, retries: int = 20
                    ) -> DriverReply:
        """Drive a ConfChange to completion through redirects and
        timeouts (parity: the reference mess/tester clients' conf flow,
        clients/mess.rs:16-45); each attempt waits at least 15 s, since
        the change rides the log."""
        for _ in range(retries):
            rid = self.next_req
            self.next_req += 1
            t0 = time.monotonic()
            try:
                self.ep.send_conf(rid, conf_delta)
            except Exception:
                self._failover(DriverReply("disconnect"))
                self.backoff.sleep()
                continue
            deadline = t0 + max(self.timeout, 15.0)
            rep = None
            while True:
                budget = deadline - time.monotonic()
                if budget <= 0:
                    rep = DriverReply("timeout")
                    break
                try:
                    raw = self.ep.recv_reply(timeout=budget)
                except socket.timeout:
                    rep = DriverReply("timeout")
                    break
                except Exception:
                    rep = DriverReply("disconnect")
                    break
                if raw.req_id != rid:
                    continue
                if raw.kind == "redirect":
                    self.ep.follow_redirect(raw.redirect, deadline=deadline)
                    rep = DriverReply("redirect", redirect=raw.redirect)
                    break
                rep = (DriverReply("success", latency=time.monotonic() - t0)
                       if raw.success else DriverReply("failure"))
                break
            if rep.kind == "success":
                self.backoff.reset()
                return rep
            self._failover(rep)
            self.backoff.sleep()
        raise AssertionError("conf_change failed after retries")

    def _failover(self, rep: DriverReply) -> None:
        """A timeout, refusal or dead connection rotates the endpoint to
        a different server, the walk bounded by one request budget."""
        if rep.kind in ("timeout", "failure", "disconnect"):
            try:
                self.ep.rotate(deadline=time.monotonic() + self.timeout)
            except Exception:
                pass

    def _retry_pause(self, rep: DriverReply) -> None:
        """Between-retry wait: sheds honor the retry-after hint (no
        rotation — the server is healthy, just full); everything else
        fails over and takes the exponential backoff."""
        if rep.kind == "shed":
            self.backoff.sleep_hint(rep.retry_after)
        else:
            self._failover(rep)
            self.backoff.sleep()

    def checked_put(self, key: str, value: str, retries: int = 20):
        """Retry through redirects/timeouts until acked (parity:
        tester.rs checked_put)."""
        for _ in range(retries):
            rep = self.put(key, value)
            if rep.kind == "success":
                self.backoff.reset()
                return rep
            self._retry_pause(rep)
        raise AssertionError(f"checked_put({key}) failed after retries")

    def checked_get(self, key: str, expect: Optional[str],
                    retries: int = 20):
        for _ in range(retries):
            rep = self.get(key)
            if rep.kind == "success":
                got = rep.result.value if rep.result else None
                assert got == expect, f"get({key}) = {got} != {expect}"
                self.backoff.reset()
                return rep
            self._retry_pause(rep)
        raise AssertionError(f"checked_get({key}) failed after retries")


class DriverOpenLoop:
    """Pipelined issue/ack driver (parity: open_loop.rs)."""

    def __init__(self, endpoint: GenericEndpoint, timeout: float = 5.0):
        self.ep = endpoint
        self.timeout = timeout
        self.next_req = 0
        self.inflight: Dict[int, float] = {}

    def issue(self, cmd: Command) -> int:
        rid = self.next_req
        self.next_req += 1
        self.ep.send_req(rid, cmd)
        self.inflight[rid] = time.monotonic()
        return rid

    def wait_reply(self, timeout: Optional[float] = None
                   ) -> Optional[DriverReply]:
        try:
            rep = self.ep.recv_reply(
                timeout=self.timeout if timeout is None else timeout
            )
        except Exception:
            return None
        t0 = self.inflight.pop(rep.req_id, None)
        if rep.kind == "redirect":
            self.ep.reconnect(rep.redirect)
            return DriverReply("redirect", redirect=rep.redirect)
        if rep.kind == "shed":
            # negative ack (never executed) — a bench counting this as
            # success would fold refused ops into the very overload
            # curves the workload classes exist to measure
            return DriverReply(
                "shed", retry_after=max(rep.retry_after_ms, 1) / 1e3,
            )
        if rep.kind not in ("reply", "conf") or not rep.success:
            return DriverReply("failure")
        return DriverReply(
            "success",
            latency=(time.monotonic() - t0) if t0 else 0.0,
            result=rep.result,
        )


class DriverOpenLoopPaced:
    """Shed-aware pipelined driver for open-loop workload schedules
    (``host/workload.WorkloadPlan``): the caller paces arrivals (the
    plan's phase table x the wall clock is the runner's business), this
    driver owns the inflight window, reply matching, shed gating, and
    per-op deadlines.

    Recording semantics for the workload soak's ``utils/linearize``
    histories (returned per reply so the caller can record):

    - ``success``  — acked; record with [t_inv, t_resp];
    - ``shed``     — negatively acked (guaranteed never proposed);
      record as a shed op (the checker EXCLUDES it — a get observing
      its value is then a linearizability violation) and gate issuing
      until the jittered retry-after elapses;
    - ``redirect`` — refused without proposing; not recorded (the
      driver reconnects toward the hint);
    - expiry (``expired()``) — no reply within ``timeout``: a put may
      or may not have executed, record UNACKED.
    """

    def __init__(self, endpoint: GenericEndpoint, timeout: float = 5.0,
                 seed: int = 0, max_inflight: int = 128):
        self.ep = endpoint
        self.timeout = timeout
        self.next_req = 0
        # rid -> {"kind", "key", "value", "t0", "deadline"}
        self.inflight: Dict[int, dict] = {}
        # bounded window (YCSB-style): past it, arrivals are dropped
        # client-side and counted — an unbounded window under overload
        # would just move the unbounded queue into the client
        self.max_inflight = max(1, int(max_inflight))
        self._rng = random.Random(seed * 65537 + 3)
        self.hold_until = 0.0  # shed gate (monotonic seconds)
        self.counts = {
            "issued": 0, "acked": 0, "shed": 0, "expired": 0,
            "redirect": 0, "failure": 0, "held": 0, "window": 0,
        }

    def gated(self, now: float) -> bool:
        """Is issuing currently suppressed by a shed retry-after
        hint?  (Open-loop arrivals landing inside the gate are counted
        ``held`` by the caller and dropped — the client-side half of
        graceful degradation.)"""
        return now < self.hold_until

    def issue(self, kind: str, key: str,
              value: Optional[str] = None,
              end: Optional[str] = None) -> Optional[int]:
        """Send one op; returns its rid, or None when the connection
        died at send (the op never left — nothing to record; the driver
        rotates so the next arrival has a live socket)."""
        if len(self.inflight) >= self.max_inflight:
            self.counts["window"] += 1
            return None
        rid = self.next_req
        self.next_req += 1
        if kind == "put":
            cmd = Command("put", key, value)
        elif kind == "scan":
            # open-loop scans carry the length in ``value`` (workload
            # OpStream emits ("scan", start_key, length)): a limit cap
            # with an optional end bound — the YCSB-E shape.  Recorder
            # callers pass the plan keyspace's upper bound as ``end`` so
            # the observed cut never strays into harness keys whose
            # writes the checked history does not carry
            cmd = Command("scan", key, end=end,
                          limit=max(1, int(value or 1)))
        else:
            cmd = Command("get", key)
        try:
            self.ep.send_req(rid, cmd)
        except Exception:
            self._reconnect()
            return None
        now = time.monotonic()
        self.inflight[rid] = {
            "kind": kind, "key": key, "value": value,
            "limit": cmd.limit, "end": cmd.end, "t0": now,
            "deadline": now + self.timeout,
        }
        self.counts["issued"] += 1
        return rid

    def _reconnect(self) -> None:
        try:
            self.ep.rotate(deadline=time.monotonic() + 1.0)
        except Exception:
            pass

    def poll(self, budget: float) -> List[Tuple[dict, DriverReply]]:
        """Drain replies for up to ``budget`` seconds; returns
        ``[(inflight-info, DriverReply)]`` for every matched reply."""
        out: List[Tuple[dict, DriverReply]] = []
        end = time.monotonic() + max(budget, 0.0)
        while True:
            rem = end - time.monotonic()
            if rem <= 0:
                break
            try:
                rep = self.ep.recv_reply(timeout=max(rem, 0.001))
            except socket.timeout:
                break
            except Exception:
                # dead/mid-frame connection: inflight ops will expire
                # as unacked; reconnect for the next arrivals
                self._reconnect()
                break
            info = self.inflight.pop(rep.req_id, None)
            if info is None:
                continue  # stale reply from before a reconnect
            now = time.monotonic()
            if rep.kind == "shed":
                hint = max(rep.retry_after_ms, 1) / 1e3
                self.hold_until = max(
                    self.hold_until,
                    now + hint * self._rng.uniform(0.5, 1.5),
                )
                self.counts["shed"] += 1
                out.append((info, DriverReply(
                    "shed", retry_after=hint,
                )))
            elif rep.kind == "redirect":
                self.counts["redirect"] += 1
                self.ep.follow_redirect(rep.redirect, deadline=now + 1.0)
                out.append((info, DriverReply(
                    "redirect", redirect=rep.redirect,
                )))
            elif rep.kind in ("reply", "conf") and rep.success:
                self.counts["acked"] += 1
                out.append((info, DriverReply(
                    "success", latency=now - info["t0"],
                    result=rep.result, local=rep.local,
                )))
            else:
                self.counts["failure"] += 1
                out.append((info, DriverReply("failure")))
            if not self.inflight:
                break
        return out

    def expired(self) -> List[dict]:
        """Pop and return every inflight op past its deadline (puts
        among them must be recorded UNACKED — they may have executed)."""
        now = time.monotonic()
        out = []
        for rid, info in list(self.inflight.items()):
            if now > info["deadline"]:
                out.append(self.inflight.pop(rid))
        self.counts["expired"] += len(out)
        return out
