"""Closed-loop request driver, counterpart of
``summerset_tpu/client/drivers.py``.

Parity: reference ``summerset_client/src/drivers/closed_loop.rs`` — one
outstanding request with a timeout (``DriverReply::{Success{latency},
Redirect, Timeout}``, drivers/mod.rs:12-40); a success carries the
reply's ``local`` flag (a leased local read), ``scan`` is the ordered
range read, and ``conf_change`` drives a ConfChange to completion.  The open-loop drivers are not ported yet.
"""

from __future__ import annotations

import dataclasses
import random
import socket
import time
from typing import Optional

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
