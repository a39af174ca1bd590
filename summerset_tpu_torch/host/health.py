"""Gray-failure detection: per-replica health scoring by quorum-median
outlier, and the shared indictment machinery behind leader demotion.

The port's own copy of ``summerset_tpu/host/health.py``, held to it by
``tests/test_torch_health.py``; it imports nothing of the JAX package.

The dominant real-world failure mode for long-lived clusters is
fail-slow, not fail-stop: a limping disk, a rate-limited NIC, a
CPU-starved host — alive enough to answer heartbeats and hold
leadership/leases while tanking the whole group.  The nemesis classes
``slow_disk`` / ``slow_peer`` / ``mem_pressure`` inject exactly that;
this module is the detection half, ``host/server.py``'s demotion path
the mitigation half.

Signals — all things the hubs already emit, no new measurement plane:

- ``fsync_us``    — EWMA of WAL durability-point latency (StorageHub's
                    ``wal_fsync_us`` samples; the slow_disk tell);
- ``wal_tick_us`` — EWMA of TOTAL durability time per tick (mem_pressure
                    forces many cheap fsyncs per tick, so the per-sync
                    latency stays innocent while the per-tick cost
                    explodes);
- ``qd``          — EWMA of the api ingress queue depth (the PR 7
                    ``api_queue_depth`` gauge: a starved replica that
                    cannot drain its intake);
- ``delay_ms``    — per-peer frame delivery delay from the transport's
                    send stamps (the slow_peer tell: the egress token
                    bucket / CPU-starve stall lands AFTER the stamp, so
                    peers see the victim's limp directly).

Each replica piggybacks a compact beacon of its own signals (plus its
*observations* of every peer's frame delay) on the tick frames it
already sends; every replica therefore assembles the same R-row signal
table and computes the same verdict — the indicted LEADER discovers its
own indictment locally and steps down voluntarily.

The verdict is a **robust outlier test relative to the quorum median**,
explicitly NOT an absolute threshold: a replica is outlier on a signal
only when its value exceeds BOTH a per-signal noise floor AND
``ratio x`` the cross-replica median.  Uniform slowness (a loaded box:
every median moves together) and ``clock_skew`` (the victim's clock
runs slow, but its per-op latencies — fsync duration, frame
stamp-to-delivery — stay healthy; only its RATE drops, which no signal
here measures) cannot trip it.  Indictment requires ``hysteresis``
consecutive outlier evaluations and at least a quorum of fresh beacons
(so a partition minority, or the churn window of a legitimate election,
can never indict anyone), and clears after ``clear_after`` consecutive
healthy evaluations — oscillating slowness flaps the streak, not the
leadership.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Tuple

#: the signal table: name -> (beacon key, noise floor).  Floors are the
#: "could this be measurement noise" guard of the outlier test — small
#: enough that every injected fail-slow class clears them by an order of
#: magnitude, large enough that a quiet same-box cluster never does.
SIGNALS: Tuple[Tuple[str, str, float], ...] = (
    ("fsync_us", "f", 5000.0),     # 5ms: healthy same-box fsync ~0.1-1ms
    ("wal_tick_us", "w", 8000.0),  # 8ms of durability per tick
    ("qd", "q", 64.0),             # api queue depth
    ("delay_ms", "d", 25.0),       # frame stamp->delivery, same-host
)


@dataclasses.dataclass
class HealthVerdict:
    """One evaluation round's outcome."""

    evaluated: bool                  # quorum of fresh beacons present?
    indicted: List[int]              # replicas past the hysteresis bar
    outliers: Dict[int, List[str]]   # this round's raw outlier signals
    scores: Dict[int, float]         # 1.0 healthy .. 0.0 indicted
    table: Dict[str, Dict[int, float]]  # signal -> {replica: value}


class HealthScorer:
    """Per-replica gray-failure scorer (one per server process).

    Hub seams call ``note_fsync`` / ``note_peer_delay`` from their own
    threads; the replica loop calls ``end_tick`` once per tick,
    ``beacon``/``ingest`` around the frame exchange, and ``evaluate``
    every ``eval_interval`` ticks (the server owns the cadence).
    """

    def __init__(
        self,
        me: int,
        population: int,
        ratio: float = 4.0,
        hysteresis: int = 3,
        clear_after: int = 2,
        stale_s: float = 2.0,
        alpha: float = 0.25,
        floors: Optional[Dict[str, float]] = None,
    ):
        self.me = me
        self.population = population
        self.quorum = population // 2 + 1
        self.ratio = float(ratio)
        self.hysteresis = max(1, int(hysteresis))
        self.clear_after = max(1, int(clear_after))
        self.stale_s = float(stale_s)
        self.alpha = float(alpha)
        self.floors = {
            name: (floors or {}).get(name, floor)
            for name, _k, floor in SIGNALS
        }
        self._lock = threading.Lock()
        # own-signal EWMAs (written under the lock: storage's logger
        # thread and transport's messenger threads feed them)
        self._fsync_us = 0.0
        self._wal_tick_us = 0.0
        self._qd = 0.0
        self._tick_sync_us = 0.0   # this tick's durability accumulator
        self._have_own = False
        # my observations of each peer's frame delay (EWMA, ms)
        self._peer_delay_ms: Dict[int, float] = {}
        # freshest beacon per peer: (monotonic stamp, beacon dict)
        self._beacons: Dict[int, Tuple[float, Dict[str, Any]]] = {}
        # hysteresis state
        self._bad_streak: Dict[int, int] = {}
        self._good_streak: Dict[int, int] = {}
        self._indicted: set = set()

    # -- hub write side ------------------------------------------------------
    def _ewma(self, old: float, x: float) -> float:
        return x if old <= 0.0 else (1 - self.alpha) * old + self.alpha * x

    def note_fsync(self, dur_s: float) -> None:
        """One durability point completed (StorageHub logger thread)."""
        us = dur_s * 1e6
        with self._lock:
            self._fsync_us = self._ewma(self._fsync_us, us)
            self._tick_sync_us += us

    def note_peer_delay(self, peer: int, delay_s: float) -> None:
        """One send-stamped frame delivered from ``peer`` (transport
        messenger thread; same-host stamps only, like the adaptive
        plane's samples)."""
        ms = max(0.0, delay_s * 1e3)
        with self._lock:
            self._peer_delay_ms[peer] = self._ewma(
                self._peer_delay_ms.get(peer, 0.0), ms
            )

    # -- replica-loop side ---------------------------------------------------
    def end_tick(self, queue_depth: float) -> None:
        """Fold this tick's accumulators into the per-tick EWMAs."""
        with self._lock:
            self._wal_tick_us = self._ewma(
                self._wal_tick_us, self._tick_sync_us
            )
            self._tick_sync_us = 0.0
            self._qd = self._ewma(self._qd, float(queue_depth))
            self._have_own = True

    def beacon(self) -> Dict[str, Any]:
        """The compact health blob piggybacked on every tick frame."""
        with self._lock:
            return {
                "f": round(self._fsync_us, 1),
                "w": round(self._wal_tick_us, 1),
                "q": round(self._qd, 2),
                "o": {
                    p: round(v, 2)
                    for p, v in self._peer_delay_ms.items()
                },
            }

    def ingest(self, src: int, beacon: Dict[str, Any], now: float) -> None:
        """A peer's beacon arrived on a tick frame."""
        if not isinstance(beacon, dict):
            return
        with self._lock:
            self._beacons[int(src)] = (float(now), dict(beacon))

    # -- verdict -------------------------------------------------------------
    def _signal_table(self, now: float) -> Dict[str, Dict[int, float]]:
        """signal -> {replica: value} over fresh reporters (self always
        fresh).  ``delay_ms[r]`` is the median over OBSERVERS of r —
        self-reports can't hide a limping egress."""
        with self._lock:
            fresh: Dict[int, Dict[str, Any]] = {
                self.me: {
                    "f": self._fsync_us, "w": self._wal_tick_us,
                    "q": self._qd, "o": dict(self._peer_delay_ms),
                }
            }
            if not self._have_own:
                del fresh[self.me]
            for p, (t, b) in self._beacons.items():
                if now - t <= self.stale_s:
                    fresh[p] = b
        table: Dict[str, Dict[int, float]] = {}
        for name, key, _fl in SIGNALS:
            if name == "delay_ms":
                continue
            table[name] = {
                r: float(b.get(key, 0.0) or 0.0) for r, b in fresh.items()
            }
        obs: Dict[int, List[float]] = {}
        for o, b in fresh.items():
            for subj, v in (b.get("o") or {}).items():
                obs.setdefault(int(subj), []).append(float(v))
        table["delay_ms"] = {
            subj: _median(vals)
            for subj, vals in obs.items() if int(subj) in fresh
        }
        return table

    def evaluate(self, now: float) -> HealthVerdict:
        """One outlier round.  Quorum-gated: with fewer than a quorum of
        fresh reporters (partition minority, election churn taking peers'
        frames away) nothing is evaluated and every streak resets toward
        healthy — absence of evidence never indicts."""
        table = self._signal_table(now)
        reporters = set(table["fsync_us"])
        if len(reporters) < self.quorum:
            for r in list(self._bad_streak):
                self._bad_streak[r] = 0
            return HealthVerdict(
                False, sorted(self._indicted), {}, self._scores(), table
            )
        outliers: Dict[int, List[str]] = {}
        for name, _key, _fl in SIGNALS:
            vals = table.get(name) or {}
            if len(vals) < self.quorum:
                continue
            med = _median(list(vals.values()))
            floor = self.floors[name]
            for r, x in vals.items():
                if x > floor and x > self.ratio * max(med, 1e-9):
                    outliers.setdefault(r, []).append(name)
        for r in reporters:
            if r in outliers:
                self._bad_streak[r] = self._bad_streak.get(r, 0) + 1
                self._good_streak[r] = 0
                if self._bad_streak[r] >= self.hysteresis:
                    self._indicted.add(r)
            else:
                self._good_streak[r] = self._good_streak.get(r, 0) + 1
                self._bad_streak[r] = 0
                if self._good_streak[r] >= self.clear_after:
                    self._indicted.discard(r)
        return HealthVerdict(
            True, sorted(self._indicted), outliers, self._scores(), table
        )

    def _scores(self) -> Dict[int, float]:
        """1.0 healthy .. 0.0 indicted (the ``health_score`` gauge)."""
        out = {}
        for r in range(self.population):
            if r in self._indicted:
                out[r] = 0.0
            else:
                out[r] = round(
                    max(0.0, 1.0 - self._bad_streak.get(r, 0)
                        / self.hysteresis), 3
                )
        return out

    @property
    def self_indicted(self) -> bool:
        return self.me in self._indicted


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    if n == 0:
        return 0.0
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])
