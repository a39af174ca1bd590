"""Host metrics registry: counters, gauges, exponential-bucket histograms,
counterpart of ``summerset_tpu/host/telemetry.py``.

The host half of the telemetry plane (the device half is
``core/telemetry.py``'s in-kernel metric lanes).  One ``MetricsRegistry``
per server process, threaded through every hub seam:

- ``ExternalApi``   — request→reply latency, request/reply counts;
- ``TransportHub``  — frames/bytes per peer (both directions), reconnects;
- ``StorageHub``    — fsync latency, group-commit batch size, appends;
- ``ServerReplica`` — run-loop stage breakdown (intake/exchange/step/log/
  apply — the one timing system; the old ad-hoc ``record_breakdown``
  stopwatch dict is gone), payload-plane egress gauges, and sampled
  per-request slot traces whose ticks-to-commit distribution finally
  measures the host-plane latency story server-side.

Everything is pull-based: hub writes are lock-guarded increments; the
``metrics_dump`` ctrl scrape (``host/server.py`` ``metrics_snapshot``)
serializes one deterministic, JSON-able snapshot.

Histogram shape: power-of-two buckets over non-negative integer samples
(microseconds for latencies, counts for sizes): bucket ``i`` holds
samples with ``bit_length == i`` (0 goes to bucket 0), i.e. bounds
1, 2, 4, ... — 64 buckets cover anything an int64 can hold.  Snapshots
emit buckets sparsely ({index: count}) plus count/sum/min/max and
bucket-interpolated p50/p99, so committed artifacts stay small.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

_NB = 64


def _key(name: str, labels: Dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Histogram:
    """Exponential (power-of-two) bucket histogram over integer samples."""

    __slots__ = ("count", "total", "vmin", "vmax", "buckets")

    def __init__(self):
        self.count = 0
        self.total = 0
        self.vmin: Optional[int] = None
        self.vmax = 0
        self.buckets = [0] * _NB

    def observe(self, value) -> None:
        v = max(0, int(value))
        self.count += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        self.buckets[min(v.bit_length(), _NB - 1)] += 1

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile (0 <= q <= 1), clamped to the
        observed [min, max] (interpolation inside the top bucket would
        otherwise overshoot the largest sample actually seen)."""
        if self.count == 0:
            return 0.0
        rank = q * (self.count - 1)
        seen = 0
        for i, n in enumerate(self.buckets):
            if n == 0:
                continue
            if seen + n > rank:
                lo = 0 if i == 0 else 1 << (i - 1)
                hi = (1 << i) - 1
                frac = (rank - seen) / n
                v = lo + frac * (hi - lo)
                return min(max(v, float(self.vmin or 0)), float(self.vmax))
            seen += n
        return float(self.vmax)

    def since(self, prev: Optional["Histogram"]) -> "Histogram":
        """Windowed view: a histogram of only the samples recorded after
        ``prev`` was captured (for periodic prints that must reflect
        RECENT behavior — lifetime-cumulative quantiles pin to history
        and hide a fresh regression).  min/max are not delta-decodable
        from counts, so the window inherits the cumulative ones."""
        if prev is None:
            return self
        out = Histogram()
        out.count = self.count - prev.count
        out.total = self.total - prev.total
        out.vmin = self.vmin
        out.vmax = self.vmax
        out.buckets = [
            a - b for a, b in zip(self.buckets, prev.buckets)
        ]
        return out

    def copy(self) -> "Histogram":
        out = Histogram()
        out.count = self.count
        out.total = self.total
        out.vmin = self.vmin
        out.vmax = self.vmax
        out.buckets = list(self.buckets)
        return out

    def merge(self, other: Optional["Histogram"]) -> "Histogram":
        """Fold ``other``'s samples into this histogram in place (and
        return self).  The inverse of :meth:`since`:
        ``prev.copy().merge(cur.since(prev))`` reproduces ``cur``'s
        count/sum/buckets exactly — the delta-snapshot round-trip the
        graftwatch stream relies on.  min/max combine conservatively
        (a window inherits cumulative extremes, so merging a window
        back never widens them wrongly)."""
        if other is None or other.count == 0 and other.total == 0 and \
                not any(other.buckets):
            return self
        self.count += other.count
        self.total += other.total
        if other.vmin is not None:
            self.vmin = other.vmin if self.vmin is None \
                else min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        for i, n in enumerate(other.buckets):
            if n:
                self.buckets[i] += n
        return self

    def frac_over(self, threshold: int) -> float:
        """Fraction of samples strictly above ``threshold`` — the
        "error rate" an SLO burn computes from a latency window
        (budget = 1 - objective quantile).  Interpolates inside the
        bucket the threshold lands in, consistent with
        :meth:`quantile`'s uniform-within-bucket model."""
        if self.count <= 0:
            return 0.0
        t = max(0, int(threshold))
        over = 0.0
        for i, n in enumerate(self.buckets):
            if n == 0:
                continue
            lo = 0 if i == 0 else 1 << (i - 1)
            hi = (1 << i) - 1
            if t < lo:
                over += n
            elif t < hi:
                over += n * (hi - t) / (hi - lo)
        return min(1.0, max(0.0, over / self.count))

    @classmethod
    def from_snapshot(cls, snap: Dict[str, Any]) -> "Histogram":
        """Rebuild a histogram from :meth:`snapshot`'s sparse form (the
        shape that rides wire frames and committed artifacts).  JSON
        round-trips stringify bucket indices, so keys may be str."""
        out = cls()
        out.count = int(snap.get("count", 0))
        out.total = int(snap.get("sum", 0))
        out.vmin = None if out.count == 0 else int(snap.get("min", 0))
        out.vmax = int(snap.get("max", 0))
        for i, n in (snap.get("buckets") or {}).items():
            out.buckets[int(i)] = int(n)
        return out

    def snapshot(self) -> Dict[str, Any]:
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.vmin or 0,
            "max": self.vmax,
            "p50": round(self.quantile(0.50), 1),
            "p99": round(self.quantile(0.99), 1),
            "buckets": {
                i: n for i, n in enumerate(self.buckets) if n
            },
        }


class MetricsRegistry:
    """Thread-safe named metrics; snapshot order is deterministic."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}

    # -- write side (hub seams) ---------------------------------------------
    def counter_add(self, name: str, inc: int = 1, **labels) -> None:
        k = _key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0) + int(inc)

    def gauge_set(self, name: str, value, **labels) -> None:
        with self._lock:
            self._gauges[_key(name, labels)] = value

    def observe(self, name: str, value, **labels) -> None:
        """Record one histogram sample (integer units: us / bytes / n)."""
        k = _key(name, labels)
        with self._lock:
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = Histogram()
            h.observe(value)

    def observe_s(self, name: str, seconds: float, **labels) -> None:
        """Record a latency sample given in seconds (stored as us)."""
        self.observe(name, int(seconds * 1e6), **labels)

    # -- read side -----------------------------------------------------------
    def hist(self, name: str, **labels) -> Optional[Histogram]:
        return self._hists.get(_key(name, labels))

    def counter_value(self, name: str, **labels) -> int:
        return self._counters.get(_key(name, labels), 0)

    def gauge_value(self, name: str, default: float = 0.0, **labels):
        with self._lock:
            return self._gauges.get(_key(name, labels), default)

    def names(self) -> set:
        """Base metric names present (label suffixes stripped)."""
        with self._lock:
            keys = (
                list(self._counters) + list(self._gauges) + list(self._hists)
            )
        return {k.split("{", 1)[0] for k in keys}

    def export_raw(self) -> Tuple[Dict[str, int], Dict[str, float],
                                  Dict[str, Histogram]]:
        """One consistent point-in-time copy of every series (counters,
        gauges, histogram COPIES) under a single lock hold — the
        graftwatch emitter diffs two of these to build a delta frame.
        Copies are cheap (a histogram is 64 ints); the caller owns them."""
        with self._lock:
            return (
                dict(self._counters),
                dict(self._gauges),
                {k: h.copy() for k, h in self._hists.items()},
            )

    def snapshot(self) -> Dict[str, Any]:
        """Deterministic JSON-able dump: same recorded ops -> same dict."""
        with self._lock:
            return {
                "counters": {
                    k: self._counters[k] for k in sorted(self._counters)
                },
                "gauges": {
                    k: self._gauges[k] for k in sorted(self._gauges)
                },
                "histograms": {
                    k: self._hists[k].snapshot()
                    for k in sorted(self._hists)
                },
            }


class SlotTraces:
    """Sampled per-request slot spans: arrival → proposed tick →
    committed tick → applied tick → replied, for the host serving path.

    ``sample_every = n`` traces every n-th proposed batch per group (1 =
    everything, 0 = off).  Completed traces feed the ``ticks_to_commit``
    and ``ticks_to_apply`` histograms in the registry — the distribution
    behind the host-plane latency cliff that client-side percentiles
    could only hint at — and the last few full traces ride the scrape for
    eyeballing.

    Span building (graftscope): each sampled trace is keyed by its
    ``(g, vid)`` slot identity and carries the representative
    ``(client, req_id)`` of its batch — the junction that connects the
    api-plane ingress/reply events to the slot's propose/commit/apply
    events at export time.  When a ``flight``
    recorder is attached, ``maybe_start`` logs the ``propose`` event
    with both identities so ``scripts/trace_export.py`` can stitch the
    full chain api-arrival → propose → commit → apply → reply.

    Locking: EVERY ``_open`` access holds ``_lock`` — ``maybe_start``
    can ``clear()`` the map under the lock while the mark_* paths run on
    the replica thread, so a lock-free ``get`` could double-observe a
    histogram sample or mutate a dict that was already evicted.
    """

    KEEP = 32

    def __init__(self, registry: MetricsRegistry, sample_every: int = 8,
                 flight=None):
        self.registry = registry
        self.sample_every = max(0, int(sample_every))
        self.flight = flight  # optional tracing.FlightRecorder
        self._n = 0
        self._open: Dict[Tuple[int, int], Dict[str, Any]] = {}
        self._done: list = []
        self._lock = threading.Lock()

    def maybe_start(self, g: int, vid: int, tick: int,
                    arrival_s: float, client: Optional[int] = None,
                    req_id: Optional[int] = None) -> None:
        if self.sample_every == 0:
            return
        with self._lock:
            self._n += 1
            if self._n % self.sample_every:
                return
            if len(self._open) >= 512:  # lost traces must not accumulate
                self._open.clear()
            self._open[(g, vid)] = {
                "g": g, "vid": vid, "t_arrival_s": arrival_s,
                "tick_proposed": tick,
                "client": client, "req_id": req_id,
            }
        if self.flight is not None:
            self.flight.record(
                "propose", g=g, vid=vid, tick=tick,
                client=client, req_id=req_id,
            )

    def mark_committed(self, g: int, vid: int, tick: int) -> None:
        with self._lock:
            tr = self._open.get((g, vid))
            if tr is None or "tick_committed" in tr:
                return
            tr["tick_committed"] = tick
            delta = tick - tr["tick_proposed"]
        self.registry.observe("ticks_to_commit", delta)

    def mark_applied(self, g: int, vid: int, tick: int) -> None:
        with self._lock:
            tr = self._open.get((g, vid))
            if tr is None or "tick_applied" in tr:
                return
            tr["tick_applied"] = tick
            delta = tick - tr["tick_proposed"]
        self.registry.observe("ticks_to_apply", delta)

    def mark_replied(self, g: int, vid: int, now_s: float) -> None:
        with self._lock:
            tr = self._open.pop((g, vid), None)
            if tr is None:
                return
            tr["latency_ms"] = round(
                (now_s - tr.pop("t_arrival_s")) * 1e3, 3
            )
            self._done.append(tr)
            del self._done[: -self.KEEP]

    def sampled(self) -> list:
        with self._lock:
            return list(self._done)


# canonical metric names every live server must expose once it has
# served traffic — the tier-2d smoke gate fails if one goes missing
# (renames must update this tuple AND the README Telemetry table)
DECLARED = (
    "api_request_latency_us",
    "api_requests_total",
    "api_replies_total",
    "api_stamps_evicted",
    # ingress backpressure (host/external.py bounded queue): sheds are
    # pre-registered at zero so "no overload yet" is visible as 0, not
    # as a missing series; queue depth is the gauge the shed decision
    # reads, sampled at every batch take
    "api_shed",
    "api_queue_depth",
    "transport_frames_sent",
    "transport_bytes_sent",
    "transport_frames_recv",
    "transport_bytes_recv",
    "transport_connects",
    # wire-plane codec (utils/wirecodec.py): per-frame serialize /
    # deserialize cost histograms labeled by plane (p2p = tick mesh,
    # api/proxy = client planes) — the A/B row's gated us/op source —
    # plus the SAMPLED bytes-saved counter (every Nth codec frame is
    # also pickled to measure the delta; pre-registered at zero so
    # codec-off runs read as 0, not missing).  wire_codec_on is the
    # mode gauge artifacts stamp.
    "wire_encode_us",
    "wire_decode_us",
    "wire_bytes_saved",
    "wire_codec_on",
    # gray-failure plane (host/health.py): per-peer frame-delivery
    # latency histograms (the slow_peer signal), the replica's own
    # health verdict gauge (1.0 healthy .. 0.0 indicted), and the
    # demotion counter — pre-registered so "never limped" reads as
    # healthy values, not missing series
    "peer_ack_delay_us",
    "health_score",
    "leader_demotions",
    "wal_fsync_us",
    "wal_group_commit_batch",
    "wal_appends_total",
    "loop_stage_us",
    "ticks_to_commit",
    "commits_applied_total",
    "pp_bytes",
    "pp_items",
    # live resharding (host/resharding.py): per-key-range heat at the
    # api seam, executed split/merge cutovers, and seal->adopt latency
    "range_heat",
    "reshard_splits",
    "reshard_merges",
    "reshard_cutover_us",
    # seal-TTL escape hatch (host/server.py _range_unseal): sealed
    # ranges whose destination stayed leaderless past seal_ttl_ticks
    # and rolled back to serving from the source
    "reshard_seal_expired",
    # ordered range reads (scan plane): scans served from applied state
    # (fused lease path or commit-bar barrier), scans refused (sealed
    # span / expired barrier), and total keys returned — pre-registered
    # so scan-free runs read as zero series
    "scan_served",
    "scan_shed",
    "scan_keys",
    # autopilot policy tier (host/autopilot.py): actuations applied on
    # THIS server labeled by actuator, the announced driver mode
    # (0 = none/observe, 1 = act), and per-actuator remaining-cooldown
    # gauges — pre-registered so "no autopilot attached" reads as zero
    # series, not missing ones
    "autopilot_actions",
    "autopilot_mode",
    "autopilot_cooldown",
    # graftscope ring accounting (host/tracing.py): events the flight
    # ring overwrote, labeled by event type — pre-registered bare at
    # zero so "nothing dropped" reads as 0, not a missing series; the
    # labeled series appear per type once overflow actually happens
    "trace_dropped_total",
    # graftwatch streaming (host/graftwatch.py): delta frames emitted
    # over the ctrl plane, and the per-emit build cost — pre-registered
    # so streaming-off runs read as zero series, not missing ones
    "watch_frames_total",
    "watch_emit_us",
)

# canonical metric names every INGRESS PROXY (host/ingress.py) must
# expose — the proxy-tier twin of DECLARED, pre-registered at proxy
# construction so "never routed / never shed / never served a learner
# read" all read as zero series, not missing ones.  The proxy's embedded
# ExternalApi contributes the proxy_requests/replies/shed/queue_depth
# family through its metric namespace; the routing/dedupe/read-tier
# counters are the proxy's own.  Per-tier queue-depth attribution:
# ``api_queue_depth`` is the shard tier's gauge, ``proxy_queue_depth``
# the proxy tier's — overload location is readable straight off which
# tier's ``*_shed`` series moves.
PROXY_DECLARED = (
    "proxy_requests_total",
    "proxy_replies_total",
    "proxy_request_latency_us",
    "proxy_stamps_evicted",
    "proxy_shed",            # front-door sheds AT the proxy tier
    "proxy_queue_depth",
    "proxy_routed",          # commands forwarded to owner shards
    "proxy_dedupe_hits",     # (client, req_id) duplicates absorbed
    "proxy_upstream_shed",   # shard-tier sheds relayed through
    "proxy_backlog",         # internal forward backlog depth gauge
    "read_tier_served",      # reads served from the learner's state
    #                          (gets AND scans — total serve volume)
    "read_tier_scans",       # the scan share of read_tier_served
    "read_tier_backlog",     # in-flight freshness probes gauge
    "range_heat",            # per-key-range heat at the proxy seam
)
