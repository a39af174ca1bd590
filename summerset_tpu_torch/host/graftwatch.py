"""graftwatch: the fleet-wide windowed time-series + SLO burn-rate
plane over the ctrl channel.

The port's own copy of ``summerset_tpu/host/graftwatch.py``, held to it by
``tests/test_torch_tracing.py``; it imports nothing of the JAX package.

Every observability surface before this one was a point-in-time scrape
(``metrics_dump``) or an end-of-run dump (flight rings, soak
artifacts) — nobody could answer "what did p99 do DURING the nemesis
window on replica 2".  graftwatch closes that gap with three pieces:

- :class:`WatchEmitter` (server side): every ``watch_ticks`` ticks the
  replica diffs its :class:`~.telemetry.MetricsRegistry`
  against the previous emit (one ``export_raw`` lock hold) and ships a
  compact DELTA frame over the existing ctrl connection as a one-way
  ``CtrlMsg("watch_frame", ...)`` — counter deltas, gauge values, and
  histogram WINDOW snapshots (bucket deltas via ``Histogram.since``,
  so windowed quantiles come for free).  Frames are indexed by
  ``widx = tick // span_ticks`` — the tick counter, never wallclock —
  so every replica's window n means "its ticks [n*span, (n+1)*span)"
  and fleet alignment needs no clock agreement (graftlint H103 holds
  for this module like every other host plane).

- :class:`FleetSeries` (manager side): a bounded per-``(sid, tier,
  group)`` ring of the frames each server shipped, aligned by widx,
  with a deterministic JSON export.  ``clusman`` ingests frames
  exactly like the other one-way ctrl kinds and serves the ring to
  clients via ``CtrlRequest("watch_series")`` — the data source for
  ``scripts/fleet_top.py``, the autopilot's burn senses, and the
  committed per-phase windows in ``SLO.json``.

- :class:`SloPolicy`: declared objectives (reply p99, shed rate, WAL
  fsync lag, scan starvation) evaluated with SRE-style multi-window
  burn rates.  Per window, each objective turns its slice of the
  fleet's deltas into an error rate (fraction of latency samples over
  the threshold — ``Histogram.frac_over`` — or a bad/total counter
  ratio); ``burn = error_rate / error_budget``.  A fast mean (last
  ``fast_windows``) catches cliffs, a slow mean (last
  ``slow_windows``) filters blips; the alert latches when BOTH clear
  ``burn_hi`` and un-latches when the fast mean drops below
  ``burn_clear``.  Evaluation is a pure fold over frames — the same
  code scores a live fleet and the committed SLO.json windows.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .telemetry import Histogram, MetricsRegistry

#: frame schema version (committed SLO.json embeds frames; bump on
#: field renames, append freely)
FRAME_VERSION = 1

#: the default declared objectives — each is (error rate)/(budget) per
#: window.  ``kind=quantile``: error rate is the fraction of the
#: window's histogram samples above ``threshold_us`` and the budget is
#: ``1 - q`` (e.g. p99 => 1% of samples may exceed the threshold).
#: ``kind=ratio``: error rate is ``num/den`` counter deltas and the
#: budget is explicit.  Thresholds are deliberately loose defaults for
#: the CI-scale localhost fleet; soaks override per artifact.
DEFAULT_OBJECTIVES = (
    {
        "name": "reply_p99", "kind": "quantile",
        "metric": "api_request_latency_us", "q": 0.99,
        "threshold_us": 250_000,
    },
    {
        "name": "shed_rate", "kind": "ratio",
        "num": "api_shed", "den": "api_requests_total",
        "budget": 0.05,
    },
    {
        "name": "wal_fsync_lag", "kind": "quantile",
        "metric": "wal_fsync_us", "q": 0.99,
        "threshold_us": 500_000,
    },
    {
        # starved scans / all scans: den is served-only, so the num is
        # folded back in (shed + served = attempted)
        "name": "scan_starvation", "kind": "ratio",
        "num": "scan_shed", "den": "scan_served",
        "den_excludes_num": True,
        "budget": 0.05,
    },
)


def base_name(key: str) -> str:
    """Strip the ``{label=...}`` suffix off a registry key."""
    return key.split("{", 1)[0]


# ---------------------------------------------------------------- emitter --
class WatchEmitter:
    """Server-side delta-frame builder.

    Holds the previous ``export_raw`` state; :meth:`frame` diffs the
    registry against it and returns one JSON-able delta frame.  The
    caller (the replica tick loop) owns cadence and shipping — the
    emitter never touches sockets, so it is trivially testable and the
    overhead ablation can flip it off by simply not calling it.
    """

    def __init__(self, registry: MetricsRegistry, me: int,
                 span_ticks: int = 50, tier: str = "shard",
                 group: int = 0):
        self.registry = registry
        self.me = int(me)
        self.span_ticks = max(1, int(span_ticks))
        self.tier = str(tier)
        self.group = int(group)
        self._prev_counters: Dict[str, int] = {}
        self._prev_hists: Dict[str, Histogram] = {}
        self.frames_emitted = 0

    def frame(self, tick: int) -> Dict[str, Any]:
        """Build the delta frame for the window ending at ``tick``.

        Counters ship as deltas (zero deltas elided), gauges as values,
        histograms as window snapshots (only windows that actually saw
        samples).  The first frame is the delta against an empty
        registry, i.e. the cumulative state — merging every frame of a
        series reproduces the registry, which is what makes the stream
        lossless for downstream accounting.
        """
        counters, gauges, hists = self.registry.export_raw()
        c_delta = {}
        for k, v in counters.items():
            d = v - self._prev_counters.get(k, 0)
            if d:
                c_delta[k] = d
        h_delta = {}
        for k, h in hists.items():
            win = h.since(self._prev_hists.get(k))
            if win.count > 0:
                h_delta[k] = win.snapshot()
        self._prev_counters = counters
        self._prev_hists = hists
        self.frames_emitted += 1
        return {
            "v": FRAME_VERSION,
            "sid": self.me,
            "tier": self.tier,
            "group": self.group,
            "widx": int(tick) // self.span_ticks,
            "tick": int(tick),
            "span_ticks": self.span_ticks,
            "counters": {k: c_delta[k] for k in sorted(c_delta)},
            "gauges": {k: gauges[k] for k in sorted(gauges)},
            "hists": {k: h_delta[k] for k in sorted(h_delta)},
        }


# ----------------------------------------------------------- fleet series --
class FleetSeries:
    """Manager-side bounded ring of per-server delta frames.

    Keyed ``(sid, tier, group)``; each key retains the newest
    ``retain`` frames.  Ingest is append-only and tolerant (a frame
    from an unknown/old schema is kept as-is — consumers filter by
    ``v``); export is deterministic (sorted keys, frames in arrival
    order, which per key is widx order because each server emits
    monotonically).  Thread-safe: clusman ingests on the asyncio loop
    while gate scripts may export from another thread.
    """

    def __init__(self, retain: int = 256):
        self.retain = max(8, int(retain))
        self._lock = threading.Lock()
        self._rings: Dict[Tuple[int, str, int], deque] = {}
        self.frames_ingested = 0

    def ingest(self, sid: int, frame: Dict[str, Any]) -> None:
        if not isinstance(frame, dict):
            return
        key = (
            int(sid),
            str(frame.get("tier", "shard")),
            int(frame.get("group", 0)),
        )
        with self._lock:
            ring = self._rings.get(key)
            if ring is None:
                ring = self._rings[key] = deque(maxlen=self.retain)
            ring.append(frame)
            self.frames_ingested += 1

    def export(self) -> Dict[str, Any]:
        """Deterministic JSON-able dump of the retained fleet series."""
        with self._lock:
            keys = sorted(self._rings)
            return {
                "v": FRAME_VERSION,
                "retain": self.retain,
                "frames_ingested": self.frames_ingested,
                "series": [
                    {
                        "sid": sid, "tier": tier, "group": group,
                        "frames": list(self._rings[(sid, tier, group)]),
                    }
                    for sid, tier, group in keys
                ],
            }

    def sids(self) -> List[int]:
        with self._lock:
            return sorted({sid for sid, _, _ in self._rings})


def windows(export: Dict[str, Any],
            tier: Optional[str] = None) -> List[Dict[str, Any]]:
    """Fold a :meth:`FleetSeries.export` doc into per-widx fleet
    windows, each the MERGE of every server's frame for that widx:
    counter deltas summed, histograms merged (``Histogram.merge`` over
    ``from_snapshot``), gauges kept per-sid.  Returns windows sorted by
    widx; each carries the contributing sids so partial windows (a
    crashed replica's missing frame) are visible, not silent.
    """
    acc: Dict[int, Dict[str, Any]] = {}
    for s in export.get("series", []):
        if tier is not None and s.get("tier") != tier:
            continue
        for fr in s.get("frames", []):
            w = acc.setdefault(int(fr.get("widx", 0)), {
                "widx": int(fr.get("widx", 0)),
                "span_ticks": int(fr.get("span_ticks", 1)),
                "sids": [],
                "counters": {},
                "gauges": {},
                "_hists": {},
            })
            sid = int(fr.get("sid", s.get("sid", -1)))
            if sid not in w["sids"]:
                w["sids"].append(sid)
            for k, d in (fr.get("counters") or {}).items():
                b = base_name(k)
                w["counters"][b] = w["counters"].get(b, 0) + int(d)
            for k, v in (fr.get("gauges") or {}).items():
                w["gauges"].setdefault(base_name(k), {})[sid] = v
            for k, snap in (fr.get("hists") or {}).items():
                b = base_name(k)
                h = w["_hists"].get(b)
                win = Histogram.from_snapshot(snap)
                if h is None:
                    w["_hists"][b] = win
                else:
                    h.merge(win)
    out = []
    for widx in sorted(acc):
        w = acc[widx]
        w["sids"].sort()
        w["hists"] = {k: w["_hists"][k] for k in sorted(w["_hists"])}
        del w["_hists"]
        out.append(w)
    return out


# ------------------------------------------------------------- SLO policy --
class SloPolicy:
    """Multi-window burn-rate evaluation over fleet windows.

    Feed windows in widx order via :meth:`observe_window`; read
    :meth:`status` (or the per-window rows it appends to
    :attr:`history`).  Stateless alternative: :func:`evaluate_series`
    folds a whole export in one call — the committed-artifact path.
    """

    def __init__(self, objectives=DEFAULT_OBJECTIVES,
                 fast_windows: int = 3, slow_windows: int = 12,
                 burn_hi: float = 2.0, burn_clear: float = 1.0):
        self.objectives = [dict(o) for o in objectives]
        self.fast_windows = max(1, int(fast_windows))
        self.slow_windows = max(self.fast_windows, int(slow_windows))
        self.burn_hi = float(burn_hi)
        self.burn_clear = float(burn_clear)
        self._burns: Dict[str, deque] = {
            o["name"]: deque(maxlen=self.slow_windows)
            for o in self.objectives
        }
        self._alerting: Dict[str, bool] = {
            o["name"]: False for o in self.objectives
        }
        self.history: List[Dict[str, Any]] = []
        self.n_windows = 0

    # -- per-objective window error rate ------------------------------------
    @staticmethod
    def window_burn(obj: Dict[str, Any], window: Dict[str, Any]) -> float:
        """One objective's burn rate over one fleet window.  A window
        with no relevant activity burns 0 (no samples => no errors)."""
        if obj["kind"] == "quantile":
            h = window.get("hists", {}).get(obj["metric"])
            if h is None or h.count == 0:
                return 0.0
            err = h.frac_over(int(obj["threshold_us"]))
            budget = max(1e-9, 1.0 - float(obj["q"]))
            return err / budget
        if obj["kind"] == "ratio":
            num = int(window.get("counters", {}).get(obj["num"], 0))
            den = int(window.get("counters", {}).get(obj["den"], 0))
            den += num if obj.get("den_excludes_num") else 0
            if den <= 0:
                return 0.0
            err = num / den
            return err / max(1e-9, float(obj["budget"]))
        raise ValueError(f"unknown objective kind: {obj['kind']!r}")

    def observe_window(self, window: Dict[str, Any]) -> Dict[str, Any]:
        """Score one fleet window; returns (and records) the per-
        objective row {burn, fast, slow, alerting}."""
        self.n_windows += 1
        row: Dict[str, Any] = {"widx": window.get("widx")}
        for obj in self.objectives:
            name = obj["name"]
            burn = self.window_burn(obj, window)
            burns = self._burns[name]
            burns.append(burn)
            recent = list(burns)
            fast = sum(recent[-self.fast_windows:]) / min(
                len(recent), self.fast_windows
            )
            slow = sum(recent) / len(recent)
            if fast >= self.burn_hi and slow >= self.burn_hi:
                self._alerting[name] = True
            elif fast < self.burn_clear:
                self._alerting[name] = False
            row[name] = {
                "burn": round(burn, 4),
                "fast": round(fast, 4),
                "slow": round(slow, 4),
                "alerting": self._alerting[name],
            }
        self.history.append(row)
        return row

    def status(self) -> Dict[str, Any]:
        """The latest per-objective verdicts (empty before any window).
        This is the autopilot's ``slo_burn`` sense payload."""
        if not self.history:
            return {}
        latest = self.history[-1]
        return {
            o["name"]: latest[o["name"]] for o in self.objectives
        }


def evaluate_series(export: Dict[str, Any],
                    objectives=DEFAULT_OBJECTIVES,
                    tier: Optional[str] = None,
                    **policy_kw) -> Dict[str, Any]:
    """Fold a whole FleetSeries export through an :class:`SloPolicy` —
    the deterministic re-derivation path the SLO.json gate uses (same
    frames in => same verdicts out, no wallclock anywhere)."""
    pol = SloPolicy(objectives=objectives, **policy_kw)
    for w in windows(export, tier=tier):
        pol.observe_window(w)
    return {
        "n_windows": pol.n_windows,
        "status": pol.status(),
        "history": pol.history,
    }
