"""graftscope flight recorder: a fixed-size ring of typed, monotonic-
stamped events per server — the causal-trace complement of the
aggregate telemetry plane (``host/telemetry.py``).

The port's own copy of ``summerset_tpu/host/tracing.py``, held to it by
``tests/test_torch_tracing.py``; it imports nothing of the JAX package.

Where the metrics registry answers "how slow, on average, is each
seam", the flight recorder answers "what exactly was this replica doing
in its final ticks" and "where did THIS request spend its time": every
hub seam logs a compact event into one per-server ring buffer —

- ``api_ingress`` / ``api_reply`` — client plane (client, req_id);
- ``propose``                    — a sampled batch entered the log
                                   ((g, vid) plus the representative
                                   (client, req_id) that connects the
                                   request span to the slot span);
- ``tick``                       — one run-loop iteration with its
                                   stage durations (the loop_stage_us
                                   stopwatches as child spans; the
                                   ``step`` stage is the device scan);
- ``frame_tx`` / ``frame_rx``    — transport frames with (peer, seq):
                                   ``seq`` is the sender's tick number,
                                   which already rides the wire, so tx
                                   and rx pair at export time across two
                                   servers' dumps with no wire change;
- ``wal_append`` / ``wal_fsync`` — storage plane (fsync carries the
                                   group-commit batch size + duration);
- ``commit`` / ``apply``         — a slot passed the commit bar / was
                                   applied, on every replica (not just
                                   the proposer);
- ``fault_ctl`` / ``crash`` / ``restart`` — nemesis actions, supervisor-
                                   observed crashes, and recovery.

The ring is lock-cheap: one mutex guarding a bounded ``deque`` append
(the write path is an int stamp + tuple append, ~1us); overflow drops
the OLDEST events and the drop count is part of every dump, so a
truncated view is always visible as truncated.  Stamps are
``time.monotonic()`` microseconds — never wallclock, which can jump and
reorder spans (graftlint H103 enforces this for the whole module).

Drop accounting is PER TYPE (schema v2): a leader's ring is dominated
by high-rate types (frame_tx/rx, tick), which used to silently evict
every rare-but-load-bearing event (demote, range_seal, crash) — TRACE.json
showed sid 0 dropping 27k events while its peers dropped none, with no
way to tell WHAT was lost.  Now every type keeps a small reserve ring
beside the main one (union-deduped at dump time), so a burst of frames
can no longer wash out the last demotion, and every dump carries
``recorded_by_type`` + ``dropped_by_type`` with the invariant
``sum(dropped_by_type.values()) == dropped``.  ``publish_drops``
mirrors the per-type drop counts into ``trace_dropped_total{type=...}``
registry counters at scrape time, and ``scripts/trace_export.py``
fails its schema check when a v2 dump's drops are unaccounted.

Dumps travel the ctrl plane: ``CtrlRequest("flight_dump")`` fans out and
gathers ``{sid: dump}`` exactly like ``metrics_dump``; NemesisRunner
failure repro bundles and the test_cluster supervisor's crash reports
attach the last-N tails automatically.  ``scripts/trace_export.py``
merges per-server dumps into one Chrome-trace/Perfetto timeline.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

#: the event taxonomy (dump consumers index by these names; appending is
#: fine, renames invalidate committed TRACE.json artifacts)
EVENT_TYPES = (
    "api_ingress",   # client request hit the api plane (client, req_id)
    "api_reply",     # reply left the api plane (client, req_id, kind)
    "api_shed",      # ingress backpressure refused a request before it
                     # entered the queue (client, req_id, retry_ms,
                     # depth) — overload is attributable on graftscope
                     # request chains instead of vanishing silently
    "propose",       # sampled batch proposed (g, vid, tick, client, req_id)
    "tick",          # run-loop iteration (tick, per-stage durations us;
                     # pipelined ticks additionally carry pipelined=1
                     # plus the overlap/device_wait attribution stages —
                     # host-work us coincident with the in-flight device
                     # step, and us spent blocked on its results)
    "device_step",   # pipelined mode: one DEVICE step's true wall span
                     # (tick, dur_us = dispatch -> results ready,
                     # wait_us = the host's residual blocked share).
                     # Recorded at drain time, on its own track, so the
                     # exporter renders the scan as a genuinely
                     # overlapping span beside the host "overlap" stage
                     # instead of nesting it inside the host tick span
    "frame_tx",      # p2p frame sent (peer=dst, seq=sender tick, nbytes)
    "frame_rx",      # p2p frame received (peer=src, seq=sender tick, nbytes)
    "wal_append",    # WAL record appended (sync flag)
    "wal_fsync",     # group-commit durability point (dur_us, batch)
    "commit",        # slot passed the commit bar (g, vid, slot, tick)
    "apply",         # slot applied to the KV (g, vid, slot, tick)
    "proxy_fwd",     # ingress proxy forwarded an op to an owner shard
                     # (sid, prid, client, req_id, fwd_id) — pairs with
                     # the shard's api_ingress where client == fwd_id
                     # and req_id == prid, giving trace_export the
                     # client→proxy→shard flow arrow with no wire change
    "proxy_rcv",     # upstream reply returned to the proxy (sid, prid,
                     # kind) — the shard→proxy half of the hop chain
    "read_serve",    # read tier served a get from learner state
                     # (client, req_id, seq) — the probe-gated
                     # lease-local read that never touched the proposer
    "scan_serve",    # ordered range read served (keys, tick on the
                     # fused path; client, req_id, seq on the learner
                     # tier) — one event per scan wherever it was cut
    "fault_ctl",     # nemesis fault_ctl received (planes touched)
    "demote",        # health plane indicted THIS replica's leadership and
                     # the server voluntarily stepped down (signals, the
                     # quorum-median table row, mitigation path) — the
                     # demotion instant on the exported ctrl track
    "crash",         # supervisor-observed crash (error)
    "restart",       # bring-up recovery completed (wal records, applied
                     # floor; cold=True means first boot, empty backer)
    "range_seal",    # live resharding: a key range sealed for cutover
                     # (rc_id, op, tick) — ops on it shed until adopted
    "range_adopt",   # live resharding: the destination group applied
                     # the adopt (rc_id, op, dst, keys, tick) — the
                     # cutover instant on the exported ctrl track
    "range_unseal",  # seal-TTL escape hatch: the source un-sealed a
                     # range whose destination never adopted (rc_id,
                     # why, tick) and resumed serving it
    "autopilot_act", # autopilot actuation applied on this server
                     # (act, plus actuator-specific fields like reason/
                     # api_max_batch/pipeline, tick) — the policy
                     # tier's instant on the exported ctrl track
    "transport_handshake_fail",
                     # a p2p dialer never completed the id handshake
                     # (error) — one stray is a port scan; a stream of
                     # them is codec skew after a partial upgrade, and
                     # without the record the mesh silently never forms
)
_EVENT_SET = frozenset(EVENT_TYPES)

SCHEMA_VERSION = 2


class FlightRecorder:
    """Fixed-size, lock-cheap ring of typed monotonic-stamped events.

    ``enabled=False`` turns every ``record`` into one attribute read —
    the recorder-off variant the tier-2f overhead gate compares against.
    ``capacity`` bounds memory AND dump size; overflow drops oldest —
    but each event type additionally keeps ``reserve_per_type`` newest
    events of its own in a side ring, so rare types survive a flood of
    hot ones.  A dump is the seq-ordered union (main ∪ reserves,
    deduped), which for a single-type stream is exactly the main ring.
    """

    def __init__(self, capacity: int = 8192, enabled: bool = True,
                 me: int = -1, reserve_per_type: Optional[int] = None):
        self.capacity = max(16, int(capacity))
        self.enabled = bool(enabled)
        self.me = me
        self.reserve_per_type = (
            max(8, self.capacity // 64) if reserve_per_type is None
            else max(1, int(reserve_per_type))
        )
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=self.capacity)
        self._seq = 0  # events ever recorded (>= len(_buf))
        # per-type reservations + lifetime counts (schema v2 accounting)
        self._reserve: Dict[str, deque] = {}
        self._recorded: Dict[str, int] = {}
        # publish_drops cursor: per-type drops already mirrored into the
        # registry (drop counts are monotone — an evicted event never
        # returns — so the delta is always >= 0)
        self._published: Dict[str, int] = {}
        # incarnation floor: a crash-restarted server gets a FRESH
        # recorder (and restarts its tick counter, reusing wire seqs),
        # so the exporter uses this birth stamp to refuse pairing the
        # new incarnation's frames against a peer's stale rx events
        self._t_start_us = int(time.monotonic() * 1e6)

    # -- write side (every hub seam; hot-path safe) -------------------------
    def record(self, etype: str, **fields: Any) -> None:
        """Append one event.  ``etype`` must be a declared
        :data:`EVENT_TYPES` name — an undeclared type is a contributor
        bug and fails loudly, same policy as the device metric lanes."""
        if not self.enabled:
            return
        if etype not in _EVENT_SET:
            raise KeyError(etype)
        with self._lock:
            # stamp INSIDE the lock: a pre-lock stamp lets a preempted
            # writer append behind a later-stamped peer, breaking the
            # ring's oldest-first stamp order that dumps/tails rely on
            t_us = int(time.monotonic() * 1e6)
            ev = (self._seq, t_us, etype, fields)
            self._buf.append(ev)
            res = self._reserve.get(etype)
            if res is None:
                res = self._reserve[etype] = deque(
                    maxlen=self.reserve_per_type
                )
            res.append(ev)
            self._recorded[etype] = self._recorded.get(etype, 0) + 1
            self._seq += 1

    # -- read side -----------------------------------------------------------
    def dump(self, last_n: Optional[int] = None) -> Dict[str, Any]:
        """JSON-able snapshot: the retained events (oldest first, trimmed
        to ``last_n`` newest when given) plus the drop accounting that
        makes truncation visible."""
        with self._lock:
            events = list(self._buf)
            total = self._seq
            recorded = dict(self._recorded)
            reserves = [list(r) for r in self._reserve.values()]
        # union the per-type reserves in (dedup by ring seq): a rare
        # type washed out of the main ring survives in its reserve, so
        # the dump keeps at least the newest few of EVERY type
        seen = {ev[0] for ev in events}
        extra = [
            ev for ring in reserves for ev in ring if ev[0] not in seen
        ]
        if extra:
            events = sorted(events + extra)
        if last_n is not None:
            n = int(last_n)
            # n <= 0 means "metadata only" (events[-0:] would be ALL)
            events = events[-n:] if n > 0 else []
        retained: Dict[str, int] = {}
        for ev in events:
            retained[ev[2]] = retained.get(ev[2], 0) + 1
        # invariant: sum(dropped_by_type.values()) == dropped — every
        # recorded event has exactly one type, so the per-type ledger
        # always reconciles against the scalar drop count
        dropped_by_type = {
            t: recorded[t] - retained.get(t, 0)
            for t in sorted(recorded)
            if recorded[t] - retained.get(t, 0) > 0
        }
        return {
            "v": SCHEMA_VERSION,
            "me": self.me,
            "t_start_us": self._t_start_us,
            "count": total,
            "dropped": total - len(events),
            "recorded_by_type": {t: recorded[t] for t in sorted(recorded)},
            "dropped_by_type": dropped_by_type,
            "t_dump_us": int(time.monotonic() * 1e6),
            # "n" is the ring's own event counter ("seq" stays free for
            # the frame events' wire sequence field)
            "events": [
                {"n": seq, "t_us": t_us, "type": etype, **fields}
                for seq, t_us, etype, fields in events
            ],
        }

    def publish_drops(self, registry) -> None:
        """Mirror per-type drop counts into the metrics registry as
        ``trace_dropped_total{type=...}`` counters (scrape-time path —
        called from ``metrics_snapshot``, never the record hot path).
        Only NEW drops since the last publish are added, so repeated
        scrapes don't double-count.  Drops here are main-ring evictions
        net of reserve survival — the events a dump can no longer show."""
        with self._lock:
            retained: Dict[str, int] = {}
            for ev in self._buf:
                retained[ev[2]] = retained.get(ev[2], 0) + 1
            # reserve events absent from the main ring still ride
            # dumps, so they count as retained, not dropped
            reserve_extra: Dict[str, int] = {}
            main_seqs = {ev[0] for ev in self._buf}
            for t, ring in self._reserve.items():
                reserve_extra[t] = sum(
                    1 for ev in ring if ev[0] not in main_seqs
                )
            deltas = []
            for t, rec in self._recorded.items():
                dropped = rec - retained.get(t, 0) - reserve_extra.get(t, 0)
                new = dropped - self._published.get(t, 0)
                if new > 0:
                    self._published[t] = dropped
                    deltas.append((t, new))
        for t, new in deltas:
            registry.counter_add("trace_dropped_total", new, type=t)

    def tail(self, n: int = 64) -> List[str]:
        """The last ``n`` events rendered one per line — the
        crash-report attachment format (test_cluster supervisor)."""
        n = int(n)
        if n <= 0:
            return []
        with self._lock:
            events = list(self._buf)[-n:]
        return [
            f"#{seq} t={t_us}us {etype} " + " ".join(
                f"{k}={fields[k]}" for k in sorted(fields)
            )
            for seq, t_us, etype, fields in events
        ]
