"""ServerReplica: a networked replica around the port's device kernel,
counterpart of ``summerset_tpu/host/server.py`` for every protocol of the
package: MultiPaxos (with or without leader leases), Raft, the codeword
family (RSPaxos, CRaft, Crossword), the lease planes (QuorumLeases,
Bodega), leaderless EPaxos and the basic kernels (ChainRep, SimplePush,
RepNothing).

Parity: reference ``GenericReplica`` + ``summerset_server`` — the replica
composes ControlHub -> StateMachine -> StorageHub -> TransportHub ->
ExternalApi, joins via the manager, then ``run()`` drives the tick loop;
returning True means crash-restart.

This process owns replica index ``me`` of every group.  Each tick it
(1) drains the client batch, routing each key to a group by crc32,
(2) exchanges tick frames with its peers (its outbox slice plus the
payload piggyback), (3) steps the kernel on the card with the inbox
assembled from the peers' frames, (4) WAL-logs dirty acceptor rows before
the acks referencing them leave, applies newly committed slots and
replies to the clients it proposed for.  Request payloads ride host
frames keyed by (group, value id); the device log stores int32 references.

The device seam (what ``jax.jit`` and async dispatch were in the JAX
server): the step is ``kernel.step(state, inbox, inputs)`` under
``torch.inference_mode()`` on a CUDA stream owned by the replica (so the
replica threads of an in-process cluster never share one).  The inbox and
the inputs go up as ``non_blocking`` copies from pinned host memory, and
the host views the loop reads next (durable rows, windows, ``leader``,
the telemetry block, every outbox lane, the commit bar and the effects)
come back as ``non_blocking`` copies into pinned buffers allocated once
per leaf, two sets used in turn, with one event recorded behind them.
Waiting on that event is the ``device_wait`` stage.  On the CPU device
there are no streams, no pinned memory and no prefetch: host views are
the tensors' own memory.  Nothing falls back to the CPU: a failed CUDA
call raises out of the tick and crashes the replica.

Durability contract: the kernel's ``DURABLE_SCALARS``/``DURABLE_WINDOWS``
are logged per dirty group before any ack leaves (serial loop: a
group-commit fsync per tick; pipelined loop: a background group commit
behind the durability fence).  A failed fsync crashes the replica before
any gated frame or reply leaves.

The codeword plane (RSPaxos, CRaft, Crossword): the leader RS-encodes each
proposed batch once (``CodewordStore.encode``, the ``bitslice_gf256``
kernel on the card) and ships each peer only its assigned shard rows
(``ps``) instead of the full batch; a replica holding fewer than ``d``
shards of a committed value asks its peers for more (``cw_need``, answered
with ``cw``) and rebuilds the batch once it holds ``d``.  A voter logs its
own shard rows (``cw`` in the vote record), so a recovered quorum rebuilds
every committed value.  CRaft ships full copies while more than
``fault_tolerance`` peers look dead; Crossword's width per value comes
from ``host/adaptive.py`` (``spr_override``).  The codec runs on the
replica's stream at intake and apply, where no step is in flight on it.

The lease and conf planes (QuorumLeases, Bodega; MultiPaxos with
``leader_leases``): a client ``conf`` request (``conf_delta``) is queued,
one in flight, and fed to the kernel's conf inputs each tick
(``conf_target`` on QuorumLeases, ``conf_init``/``conf_leader_target``/
``conf_resp_target``/``conf_bucket`` on Bodega) until every group's
installed conf equals the target; then the client gets a ``conf`` reply
and the manager a ``responders_conf`` notice.  A QuorumLeases server
that does not lead every group relays the change through the manager
(``conf_forward``), which re-announces it to every server
(``install_conf``, newest sequence number wins).  A get at a replica whose
lease holds and whose key buckets are all quiescent (``_can_local_read``)
is answered from applied state with ``local=True``; a leader holding a
leader lease (``leader_read_ok``) does the same for a key with no write in
its voted tail (``_tail_writes_key``).  Everything else redirects or goes
through the log.  The conf state rides the vote records the kernel
declares durable (QuorumLeases' ``conf_cur``/``conf_slot``); Bodega's
conf is lease-installed and re-learned after a restart, as in the JAX
package.  A replica the health plane indicts serves no local read
(``_can_local_read``), and, unlike the JAX server, a resumed replica
serves no local read until every lease from before its pause has run out
in its own tick count (``_resume``).

EPaxos is leaderless: every replica proposes into its own row of the
2-D instance space, one batch per key bucket with pending requests in the
same tick (vids minted in the residue class ``bucket + K * me`` modulo
``K * R``, so the kernel's ``vid % K`` conflict test sees real key
interference), and a host Tarjan executor per group (``host/
epaxos_exec.py``) applies committed instances in dependency order,
WAL-logging each as an ``eapply`` record; its per-row floors feed the
kernel's ``exec_floor_rows``.  The basic kernels (ChainRep, SimplePush,
RepNothing) serve at their head or serving replica and mark votes in no
ballot or term window: ``_tail_writes_key`` counts their voted tail as a
hit.

Snapshots: ``take_snapshot`` (a manager ctrl, or every
``snapshot_interval`` ticks once something applied) writes the full KV,
``applied``, the write slots and, for EPaxos, the executors' row floors
to ``r<me>.snap`` (atomically, fsynced), then compacts the WAL to a
``snap_floor`` marker and one ``vote`` record per group carrying its
window payloads or shard rows.  Recovery loads the snapshot before the
WAL; a compacted WAL whose snapshot is unreadable, missing or stale is
fatal.

The read tier.  Near-quorum reads (``near_quorum_reads``, the MultiPaxos
family; quorumread.rs): a follower answers a get by sampling a majority's
(value, write slot, tail hit) through the tick frames (``rq``/``rqr``
parts) instead of redirecting; a tail hit anywhere falls back to the
leader with an ``rq_retry`` redirect.  Scans (``Command("scan")``, or the
``scan`` request kind) are served from applied state when every group is
read-ready for the span (leader leases where this replica leads, lease
rights elsewhere, no voted-unexecuted write in the span); a replica that
leads every group otherwise proposes a no-effect barrier marker into
every group's log and reads the cut when the last one applies (on the
codeword family the marker is encoded and rebuilt like any batch);
EPaxos answers a scan with ``error``.  Probes and subscriptions: a
``sub`` request gets a KV snapshot and the commit-feed sequence number it
covers, then every applied put streams as ordered ``note`` replies,
released behind the same durability point as client replies; a ``probe``
answers the local-read verdict for a key or span and the feed seq.

The wire: tick frames and hot replies leave through the wire codec
(``wire_codec``, default the process default ``SMR_WIRE_CODEC``, on unless
disabled), and the WAL is the native C++ backend (``csrc/wal.cpp``; the
Python mirror when its build fails, logged).

The observability planes, on by default as in the JAX server: the flight
recorder (``flight_capacity``, ``flight_record``; every hub seam records
typed events), slot traces (``trace_sample``: every n-th proposed batch
is traced from arrival to reply), graftwatch (``graftwatch``,
``watch_ticks``: a delta frame of the registry to the manager every
``watch_ticks`` ticks) and the ``metrics_dump``/``flight_dump`` scrapes
(``metrics_snapshot``, ``flight_snapshot``; the device lanes come from the
host view of the last retired step, so a scrape never waits on the card).

The control planes.  Health (``health_enabled``, ``health_mitigation``
and the ``health_*`` pacing knobs): a beacon of this replica's fsync and
frame-delay EWMAs rides every tick frame (``hb``), and every
``health_eval_ticks`` ticks the quorum-median outlier rule scores every
replica; an indicted leader arms the kernel's ``demote`` input (a
QuorumLeases or Bodega leader revokes its lease responders first).  The
``fault_ctl`` ctrl swaps the transport's and the WAL's fault specs (the
``net`` and ``wal`` planes).  Live resharding: a ``range_change`` seals a
key range at every replica (``rseal`` WAL record; ops on it are shed),
the destination group's leader proposes one ``adopt`` command through
that group's log once the seal is confirmed cluster-wide and no voted
write to the range is pending, and its apply installs the range override
(``route_group``) at every replica; the snapshot carries ``ranges``,
``radopted`` and ``rseals``.  The autopilot's actuations arrive as
``autopilot_ctl`` (demote, retune, announce).

The nemesis planes of ``fault_ctl`` (``host/nemesis.py``): ``skew``
stretches this replica's tick period by a factor (clock skew), and
``snap_crash`` arms a crash point in the next snapshots, after the
snapshot is durably written and before the WAL is compacted.

Not in this slice (ROADMAP.md, Queue 1): the ingress proxy's ``batch``
forwards (answered ``error``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import queue
import tempfile
import time
import zlib
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..core import telemetry as dev_telemetry
from ..device import resolve_device
from ..ops.rscoding import RSCode
from ..protocols import make_protocol
from ..utils import wirecodec
from ..utils.errors import SummersetError
from ..utils.logging import pf_info, pf_logger, pf_warn
from .adaptive import CrosswordAdaptive
from .codeword import CodewordStore, assigned_sids
from .control import ControlHub
from .epaxos_exec import EPaxosExecutor
from .external import ExternalApi
from .graftwatch import WatchEmitter
from .health import HealthScorer
from .messages import ApiReply, ApiRequest, CtrlMsg, ShardPayload
from .payload import PayloadStore
from .resharding import RangeHeat, RangeTable
from .statemach import Command, CommandResult, StateMachine, apply_command
from .storage import LogAction, StorageHub
from .telemetry import MetricsRegistry, SlotTraces
from .tracing import FlightRecorder
from .transport import TransportHub

logger = pf_logger("server")

#: the protocols the port's ServerReplica serves (every kernel it has)
SERVED = ("multipaxos", "raft", "rspaxos", "craft", "crossword",
          "quorumleases", "bodega", "epaxos", "chainrep", "simplepush",
          "repnothing")

# loop_stage_us stage names: the serial loop emits intake / exchange /
# step / log / apply; the pipelined loop replaces "step" with "inbox"
# (inbox lane assembly) + "dispatch" (inputs, the step launch and the
# prefetch) + "device_wait" (host blocked on the step's event) and adds
# "overlap" (host work coincident with the device step).  EPaxos also
# emits "ep_exec", the executors' Tarjan pass, a part of "apply"
STAGES = ("intake", "exchange", "step", "log", "apply",
          "inbox", "dispatch", "device_wait", "overlap", "ep_exec")

#: EPaxos state leaves the host reads only at its own row ``[:, me]``:
#: the card's prefetch copies that row alone (``deps2`` is
#: [G, R, R, W, R]), the rest of its pinned view is never read
_EP_ROW_KEYS = frozenset({
    "abs2", "st2", "bal2", "seq2", "val2", "noop2", "deps2", "pbump2",
    "it_col", "it_seq", "cmt_row",
})

#: the WAL directory when none is given: the port's own, never the JAX
#: package's (a port replica must not replay a JAX replica's records)
DEFAULT_BACKER_DIR = os.path.join(tempfile.gettempdir(), "summerset_tpu_torch")

_VID_BITS = 40  # vids fit far below 2**40; keys combine (g << 40) | vid


def _unique_window_keys(val_win: np.ndarray, groups: np.ndarray) -> np.ndarray:
    """Sorted unique combined (group << 40) | vid keys over the selected
    group rows of a (G, ...) value window, in one vectorized pass."""
    if len(groups) == 0:
        return np.empty(0, np.int64)
    rows = np.asarray(val_win)[groups].reshape(len(groups), -1)
    flat = rows.ravel().astype(np.int64)
    gcol = np.repeat(np.asarray(groups, dtype=np.int64), rows.shape[1])
    m = flat > 0
    if not m.any():
        return np.empty(0, np.int64)
    return np.unique((gcol[m] << _VID_BITS) | flat[m])


def _unique_window_vids(val_win: np.ndarray, groups: np.ndarray) -> dict:
    """{g: [vid, ...]} decode of :func:`_unique_window_keys`."""
    key = _unique_window_keys(val_win, groups)
    if len(key) == 0:
        return {}
    gs = key >> _VID_BITS
    vs = key & ((1 << _VID_BITS) - 1)
    out: dict = {}
    # gs is sorted, so slices per group come from one boundary scan
    bounds = np.nonzero(np.diff(gs))[0] + 1
    for lo, hi in zip(np.concatenate([[0], bounds]),
                      np.concatenate([bounds, [len(gs)]])):
        out[int(gs[lo])] = vs[lo:hi].tolist()
    return out


def _sp_size(sp: ShardPayload) -> int:
    """Approximate pickled wire size of a ShardPayload, without pickling
    it a second time just for the egress meter."""
    return 64 + sum(
        np.asarray(a).nbytes + 144 for a in sp.shards.values()
    )


@dataclasses.dataclass
class HostEffects:
    """Host views of a step's ``StepEffects``: ``commit_bar`` [G, R] and
    the protocol extras, as numpy arrays."""

    commit_bar: np.ndarray
    extra: Dict[str, np.ndarray]


class ServerReplica:
    def __init__(
        self,
        protocol: str,
        api_addr: Tuple[str, int],
        p2p_addr: Tuple[str, int],
        manager_addr: Tuple[str, int],
        config: Optional[dict] = None,
        num_groups: int = 1,
        window: int = 64,
        tick_interval: float = 0.002,
        backer_dir: str = DEFAULT_BACKER_DIR,
        device=None,
    ):
        self._configure(protocol, config, num_groups, window, tick_interval,
                        device)
        self.api_addr = api_addr
        self.p2p_addr = p2p_addr
        # control plane first: the manager assigns our id (control.rs:43)
        self.ctrl = ControlHub(manager_addr)
        self.me = self.ctrl.me
        self.population = self.ctrl.population
        self.transport = None
        self.external = None
        self.wal = None
        try:
            self._setup_core(backer_dir)
            self._join_mesh(protocol)
            self.external = ExternalApi(
                api_addr, max_batch_size=self.api_max_batch,
                max_pending=self.api_max_pending, registry=self.metrics,
                codec=self.wire_codec, flight=self.flight,
            )
        except BaseException:
            # a failed bring-up releases every port and handle it took:
            # the supervisor retries the constructor
            self.shutdown()
            raise
        pf_info(logger, f"replica {self.me} ready on {self.device}")

    # ------------------------------------------------------------ bring-up
    def _configure(self, protocol, config, num_groups, window,
                   tick_interval, device) -> None:
        """Validate the protocol and knobs before any resource is taken."""
        if protocol.lower() not in SERVED:
            raise SummersetError(
                f"protocol {protocol} is not served by the port's "
                f"ServerReplica; served: {', '.join(SERVED)}"
            )
        cfg = dict(config or {})
        self.protocol = protocol
        self.device = resolve_device(device)
        self.tick_interval = tick_interval
        self.G = num_groups
        self.window = window
        # ingress backpressure knobs (host/external.py)
        self.api_max_batch = int(cfg.pop("api_max_batch", 5000))
        self.api_max_pending = int(cfg.pop("api_max_pending", 16384))
        # ticks between automatic snapshots (taken only once something
        # applied since the last one); 0 = only on a take_snapshot ctrl
        self.snapshot_interval = int(cfg.pop("snapshot_interval", 0))
        if str(cfg.pop("device_mesh", "") or ""):
            raise NotImplementedError(
                "device_mesh: the sharded mesh is not ported to "
                "summerset_tpu_torch yet (ROADMAP.md, Queue 1: the "
                "multi-GPU mesh)"
            )
        # pipelined tick loop: the device step is dispatched and drained
        # at its first consumer, and the WAL group-commit fsync runs on
        # the logger thread behind the durability fence; False is the
        # strictly ordered serial loop
        self.pipeline = bool(cfg.pop("pipeline", True))
        # wire codec on the p2p tick frames and the api replies; None
        # follows the process default (SMR_WIRE_CODEC)
        _wc = cfg.pop("wire_codec", None)
        self.wire_codec = (
            wirecodec.default_on() if _wc is None else bool(_wc)
        )
        self.near_quorum_reads = bool(cfg.pop("near_quorum_reads", False))
        # one registry threaded through every hub seam
        self.metrics = MetricsRegistry()
        # the flight recorder (host/tracing.py): a ring of typed events
        # threaded through every hub seam; flight_record=0 records
        # nothing.  trace_sample: every n-th proposed batch gets a slot
        # trace (0 = off)
        self.flight = FlightRecorder(
            capacity=int(cfg.pop("flight_capacity", 8192)),
            enabled=bool(cfg.pop("flight_record", True)),
        )
        self.traces = SlotTraces(
            self.metrics, sample_every=int(cfg.pop("trace_sample", 8)),
            flight=self.flight,
        )
        # graftwatch (host/graftwatch.py): every watch_ticks ticks one
        # delta frame goes to the manager as a one-way watch_frame;
        # graftwatch=0 builds no emitter
        self.graftwatch = bool(cfg.pop("graftwatch", True))
        self.watch_ticks = max(1, int(cfg.pop("watch_ticks", 50)))
        self.watch: Optional[WatchEmitter] = None
        self._trace_replied: List[Tuple[int, int]] = []
        # the health plane (host/health.py): health_enabled=0 builds no
        # scorer; health_mitigation gates only its actions (demotion,
        # lease-read steering).  A demotion keeps the kernel's demote
        # input armed health_demote_ticks ticks, and no new one fires
        # for health_cooldown_ticks after it
        self.health_enabled = bool(cfg.pop("health_enabled", True))
        self.health_mitigation = bool(cfg.pop("health_mitigation", True))
        self.health_eval_ticks = max(1, int(cfg.pop("health_eval_ticks", 10)))
        self.health_demote_ticks = int(cfg.pop("health_demote_ticks", 40))
        self.health_cooldown_ticks = int(
            cfg.pop("health_cooldown_ticks", 800)
        )
        # nemesis clock skew: the tick period's stretch factor
        # (fault_ctl {"skew": f}); 1.0 = healthy
        self._tick_scale = 1.0
        # nemesis snapshot crash point (fault_ctl {"snap_crash": n}): the
        # next n snapshots crash between the snapshot write and the WAL
        # compaction
        self._snap_crash = 0
        self._health_kw = {
            k: cfg.pop(f"health_{k}")
            for k in ("ratio", "hysteresis", "clear_after", "stale_s")
            if f"health_{k}" in cfg
        }
        # live resharding: a sealed range whose destination never adopts
        # is un-sealed after seal_ttl_ticks (0 = never)
        self.seal_ttl_ticks = int(cfg.pop("seal_ttl_ticks", 2400))
        self._kcfg = cfg
        # series pre-registered, so "nothing happened yet" reads as 0
        self.metrics.counter_add("leader_demotions", 0)
        self.metrics.gauge_set("health_score", 1.0)
        self.metrics.counter_add("reshard_splits", 0)
        self.metrics.counter_add("reshard_merges", 0)
        self.metrics.gauge_set("range_heat", 0.0)
        self.metrics.observe("reshard_cutover_us", 0)
        self.metrics.counter_add("reshard_seal_expired", 0)
        for name in ("scan_served", "scan_shed", "scan_keys"):
            self.metrics.counter_add(name, 0)
        self.metrics.counter_add("autopilot_actions", 0)
        self.metrics.gauge_set("autopilot_mode", 0.0)
        self.metrics.gauge_set("autopilot_cooldown", 0.0)
        self.metrics.counter_add("trace_dropped_total", 0)
        self.metrics.counter_add("watch_frames_total", 0)
        self.metrics.observe("watch_emit_us", 0)

    def _setup_core(self, backer_dir: str) -> None:
        """Kernel, state on the device, WAL (recovered) and bookkeeping."""
        dev = self.device
        proto = self.protocol
        self.flight.me = self.me
        if self.graftwatch:
            self.watch = WatchEmitter(
                self.metrics, self.me, span_ticks=self.watch_ticks,
                tier="shard", group=0,
            )
        # the gray-failure scorer: beacons ride the tick frames, every
        # replica assembles the same signal table, and an indicted leader
        # sees its own indictment
        self.health = (
            HealthScorer(self.me, self.population, **self._health_kw)
            if self.health_enabled else None
        )
        self._health_self_bad = False
        # demotion state: _demote_until arms the kernel's demote input; a
        # QuorumLeases/Bodega leader first revokes its lease responders
        # (an empty-responders conf change) until _demote_revoke_deadline,
        # and restores _demote_restore_resp if the indictment clears
        # meanwhile.  _ap_demote_pending: the autopilot started the revoke
        # and _autopilot_tick resolves it
        self._demote_until = 0
        self._demote_cooldown_until = 0
        self._demote_revoke_deadline: Optional[int] = None
        self._demote_restore_resp: Optional[List[int]] = None
        self._ap_demote_pending = False
        # live resharding (host/resharding.py): installed range overrides,
        # ranges sealed awaiting adoption (rc_id -> change + sealed_at),
        # rc_ids whose adopt executed here (its merge happened) apart from
        # those whose routing override alone came from a manager
        # re-announce (the replicated adopt must still merge), the newest
        # install_ranges seq, adopt re-propose marks, adopts awaiting
        # intake, per-key heat at the api seam, and the seal-TTL state
        self.rangetab = RangeTable()
        self._range_sealed: Dict[int, dict] = {}
        self._range_adopted: Set[int] = set()
        self._range_override: Set[int] = set()
        self._range_seq_seen = 0
        self._range_adopt_mark: Dict[int, int] = {}
        self._range_adopt_ready: List[Tuple[int, ApiRequest]] = []
        self._range_heat = RangeHeat()
        self._range_adopt_granted: Set[int] = set()
        self._range_expired: Set[int] = set()
        self._range_intent_sent: Dict[int, int] = {}
        self._range_expire_sent: Dict[int, int] = {}
        kercfg_cls = type(
            make_protocol(proto, 1, self.population, 32, device="cpu").config
        )
        known = {f.name for f in dataclasses.fields(kercfg_cls)}
        kcfg = kercfg_cls(
            **{k: v for k, v in self._kcfg.items() if k in known}
        )
        if hasattr(kcfg, "exec_follows_commit"):
            kcfg.exec_follows_commit = False
        kcfg.max_proposals_per_tick = 1  # one ReqBatch per group/tick
        if proto.lower() == "epaxos":
            # leaderless multi-bucket intake: one ReqBatch per key bucket
            # per group per tick, the vids passed as an explicit list
            kcfg.max_proposals_per_tick = max(
                1, min(kcfg.num_key_buckets, self.window // 2)
            )
        self.kernel = make_protocol(
            proto, self.G, self.population, self.window, kcfg, device=dev
        )
        if self.kernel.DURABLE_SCALARS is None:
            raise SummersetError(
                f"protocol {proto} declares no durable acceptor contract; "
                "refusing to serve it without durability"
            )
        self._demote_supported = (
            "demote" in {n for n, _ in self.kernel.EXTRA_INPUTS}
        )
        self.state = self.kernel.init_state(seed=0)
        # device metric lanes ride the state, on its device
        dev_telemetry.attach(self.state, self.G, self.population)

        os.makedirs(backer_dir, exist_ok=True)
        self.wal_path = os.path.join(backer_dir, f"r{self.me}.wal")
        self.snap_path = os.path.join(backer_dir, f"r{self.me}.snap")
        # checked before the hub creates the file: the restart event's
        # cold flag (first boot on an empty backer)
        self._cold_boot = not (os.path.exists(self.wal_path)
                               or os.path.exists(self.snap_path))
        self.wal = StorageHub(self.wal_path, registry=self.metrics,
                              flight=self.flight)
        self.wal.health = self.health
        # set by _recover_from_snapshot: the error of a present snapshot
        # that failed to load, and the floors a loaded one restored; a
        # compacted WAL demands a snapshot covering its marker's floors
        self._snap_unreadable: Optional[str] = None
        self._snap_floors: Optional[List[int]] = None
        self._snap_last = 0   # sum(applied) at the last auto-snapshot
        self.statemach = StateMachine()
        self.payloads = PayloadStore(self.G)
        self.applied = [0] * self.G        # exec floor per group (own row)
        self._sig: Optional[np.ndarray] = None  # durable-row dirty cache
        self._logged_vids: Dict[int, set] = {
            g: set() for g in range(self.G)
        }
        self._logged_keys = np.empty(0, np.int64)
        self.origin: Set[Tuple[int, int]] = set()   # (g, vid) we proposed
        self.missing: Set[Tuple[int, int]] = set()  # committed, no payload
        # per key: the slot of its last applied put (snapshot state, as
        # in the JAX server, whose near-quorum reads compare them)
        self._wslot: Dict[str, int] = {}
        # near-quorum reads (quorumread.rs): in-flight read queries and the
        # rq/rqr frame parts queued per peer
        self._qreads: Dict[int, dict] = {}
        self._qread_next = 0
        self._pending_rq: Dict[int, list] = {}   # dst -> [(rid, key, g)]
        self._pending_rqr: Dict[int, list] = {}  # dst -> [(rid, v, s, hit)]
        # the commit feed: subscribers, its sequence number and the notes
        # of this tick's applied puts (the seq advances only while some
        # learner subscribes)
        self._subs: Dict[int, bool] = {}
        self._sub_seq = 0
        self._sub_notes: List[Tuple[int, str, Any]] = []
        # barrier scans in flight: sbid -> {client, req_id, cmd, need
        # (groups whose marker has not applied), tick (for the GC)}
        self._scan_pend: Dict[int, dict] = {}
        self._scan_next = 1
        self._wal_dirty = False
        self._reply_queue: List[Tuple[int, ApiReply]] = []
        self.kv_need: Set[int] = set()     # groups that jumped past window
        self._pending_serve: Dict[Tuple[int, int], Any] = {}
        self._pending_kv_serve = False
        # per peer: frames whose lanes are still owed to some groups
        # (see _peer_lanes)
        self._owed: Dict[int, list] = {}
        self._setup_epaxos()
        self._setup_codewords()
        # near-quorum reads need the MultiPaxos family's vote runs and a
        # single-writer-per-slot log (not the EPaxos 2-D space)
        self._nqr_ok = (self.near_quorum_reads and "vote_bar" in self.state
                        and not self._epaxos)
        # client ConfChange plane (QuorumLeases, Bodega): one in flight;
        # queue entries are (client id, request) from the data plane or
        # (None, request) for manager-relayed installs
        self._conf_kind = (
            "ql" if "ql_out" in self.state
            else "bodega" if "conf_resp" in self.state
            else None
        )
        self._conf_active: Optional[dict] = None
        self._conf_queue: List[Tuple[Optional[int], ApiRequest]] = []
        self._conf_seq_seen = 0
        # leases count ticks, and a paused replica's ticks stop: after a
        # resume no local read is served until any lease held before the
        # pause has run out in this replica's own count (see _resume)
        kc = self.kernel.config
        self._lease_ticks = max(getattr(kc, "lease_len", 0),
                                getattr(kc, "leader_lease_len", 0)) \
            + getattr(kc, "lease_margin", 0)
        self._lease_hold_off = 0
        self.paused = False
        self.stopping = False  # cooperative stop for embedded harnesses
        self.was_leader = False
        self._lead_announced = 0
        self._is_leader = np.zeros(self.G, bool)
        self._leader_hint = np.full(self.G, -1, np.int64)
        self._last_extra: Dict[str, np.ndarray] = {}
        self.tick = 0
        # pipeline registers: the in-flight dispatched step and the
        # durability fence token gating frames/replies on the fsync
        self._pl: Optional[Dict[str, Any]] = None
        self._fence_token: Optional[int] = None
        self._np_cache: Dict[str, np.ndarray] = {}

        self._recover_from_snapshot()
        self._recover_from_wal()
        self.flight.record(
            "restart", cold=self._cold_boot, wal_size=self.wal.size,
            applied=int(sum(self.applied)),
        )

        # the device seam: the replica's own stream, which waits once on
        # the default stream init_state and recovery ran on; two sets of
        # pinned host buffers used in turn by the prefetch
        self._stream = None
        if dev.type == "cuda":
            self._stream = torch.cuda.Stream(device=dev)
            self._stream.wait_stream(torch.cuda.current_stream(dev))
        self._pinned: Tuple[dict, dict] = ({}, {})
        self._pf_slot = 0
        ker = self.kernel
        cand = set(ker.DURABLE_SCALARS) | set(ker.DURABLE_WINDOWS)
        cand.update((ker.VALUE_WINDOW, "win_abs", "win_bal", "win_cfg",
                     "win_noop", "leader", "alive_cnt", "conf_cur",
                     "conf_resp", "conf_leader", "own_next", "exec_row",
                     "cmt_row", "abs2", "st2", "seq2", "val2", "noop2",
                     "deps2", dev_telemetry.TELEM_KEY))
        self._prefetch_keys = sorted(k for k in cand if k in self.state)
        # the kernel's ``renack`` hook's per-group tick counter
        self._stall = np.zeros(self.G, np.int64)
        self._last_cbar = np.full(self.G, np.iinfo(np.int64).max)
        self._np_cache = {}
        # outbox register the first tick's frames slice from (host views)
        self._last_out = {
            k: self._host(v) for k, v in self.kernel.zero_outbox().items()
        }

    def _setup_epaxos(self) -> None:
        """EPaxos: leaderless, every replica proposes into its own row,
        execution through one host Tarjan executor per group.  Every key
        bucket with pending requests proposes in the same tick (the vids
        ride ``prop_vids``); ``_ep_defer`` holds only the overflow beyond
        ``max_proposals_per_tick`` buckets."""
        self._epaxos = "st2" in self.state
        self._ep_exec: Dict[int, EPaxosExecutor] = {}
        self._ep_defer: Dict[int, list] = {}
        self._ep_prop_vids = None
        if not self._epaxos:
            return
        self._ep_prop_vids = np.zeros(
            (self.G, self.kernel.config.max_proposals_per_tick), np.int32
        )
        for g in range(self.G):
            self._ep_exec[g] = EPaxosExecutor(
                self.population, self.window, self._make_ep_apply(g)
            )
            self._ep_defer[g] = []

    def _setup_codewords(self) -> None:
        """The codeword payload plane of the RS-coded family: the kernel
        runs the coded control plane over value ids, the store holds the
        shard bytes (none for MultiPaxos and Raft)."""
        ker = self.kernel
        # Crossword: the host's predictive width; assignment_adaptive
        # False pins both it and the kernel's reactive policy to init_spr
        self._adaptive = None
        if "cur_spr" in self.state and ker.config.assignment_adaptive:
            self._adaptive = CrosswordAdaptive(
                self.population, ker.data_shards, self.me,
            )
            self._batch_bytes = 0.0  # EWMA of proposed batch sizes
            self._spr_tick = [ker.data_shards] * self.G
        self.codewords = None
        self._cw_dj = 1
        self._cw_spr0 = 1
        if hasattr(ker, "num_data") and "full_bar" in self.state:
            if "cur_spr" in self.state:  # Crossword: T shards, dj-wide base
                cw_T, cw_d = ker.total_shards, ker.data_shards
                self._cw_dj = ker.dj
                self._cw_spr0 = ker.init_spr
            else:  # RSPaxos / CRaft: shard r -> replica r
                cw_T, cw_d = self.population, ker.num_data
            self.codewords = CodewordStore(
                self.G, RSCode(cw_d, cw_T - cw_d, device=self.device),
                cw_T, self._cw_dj, device=self.device,
            )
        self._cw_first_missing: Dict[Tuple[int, int], int] = {}
        self._pending_shards: Dict[int, dict] = {}  # dst -> {(g,vid): sp}
        self._pending_cw: Dict[int, dict] = {}      # dst -> {(g,vid): sp}
        # per-peer payload-plane egress, bytes and payload count: pp_*
        # meter the protocol's own payload sends (full copies of the
        # pp part without a codeword plane; ps shard sends with one, at
        # ~batch/d per item); full_* the full copies a codeword replica
        # also sends (CRaft's fallback proposals and need-serves), so
        # the two never mix in one per-item mean; cw_bytes the gossip
        # replies
        self.pp_bytes = [0] * self.population
        self.pp_items = [0] * self.population
        self.full_bytes = [0] * self.population
        self.full_items = [0] * self.population
        self.cw_bytes = [0] * self.population
        # CRaft's full-copy fallback reads the last drained step's
        # liveness countdowns, so it may trail the kernel by one tick
        # exactly as the JAX server's does (craft/mod.rs:280-283)
        self._craft_mode = "win_full" in self.state

    def _join_mesh(self, protocol: str) -> None:
        """p2p mesh join (multipaxos/mod.rs:717-737): the join is re-sent
        until the mesh completes — a lower-id peer may join after us."""
        self.transport = TransportHub(
            self.me, self.population, self.p2p_addr, registry=self.metrics,
            flight=self.flight, codec=self.wire_codec,
        )
        self.transport.health = self.health
        join = CtrlMsg("new_server_join", {
            "protocol": protocol,
            "api_addr": self.api_addr,
            "p2p_addr": self.p2p_addr,
        })
        connected: set = set()
        deadline = time.monotonic() + 60
        while True:
            self.ctrl.send_ctrl(join)
            try:
                msg = self.ctrl.recv_ctrl(timeout=3)
            except (queue.Empty, SummersetError):
                msg = None  # poll timeout or manager gone: re-send
            if msg is not None and msg.kind == "connect_to_peers":
                for peer, addr in msg.payload["to_peers"].items():
                    p = int(peer)
                    if p in connected or self.transport.connected(p):
                        continue
                    try:
                        self.transport.connect_to_peer(p, addr)
                    except (SummersetError, OSError):
                        continue  # the peer may be mid-restart: retry
                    connected.add(p)
            try:
                self.transport.wait_for_group(timeout=2)
                break
            except SummersetError:
                if time.monotonic() > deadline:
                    raise

    # ------------------------------------------------------------- routing
    def group_of(self, key: str) -> int:
        """Key -> consensus group (crc32, as the JAX server routes)."""
        if self.G == 1:
            return 0
        return zlib.crc32(key.encode()) % self.G

    def route_group(self, key: str) -> int:
        """Live placement: an installed range override (an adopted split
        or merge) first, the hash placement otherwise."""
        if len(self.rangetab):
            e = self.rangetab.lookup(key)
            if e is not None:
                return int(e["group"]) % self.G
        return self.group_of(key)

    def _range_sealed_for(self, key: str) -> Optional[dict]:
        """The sealed (mid-cutover) range change covering ``key``."""
        for ch in self._range_sealed.values():
            end = ch.get("end")
            if key >= ch["start"] and (end is None or key < end):
                return ch
        return None

    def _range_seal_overlaps(self, start: str, end: Optional[str]) -> bool:
        """Does a sealed range intersect ``[start, end)``?  A scan across
        one is shed before any proposal."""
        for ch in self._range_sealed.values():
            ce = ch.get("end")
            if (end is None or ch["start"] < end) and (
                    ce is None or start < ce):
                return True
        return False

    # ----------------------------------------------------- host state views
    def _on_stream(self):
        """Context that issues device work on the replica's stream."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _host(self, t: torch.Tensor) -> np.ndarray:
        """Host view of a tensor whose producing work has completed: the
        tensor's own memory on the CPU, a synchronous copy on the card."""
        if t.device.type == "cpu":
            return t.numpy()
        return t.cpu().numpy()

    def _np_state(self, k: str) -> np.ndarray:
        """Host view of one state leaf, pinned to the last DRAINED step;
        cached until the next drain (the prefetched leaves arrive with
        the drain itself)."""
        cache = self.__dict__.setdefault("_np_cache", {})
        v = cache.get(k)
        if v is None:
            v = self._host(self.state[k])
            cache[k] = v
        return v

    def _set_state(self, new_state, views=None) -> None:
        """Swap in a new device state and its host views."""
        self.state = new_state
        self._np_cache = dict(views or {})

    def _upload(self, arrays: Dict[str, np.ndarray]
                ) -> Dict[str, torch.Tensor]:
        """Host lanes to the device.  On the CPU each tensor shares its
        array's memory.  On the card each lane goes up as one pinned
        ``non_blocking`` copy on the replica's stream (the caching host
        allocator keeps each pinned block until its copy has run).  One
        packed staging copy of all lanes made the ``inbox`` stage 0.2 ms
        shorter but the tick no faster (``serve_upload_ab.py``)."""
        if self._stream is None:
            return {k: torch.from_numpy(np.ascontiguousarray(a))
                    for k, a in arrays.items()}
        with self._on_stream():
            return {k: torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                    .to(self.device, non_blocking=True)
                    for k, a in arrays.items()}

    # ------------------------------------------------------------ recovery
    def _recover_from_snapshot(self) -> None:
        """Load the snapshot (full KV, applied floors, write slots and
        EPaxos row floors) before the WAL replay (parity: snapshot.rs:189
        recover_from_snapshot).  A present snapshot that fails to load is
        only noted here: ``_recover_from_wal`` decides, since a full WAL
        rebuilds everything without it and a compacted one cannot."""
        if not os.path.exists(self.snap_path):
            return
        try:
            with open(self.snap_path, "rb") as f:
                kind, kv, meta = pickle.load(f)
            if not isinstance(meta, dict):  # a bare floors list
                meta = {"applied": list(meta)}
            if kind != "kv":
                raise ValueError(f"snapshot kind {kind!r}")
        except Exception as e:
            self._snap_unreadable = repr(e)
            pf_warn(logger, f"snapshot unreadable: {e}; fatal unless the "
                            "WAL still holds the full history")
            return
        self.statemach._kv.update(kv)
        floors = meta["applied"]
        self._snap_floors = [int(fl) for fl in floors[: self.G]]
        for g, fl in enumerate(self._snap_floors):
            self.applied[g] = max(self.applied[g], fl)
        for k, slot in meta.get("wslots", {}).items():
            self._wslot[k] = max(self._wslot.get(k, -1), int(slot))
        # range installs travel with the KV they moved, each rc_id back in
        # the set it lived in: an override-only install leaves the adopt
        # replay free to merge (a snapshot without ``radopted`` counts
        # every install as adopted)
        radopted = meta.get("radopted")
        radopted = None if radopted is None else {int(r) for r in radopted}
        for entry in meta.get("ranges", []):
            rc_id = int(entry["rc_id"])
            if radopted is None or rc_id in radopted:
                self._range_adopted.add(rc_id)
            else:
                self._range_override.add(rc_id)
            self.rangetab.install(entry)
        for ch in meta.get("rseals", []):
            # sealed but unadopted at snapshot time: re-seal
            self._reseal(ch)
        for g, rows in enumerate(meta.get("ep_rows", [])[: self.G]):
            ex = self._ep_exec.get(g)
            if ex is not None:
                ex.floor = [max(a, int(b)) for a, b in zip(ex.floor, rows)]
        pf_info(logger, f"recovered snapshot: {len(kv)} keys, "
                        f"floors {floors[:4]}...")

    def _recover_from_wal(self) -> None:
        """Replay the WAL: apply records (``eapply`` for EPaxos) rebuild
        payloads + KV + exec floors; the last durable record per group
        rebuilds the kernel row's acceptor state (parity: recovery.rs
        replay loop + raft durable curr_term/voted_for,
        raft/mod.rs:144-176).  A compacted WAL starts with a
        ``snap_floor`` marker: the apply history below its floors lives
        only in the snapshot, so a snapshot that is unreadable, missing
        or stale (floors below the marker's) is fatal."""
        off = 0
        n = 0
        votes: Dict[int, dict] = {}
        while True:
            res = self.wal.do_sync_action(LogAction("read", offset=off))
            if not res.offset_ok or res.entry is None:
                break
            rec = res.entry
            if isinstance(rec, tuple) and rec and rec[0] == "snap_floor":
                marker = [int(fl) for fl in rec[1][: self.G]]
                if self._snap_unreadable is not None:
                    why = f"unreadable ({self._snap_unreadable})"
                elif self._snap_floors is None:
                    why = "missing"
                elif any(sf < mf for sf, mf in
                         zip(self._snap_floors, marker)):
                    why = (f"stale (snapshot floors {self._snap_floors} "
                           "below the marker's)")
                else:
                    why = None
                if why is not None:
                    raise SummersetError(
                        f"snapshot {why} but the WAL was compacted to "
                        f"floors {marker}: committed state below the "
                        "snapshot floor is unrecoverable; refusing to serve"
                    )
                for g, fl in enumerate(marker):
                    self.applied[g] = max(self.applied[g], fl)
            elif isinstance(rec, tuple) and rec and rec[0] == "rseal":
                # a range sealed before the crash and, as far as this WAL
                # knows, never adopted: recovery must not admit ops the
                # replica was refusing
                self._reseal(rec[1])
            elif isinstance(rec, tuple) and rec and rec[0] == "eapply":
                # EPaxos exec record: replayed in logged (= execution)
                # order; the per-row floors advance contiguously
                _, g, row, col, vid, batch = rec
                if batch is not None:
                    self.payloads.install(g, vid, batch)
                    for _client, req in batch:
                        if req.cmd is not None:
                            apply_command(self.statemach._kv, req.cmd)
                ex = self._ep_exec.get(g)
                if ex is not None:
                    if col >= ex.floor[row]:
                        ex.floor[row] = col + 1
                    self.applied[g] = sum(ex.floor)
            elif isinstance(rec, tuple) and rec and rec[0] == "vote":
                g, v = rec[1], rec[2]
                votes[g] = v
                for vid, batch in v.get("pp", {}).items():
                    self.payloads.install(g, vid, batch, overwrite=False)
                    self._logged_vids[g].add(vid)
                for vid, (dlen, sh) in v.get("cw", {}).items():
                    # a voter's own shard rows: a recovered quorum's
                    # shards rebuild committed values through gossip
                    if self.codewords is not None:
                        self.codewords.add_shards(
                            g, vid, dlen, sh, assigned=True
                        )
                    self.payloads.note_seen(g, vid)
                    self._logged_vids[g].add(vid)
            elif isinstance(rec, tuple) and len(rec) == 4 \
                    and isinstance(rec[0], int):
                g, slot, vid, batch = rec
                self.payloads.install(g, vid, batch)
                if batch is not None and slot >= self.applied[g]:
                    for _client, req in batch:
                        if req.cmd is None:
                            continue
                        if req.cmd.kind == "adopt":
                            # the replicated adoption replays as it
                            # applied live (idempotent per rc_id)
                            self._apply_adopt(req.cmd.value, announce=False,
                                              recovery=True)
                            continue
                        if req.cmd.kind == "put":
                            fg = self._handoff_floor(g, req.cmd.key)
                            if fg is not None and slot < fg:
                                # below the handoff floor: the value
                                # already rode the adopt
                                continue
                        apply_command(self.statemach._kv, req.cmd)
                        if req.cmd.kind == "put":
                            k = req.cmd.key
                            self._wslot[k] = max(self._wslot.get(k, -1),
                                                 slot)
                self.applied[g] = max(self.applied[g], slot + 1)
            else:
                kind = rec[0] if isinstance(rec, tuple) and rec else rec
                raise SummersetError(
                    f"WAL record {kind!r} is not served by the port "
                    f"({', '.join(SERVED)}); refusing to serve"
                )
            off = res.end_offset
            n += 1
        if off < self.wal.size:
            # torn tail: a crash mid-group-commit left a partial record
            # (nothing beyond it was ever acked); truncate it away, or
            # later appends would land past garbage
            pf_warn(
                logger,
                f"truncating torn WAL tail at {off} (size {self.wal.size})",
            )
            self.wal.do_sync_action(
                LogAction("truncate", offset=off, sync=True)
            )
        if votes:
            # rebuild the rows on a host copy, each group on its own
            # 1-group slice (a kernel's row write copies the tensor it
            # writes: on the [G, ...] leaves that is a full copy per
            # group), then move the state to its device once
            st = {k: v.detach().cpu().clone() for k, v in self.state.items()}
            for g, v in votes.items():
                row = {k: t[g:g + 1] for k, t in st.items()}
                self.kernel.restore_durable(row, 0, self.me, v,
                                            self.applied[g])
                for k, t in row.items():
                    st[k][g] = t[0]
            self.state = {k: v.to(self.device) for k, v in st.items()}
        self._rebuild_logged_keys()
        if n:
            pf_info(
                logger,
                f"recovered {n} WAL records ({len(votes)} acceptor rows)",
            )

    # ----------------------------------------------------------- durability
    def _wal_append(self, entry: Any) -> None:
        """One unsynced WAL append: the serial loop submits and waits, the
        pipelined loop fires and forgets and settles at the fence."""
        if self.pipeline:
            self.wal.append_nowait(entry)
        else:
            self.wal.do_sync_action(
                LogAction("append", entry=entry, sync=False)
            )
        self._wal_dirty = True

    def _fence_begin(self) -> None:
        """Open the durability fence over every record appended since the
        last one (a background group-commit sync point).  No-op on a
        clean tick."""
        if self._wal_dirty:
            self._fence_token = self.wal.flush_token()
            self._wal_dirty = False

    def _fence_wait(self) -> None:
        """THE durability fence: block until the open token's fsync
        completed.  Nothing a step computed may leave the process before
        this returns; a background append or fsync failure raises here
        and crashes the replica with everything gated still unsent."""
        token = self._fence_token
        if token is None:
            return
        self._fence_token = None
        self.wal.wait_flush(token)

    def _rebuild_logged_keys(self) -> None:
        ks = [
            (g << _VID_BITS) | v
            for g, s in self._logged_vids.items() for v in s
        ]
        self._logged_keys = (
            np.asarray(sorted(ks), np.int64) if ks
            else np.empty(0, np.int64)
        )

    def _log_votes(self) -> None:
        """Durably log dirty acceptor rows BEFORE the outbox carrying the
        corresponding acks is released (next tick's send).  Payload
        batches for newly voted value ids ride the same record.  Dirty
        groups come from one vectorized signature compare."""
        ker = self.kernel
        me = self.me
        scal = {
            k: self._np_state(k)[:, me] for k in ker.DURABLE_SCALARS
        }
        wins = {
            k: self._np_state(k)[:, me] for k in ker.DURABLE_WINDOWS
        }
        parts = [
            a.reshape(self.G, -1).astype(np.int64)
            for a in list(scal.values()) + list(wins.values())
        ]
        sig = np.concatenate(parts, axis=1)
        if self._sig is not None and sig.shape == self._sig.shape:
            dirty = np.nonzero((sig != self._sig).any(axis=1))[0]
        else:
            dirty = np.arange(self.G)
        self._sig = sig
        if len(dirty) == 0:
            return
        keys = _unique_window_keys(wins[ker.VALUE_WINDOW], np.asarray(dirty))
        if len(self._logged_keys):
            pos = np.minimum(
                np.searchsorted(self._logged_keys, keys),
                len(self._logged_keys) - 1,
            )
            cand = keys[self._logged_keys[pos] != keys]
        else:
            cand = keys
        new_pp_by_g: Dict[int, dict] = {}
        new_cw_by_g: Dict[int, dict] = {}
        taken = []
        for k in cand.tolist():
            g, vid = k >> _VID_BITS, k & ((1 << _VID_BITS) - 1)
            # codeword plane: a voter logs the shard rows its vote stands
            # for (its assigned slice), not the full batch
            got = (self.codewords.wal_shards(g, vid, self.me)
                   if self.codewords is not None else None)
            if got is not None:
                new_cw_by_g.setdefault(g, {})[vid] = got
            else:
                got = self.payloads.get(g, vid)
                if got is None:
                    continue
                new_pp_by_g.setdefault(g, {})[vid] = got
            self._logged_vids[g].add(vid)
            taken.append(k)
        if taken:
            # taken is sorted, so a positional insert keeps it sorted
            tk = np.asarray(taken, np.int64)
            self._logged_keys = np.insert(
                self._logged_keys, np.searchsorted(self._logged_keys, tk),
                tk,
            )
        for g in dirty:
            g = int(g)
            rec: Dict[str, Any] = {k: int(v[g]) for k, v in scal.items()}
            rec.update({k: wins[k][g].tolist() for k in wins})
            rec["pp"] = new_pp_by_g.get(g, {})
            if g in new_cw_by_g:
                rec["cw"] = new_cw_by_g[g]
            self._wal_append(("vote", g, rec))

    # ------------------------------------------------------------ snapshots
    def _take_snapshot(self) -> int:
        """Write the full KV + applied floors, then compact the WAL down
        to the current acceptor record per group plus the payloads (or
        shard rows) its window still references; apply records below the
        floors are covered by the snapshot.  Parity: snapshot.rs:121-303
        (take_new_snapshot + snapshot_discard_log), the flat-file
        snapshot replaced atomically as in the JAX server.  Returns the
        compacted WAL's size.

        In the pipelined loop the in-flight step is retired and the
        durability fence waited first: the WAL being replaced must hold
        every record appended so far, and no token may stay open on a
        hub that is about to close."""
        if self.pipeline:
            self._pipeline_flush()
        kv = self.statemach.snapshot_items()
        meta: Dict[str, Any] = {
            "applied": list(self.applied),
            "wslots": dict(self._wslot),
            # adopted range installs travel with the KV they moved;
            # radopted tells true adoptions from override-only installs;
            # still-sealed changes re-seal on recovery
            "ranges": self.rangetab.entries(),
            "radopted": sorted(self._range_adopted),
            "rseals": [
                {k: ch[k] for k in
                 ("rc_id", "op", "start", "end", "dst_group")}
                for ch in self._range_sealed.values()
            ],
        }
        if self._epaxos:
            meta["ep_rows"] = [list(self._ep_exec[g].floor)
                               for g in range(self.G)]
        tmp = self.snap_path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(("kv", kv, meta), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.snap_path)
        if self._snap_crash > 0:
            # the nemesis crash point: the snapshot is durable but the WAL
            # is not compacted yet; recovery must reconcile the new
            # snapshot with the old, longer WAL
            self._snap_crash -= 1
            raise SummersetError(
                "injected snapshot crash point: snapshot written, WAL "
                "not yet compacted"
            )

        # compact: the marker first (recovery's proof that the history
        # below these floors lives only in the snapshot), then the latest
        # durable row per group with the payloads its window references
        ker = self.kernel
        me = self.me
        scal = {k: self._np_state(k)[:, me] for k in ker.DURABLE_SCALARS}
        wins = {k: self._np_state(k)[:, me] for k in ker.DURABLE_WINDOWS}
        wtmp = self.wal_path + ".tmp"
        if os.path.exists(wtmp):
            os.remove(wtmp)
        compact = StorageHub(wtmp)
        compact.do_sync_action(LogAction(
            "append", entry=("snap_floor", list(self.applied)), sync=False
        ))
        new_logged: Dict[int, set] = {}
        vids_by_g = _unique_window_vids(wins[ker.VALUE_WINDOW],
                                        np.arange(self.G))
        for g in range(self.G):
            pp: Dict[int, Any] = {}
            cw: Dict[int, Any] = {}
            for vid in vids_by_g.get(g, ()):
                got = (self.codewords.wal_shards(g, vid, me)
                       if self.codewords is not None else None)
                if got is not None:
                    cw[vid] = got
                    continue
                b = self.payloads.get(g, vid)
                if b is not None:
                    pp[vid] = b
            rec: Dict[str, Any] = {k: int(v[g]) for k, v in scal.items()}
            rec.update({k: wins[k][g].tolist() for k in wins})
            rec["pp"] = pp
            if cw:
                rec["cw"] = cw
            compact.do_sync_action(
                LogAction("append", entry=("vote", g, rec), sync=False)
            )
            new_logged[g] = set(pp) | set(cw)
        if self.codewords is not None:
            # the proposer keeps one full codeword per vid: values below
            # every window reference can never be served again
            for g, vids in vids_by_g.items():
                self.codewords.gc_below(g, min(vids))
        compact.do_sync_action(LogAction("truncate", offset=compact.size,
                                         sync=True))
        compact.stop()
        self.wal.stop()
        os.replace(wtmp, self.wal_path)
        self.wal = StorageHub(self.wal_path, registry=self.metrics,
                              flight=self.flight)
        self.wal.health = self.health
        self._logged_vids = new_logged
        self._rebuild_logged_keys()
        self._sig = None  # the next tick re-logs any drift
        size = self.wal.size
        pf_info(logger, f"snapshot taken ({len(kv)} keys); WAL compacted "
                        f"to {size}B")
        return size

    # ----------------------------------------------------------- tick I/O
    def _slice_outbox(self, out) -> Dict[int, Dict[str, Any]]:
        """Per-peer frame: per-pair fields sliced [G] at (me, dst),
        broadcast lanes sent whole (``out`` holds host views)."""
        lanes = self.kernel.broadcast_lanes
        frames: Dict[int, Dict[str, Any]] = {}
        for dst in range(self.population):
            if dst == self.me:
                continue
            frames[dst] = {
                k: v[:, self.me] if k in lanes else v[:, self.me, dst]
                for k, v in out.items()
            }
        return frames

    def _renack_stalled(self, frames: Dict[int, Dict[str, Any]]) -> None:
        """The kernel's ``renack`` hook on this tick's outgoing frames
        (the MultiPaxos family repeats a lost accept NACK); each rewritten
        group counts on ``stall_renacks``."""
        self._stall, n = self.kernel.renack(
            frames, self._np_state, self.me, self._last_cbar, self._stall)
        if n:
            self.metrics.counter_add("stall_renacks", n)

    def _peer_lanes(self, src: int, msgs: List[dict]) -> Optional[dict]:
        """The kernel lanes of peer ``src`` this tick, from the frames it
        sent since the last tick (oldest first) and the ones still owed.

        The JAX server takes every lane from the newest frame only: the
        lanes carry cumulative state, so the latest supersedes.  The
        ``flags`` lane does not: an ``AR_NACK`` (or any event bit) in an
        older frame is lost when a newer frame arrives before the
        receiver ticks, and a follower whose nack is lost keeps a vote
        run that starts above its commit bar and never commits again in
        that group (found by ``chip_smoke.py`` phase 12; the lockstep
        case ``tests/test_torch_server.py::test_superseded_nack_lockstep``
        shows the JAX server's follower frozen so).  So per group
        the lanes come from the oldest owed frame holding a flag bit the
        newest frame lacks, else from the newest; the frames after it
        stay owed, one delivered per tick, until a newer frame holds
        their bits.  A group that is owed no frame this tick gets zero
        lanes (``flags`` 0), as a JAX replica's inbox holds zeros in the
        slot of a peer that sent nothing.  With one frame per peer per
        tick this is the JAX rule exactly.

        At most ``OWED_FRAMES`` frames stay owed per peer: beyond that
        the oldest are dropped with their bits, and each drop is counted
        on the ``owed_frames_dropped`` counter."""
        owed = self._owed.get(src, [])
        cand = owed + [(m, None) for m in msgs]
        if not cand:
            return None
        if len(cand) == 1 and cand[0][1] is None:
            self._owed[src] = []
            return cand[0][0]
        G = self.G
        n = len(cand)
        flags = np.stack([m["flags"] for m, _ in cand])
        due = np.stack([np.ones(G, bool) if o is None else o
                        for _, o in cand])
        uniq = ((flags & ~flags[-1]) != 0) & due
        pick = np.where(uniq.any(axis=0), uniq.argmax(axis=0), n - 1)
        cols = np.arange(G)
        got = due[pick, cols]
        out = {}
        for k in cand[-1][0]:
            lane = np.stack([m[k] for m, _ in cand])[pick, cols]
            lane[~got] = 0
            out[k] = lane
        rows = np.arange(n)[:, None]
        keep = (rows > pick[None, :]) & uniq
        keep[-1] = pick < n - 1
        owed = [(cand[i][0], keep[i]) for i in range(n) if keep[i].any()]
        if len(owed) > self.OWED_FRAMES:
            self.metrics.counter_add("owed_frames_dropped",
                                     len(owed) - self.OWED_FRAMES, peer=src)
            owed = owed[-self.OWED_FRAMES:]
        self._owed[src] = owed
        return out

    #: frames per peer kept owed at most (the oldest beyond are dropped
    #: and counted on ``owed_frames_dropped``)
    OWED_FRAMES = 8

    def _assemble_inbox(self, own_out, peer_frames) -> Dict[str, Any]:
        """Receiver-oriented inbox: row `me` filled from peers + self, the
        peers' lanes chosen by ``_peer_lanes``.  Lanes keep their dtypes
        (the int32 ``flags`` with the JAX uint32 bits, bool lanes as
        bool)."""
        lanes = self.kernel.broadcast_lanes
        me = self.me
        peers = {}
        for src, fl in peer_frames.items():
            got = self._peer_lanes(src, [f["msg"] for f in fl or ()])
            if got is not None:
                peers[src] = got
        inbox = {}
        for k, own in own_out.items():
            arr = np.zeros(own.shape, own.dtype)
            if k in lanes:
                arr[:, me] = own[:, me]
                for src, msg in peers.items():
                    arr[:, src] = msg[k]
            else:
                # transposed orientation: [G, dst(me), src]
                arr[:, me, me] = own[:, me, me]
                for src, msg in peers.items():
                    arr[:, me, src] = msg[k]
            inbox[k] = arr
        return self._upload(inbox)

    # -------------------------------------------------------- client intake
    def _reply(self, client: int, reply: ApiReply) -> None:
        """Reply seam, fence-aware: the pipelined loop queues every reply
        behind the durability fence; the serial loop's order already
        puts durability first, so it sends at once."""
        if self.pipeline:
            self._reply_queue.append((client, reply))
            return
        self.external.send_reply(reply, client)

    def _drain_replies_if_settled(self) -> None:
        """End-of-tick reply release: drain only if the open fence's
        fsync already completed (or the tick was clean); never block."""
        token = self._fence_token
        if token is not None and not self.wal.poll_flush(token):
            return
        self._drain_replies()

    def _drain_replies(self) -> None:
        """Release the queued replies and the commit-feed notes, the
        fence waited FIRST (and again by ``ExternalApi.send_replies``)."""
        self._fence_wait()
        self._flush_notes()  # queues note replies behind the same gate
        q = self._reply_queue
        if q:
            self._reply_queue = []
            self.external.send_replies(q, fence=self._fence_wait)
        self._mark_traces_replied()

    def _mark_traces_replied(self) -> None:
        """Close the sampled slot traces whose replies just left."""
        if self._trace_replied:
            now = time.monotonic()
            for g, vid in self._trace_replied:
                self.traces.mark_replied(g, vid, now)
            self._trace_replied.clear()

    def _intake(self) -> Tuple[np.ndarray, np.ndarray, Dict]:
        """Drain the client plane: queue conf changes, answer probes and
        subscriptions, serve or barrier scans, route puts and gets to
        groups, serve leased local gets and near-quorum reads, redirect
        what we don't lead, answer every other request kind with an error
        (request.rs:16-216 treat_read_only_reqs + redirects)."""
        n_prop = np.zeros((self.G,), np.int32)
        vbase = np.zeros((self.G,), np.int32)
        piggy: Dict[Tuple[int, int], Any] = {}
        batch = self.external.get_req_batch(timeout=0)
        if self._scan_pend:
            self._scan_gc()
        if not batch and not self._range_adopt_ready:
            if self._epaxos and any(self._ep_defer.values()):
                # deferred buckets drain on idle intake ticks too
                return self._intake_epaxos({}, n_prop, vbase, piggy)
            return n_prop, vbase, piggy
        by_group: Dict[int, list] = {}
        if self._range_adopt_ready:
            # adoptions whose barrier cleared enter the destination
            # group's log like any write (client None: internal)
            for g, areq in self._range_adopt_ready:
                by_group.setdefault(g, []).append((None, areq))
            self._range_adopt_ready = []
        for client, req in batch:
            if req.kind == "conf":
                self._handle_conf_req(client, req)
            elif req.kind == "sub":
                self._handle_subscribe(client, req)
            elif req.kind == "probe":
                self._handle_probe(client, req)
            elif req.kind == "scan" or (
                    req.kind == "req" and req.cmd is not None
                    and req.cmd.kind == "scan"):
                # a scan rides either its own kind or a "req" Command
                self._intake_scan(client, req, by_group)
            elif (req.kind != "req" or req.cmd is None
                    or req.cmd.kind not in ("put", "get")):
                self._reply(client, ApiReply(
                    "error", req_id=req.req_id, success=False,
                ))
            elif self._range_sealed_for(req.cmd.key) is not None:
                # mid-cutover seal: refused before any proposal, so a
                # shed op can never have been acked
                self._reply(client, ApiReply(
                    "shed", req_id=req.req_id, success=False,
                    retry_after_ms=50,
                ))
                self.metrics.counter_add("api_shed", 1)
            else:
                self._range_heat.note(req.cmd.key)
                by_group.setdefault(
                    self.route_group(req.cmd.key), []
                ).append((client, req))
        if self._epaxos:
            return self._intake_epaxos(by_group, n_prop, vbase, piggy)
        cw_fallback = self._craft_fallback_groups() if by_group else None
        for g, reqs in by_group.items():
            if not self._is_leader[g]:
                # a lease holder with every key bucket quiescent answers
                # gets from applied state; with near-quorum reads a get
                # samples a majority; the rest redirect
                local_ok = self._can_local_read(g)
                pending = []
                for client, req in reqs:
                    if client is None:
                        # an internal adopt and we no longer lead its
                        # destination: _range_progress re-proposes it
                        continue
                    if local_ok and req.cmd.kind == "get":
                        self._reply_local(client, req)
                    elif self._nqr_ok and req.cmd.kind == "get":
                        self._start_qread(client, req, g)
                    else:
                        pending.append((client, req))
                hint = int(self._leader_hint[g])
                for client, req in pending:
                    self._reply(client, ApiReply(
                        "redirect", req_id=req.req_id, redirect=hint,
                        success=False,
                    ))
                continue
            if self._leader_read_ok(g):
                # stable-leader lease: a get whose key has no write in
                # the voted tail is answered from applied state (acks
                # ride execution, and under a held lease no other
                # proposer can have committed newer state)
                to_log = []
                for client, req in reqs:
                    if (req.cmd.kind == "get"
                            and not self._tail_writes_key(g, req.cmd.key)):
                        self._reply_local(client, req)
                    else:
                        to_log.append((client, req))
                reqs = to_log
                if not reqs:
                    continue
            vid = self.payloads.put(
                g, reqs, stride=self.population, residue=self.me
            )
            self.origin.add((g, vid))
            # slot trace sampling, stamped at intake; the batch's first
            # (client, req_id) joins the request span to the slot span
            self.traces.maybe_start(
                g, vid, self.tick, time.monotonic(),
                client=-1 if reqs[0][0] is None else reqs[0][0],
                req_id=reqs[0][1].req_id,
            )
            n_prop[g] = 1
            vbase[g] = vid
            if self.codewords is not None and not (
                cw_fallback is not None and bool(cw_fallback[g])
            ):
                # codeword plane: peers get only their assigned shard
                # rows; the full batch stays at the proposer
                self._distribute_shards(g, vid, reqs)
                self.metrics.counter_add("proposals_sent", copy="shards")
            else:
                piggy[(g, vid)] = reqs
                if self.codewords is not None:
                    self.metrics.counter_add("proposals_sent", copy="full")
            if self._adaptive is not None:
                nb = float(len(pickle.dumps(reqs)))
                self._batch_bytes = 0.9 * self._batch_bytes + 0.1 * nb
        return n_prop, vbase, piggy

    def _key_bucket(self, key: str) -> int:
        """Key -> EPaxos conflict bucket (a hash independent of the group
        routing, so groups and buckets do not alias)."""
        K = self.kernel.config.num_key_buckets
        return zlib.crc32(key.encode() + b"#b") % K

    def _intake_epaxos(self, by_group, n_prop, vbase, piggy):
        """EPaxos proposals: every replica proposes (leaderless).  Every
        key bucket with pending requests proposes in the same tick, one
        batch per bucket, its vid minted in the residue class ``bucket +
        K * me`` (mod ``K * R``), so the kernel's ``vid % K`` conflict
        detection sees key interference and concurrent proposers never
        collide; the vid list rides ``prop_vids``.  Only buckets beyond
        ``max_proposals_per_tick``, or beyond the room in our own row,
        wait in ``_ep_defer`` (dependency.rs:180-240)."""
        K = self.kernel.config.num_key_buckets
        R = self.population
        pmax = self.kernel.config.max_proposals_per_tick
        self._ep_prop_vids[:] = 0
        for g, reqs in by_group.items():
            self._ep_defer[g].extend(reqs)
        own_next = self._np_state("own_next")[:, self.me]
        # the kernel's window guard reads exec_row as of the LAST drained
        # step (its propose runs before this tick's exec_floor_rows
        # apply), so the room is computed from that same view: the live
        # Tarjan floor runs one tick ahead and would mint vids the kernel
        # then refuses to propose, orphaning their payloads
        exec_me = self._np_state("exec_row")[:, self.me, self.me]
        for g in range(self.G):
            pend = self._ep_defer[g]
            if not pend:
                continue
            by_bucket: Dict[int, list] = {}
            for c, r in pend:
                by_bucket.setdefault(
                    self._key_bucket(r.cmd.key), []
                ).append((c, r))
            space = max(0, int(exec_me[g]) + self.window - int(own_next[g]))
            take_buckets = list(by_bucket)[:min(pmax, space)]
            self._ep_defer[g] = [
                cr for b in by_bucket if b not in take_buckets
                for cr in by_bucket[b]
            ]
            for i, b in enumerate(take_buckets):
                take = by_bucket[b]
                vid = self.payloads.put(g, take, stride=K * R,
                                        residue=b + K * self.me)
                self.origin.add((g, vid))
                self.traces.maybe_start(
                    g, vid, self.tick, time.monotonic(),
                    client=take[0][0], req_id=take[0][1].req_id,
                )
                self._ep_prop_vids[g, i] = vid
                piggy[(g, vid)] = take
            n_prop[g] = len(take_buckets)
            vbase[g] = int(self._ep_prop_vids[g, 0])
        return n_prop, vbase, piggy

    def _reply_local(self, client: int, req: ApiRequest) -> None:
        """Answer a get from applied state, marked as a leased local
        read."""
        res = apply_command(self.statemach._kv, req.cmd)
        self._reply(client, ApiReply(
            "reply", req_id=req.req_id, result=res, local=True,
        ))

    # ------------------------------------------------------ lease reads
    def _can_local_read(self, g: int) -> bool:
        """May this replica serve a linearizable read of group ``g``
        locally right now?  The host form of the kernel's per-bucket
        rule: the lease condition holds and every key bucket is
        quiescent (quorumlease.rs is_local_reader, bodega
        localread.rs:8-26)."""
        ex = self._last_extra
        if not ex or self.tick < self._lease_hold_off:
            return False
        if self._health_self_bad and self.health_mitigation:
            # a limping replica stops serving local reads: clients get
            # the leader redirect (steering; the lease stays valid)
            return False
        K = getattr(self.kernel.config, "num_key_buckets", 0)
        if "lease_held" in ex:      # QuorumLeases
            return bool(ex["lease_held"][g, self.me]) and int(
                ex["n_local_buckets"][g, self.me]
            ) == K
        if "local_read_buckets" in ex:  # Bodega
            return int(ex["n_local_buckets"][g, self.me]) == K
        return False

    def _leader_read_ok(self, g: int) -> bool:
        """May this leader serve reads of group ``g`` locally under a
        stable-leader lease (a confirmed quorum of follower vote-refusal
        promises; multipaxos/leaderlease.rs:10-21)?  The per-key
        freshness check is ``_tail_writes_key``."""
        ex = self._last_extra
        return (bool(ex) and self.tick >= self._lease_hold_off
                and "leader_read_ok" in ex
                and bool(ex["leader_read_ok"][g, self.me]))

    def _tail_writes(self, g: int, hit) -> bool:
        """Does our voted-but-unexecuted window tail of group ``g``
        possibly hold a put whose key satisfies ``hit(key)``?  Every voted
        slot at or above the exec floor counts, with no upper bound (a
        higher-ballot run reset rewinds ``vote_bar`` without zeroing
        ``win_bal`` above it); a payload we cannot inspect counts as a
        hit.  Votes are marked in ``win_bal`` (ballot families) or
        ``win_term`` (the Raft family); a kernel with neither (ChainRep,
        SimplePush, RepNothing) has an uninspectable tail, which is a
        hit."""
        mark = next((k for k in ("win_bal", "win_term") if k in self.state),
                    None)
        if mark is None or "win_abs" not in self.state:
            return True
        win_abs = self._np_state("win_abs")[g, self.me]
        win_mark = self._np_state(mark)[g, self.me]
        win_val = self._np_state(self.kernel.VALUE_WINDOW)[g, self.me]
        tail = (win_mark > 0) & (win_abs >= self.applied[g])
        for vid in set(int(v) for v in win_val[tail]):
            if vid == 0:
                continue
            batch = self.payloads.get(g, vid)
            if batch is None:
                return True
            for _c, req in batch:
                if (req.cmd is not None and req.cmd.kind == "put"
                        and hit(req.cmd.key)):
                    return True
        return False

    def _tail_writes_key(self, g: int, key: str) -> bool:
        """A write to ``key`` in group ``g``'s voted tail (the per-key
        freshness check of a leased or quorum read; quorumread.rs's
        highest-slot check)."""
        return self._tail_writes(g, lambda k: k == key)

    def _tail_writes_range(self, start: str, end: Optional[str]) -> bool:
        """A write inside the span ``[start, end)`` in ANY group's voted
        tail: the KV is flat per process, so every group's tail could
        touch the span."""

        def hit(k: str) -> bool:
            return k >= start and (end is None or k < end)

        return any(self._tail_writes(g, hit) for g in range(self.G))

    def _scan_read_ok(self, start: str, end: Optional[str]) -> bool:
        """May a linearizable range read over ``[start, end)`` be served
        from applied state right now?  Keys hash across every group, so
        the per-group read predicate must hold everywhere (a leader lease
        where this replica leads, lease-local rights elsewhere) and no
        voted-unexecuted write anywhere may target the span."""
        for g in range(self.G):
            if self._is_leader[g]:
                if not self._leader_read_ok(g):
                    return False
            elif not self._can_local_read(g):
                return False
        return not self._tail_writes_range(start, end)

    # ------------------------------------------------------- commit feed
    def _handle_subscribe(self, client: int, req: ApiRequest) -> None:
        """Register a read-tier learner: the reply carries a consistent
        KV snapshot plus the feed seq it covers; every put applied after
        this point streams as a note."""
        self._subs[int(client)] = True
        self._reply(client, ApiReply(
            "sub", req_id=req.req_id, success=True, seq=self._sub_seq,
            notes=self.statemach.snapshot_items(),
        ))

    def _handle_probe(self, client: int, req: ApiRequest) -> None:
        """Answer a freshness probe: may a local read of this key (or
        scan span) be served right now, and which feed seq covers it?
        Runs on the replica thread between the last tick's applies (all
        flushed as notes) and this tick's, where the fused serving path
        takes the same decision."""
        ok = False
        cmd = req.cmd
        if cmd is not None and cmd.kind == "get":
            g = self.route_group(cmd.key)
            if self._range_sealed_for(cmd.key) is not None:
                ok = False
            elif self._is_leader[g]:
                ok = (self._leader_read_ok(g)
                      and not self._tail_writes_key(g, cmd.key))
            else:
                ok = self._can_local_read(g)
        elif cmd is not None and cmd.kind == "scan":
            ok = (not self._range_seal_overlaps(cmd.key, cmd.end)
                  and self._scan_read_ok(cmd.key, cmd.end))
        self._reply(client, ApiReply(
            "probe", req_id=req.req_id, success=bool(ok),
            seq=self._sub_seq,
        ))

    def _note_put(self, key: str, value: Any) -> None:
        """Append one applied put to the commit feed (a no-op without
        subscribers)."""
        if self._subs:
            self._sub_seq += 1
            self._sub_notes.append((self._sub_seq, key, value))

    def _flush_notes(self) -> None:
        """Ship the buffered notes to every live subscriber, once per
        tick, strictly after the group-commit fsync covering the applies
        they report (the callers run behind the durability gate).
        Subscribers whose connection is gone are dropped here."""
        if not (self._subs and self._sub_notes):
            return
        notes = self._sub_notes
        self._sub_notes = []
        for c in [c for c in self._subs
                  if not self.external.has_client(c)]:
            del self._subs[c]
        last = notes[-1][0]
        for c in self._subs:
            self._reply(c, ApiReply(
                "note", req_id=0, seq=last, notes=notes,
            ))

    # ------------------------------------------------ ordered range reads
    def _intake_scan(self, client: int, req: ApiRequest,
                     by_group: Dict[int, list]) -> None:
        """Scan serving, in order: (1) a span crossing a sealed cutover is
        shed before any proposal (never, with no range table); (2) EPaxos
        answers ``error``: leaderless rows have no commit bar to barrier
        on and no lease plane; (3) when every group is read-ready for the
        span, the applied KV is served (the replica thread applies
        serially, so the KV between applies is a consistent cut); (4) a
        replica leading every group proposes one no-effect scan marker
        into every group's log and reads the cut when the last marker
        applies: any write acked before that instant was acked by this
        replica (acks ride execution) and sits ahead of some marker in
        its group's log; (5) split leadership redirects, as a get."""
        cmd = req.cmd
        if cmd is None:
            self._reply(client, ApiReply(
                "error", req_id=req.req_id, success=False,
            ))
            return
        if self._range_seal_overlaps(cmd.key, cmd.end):
            self._reply(client, ApiReply(
                "shed", req_id=req.req_id, success=False,
                retry_after_ms=50,
            ))
            self.metrics.counter_add("api_shed", 1)
            self.metrics.counter_add("scan_shed", 1)
            return
        if self._epaxos:
            self._reply(client, ApiReply(
                "error", req_id=req.req_id, success=False,
            ))
            return
        if self._scan_read_ok(cmd.key, cmd.end):
            res = apply_command(self.statemach._kv, cmd)
            self._reply(client, ApiReply(
                "reply", req_id=req.req_id, result=res, local=True,
            ))
            self._scan_served(res)
            return
        if bool(self._is_leader.all()):
            sbid = self._scan_next
            self._scan_next += 1
            self._scan_pend[sbid] = {
                "client": client, "req_id": req.req_id, "cmd": cmd,
                "need": set(range(self.G)), "tick": self.tick,
            }
            marker = ApiRequest("req", req_id=sbid, cmd=cmd)
            for g in range(self.G):
                by_group.setdefault(g, []).append((None, marker))
            return
        hint = int(self._leader_hint[self.route_group(cmd.key)])
        self._reply(client, ApiReply(
            "redirect", req_id=req.req_id, redirect=hint, success=False,
        ))

    def _scan_served(self, res: CommandResult) -> None:
        keys = len(res.items or ())
        self.metrics.counter_add("scan_served", 1)
        self.metrics.counter_add("scan_keys", keys)
        self.flight.record("scan_serve", keys=keys, tick=self.tick)

    def _scan_barrier_hit(self, g: int, sbid: int) -> None:
        """One group's scan marker reached the apply bar at its proposer.
        When the last group lands, the applied KV is a linearizable cut
        for the span: read it and queue the reply behind the durability
        fence."""
        p = self._scan_pend.get(sbid)
        if p is None:
            return  # expired (the GC replied shed) or a duplicate
        p["need"].discard(g)
        if p["need"]:
            return
        del self._scan_pend[sbid]
        res = apply_command(self.statemach._kv, p["cmd"])
        self._reply_queue.append((p["client"], ApiReply(
            "reply", req_id=p["req_id"], result=res,
        )))
        self._scan_served(res)

    def _scan_gc(self, ttl_ticks: int = 500) -> None:
        """Expire barrier scans whose markers never committed (leadership
        moved mid-barrier): reply shed; a scan is a read, so refusing it
        late is safe, and a marker applying afterwards finds no pend."""
        dead = [sbid for sbid, p in self._scan_pend.items()
                if self.tick - p["tick"] > ttl_ticks]
        for sbid in dead:
            p = self._scan_pend.pop(sbid)
            self._reply(p["client"], ApiReply(
                "shed", req_id=p["req_id"], success=False,
                retry_after_ms=50,
            ))
            self.metrics.counter_add("scan_shed", 1)

    # ------------------------------------------------- near-quorum reads
    def _local_read_sample(self, g: int, key: str) -> Tuple[Any, int, bool]:
        """This replica's (value, write slot, tail hit) for ``key``."""
        return (
            self.statemach._kv.get(key),
            self._wslot.get(key, -1),
            self._tail_writes_key(g, key),
        )

    def _start_qread(self, client: int, req: ApiRequest, g: int) -> None:
        """Begin a near-quorum read (quorumread.rs ReadQuery fan-out):
        sample ourselves now, ask every connected peer through the tick
        frames, and serve once a majority answered with no in-flight
        write in sight.  A completed write holds votes at a majority,
        which intersects the read quorum: the intersecting member either
        applied it (its write-slot sample shows it) or still has it in
        its voted tail (a hit: fall back to the leader).  Too few
        connected peers for a quorum redirect at once."""
        key = req.cmd.key
        need = self.kernel.quorum - 1
        peers = self.transport.peers()
        if len(peers) < need:
            self._reply(client, ApiReply(
                "redirect", req_id=req.req_id,
                redirect=int(self._leader_hint[g]),
                success=False, rq_retry=True,
            ))
            return
        rid = self._qread_next
        self._qread_next += 1
        self._qreads[rid] = {
            "client": client, "req": req, "g": g, "key": key,
            "replies": {self.me: self._local_read_sample(g, key)},
            "deadline": self.tick + 400,
        }
        # every connected peer is asked and the first quorum of replies
        # completes: one slow peer cannot stall the read
        for dst in peers:
            self._pending_rq.setdefault(dst, []).append((rid, key, g))
        self._qread_check(rid)

    def _qread_check(self, rid: int) -> None:
        qr = self._qreads.get(rid)
        if qr is None or len(qr["replies"]) < self.kernel.quorum:
            return
        del self._qreads[rid]
        req = qr["req"]
        samples = list(qr["replies"].values())
        if any(hit for _v, _s, hit in samples):
            # an in-flight write touches the key: the log path at the
            # leader (the reference's rq_retry hint)
            self._reply(qr["client"], ApiReply(
                "redirect", req_id=req.req_id,
                redirect=int(self._leader_hint[qr["g"]]),
                success=False, rq_retry=True,
            ))
            return
        value, _slot, _hit = max(samples, key=lambda x: x[1])
        self._reply(qr["client"], ApiReply(
            "reply", req_id=req.req_id,
            result=CommandResult("get", value=value), local=True,
        ))

    def _qread_expire(self) -> None:
        """Redirect the read queries past their deadline (rq_retry)."""
        for rid in [r for r, q in self._qreads.items()
                    if self.tick > q["deadline"]]:
            qr = self._qreads.pop(rid)
            self._reply(qr["client"], ApiReply(
                "redirect", req_id=qr["req"].req_id,
                redirect=int(self._leader_hint[qr["g"]]),
                success=False, rq_retry=True,
            ))

    # ------------------------------------------------------ conf plane
    def _handle_conf_req(self, client: int, req: ApiRequest) -> None:
        """Queue a client ConfChange; a kernel without a conf plane
        answers it with a failed ``conf`` reply (external.rs:106-121)."""
        if self._conf_kind is None:
            self._reply(client, ApiReply(
                "conf", req_id=req.req_id, success=False,
            ))
            return
        if self._conf_kind == "ql" and not self._is_leader.all():
            # QuorumLeases conf entries ride the log, so only a group's
            # leader proposes them: under split leadership the manager
            # re-announces the delta to every server, and our completion
            # check waits for conf_cur to reach the target in all groups
            self.ctrl.send_ctrl(CtrlMsg(
                "conf_forward", {"delta": dict(req.conf_delta or {})}
            ))
        self._conf_queue.append((client, req))

    def _conf_inputs(self, arrays: Dict[str, np.ndarray]) -> None:
        """Activate the next queued ConfChange and feed the active one
        into the kernel's conf inputs (host arrays)."""
        if self._conf_kind is None:
            return
        if self._conf_active is None and self._conf_queue:
            client, req = self._conf_queue.pop(0)
            d = dict(req.conf_delta or {})
            resp = 0
            for r in d.get("responders", []):
                resp |= 1 << int(r)
            lead = d.get("leader")
            if lead is None:
                # a responders-only change keeps Bodega's current conf
                # leader; QuorumLeases' conf plane carries no leader
                if "conf_leader" in self.state:
                    cur = int(self._np_state("conf_leader")[0, self.me])
                    lead = cur if cur >= 0 else self.me
                else:
                    lead = -1
            self._conf_active = {
                "client": client, "req_id": req.req_id, "resp": resp,
                "leader": int(lead), "deadline": self.tick + 2000,
            }
        a = self._conf_active
        G = self.G
        if self._conf_kind == "ql":
            arrays["conf_target"] = np.full(
                (G,), a["resp"] if a is not None else -1, np.int32)
        else:
            arrays["conf_init"] = np.full(
                (G,), self.me if a is not None else -1, np.int32)
            arrays["conf_leader_target"] = np.full(
                (G,), a["leader"] if a else -1, np.int32)
            arrays["conf_resp_target"] = np.full(
                (G,), a["resp"] if a else 0, np.int32)
            arrays["conf_bucket"] = np.full((G,), -1, np.int32)

    def _conf_progress(self) -> None:
        """Once the active ConfChange is installed in every group, reply
        to its client and report the new conf to the manager (reigner.rs
        RespondersConf); past its deadline, fail it."""
        a = self._conf_active
        if a is None:
            return
        me = self.me
        if self._conf_kind == "ql":
            cur = self._np_state("conf_cur")[:, me]
            done = bool((cur == a["resp"]).all())
        else:
            resp = self._np_state("conf_resp")[:, me, :]
            lead = self._np_state("conf_leader")[:, me]
            done = bool(
                (resp == a["resp"]).all() and (lead == a["leader"]).all()
            )
        if done:
            if a["client"] is not None:
                self._reply(a["client"], ApiReply(
                    "conf", req_id=a["req_id"], success=True,
                ))
            new_conf = {
                "responders": [
                    r for r in range(self.population) if a["resp"] >> r & 1
                ],
            }
            if a["leader"] >= 0:
                new_conf["leader"] = a["leader"]
            self.ctrl.send_ctrl(CtrlMsg(
                "responders_conf", {"new_conf": new_conf}
            ))
            self._conf_active = None
        elif self.tick > a["deadline"]:
            if a["client"] is not None:
                self._reply(a["client"], ApiReply(
                    "conf", req_id=a["req_id"], success=False,
                ))
            self._conf_active = None

    def _install_conf(self, payload: dict) -> None:
        """A manager-relayed ConfChange, newest sequence number wins: a
        stale relay neither queues behind a newer one (it would revert
        the conf when it activated) nor takes the active slot."""
        d = payload.get("delta") or {}
        seq = int(payload.get("seq", 0))
        if self._conf_kind is None or seq <= self._conf_seq_seen:
            return
        self._conf_seq_seen = seq
        resp = 0
        for r in d.get("responders", []):
            resp |= 1 << int(r)
        a = self._conf_active
        # superseded manager-relayed entries leave the queue
        self._conf_queue = [(c, q) for c, q in self._conf_queue
                            if c is not None]
        if not (a is not None and a.get("resp") == resp):
            self._conf_queue.append((None, ApiRequest(
                "conf", conf_delta=d,
            )))

    # ---------------------------------------------- codeword payload plane
    def _craft_fallback_groups(self) -> Optional[np.ndarray]:
        """Host mirror of CRaft's full-copy fallback (more than
        ``fault_tolerance`` peers look dead: ship full batches), read
        from the last drained step's liveness countdowns."""
        if not (self._craft_mode and self.codewords is not None):
            return None
        ac = self._np_state("alive_cnt")[:, self.me]
        return (ac <= 0).sum(axis=1) > self.kernel.config.fault_tolerance

    def _spr_choice(self, g: int) -> int:
        """Shards per replica for this tick's sends: the value the kernel
        receives as ``spr_override``, clipped as the kernel clips it, so
        its ``win_spr`` stamp matches the bytes on the wire (static
        without an adaptive policy)."""
        if self._adaptive is None:
            return self._cw_spr0
        d = self.kernel.data_shards
        return int(min(max(int(self._spr_tick[g]), self._cw_dj), d))

    def _distribute_shards(self, g: int, vid: int, batch: Any) -> None:
        """Leader-side send plan: encode once, then queue each peer's
        assigned rows of the codeword for this tick's frame
        (rspaxos/mod.rs:597-608; Crossword: ``spr``-wide diagonal
        slices)."""
        spr = self._spr_choice(g)
        with self._on_stream():
            dlen, cw = self.codewords.encode(g, vid, batch, spr)
        T = self.codewords.T
        for dst in range(self.population):
            if dst == self.me:
                continue
            sids = assigned_sids(dst, spr, self._cw_dj, T)
            sp = ShardPayload(dlen, {s: cw[s] for s in sids})
            self._pending_shards.setdefault(dst, {})[(g, vid)] = sp
            self.pp_bytes[dst] += _sp_size(sp)
            self.pp_items[dst] += 1

    def _resolve_payload(self, g: int, vid: int) -> Optional[Any]:
        """The full batch of ``(g, vid)``: the payload store, else a
        rebuild from >= d held shards (decoded once, then installed)."""
        b = self.payloads.get(g, vid)
        if b is None and vid != 0 and self.codewords is not None:
            with self._on_stream():
                b = self.codewords.reconstruct_batch(g, vid)
            if b is not None:
                self.payloads.install(g, vid, b, overwrite=False)
                self.missing.discard((g, vid))
                self._cw_first_missing.pop((g, vid), None)
                if bool(self._is_leader[g]):
                    # a leader that rebuilt an adopted value re-sends
                    # fresh slices under its own assignment, so the
                    # followers' votes are backed by shard rows again
                    self._distribute_shards(g, vid, b)
        return b

    # ------------------------------------------------- live resharding
    def _reseal(self, ch: dict) -> None:
        """Re-seal a range change found in a snapshot or a ``rseal`` WAL
        record unless its adopt (or override) is already known here; the
        cutover clock restarts with the process."""
        rc_id = int(ch["rc_id"])
        if rc_id in self._range_adopted or rc_id in self._range_override:
            return
        ch = dict(ch)
        ch["sealed_at"] = time.monotonic()
        self._range_sealed[rc_id] = ch

    def _handoff_floor(self, g: int, key: str) -> Optional[int]:
        """Group ``g``'s handoff floor when ``key``'s range moved away from
        ``g`` (a put to it below that slot already rode the adopt), else
        None."""
        if not len(self.rangetab):
            return None
        ent = self.rangetab.lookup(key)
        if ent is None or int(ent["group"]) % self.G == g:
            return None
        floors = ent.get("floors") or []
        return int(floors[g]) if g < len(floors) else 0

    def _range_begin(self, ch: dict, replayed: bool = False) -> None:
        """Seal a range for cutover (the revoke half of revoke-then-adopt):
        from here on an op on the range is shed at intake, never silently
        dropped, until the destination group's adopt applies.  The seal is
        WAL-durable (``rseal``); a ``replayed`` seal (a manager
        re-announce) skips the append.  EPaxos, and the kernels with no
        inspectable vote window (ChainRep, SimplePush, RepNothing), refuse
        the cutover: their barrier could never clear."""
        rc_id = int(ch.get("rc_id", 0))
        if rc_id in self._range_adopted or rc_id in self._range_sealed \
                or rc_id in self._range_override \
                or rc_id in self._range_expired:
            return
        if self._epaxos:
            pf_warn(logger, f"range_change {rc_id} refused: leaderless "
                            "protocol has no seal barrier")
            return
        if "win_abs" not in self.state or not any(
                k in self.state for k in ("win_bal", "win_term")):
            pf_warn(logger, f"range_change {rc_id} refused: kernel "
                            "family has no inspectable vote window")
            return
        ch = dict(ch)
        ch["sealed_at"] = time.monotonic()
        # the seal TTL counts from this tick (a replayed seal restarts it)
        ch["sealed_tick"] = self.tick
        self._range_sealed[rc_id] = ch
        if not replayed:
            self._wal_append(("rseal", {
                k: ch[k] for k in ("rc_id", "op", "start", "end", "dst_group")
            }))
        self.flight.record("range_seal", rc_id=rc_id, op=str(ch.get("op")),
                           tick=self.tick)

    def _range_progress(self) -> None:
        """Propose the adopt of each sealed range whose barrier cleared:
        this replica leads the destination group, the manager confirmed
        the seal at every server (``sealed_ok``) and granted the adopt
        intent, and no voted-unexecuted write to the range remains in any
        group.  The range-filtered KV, write slots and apply floors ride
        one ``adopt`` command through the destination group's log.  A
        seal with no grant past ``seal_ttl_ticks`` asks the manager to
        expire it."""
        if not self._range_sealed or self._epaxos:
            return
        for rc_id in sorted(self._range_sealed):
            ch = self._range_sealed[rc_id]
            dst = int(ch["dst_group"]) % self.G
            if (self.seal_ttl_ticks > 0
                    and rc_id not in self._range_adopt_granted
                    and self.tick - int(ch.get("sealed_tick", 0))
                    > self.seal_ttl_ticks):
                last = self._range_expire_sent.get(rc_id)
                if last is None or self.tick - last >= 200:
                    self._range_expire_sent[rc_id] = self.tick
                    self.ctrl.send_ctrl(CtrlMsg(
                        "range_expire", {"rc_id": rc_id},
                    ))
                continue
            if not bool(self._is_leader[dst]):
                continue
            if not ch.get("sealed_ok"):
                # a server the seal fan-out has not reached could still
                # admit a write to the range
                continue
            mark = self._range_adopt_mark.get(rc_id)
            if mark is not None and self.tick - mark < 400:
                continue  # an adopt in flight (re-proposed after 400)
            if self._tail_writes_range(ch["start"], ch.get("end")):
                continue
            if rc_id not in self._range_adopt_granted:
                # the grant pins the change against expiry, so adopt and
                # expire can never both win
                last = self._range_intent_sent.get(rc_id)
                if last is None or self.tick - last >= 200:
                    self._range_intent_sent[rc_id] = self.tick
                    self.ctrl.send_ctrl(CtrlMsg(
                        "adopt_intent", {"rc_id": rc_id},
                    ))
                continue
            start, end = ch["start"], ch.get("end")

            def _inr(k: str) -> bool:
                return k >= start and (end is None or k < end)

            val = {
                "rc_id": rc_id, "op": ch.get("op", "split"),
                "start": start, "end": end, "dst_group": dst,
                "kv": {k: v for k, v in self.statemach._kv.items()
                       if _inr(k)},
                "wslots": {k: s for k, s in self._wslot.items() if _inr(k)},
                "floors": list(self.applied),
            }
            self._range_adopt_ready.append((dst, ApiRequest(
                "req", req_id=0,
                cmd=Command("adopt", key=f"__adopt__{rc_id}", value=val),
            )))
            self._range_adopt_mark[rc_id] = self.tick

    def _apply_adopt(self, val: Any, announce: bool,
                     recovery: bool = False) -> None:
        """Execute an ``adopt`` at its destination-group slot: install the
        range override, merge the handed-off KV and write slots, unseal,
        and (the proposer, live) tell the manager.  Idempotent per
        rc_id."""
        val = dict(val or {})
        rc_id = int(val.get("rc_id", 0))
        if rc_id in self._range_adopted:
            return
        self._range_adopted.add(rc_id)
        # a re-announce may have installed the override first; this is
        # the real adoption
        self._range_override.discard(rc_id)
        entry = {
            "rc_id": rc_id, "op": val.get("op", "split"),
            "start": val["start"], "end": val.get("end"),
            "group": int(val.get("dst_group", 0)) % self.G,
            "floors": [int(f) for f in (val.get("floors") or [])],
        }
        self.rangetab.install(entry)
        kv = dict(val.get("kv") or {})
        self.statemach._kv.update(kv)
        for k, v in kv.items():
            # moved keys re-enter the commit feed
            self._note_put(k, v)
        for k, sl in (val.get("wslots") or {}).items():
            self._wslot[k] = max(self._wslot.get(k, -1), int(sl))
        sealed = self._range_sealed.pop(rc_id, None)
        self._range_adopt_mark.pop(rc_id, None)
        self.metrics.counter_add(
            "reshard_splits" if entry["op"] == "split" else "reshard_merges",
            1,
        )
        if sealed is not None and not recovery and "sealed_at" in sealed:
            self.metrics.observe(
                "reshard_cutover_us",
                int((time.monotonic() - sealed["sealed_at"]) * 1e6),
            )
        self.flight.record("range_adopt", rc_id=rc_id, op=str(entry["op"]),
                           dst=entry["group"], keys=len(kv), tick=self.tick)
        if announce and not recovery:
            self.ctrl.send_ctrl(CtrlMsg("range_installed", {"entry": entry}))

    def _range_unseal(self, rc_id: int, why: str) -> None:
        """Roll back a sealed, never-adopted range change (the manager
        expired it): the source serves the range again, and the rc_id is
        remembered so a straggling re-announce cannot re-seal it."""
        rc_id = int(rc_id)
        if rc_id in self._range_expired or rc_id in self._range_adopted:
            return
        self._range_expired.add(rc_id)
        self._range_adopt_granted.discard(rc_id)
        self._range_intent_sent.pop(rc_id, None)
        self._range_expire_sent.pop(rc_id, None)
        sealed = self._range_sealed.pop(rc_id, None)
        self._range_adopt_mark.pop(rc_id, None)
        # an adopt still waiting for intake must not reach the log
        self._range_adopt_ready = [
            (g, req) for g, req in self._range_adopt_ready
            if int((req.cmd.value or {}).get("rc_id", -1)) != rc_id
        ]
        if sealed is None:
            return
        self.metrics.counter_add("reshard_seal_expired", 1)
        self.flight.record("range_unseal", rc_id=rc_id, why=str(why),
                           tick=self.tick)
        pf_warn(logger, f"range_change {rc_id} un-sealed ({why}): "
                        "source resumes serving the range")

    def _install_ranges(self, payload: dict) -> None:
        """The manager's re-announce (late joiners, fan-out stragglers),
        newest seq wins: installed entries land as routing overrides only
        (the replicated adopt still merges at its slot), pending changes
        seal or learn ``sealed_ok``, expired ones un-seal."""
        seq = int(payload.get("seq", 0))
        if seq <= self._range_seq_seen:
            return
        self._range_seq_seen = seq
        for entry in payload.get("installed", []):
            rc_id = int(entry["rc_id"])
            if rc_id not in self._range_adopted \
                    and rc_id not in self._range_override:
                self._range_override.add(rc_id)
                self.rangetab.install(entry)
                self._range_sealed.pop(rc_id, None)
                self._range_adopt_mark.pop(rc_id, None)
        for ch in payload.get("pending", []):
            rc_id = int(ch.get("rc_id", 0))
            sealed = self._range_sealed.get(rc_id)
            if sealed is not None:
                if ch.get("sealed_ok"):
                    sealed["sealed_ok"] = True
            elif rc_id not in self._range_adopted \
                    and rc_id not in self._range_override:
                self._range_begin(dict(ch), replayed=True)
        for rc_id in payload.get("expired", []):
            self._range_unseal(int(rc_id), why="seal-ttl")

    # ---------------------------------------------------------- tick loop
    def run(self) -> bool:
        """Event loop; returns True to request a crash-restart."""
        while True:
            if self.stopping:
                self._pipeline_flush()
                return False
            t0 = time.monotonic()
            restart = self._handle_ctrl()
            if restart is not None:
                if restart is False:
                    # graceful leave: settle the in-flight step so every
                    # already-applied op is acked before teardown
                    self._pipeline_flush()
                return restart
            if self.paused:
                time.sleep(self.tick_interval)
                continue
            if self.pipeline:
                self._tick_pipelined(t0)
            else:
                self._tick_serial(t0)

    def _stage_clock(self, t0: float):
        """Per-tick stage stopwatch: ``mark(name)`` records the segment
        since the previous mark into ``loop_stage_us{stage=name}``."""
        stage_us: Dict[str, int] = {}
        box = [t0]

        def mark(name: str) -> None:
            now = time.monotonic()
            d = int((now - box[0]) * 1e6)
            self.metrics.observe("loop_stage_us", d, stage=name)
            stage_us[name] = d
            box[0] = now

        return stage_us, mark

    def _fold_adaptive(self) -> None:
        """Fold the delivery samples and pick this tick's shard width
        BEFORE intake: the same choice slices the shard sends and rides
        the ``spr_override`` kernel input."""
        if self._adaptive is None:
            return
        samples = self.transport.samples
        while samples:
            try:
                p, nb, dly = samples.popleft()
            except IndexError:
                break
            self._adaptive.observe(p, nb, dly)
        self._spr_tick = self._adaptive.overrides(self.G, self._batch_bytes)
        self.metrics.counter_add("spr_choice_ticks", spr=self._spr_tick[0])

    def _cw_needs(self, needs) -> Dict[int, list]:
        """Shard-gossip requests per peer for the missing values: each
        asks the fewest peers whose base slices cover the deficit,
        leaders last; a request unserved for 40 ticks goes to every peer
        as urgent (answered with any held shard)."""
        out: Dict[int, list] = {}
        cw_T, cw_dj = self.codewords.T, self._cw_dj
        for g, vid in needs:
            first = self._cw_first_missing.setdefault((g, vid), self.tick)
            have = self.codewords.have_mask(g, vid)
            if self.tick - first > 40:
                for dst in range(self.population):
                    if dst != self.me:
                        out.setdefault(dst, []).append((g, vid, have, True))
                continue
            lead = int(self._leader_hint[g])
            order = sorted((d for d in range(self.population)
                            if d != self.me),
                           key=lambda d: (d == lead, d))
            cover = have
            for dst in order:
                add = [sid for sid in assigned_sids(dst, cw_dj, cw_dj, cw_T)
                       if not (cover >> sid) & 1]
                if not add:
                    continue
                out.setdefault(dst, []).append((g, vid, have, False))
                for sid in add:
                    cover |= 1 << sid
                if bin(cover).count("1") >= self.codewords.d:
                    break
        return out

    def _build_tick_frames(self, frames, piggy) -> Dict[int, dict]:
        """This tick's per-peer frames: kernel lane slices plus the
        payload piggyback, the need plane, the codeword parts (``ps``
        shard sends, ``cw`` gossip replies, ``cw_need`` requests), the
        near-quorum read parts (``rq`` queries, ``rqr`` replies) and the
        kv install plane."""
        piggy.update(self._pending_serve)
        self._pending_serve = {}
        # the full-payload need plane stays on in codeword mode: CRaft's
        # full-copy values are in no shard store
        needs = sorted(self.missing)[:64]
        payload_msg: Dict[str, Any] = {
            "pp": piggy,
            "kv_need": bool(self.kv_need),
            "ts": time.monotonic(),
        }
        if self.health is not None:
            # the health beacon: own signal EWMAs and this replica's
            # observations of every peer's frame delay
            payload_msg["hb"] = self.health.beacon()
        payload_msg["need"] = needs
        cw_need = self._cw_needs(needs) if self.codewords is not None else {}
        if self._pending_kv_serve:
            payload_msg["kv"] = self.statemach.snapshot_items()
            payload_msg["kv_floor"] = list(self.applied)
            payload_msg["kv_wslots"] = dict(self._wslot)
            if self._epaxos:
                payload_msg["kv_ep"] = [list(self._ep_exec[g].floor)
                                        for g in range(self.G)]
            self._pending_kv_serve = False
        ps_pend, self._pending_shards = self._pending_shards, {}
        cw_pend, self._pending_cw = self._pending_cw, {}
        rq, self._pending_rq = self._pending_rq, {}
        rqr, self._pending_rqr = self._pending_rqr, {}
        tick_frames = {}
        for dst in frames:
            f = {"msg": frames[dst], **payload_msg}
            for key, part in (("rq", rq), ("rqr", rqr), ("ps", ps_pend),
                              ("cw", cw_pend), ("cw_need", cw_need)):
                if dst in part:
                    f[key] = part[dst]
            tick_frames[dst] = f
        if piggy:
            # full copies are identical per peer, sized as the frame
            # pickles them; shard sends and gossip replies were sized
            # when queued
            pp_len = wirecodec.payload_nbytes(piggy)
            nbytes, nitems = ((self.full_bytes, self.full_items)
                              if self.codewords is not None
                              else (self.pp_bytes, self.pp_items))
            for dst in tick_frames:
                nbytes[dst] += pp_len
                nitems[dst] += len(piggy)
        return tick_frames

    def _build_inputs(self, n_prop, vbase) -> Dict[str, Any]:
        """This tick's kernel step inputs: ``n_proposals``,
        ``value_base``, ``exec_floor``, the conf plane's inputs and
        (kernels declaring it) ``demote``, true at this
        replica's rows while a demotion is armed, on the step's device."""
        floor = np.repeat(
            np.asarray(self.applied, np.int32)[:, None],
            self.population, axis=1,
        )
        arrays = {"n_proposals": n_prop, "value_base": vbase,
                  "exec_floor": floor}
        self._conf_inputs(arrays)
        if self._demote_supported:
            dem = np.zeros((self.G, self.population), bool)
            if self.tick < self._demote_until:
                dem[:, self.me] = True
            arrays["demote"] = dem
        if self._adaptive is not None:
            # the choice that sliced this tick's shard sends
            arrays["spr_override"] = np.asarray(self._spr_tick, np.int32)
        if self._epaxos:
            floors = np.zeros((self.G, self.population, self.population),
                              np.int32)
            for g in range(self.G):
                floors[g, self.me, :] = self._ep_exec[g].floor
            arrays["exec_floor_rows"] = floors
            arrays["prop_replica"] = np.full((self.G,), self.me, np.int32)
            # a copy: the next intake rewrites the register in place
            arrays["prop_vids"] = self._ep_prop_vids.copy()
        return self._upload(arrays)

    def _dispatch(self, inbox, inputs) -> Dict[str, Any]:
        """Launch step N on the replica's stream and, on the card, start
        the prefetch of every host view the drain reads; returns the
        in-flight register (it holds every tensor the step reads until
        its event completes)."""
        with self._on_stream(), torch.inference_mode():
            new_state, new_out, fx = self.kernel.step(
                self.state, inbox, inputs
            )
            host = self._prefetch_async(new_state, new_out, fx)
        return {
            "state": new_state, "out": new_out, "fx": fx, "host": host,
            "inbox": inbox, "inputs": inputs, "prev": self.state,
            "tick": self.tick, "t_dispatch": time.monotonic(),
        }

    def _prefetch_async(self, new_state, new_out, fx) -> Dict[str, Any]:
        """Device->host copies of every leaf the host reads next into
        pinned buffers (allocated once per leaf and shape; two sets used
        in turn so a copy never lands under a view still in use), with
        one event recorded behind them.  On the CPU the views are the
        tensors' own memory and there is nothing to prefetch."""
        if self._stream is None:
            return {
                "state": {k: new_state[k].numpy()
                          for k in self._prefetch_keys},
                "out": {k: v.numpy() for k, v in new_out.items()},
                "commit_bar": fx.commit_bar.numpy(),
                "extra": {k: v.numpy() for k, v in fx.extra.items()},
                "event": None,
            }
        self._pf_slot ^= 1
        bufs = self._pinned[self._pf_slot]
        me = self.me

        def copy(name: str, t: torch.Tensor) -> torch.Tensor:
            b = bufs.get(name)
            if b is None or b.shape != t.shape or b.dtype != t.dtype:
                b = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                bufs[name] = b
            b.copy_(t, non_blocking=True)
            return b

        # EPaxos 2-D leaves: the host reads only row ``me`` of them, so
        # only that row crosses; the drain views it at the full shape
        rows = ({k: tuple(new_state[k].shape) for k in self._prefetch_keys
                 if k in _EP_ROW_KEYS} if self._epaxos else {})
        host = {
            "state": {k: copy("s:" + k, new_state[k][:, me] if k in rows
                              else new_state[k])
                      for k in self._prefetch_keys},
            "rows": rows,
            "out": {k: copy("o:" + k, v) for k, v in new_out.items()},
            "commit_bar": copy("f:commit_bar", fx.commit_bar),
            "extra": {k: copy("x:" + k, v) for k, v in fx.extra.items()},
        }
        ev = torch.cuda.Event()
        ev.record(self._stream)
        host["event"] = ev
        return host

    def _retire(self, pl: Dict[str, Any]) -> HostEffects:
        """Wait for the in-flight step's event (the ``device_wait``), then
        swap in its state and host views; returns its host effects."""
        host = pl["host"]
        ev = host["event"]
        if ev is not None:
            ev.synchronize()

        def np_of(t):
            return t if isinstance(t, np.ndarray) else t.numpy()

        views = {k: np_of(v) for k, v in host["state"].items()}
        for k, shape in host.get("rows", {}).items():
            # every replica index of the view is this replica's row
            views[k] = np.broadcast_to(views[k][:, None], shape)
        self._set_state(pl["state"], views)
        self._last_out = {k: np_of(v) for k, v in host["out"].items()}
        return HostEffects(
            commit_bar=np_of(host["commit_bar"]),
            extra={k: np_of(v) for k, v in host["extra"].items()},
        )

    def _tick_end(self, t0: float, deadline: float) -> None:
        """Shared tick epilogue: advance the tick, the snapshot schedule,
        sleep to the deadline (stretched under the nemesis clock skew)."""
        self.tick += 1
        if (self.snapshot_interval
                and self.tick % self.snapshot_interval == 0
                and sum(self.applied) > self._snap_last):
            self._snap_last = sum(self.applied)
            self._take_snapshot()
            self.ctrl.send_ctrl(CtrlMsg(
                "snapshot_up_to", {"new_start": list(self.applied)}
            ))
        if self.watch is not None and self.tick % self.watch_ticks == 0:
            # one graftwatch delta frame on the watch cadence, one-way
            # over the ctrl connection
            t_emit = time.monotonic()
            frame = self.watch.frame(self.tick)
            self.ctrl.send_ctrl(CtrlMsg("watch_frame", frame))
            self.metrics.counter_add("watch_frames_total", 1)
            self.metrics.observe_s("watch_emit_us",
                                   time.monotonic() - t_emit)
        now = time.monotonic()
        rem = deadline - now
        if self._tick_scale > 1.0:
            # a compute-bound loop never reaches the deadline sleep, so
            # the stretch pads by the scaled actual loop time: the skewed
            # replica's period is ~scale x its natural period either way
            rem = max(rem, (self._tick_scale - 1.0) * (now - t0))
        if rem > 0:
            time.sleep(rem)

    def _tick_serial(self, t0: float) -> None:
        """One strictly ordered tick: intake -> send/recv -> step (waited)
        -> WAL log -> group-commit fsync -> apply/reply."""
        stage_us, _stage = self._stage_clock(t0)
        self._fold_adaptive()
        n_prop, vbase, piggy = self._intake()
        _stage("intake")

        frames = self._slice_outbox(self._last_out)
        self._renack_stalled(frames)
        # _tick_scale > 1 is the nemesis clock skew: this replica's tick
        # clock runs slow against its peers'
        deadline = t0 + self.tick_interval * self._tick_scale
        tick_frames = self._build_tick_frames(frames, piggy)
        # these frames carry step N-1's outbox, whose WAL records
        # _flush_durability fsynced at the end of tick N-1
        self.transport.send_tick(self.tick, tick_frames)
        got = self.transport.recv_tick(self.tick, deadline)
        self._ingest_payloads(got)
        inbox = self._assemble_inbox(self._last_out, got)
        inputs = self._build_inputs(n_prop, vbase)
        _stage("exchange")
        fx = self._retire(self._dispatch(inbox, inputs))
        _stage("step")

        self._log_votes()
        _stage("log")
        self._apply_committed(fx)
        self._flush_durability()
        self._qread_expire()
        self._conf_progress()
        self._range_progress()
        self._leader_edges(fx)
        self._health_tick()
        self._autopilot_tick()
        _stage("apply")
        # the stage stopwatches ride the tick event as child spans
        self.flight.record("tick", tick=self.tick, **stage_us)
        self._tick_end(t0, deadline)

    def _tick_pipelined(self, t0: float) -> None:
        """One software-pipelined tick: the serial dataflow, with the
        device step drained at its first consumer and the WAL fsync on
        the logger thread behind the durability fence.

            intake   tick N's client batch -> proposals
            exchange frames out (gated on the fence over step N-1's
                     records), deferred replies released behind the same
                     fence, frame recv until the deadline
            inbox    inbox lane assembly and upload
            dispatch inputs built, step N launched, prefetch started
            overlap  peer-payload ingest and the conf plane's progress
                     (on step N-1's state), coincident with the step
            device_wait  residual wait on step N's event
            apply    apply N's commits, queue replies
            log      N's durable rows -> background appends, fence N
            (sleep to the deadline, the fsync running under it)
            drain    replies released if fence N settled, else at N+1
        """
        stage_us, _stage = self._stage_clock(t0)
        deadline = t0 + self.tick_interval * self._tick_scale

        self._fold_adaptive()
        n_prop, vbase, piggy = self._intake()
        _stage("intake")

        frames = self._slice_outbox(self._last_out)
        self._renack_stalled(frames)
        tick_frames = self._build_tick_frames(frames, piggy)
        self.transport.send_tick(
            self.tick, tick_frames, fence=self._fence_wait
        )
        self._drain_replies()
        got = self.transport.recv_tick(self.tick, deadline)
        _stage("exchange")

        inbox = self._assemble_inbox(self._last_out, got)
        _stage("inbox")
        inputs = self._build_inputs(n_prop, vbase)
        self._pl = self._dispatch(inbox, inputs)
        _stage("dispatch")

        self._ingest_payloads(got)
        self._qread_expire()
        self._conf_progress()
        self._range_progress()
        self._health_tick()
        self._autopilot_tick()
        _stage("overlap")

        pl = self._pl
        self._pl = None
        fx = self._retire(pl)
        _stage("device_wait")
        self.flight.record(
            "device_step", tick=pl["tick"],
            dur_us=int((time.monotonic() - pl["t_dispatch"]) * 1e6),
            wait_us=stage_us["device_wait"],
        )
        self._apply_committed(fx)
        self._leader_edges(fx)
        _stage("apply")
        self._log_votes()
        self._fence_begin()
        _stage("log")

        self.flight.record("tick", tick=self.tick, pipelined=1, **stage_us)
        self._tick_end(t0, deadline)
        self._drain_replies_if_settled()

    def _pipeline_flush(self) -> None:
        """Settle the pipeline on graceful exit: retire any in-flight step
        (log/apply), then release everything gated on the fence."""
        pl = self._pl
        if pl is not None:
            self._pl = None
            fx = self._retire(pl)
            self._apply_committed(fx)
            self._leader_edges(fx)
            self._log_votes()
        self._fence_begin()
        self._drain_replies()

    # -------------------------------------------------- payload exchange
    def _ingest_payloads(self, got) -> None:
        """Payload piggybacks are unioned across ALL frames a peer sent
        since our last tick (unlike kernel lanes, they are not
        cumulative); need requests are served next tick."""
        cw = self.codewords
        for src, fl in got.items():
            for f in fl or ():
                if self.health is not None and "hb" in f:
                    self.health.ingest(src, f["hb"], time.monotonic())
                for (g, vid), batch in f.get("pp", {}).items():
                    self.payloads.install(g, vid, batch, overwrite=False)
                    self.missing.discard((g, vid))
                    self._cw_first_missing.pop((g, vid), None)
                if cw is not None:
                    self._ingest_shards(src, f)
                for g, vid in f.get("need", []):
                    # values with shards here heal through the gossip
                    # plane, not by a full-copy serve
                    if cw is not None and cw.have_mask(g, vid):
                        continue
                    b = self.payloads.get(g, vid)
                    if b is not None:
                        self._pending_serve[(g, vid)] = b
                if f.get("kv_need") and not self.kv_need:
                    self._pending_kv_serve = True
                if "kv" in f and self.kv_need:
                    self._merge_kv(f["kv"], f["kv_floor"], f.get("kv_ep"),
                                   f.get("kv_wslots"))
                # near-quorum read queries and replies (quorumread.rs)
                for rid, key, g in f.get("rq", ()):
                    self._pending_rqr.setdefault(src, []).append(
                        (rid,) + self._local_read_sample(g, key)
                    )
                for rid, value, wslot, hit in f.get("rqr", ()):
                    qr = self._qreads.get(rid)
                    if qr is not None and src not in qr["replies"]:
                        qr["replies"][src] = (value, wslot, hit)
                        self._qread_check(rid)

    def _ingest_shards(self, src: int, f: dict) -> None:
        """One frame's codeword parts: ``ps`` rows are this replica's
        assignment (vote-loggable), ``cw`` gossip fills are not; the
        ``cw_need`` requests are answered next tick from held shards
        (non-urgent ones with our own base slice only, so the heal load
        stays spread over the peers)."""
        cw = self.codewords
        for key in ("ps", "cw"):
            for (g, vid), sp in (f.get(key) or {}).items():
                cw.add_shards(g, vid, sp.data_len, sp.shards,
                              assigned=(key == "ps"))
                self.payloads.note_seen(g, vid)
        own = assigned_sids(self.me, self._cw_dj, self._cw_dj, cw.T)
        for g, vid, have, urgent in f.get("cw_need", ())[:64]:
            held = cw.shards_for(g, vid, exclude_mask=have,
                                 only_sids=None if urgent else own)
            if held is not None:
                sp = ShardPayload(held[0], held[1])
                self._pending_cw.setdefault(src, {})[(g, vid)] = sp
                self.cw_bytes[src] += _sp_size(sp)

    def _merge_kv(self, kv: dict, floors: list,
                  ep_floors: Optional[list] = None,
                  wslots: Optional[dict] = None) -> None:
        """Install-snapshot KV merge, guarded per group: only groups that
        jumped take the provider's state, and only when the provider's
        floor covers ours.  EPaxos: the provider must be ahead or equal
        on every row (a sum-ahead provider lagging one row would regress
        that row's keys), and its row floors ride along so the executor
        jumps past instances that slid out of the stored-copy window."""
        def dominates(g: int) -> bool:
            if g >= len(floors) or floors[g] <= self.applied[g]:
                return False
            if not self._epaxos:
                return True
            if ep_floors is None or g >= len(ep_floors):
                return False
            return all(int(p) >= lo for p, lo in
                       zip(ep_floors[g], self._ep_exec[g].floor))

        ok_groups = {g for g in self.kv_need if dominates(g)}
        if not ok_groups:
            return
        upd = {k: v for k, v in kv.items() if self.route_group(k) in ok_groups}
        self.statemach._kv.update(upd)
        # the jump bypasses the per-slot apply, so the commit feed
        # carries the transferred values too
        for k, v in upd.items():
            self._note_put(k, v)
        for k in upd:
            slot = (wslots or {}).get(k)
            if slot is not None:
                self._wslot[k] = max(self._wslot.get(k, -1), int(slot))
        for g in ok_groups:
            self.applied[g] = max(self.applied[g], int(floors[g]))
            if self._epaxos:
                ex = self._ep_exec[g]
                ex.floor = [max(a, int(b)) for a, b in
                            zip(ex.floor, ep_floors[g])]
                ex.lost_rows = []
                self.applied[g] = max(self.applied[g], sum(ex.floor))
            self.kv_need.discard(g)

    # ------------------------------------------------------- application
    def _make_ep_apply(self, g: int):
        """The EPaxos executor's apply callback for group ``g``: WAL-log
        the exec record, apply to the KV, reply to the clients we
        proposed for (parity: epaxos/execution.rs commit_execute)."""
        def apply_fn(row: int, col: int, vid: int, noop: bool) -> None:
            batch = (None if (noop or vid == 0)
                     else self.payloads.get(g, vid))
            self._wal_append(("eapply", g, row, col, vid, batch))
            if batch is None:
                return
            self.traces.mark_committed(g, vid, self.tick)
            self.flight.record("commit", g=g, vid=vid, row=row, col=col,
                               tick=self.tick)
            mine = (g, vid) in self.origin
            for client, req in batch:
                res = apply_command(self.statemach._kv, req.cmd)
                if req.cmd.kind == "put":
                    self._note_put(req.cmd.key, req.cmd.value)
                if mine:
                    self._reply_queue.append((client, ApiReply(
                        "reply", req_id=req.req_id, result=res,
                    )))
            self.metrics.counter_add("commits_applied_total", len(batch))
            self.traces.mark_applied(g, vid, self.tick)
            self.flight.record("apply", g=g, vid=vid, row=row, col=col,
                               tick=self.tick)
            if mine:
                self._trace_replied.append((g, vid))
        return apply_fn

    def _apply_committed_epaxos(self) -> None:
        """Run each group's Tarjan executor over its committed-but-
        unexecuted instances (the ``ep_exec`` stage, a part of
        ``apply``); a payload still missing blocks its instance and is
        asked for, a row that slid out of the window asks for the KV."""
        t0 = time.monotonic()
        me = self.me
        cmt = self._np_state("cmt_row")[:, me]
        arrs = None
        for g in range(self.G):
            ex = self._ep_exec[g]
            if int(cmt[g].sum()) <= sum(ex.floor):
                continue
            if arrs is None:
                arrs = {k: self._np_state(k)[:, me]
                        for k in ("abs2", "st2", "seq2", "val2", "noop2",
                                  "deps2")}

            def payload_ok(vid: int, noop: bool, g=g) -> bool:
                if noop or vid == 0:
                    return True
                if self.payloads.get(g, vid) is None:
                    self.missing.add((g, vid))
                    return False
                return True

            ex.advance(arrs["abs2"][g], arrs["st2"][g], arrs["seq2"][g],
                       arrs["val2"][g], arrs["noop2"][g], arrs["deps2"][g],
                       cmt[g], payload_ok)
            if ex.lost_rows:
                # committed instances slid out of our stored-copy window
                # (paused or cut off too long): catch up through the KV
                # install plane, as the frontier kernels do
                self.kv_need.add(g)
            self.applied[g] = sum(ex.floor)
        self.metrics.observe("loop_stage_us",
                             int((time.monotonic() - t0) * 1e6),
                             stage="ep_exec")

    def _apply_committed(self, fx: HostEffects) -> None:
        self._last_extra = dict(fx.extra)
        if self._epaxos:
            self._apply_committed_epaxos()
            return
        cbs = fx.commit_bar[:, self.me]
        self._last_cbar = cbs
        applied = np.asarray(self.applied)
        for g in np.nonzero(cbs > applied)[0]:
            self._apply_group(int(g), int(cbs[g]))

    def _apply_group(self, g: int, cb: int) -> None:
        if g in self.kv_need:
            # a window jump is pending its KV transfer: hold the floor
            return
        win_abs = self._np_state("win_abs")[g, self.me]
        win_val = self._np_state(self.kernel.VALUE_WINDOW)[g, self.me]
        # marker lanes whose slots carry non-payload values
        marker = np.zeros_like(win_abs, bool)
        for lane in ("win_cfg", "win_noop"):
            if lane in self.state:
                marker |= self._np_state(lane)[g, self.me] != 0
        while self.applied[g] < cb:
            slot = self.applied[g]
            pos = np.where(win_abs == slot)[0]
            if len(pos) == 0:
                # below the window: fetch the KV state from peers; the
                # provider's floor moves applied[g] with the merge
                self.kv_need.add(g)
                return
            vid = 0 if bool(marker[pos[0]]) else int(win_val[pos[0]])
            if vid != 0:
                # the slot passed under the commit bar, on every replica
                self.traces.mark_committed(g, vid, self.tick)
                self.flight.record("commit", g=g, vid=vid, slot=slot,
                                   tick=self.tick)
            batch = self._resolve_payload(g, vid)
            if vid != 0 and batch is None:
                self.missing.add((g, vid))
                return  # stall the exec floor until the payload arrives
            # durability before client-visible effects: the apply record
            # lands now, the group commit runs before the reply leaves
            self._wal_append((g, slot, vid, batch))
            if batch is not None:
                mine = (g, vid) in self.origin
                for client, req in batch:
                    if req.cmd is not None and req.cmd.kind == "adopt":
                        # the replicated range adoption executes at its
                        # destination-group slot on every replica; the
                        # proposer announces it to the manager
                        self._apply_adopt(req.cmd.value, announce=mine)
                        continue
                    if req.cmd.kind == "scan" and client is None:
                        # a scan barrier marker: no effect anywhere; its
                        # proposer reads the cut when the last group's
                        # marker lands
                        if mine:
                            self._scan_barrier_hit(g, req.req_id)
                        continue
                    if req.cmd.kind == "put":
                        fg = self._handoff_floor(g, req.cmd.key)
                        if fg is not None:
                            if slot < fg:
                                # a write to a moved-away range in its old
                                # group's log, below the handoff floor:
                                # its value rode the adopt, so it is
                                # acked without applying
                                if mine:
                                    self._reply_queue.append((
                                        client, ApiReply(
                                            "reply", req_id=req.req_id,
                                            result=CommandResult("put"),
                                        ),
                                    ))
                                continue
                            pf_warn(logger, f"post-floor write to moved "
                                            f"range at g{g} slot {slot} "
                                            f"key {req.cmd.key!r}: applying")
                    res = apply_command(self.statemach._kv, req.cmd)
                    if req.cmd.kind == "put":
                        k = req.cmd.key
                        self._wslot[k] = max(slot,
                                             self._wslot.get(k, -1) + 1)
                        self._note_put(k, req.cmd.value)
                    if mine:
                        self._reply_queue.append((client, ApiReply(
                            "reply", req_id=req.req_id, result=res,
                        )))
                self.metrics.counter_add(
                    "commits_applied_total", len(batch)
                )
                self.traces.mark_applied(g, vid, self.tick)
                self.flight.record("apply", g=g, vid=vid, slot=slot,
                                   tick=self.tick)
                if mine:
                    self._trace_replied.append((g, vid))
            self.applied[g] = slot + 1

    def _flush_durability(self) -> None:
        """Serial group commit: one fsync covers every record appended
        this tick, then the replies gated on them go out."""
        if self._wal_dirty:
            res = self.wal.do_sync_action(LogAction("sync"))
            if not res.offset_ok:
                # a failed fsync must NEVER release the replies gated on
                # it — crash instead; recovery replays what reached disk
                raise SummersetError(
                    f"WAL group-commit fsync failed: {res.entry}"
                )
            self._wal_dirty = False
        for client, reply in self._reply_queue:
            self._reply(client, reply)
        self._reply_queue.clear()
        self._flush_notes()
        self._mark_traces_replied()

    def _leader_edges(self, fx: HostEffects) -> None:
        is_l = self._last_extra.get("is_leader")
        if is_l is None:
            return
        self._is_leader = is_l[:, self.me].astype(bool)
        if "leader" in self.state:
            lead = self._np_state("leader")[:, self.me]
            self._leader_hint = np.where(
                (lead == self.me) & ~self._is_leader, -1, lead
            )
        # manager tracking follows group 0, level-based with a periodic
        # re-announce (an edge can be lost when leadership bounces
        # through a third replica while our own flag never flips)
        g0 = bool(self._is_leader[0])
        if g0 != self.was_leader:
            self.ctrl.send_ctrl(CtrlMsg("leader_status", {"step_up": g0}))
            self.was_leader = g0
            self._lead_announced = self.tick
        elif g0 and self.tick - self._lead_announced >= 200:
            self.ctrl.send_ctrl(CtrlMsg("leader_status", {"step_up": True}))
            self._lead_announced = self.tick


    # ------------------------------------------------------ gray failure
    def _health_tick(self) -> None:
        """Feed the scorer, and every ``health_eval_ticks`` ticks run the
        quorum-median outlier round.  An indicted leader steps down
        through the kernel's ``demote`` input (a QuorumLeases or Bodega
        leader first revokes its lease responders through the conf plane
        and restores them if the indictment clears meanwhile); an
        indicted responder stops serving local reads
        (``_can_local_read``).  With ``health_mitigation`` off the plane
        only scores."""
        h = self.health
        if h is None:
            return
        h.end_tick(self.metrics.gauge_value("api_queue_depth", 0.0))
        if self.tick % self.health_eval_ticks:
            return
        verdict = h.evaluate(time.monotonic())
        self.metrics.gauge_set(
            "health_score", verdict.scores.get(self.me, 1.0)
        )
        self._health_self_bad = self.me in verdict.indicted
        if not (self.health_mitigation and self._demote_supported):
            return
        if self._ap_demote_pending:
            return  # _autopilot_tick owns an autopilot-started revoke
        if self._demote_revoke_deadline is not None:
            # an in-flight lease revoke resolves either way
            conf_idle = self._conf_active is None and not self._conf_queue
            if not conf_idle and self.tick <= self._demote_revoke_deadline:
                return  # still installing
            self._demote_revoke_deadline = None
            restore = self._demote_restore_resp
            self._demote_restore_resp = None
            if verdict.evaluated and not self._health_self_bad:
                # a false alarm: cancel, and bring the responders back
                if restore:
                    self._handle_conf_req(None, ApiRequest(
                        "conf", conf_delta={"responders": restore},
                    ))
                return
            self._arm_demotion(verdict)
            return
        if not (verdict.evaluated and self._health_self_bad):
            return
        if self.tick < max(self._demote_cooldown_until, self._demote_until):
            return
        if not self._is_leader.any():
            return  # a responder's indictment only steers reads
        if self._conf_kind is not None:
            # revoke the read-lease responders first, so local reads
            # drain instead of riding lease expiry under a gone leader
            self._demote_restore_resp = self._current_responders()
            self._handle_conf_req(None, ApiRequest(
                "conf", conf_delta={"responders": []},
            ))
            self._demote_revoke_deadline = self.tick + 600
            pf_warn(logger, f"health: replica {self.me} (leader) indicted "
                            f"{verdict.outliers.get(self.me)}; revoking "
                            "leases before demotion")
            return
        self._arm_demotion(verdict)

    def _current_responders(self) -> List[int]:
        """The installed lease responders (group 0's conf), restored after
        a false alarm."""
        if self._conf_kind == "ql":
            bits = int(self._np_state("conf_cur")[0, self.me])
        elif self._conf_kind == "bodega":
            bits = int(self._np_state("conf_resp")[0, self.me, 0])
        else:
            return []
        if bits <= 0:
            return []
        return [r for r in range(self.population) if bits >> r & 1]

    def _arm_demotion(self, verdict) -> None:
        """Arm the kernel's ``demote`` input at this replica's rows and
        stamp the demotion (counter, flight event, log)."""
        self._demote_until = self.tick + self.health_demote_ticks
        self._demote_cooldown_until = (
            self._demote_until + self.health_cooldown_ticks
        )
        self.metrics.counter_add("leader_demotions")
        self.flight.record(
            "demote", tick=self.tick,
            signals=",".join(verdict.outliers.get(self.me, ())),
            score=verdict.scores.get(self.me, 0.0),
        )
        pf_warn(logger, f"health: replica {self.me} stepping down "
                        f"(outlier on {verdict.outliers.get(self.me)})")

    # ---------------------------------------------------------- autopilot
    def _autopilot_demote(self, reason: str) -> bool:
        """A voluntary demotion for the autopilot's ``lead_move``
        actuator, through the health plane's machinery (the same demote
        input, lease revoke and cooldown).  False when it cannot apply
        here: no demote input, cooldown, not a leader, or a revoke in
        flight."""
        if not self._demote_supported:
            return False
        if self._ap_demote_pending \
                or self._demote_revoke_deadline is not None:
            return False
        if self.tick < max(self._demote_cooldown_until, self._demote_until):
            return False
        if not self._is_leader.any():
            return False
        if self._conf_kind is not None:
            self._demote_restore_resp = self._current_responders()
            self._handle_conf_req(None, ApiRequest(
                "conf", conf_delta={"responders": []},
            ))
            self._demote_revoke_deadline = self.tick + 600
            self._ap_demote_pending = True
            pf_warn(logger, f"autopilot: replica {self.me} revoking "
                            f"leases before demotion ({reason})")
            return True
        self._ap_arm_demotion(reason)
        return True

    def _ap_arm_demotion(self, reason: str) -> None:
        """``_arm_demotion`` for the autopilot: the same input and pacing,
        attributed to the policy tier."""
        self._demote_until = self.tick + self.health_demote_ticks
        self._demote_cooldown_until = (
            self._demote_until + self.health_cooldown_ticks
        )
        self.metrics.counter_add("leader_demotions")
        self.metrics.counter_add("autopilot_actions", 1,
                                 actuator="lead_move")
        self.flight.record("autopilot_act", act="demote",
                           reason=str(reason), tick=self.tick)
        pf_warn(logger, f"autopilot: replica {self.me} stepping down "
                        f"({reason})")

    def _autopilot_tick(self) -> None:
        """Resolve an autopilot-started lease revoke: once the
        empty-responders conf installs (or its deadline passes), arm the
        demotion.  No false-alarm restore: the policy decided."""
        if not self._ap_demote_pending:
            return
        if self._demote_revoke_deadline is None:
            self._ap_demote_pending = False
            return
        conf_idle = self._conf_active is None and not self._conf_queue
        if not conf_idle and self.tick <= self._demote_revoke_deadline:
            return
        self._demote_revoke_deadline = None
        self._demote_restore_resp = None
        self._ap_demote_pending = False
        self._ap_arm_demotion("lease-revoke-complete")

    # ------------------------------------------------------- control plane
    def _handle_ctrl(self) -> Optional[bool]:
        msg = self.ctrl.try_recv_ctrl()
        if msg is None:
            return None
        if msg.kind == "pause":
            self.paused = True
            self.ctrl.send_ctrl(CtrlMsg("pause_reply"))
        elif msg.kind == "resume":
            self._resume()
            self.ctrl.send_ctrl(CtrlMsg("resume_reply"))
        elif msg.kind == "reset_state":
            if not msg.payload.get("durable", True):
                self.wal.stop()
                for path in (self.wal_path, self.snap_path):
                    try:
                        os.remove(path)
                    except OSError:
                        pass
            self.ctrl.send_ctrl(CtrlMsg("reset_reply"))
            return True
        elif msg.kind == "install_conf":
            self._install_conf(msg.payload)
        elif msg.kind == "range_change":
            # every replica seals at once; always acked, a refused change
            # (EPaxos, no vote window) too
            self._range_begin(dict(msg.payload.get("change") or {}))
            self.ctrl.send_ctrl(CtrlMsg("range_reply"))
        elif msg.kind == "install_ranges":
            self._install_ranges(msg.payload)
        elif msg.kind == "adopt_decision":
            # a grant pins the change against expiry; a refusal means it
            # expired under us
            rc_id = int(msg.payload.get("rc_id", 0))
            if msg.payload.get("ok"):
                if rc_id in self._range_sealed:
                    self._range_adopt_granted.add(rc_id)
            else:
                self._range_unseal(rc_id, why="adopt-refused")
        elif msg.kind == "fault_ctl":
            self._fault_ctl(msg.payload or {})
            self.ctrl.send_ctrl(CtrlMsg("fault_reply"))
        elif msg.kind == "autopilot_ctl":
            self.ctrl.send_ctrl(CtrlMsg(
                "autopilot_reply", self._autopilot_ctl(msg.payload or {})
            ))
        elif msg.kind == "metrics_dump":
            self.ctrl.send_ctrl(CtrlMsg(
                "metrics_reply", {"snapshot": self.metrics_snapshot()}
            ))
        elif msg.kind == "flight_dump":
            self.ctrl.send_ctrl(CtrlMsg("flight_reply", {
                "flight": self.flight_snapshot(
                    last_n=(msg.payload or {}).get("last_n")
                ),
            }))
        elif msg.kind == "take_snapshot":
            self._take_snapshot()
            self.ctrl.send_ctrl(CtrlMsg("snapshot_reply"))
            self.ctrl.send_ctrl(CtrlMsg(
                "snapshot_up_to", {"new_start": list(self.applied)}
            ))
        elif msg.kind == "leave":
            return False
        return None

    def _fault_ctl(self, p: dict) -> None:
        """Swap the fault specs of four planes: the message plane
        (``net``), the disk plane (``wal``), the clock skew (``skew``, the
        tick period's stretch factor; None or 1.0 heals) and the snapshot
        crash point (``snap_crash``, the number of coming snapshots that
        crash; 0 or None clears).  A key present with None clears its
        plane, an absent key leaves it."""
        seed = int(p.get("seed", 0))
        if "net" in p:
            self.transport.set_faults(p.get("net"), seed=seed)
        if "wal" in p:
            self.wal.set_faults(p.get("wal"), seed=seed)
        if "skew" in p:
            f = p.get("skew")
            self._tick_scale = float(f) if f else 1.0
        if "snap_crash" in p:
            self._snap_crash = int(p.get("snap_crash") or 0)

        def is_heal(k: str) -> bool:
            # net/wal heal with None and snap_crash with 0/None; only
            # skew heals at 1.0 (snap_crash=1 arms a crash point)
            v = p.get(k)
            if k == "skew":
                return v is None or v == 1.0
            return not v

        planes = sorted(k for k in ("net", "wal", "skew", "snap_crash")
                        if k in p)
        self.flight.record("fault_ctl", tick=self.tick,
                           planes=",".join(planes),
                           heal=all(is_heal(k) for k in planes))

    def _autopilot_ctl(self, p: dict) -> Dict[str, Any]:
        """One autopilot actuation: ``demote`` re-places leadership
        through the health plane's machinery, ``retune`` turns the live
        serving knobs (``api_max_batch``, ``pipeline``), ``announce``
        exports the driver's mode and cooldowns as gauges.  Returns what
        applied."""
        act = str(p.get("act", ""))
        applied: Dict[str, Any] = {"act": act, "ok": True}
        if act == "demote":
            applied["ok"] = self._autopilot_demote(
                str(p.get("reason", "autopilot"))
            )
        elif act == "retune":
            if "api_max_batch" in p:
                nb = max(1, int(p["api_max_batch"]))
                self.api_max_batch = nb
                self.external.max_batch_size = nb
                applied["api_max_batch"] = nb
            if "pipeline" in p:
                want = bool(p["pipeline"])
                if want != self.pipeline:
                    # settle the in-flight step before the loop switches
                    # tick bodies (this runs on the loop thread)
                    self._pipeline_flush()
                    self.pipeline = want
                applied["pipeline"] = want
            self.metrics.counter_add(
                "autopilot_actions", 1,
                actuator="pipeline" if "pipeline" in p else "batch",
            )
            self.flight.record(
                "autopilot_act", act="retune", tick=self.tick,
                **{k: p[k] for k in ("api_max_batch", "pipeline") if k in p},
            )
        elif act == "announce":
            self.metrics.gauge_set("autopilot_mode",
                                   1.0 if p.get("mode") == "act" else 0.0)
            for a, cd in (p.get("cooldowns") or {}).items():
                self.metrics.gauge_set("autopilot_cooldown", float(cd),
                                       actuator=str(a))
        else:
            applied["ok"] = False
        return applied

    def _telemetry_row(self) -> Dict[str, Any]:
        """This replica's device metric lanes, decoded from the host view
        of the last retired step (on the card, the pinned prefetch copy:
        a scrape never waits on an in-flight step)."""
        return dev_telemetry.snapshot_row(
            self._np_state(dev_telemetry.TELEM_KEY), self.me
        )

    def metrics_snapshot(self) -> dict:
        """The ``metrics_dump`` scrape: this replica's device metric lanes
        (``[G, K]`` block decoded per lane), the host registry and the
        last sampled slot traces; JSON-able."""
        for dst in range(self.population):
            if dst == self.me:
                continue
            self.metrics.gauge_set("pp_bytes", self.pp_bytes[dst], peer=dst)
            self.metrics.gauge_set("pp_items", self.pp_items[dst], peer=dst)
            self.metrics.gauge_set("cw_bytes", self.cw_bytes[dst], peer=dst)
        # per-key-range heat at the api seam: the top 8 as labeled gauges
        # and the bare total
        self.metrics.gauge_set("range_heat",
                               float(self._range_heat.total()))
        for k, n in self._range_heat.top(8):
            self.metrics.gauge_set("range_heat", float(n), key=k)
        self.flight.publish_drops(self.metrics)
        return {
            "me": self.me,
            "protocol": self.protocol,
            "tick": self.tick,
            "wire_codec": self.wire_codec,
            "pipeline": self.pipeline,
            "api_max_batch": self.api_max_batch,
            "applied": list(self.applied),
            "device": self._telemetry_row(),
            "host": self.metrics.snapshot(),
            "traces": self.traces.sampled(),
        }

    def flight_snapshot(self, last_n: Optional[int] = None) -> dict:
        """The ``flight_dump`` scrape: the recorder ring with its drop
        accounting, plus the progress header and the device lane
        totals."""
        out = self.flight.dump(last_n=last_n)
        out.update({
            "protocol": self.protocol,
            "tick": self.tick,
            "applied": list(self.applied),
            "device_lanes": self._telemetry_row()["lanes"],
        })
        return out

    def _resume(self) -> None:
        """Leave a pause.  The kernel's leases count ticks, and while this
        replica was paused its count stood still while its peers' ran
        on: a lease it held (or a leader-lease promise it counted on)
        may have lapsed at the grantor long ago, and another leader may
        have committed since.  So local reads stay off for
        ``_lease_ticks`` of its own ticks (the longest lease plus the
        margin) after the last frame sent during the pause can have been
        delivered (``OWED_FRAMES`` + 1 ticks: ``_peer_lanes`` hands out
        owed frames one per tick), by which time every lease granted
        before the resume has run out in its own count too.  The JAX
        server keeps serving from its pre-pause lease view (ROADMAP
        Queue 3)."""
        self.paused = False
        self._lease_hold_off = (self.tick + self.OWED_FRAMES + 1
                                + self._lease_ticks)

    def debug_state(self) -> dict:
        """One-line snapshot for wedge diagnosis."""
        me = self.me
        out = {
            "me": me,
            "tick": self.tick,
            "applied": list(self.applied),
            "kv_need": sorted(self.kv_need),
            "missing": sorted(self.missing),
            "paused": self.paused,
            "peers": self.transport.peers() if self.transport else [],
            "was_leader": self.was_leader,
            "wal_size": self.wal.size,
            "pp_bytes": list(self.pp_bytes),
            "pp_items": list(self.pp_items),
            "full_bytes": list(self.full_bytes),
            "full_items": list(self.full_items),
            "cw_bytes": list(self.cw_bytes),
        }
        if self.codewords is not None:
            out["cw_vids"] = [self.codewords.size(g) for g in range(self.G)]
        if self._epaxos:
            out["ep_floor"] = [list(self._ep_exec[g].floor)
                               for g in range(self.G)]
        for k in (
            "leader", "commit_bar", "exec_bar", "vote_bar", "bal_max",
            "bal_prepared", "next_slot", "dur_bar", "term", "voted_for",
            "conf_cur", "conf_leader",
        ):
            if k in self.state:
                out[k] = self._np_state(k)[:, me].tolist()
        return out

    def shutdown(self) -> None:
        # idempotent: reachable from both the crash-restart loop and an
        # external harness stop; tolerates a half-built replica
        if getattr(self, "_shutdown_done", False):
            return
        self._shutdown_done = True
        for hub, close in (
            (getattr(self, "external", None), "stop"),
            (getattr(self, "transport", None), "close"),
            (getattr(self, "wal", None), "stop"),
            (getattr(self, "ctrl", None), "close"),
        ):
            if hub is not None:
                getattr(hub, close)()
