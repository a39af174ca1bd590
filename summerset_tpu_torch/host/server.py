"""ServerReplica: a networked replica around the port's device kernel,
counterpart of ``summerset_tpu/host/server.py`` for MultiPaxos (with or
without leader leases), Raft, the codeword family (RSPaxos, CRaft,
Crossword) and the lease planes (QuorumLeases, Bodega).

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
package.  Unlike the JAX server, ``_can_local_read`` has no health
mitigation branch (health is not ported), and a resumed replica serves
no local read until every lease from before its pause has run out in
its own tick count (``_resume``).

Not in this slice (ROADMAP.md, Queue 1): EPaxos and the basic kernels'
serving, snapshots, near-quorum reads and scans, probes and
subscriptions, health/demotion and the autopilot's conf revokes,
resharding, the flight recorder and slot traces.
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
from ..utils.errors import SummersetError
from ..utils.logging import pf_info, pf_logger, pf_warn
from .adaptive import CrosswordAdaptive
from .codeword import CodewordStore, assigned_sids
from .control import ControlHub
from .external import ExternalApi
from .messages import ApiReply, ApiRequest, CtrlMsg, ShardPayload
from .payload import PayloadStore
from .statemach import StateMachine, apply_command
from .storage import LogAction, StorageHub
from .telemetry import MetricsRegistry
from .transport import TransportHub

logger = pf_logger("server")

#: protocols this slice serves; the rest name their ROADMAP Queue 1 item
SERVED = ("multipaxos", "raft", "rspaxos", "craft", "crossword",
          "quorumleases", "bodega")
_NOT_YET = {
    "epaxos": "1 (EPaxos serving)",
    "chainrep": "2 (ChainRep, SimplePush and RepNothing serving)",
    "simplepush": "2 (ChainRep, SimplePush and RepNothing serving)",
    "repnothing": "2 (ChainRep, SimplePush and RepNothing serving)",
}

# loop_stage_us stage names: the serial loop emits intake / exchange /
# step / log / apply; the pipelined loop replaces "step" with "inbox"
# (inbox lane assembly) + "dispatch" (inputs, the step launch and the
# prefetch) + "device_wait" (host blocked on the step's event) and adds
# "overlap" (host work coincident with the device step)
STAGES = ("intake", "exchange", "step", "log", "apply",
          "inbox", "dispatch", "device_wait", "overlap")

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
        key = protocol.lower()
        if key not in SERVED:
            item = _NOT_YET.get(key)
            raise SummersetError(
                f"protocol {protocol} is not served by the port's "
                "ServerReplica yet"
                + (f" (ROADMAP.md Queue 1 item {item})" if item else "")
                + f"; served: {', '.join(SERVED)}"
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
        self._kcfg = cfg
        # one registry threaded through every hub seam
        self.metrics = MetricsRegistry()

    def _setup_core(self, backer_dir: str) -> None:
        """Kernel, state on the device, WAL (recovered) and bookkeeping."""
        dev = self.device
        proto = self.protocol
        kercfg_cls = type(
            make_protocol(proto, 1, self.population, 32, device="cpu").config
        )
        known = {f.name for f in dataclasses.fields(kercfg_cls)}
        kcfg = kercfg_cls(
            **{k: v for k, v in self._kcfg.items() if k in known}
        )
        kcfg.exec_follows_commit = False
        kcfg.max_proposals_per_tick = 1  # one ReqBatch per group/tick
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
        self.wal = StorageHub(self.wal_path, registry=self.metrics)
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
        self._wal_dirty = False
        self._reply_queue: List[Tuple[int, ApiReply]] = []
        self.kv_need: Set[int] = set()     # groups that jumped past window
        self._pending_serve: Dict[Tuple[int, int], Any] = {}
        self._pending_kv_serve = False
        # per peer: frames whose lanes are still owed to some groups
        # (see _peer_lanes)
        self._owed: Dict[int, list] = {}
        self._setup_codewords()
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

        self._recover_from_wal()

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
                     "conf_resp", "conf_leader", dev_telemetry.TELEM_KEY))
        self._prefetch_keys = sorted(k for k in cand if k in self.state)
        self._np_cache = {}
        # outbox register the first tick's frames slice from (host views)
        self._last_out = {
            k: self._host(v) for k, v in self.kernel.zero_outbox().items()
        }

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
        # per-peer payload-plane egress (bytes and payload count of the
        # pp/ps frame parts; gossip replies in cw_bytes): bytes per item
        # is a full batch for full copies, ~batch/d for shard sends
        self.pp_bytes = [0] * self.population
        self.pp_items = [0] * self.population
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
        )
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
    def _recover_from_wal(self) -> None:
        """Replay the WAL: apply records rebuild payloads + KV + exec
        floors; the last durable record per group rebuilds the kernel
        row's acceptor state (parity: recovery.rs replay loop + raft
        durable curr_term/voted_for, raft/mod.rs:144-176)."""
        off = 0
        n = 0
        votes: Dict[int, dict] = {}
        while True:
            res = self.wal.do_sync_action(LogAction("read", offset=off))
            if not res.offset_ok or res.entry is None:
                break
            rec = res.entry
            if isinstance(rec, tuple) and rec and rec[0] == "snap_floor":
                raise SummersetError(
                    "WAL starts with a snap_floor marker: it was compacted "
                    "by a snapshot, and snapshots are not ported to "
                    "summerset_tpu_torch yet (ROADMAP.md Queue 1 item 3); "
                    "refusing to serve"
                )
            if isinstance(rec, tuple) and rec and rec[0] == "vote":
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
                        if req.cmd is not None:
                            apply_command(self.statemach._kv, req.cmd)
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
            # rebuild the rows on a host copy (thousands of small row
            # writes), then move the state to its device once
            st = {k: v.cpu() for k, v in self.state.items()}
            for g, v in votes.items():
                self.kernel.restore_durable(st, g, self.me, v,
                                            self.applied[g])
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
        """Release the queued replies, the fence waited FIRST (and again
        by ``ExternalApi.send_replies``)."""
        self._fence_wait()
        q = self._reply_queue
        if q:
            self._reply_queue = []
            self.external.send_replies(q, fence=self._fence_wait)

    def _intake(self) -> Tuple[np.ndarray, np.ndarray, Dict]:
        """Drain the client plane: queue conf changes, route puts and gets
        to groups, serve leased local gets, redirect what we don't lead,
        answer every other request kind with an error (request.rs:16-216
        redirects)."""
        n_prop = np.zeros((self.G,), np.int32)
        vbase = np.zeros((self.G,), np.int32)
        piggy: Dict[Tuple[int, int], Any] = {}
        batch = self.external.get_req_batch(timeout=0)
        if not batch:
            return n_prop, vbase, piggy
        by_group: Dict[int, list] = {}
        for client, req in batch:
            if req.kind == "conf":
                self._handle_conf_req(client, req)
            elif (req.kind != "req" or req.cmd is None
                    or req.cmd.kind not in ("put", "get")):
                self._reply(client, ApiReply(
                    "error", req_id=req.req_id, success=False,
                ))
            else:
                by_group.setdefault(
                    self.group_of(req.cmd.key), []
                ).append((client, req))
        cw_fallback = self._craft_fallback_groups() if by_group else None
        for g, reqs in by_group.items():
            if not self._is_leader[g]:
                # a lease holder with every key bucket quiescent answers
                # gets from applied state; the rest redirect
                local_ok = self._can_local_read(g)
                pending = []
                for client, req in reqs:
                    if local_ok and req.cmd.kind == "get":
                        self._reply_local(client, req)
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

    def _tail_writes_key(self, g: int, key: str) -> bool:
        """Does our voted-but-unexecuted window tail possibly hold a write
        to ``key``?  Every voted slot at or above the exec floor counts,
        with no upper bound (a higher-ballot run reset rewinds
        ``vote_bar`` without zeroing ``win_bal`` above it); a payload we
        cannot inspect counts as a hit."""
        win_abs = self._np_state("win_abs")[g, self.me]
        win_bal = self._np_state("win_bal")[g, self.me]
        win_val = self._np_state(self.kernel.VALUE_WINDOW)[g, self.me]
        tail = (win_bal > 0) & (win_abs >= self.applied[g])
        for vid in set(int(v) for v in win_val[tail]):
            if vid == 0:
                continue
            batch = self.payloads.get(g, vid)
            if batch is None:
                return True
            for _c, req in batch:
                if (req.cmd is not None and req.cmd.kind == "put"
                        and req.cmd.key == key):
                    return True
        return False

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
        shard sends, ``cw`` gossip replies, ``cw_need`` requests) and the
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
            "need": needs,
        }
        cw_need = self._cw_needs(needs) if self.codewords is not None else {}
        if self._pending_kv_serve:
            payload_msg["kv"] = self.statemach.snapshot_items()
            payload_msg["kv_floor"] = list(self.applied)
            self._pending_kv_serve = False
        ps_pend, self._pending_shards = self._pending_shards, {}
        cw_pend, self._pending_cw = self._pending_cw, {}
        tick_frames = {}
        for dst in frames:
            f = {"msg": frames[dst], **payload_msg}
            for key, part in (("ps", ps_pend), ("cw", cw_pend),
                              ("cw_need", cw_need)):
                if dst in part:
                    f[key] = part[dst]
            tick_frames[dst] = f
        if piggy:
            # full copies are identical per peer, sized as the frame
            # pickles them; shard sends and gossip replies were sized
            # when queued
            pp_len = len(pickle.dumps(piggy, pickle.HIGHEST_PROTOCOL))
            for dst in tick_frames:
                self.pp_bytes[dst] += pp_len
                self.pp_items[dst] += len(piggy)
        return tick_frames

    def _build_inputs(self, n_prop, vbase) -> Dict[str, Any]:
        """This tick's kernel step inputs: ``n_proposals``,
        ``value_base``, ``exec_floor``, the conf plane's inputs and
        (kernels declaring it) an all-false ``demote``, on the step's
        device."""
        floor = np.repeat(
            np.asarray(self.applied, np.int32)[:, None],
            self.population, axis=1,
        )
        arrays = {"n_proposals": n_prop, "value_base": vbase,
                  "exec_floor": floor}
        self._conf_inputs(arrays)
        if self._demote_supported:
            arrays["demote"] = np.zeros((self.G, self.population), bool)
        if self._adaptive is not None:
            # the choice that sliced this tick's shard sends
            arrays["spr_override"] = np.asarray(self._spr_tick, np.int32)
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

        def copy(name: str, t: torch.Tensor) -> torch.Tensor:
            b = bufs.get(name)
            if b is None or b.shape != t.shape or b.dtype != t.dtype:
                b = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                bufs[name] = b
            b.copy_(t, non_blocking=True)
            return b

        host = {
            "state": {k: copy("s:" + k, new_state[k])
                      for k in self._prefetch_keys},
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

        self._set_state(pl["state"],
                        {k: np_of(v) for k, v in host["state"].items()})
        self._last_out = {k: np_of(v) for k, v in host["out"].items()}
        return HostEffects(
            commit_bar=np_of(host["commit_bar"]),
            extra={k: np_of(v) for k, v in host["extra"].items()},
        )

    def _tick_end(self, t0: float, deadline: float) -> None:
        """Shared tick epilogue: advance the tick, sleep to the deadline."""
        self.tick += 1
        rem = deadline - time.monotonic()
        if rem > 0:
            time.sleep(rem)

    def _tick_serial(self, t0: float) -> None:
        """One strictly ordered tick: intake -> send/recv -> step (waited)
        -> WAL log -> group-commit fsync -> apply/reply."""
        _, _stage = self._stage_clock(t0)
        self._fold_adaptive()
        n_prop, vbase, piggy = self._intake()
        _stage("intake")

        frames = self._slice_outbox(self._last_out)
        deadline = t0 + self.tick_interval
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
        self._conf_progress()
        self._leader_edges(fx)
        _stage("apply")
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
        _, _stage = self._stage_clock(t0)
        deadline = t0 + self.tick_interval

        self._fold_adaptive()
        n_prop, vbase, piggy = self._intake()
        _stage("intake")

        frames = self._slice_outbox(self._last_out)
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
        self._conf_progress()
        _stage("overlap")

        pl = self._pl
        self._pl = None
        fx = self._retire(pl)
        _stage("device_wait")
        self._apply_committed(fx)
        self._leader_edges(fx)
        _stage("apply")
        self._log_votes()
        self._fence_begin()
        _stage("log")

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
                    self._merge_kv(f["kv"], f["kv_floor"])

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

    def _merge_kv(self, kv: dict, floors: list) -> None:
        """Install-snapshot KV merge, guarded per group: only groups that
        jumped take the provider's state, and only when the provider's
        floor covers ours."""
        ok_groups = {
            g for g in self.kv_need
            if g < len(floors) and floors[g] > self.applied[g]
        }
        if not ok_groups:
            return
        self.statemach._kv.update({
            k: v for k, v in kv.items() if self.group_of(k) in ok_groups
        })
        for g in ok_groups:
            self.applied[g] = max(self.applied[g], int(floors[g]))
            self.kv_need.discard(g)

    # ------------------------------------------------------- application
    def _apply_committed(self, fx: HostEffects) -> None:
        self._last_extra = dict(fx.extra)
        cbs = fx.commit_bar[:, self.me]
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
                    res = apply_command(self.statemach._kv, req.cmd)
                    if mine:
                        self._reply_queue.append((client, ApiReply(
                            "reply", req_id=req.req_id, result=res,
                        )))
                self.metrics.counter_add(
                    "commits_applied_total", len(batch)
                )
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
                try:
                    os.remove(self.wal_path)
                except OSError:
                    pass
            self.ctrl.send_ctrl(CtrlMsg("reset_reply"))
            return True
        elif msg.kind == "install_conf":
            self._install_conf(msg.payload)
        elif msg.kind == "leave":
            return False
        return None

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
            "cw_bytes": list(self.cw_bytes),
        }
        if self.codewords is not None:
            out["cw_vids"] = [self.codewords.size(g) for g in range(self.G)]
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
