"""Compartmentalized serving plane: stateless ingress proxies + a
learner read tier in front of the replica shards, counterpart of
``summerset_tpu/host/ingress.py``.

Motivation (PAPERS.md "Scaling Replicated State Machines with
Compartmentalization", "HT-Paxos"): the fused ``ServerReplica`` process
pins the whole group's ingress at one ``ExternalApi``'s ``api_max_batch``
drain rate — one process owns accept, dedupe, batching, shedding, AND
consensus.  This module decouples those roles into independently
scalable stateless tiers, the frontend/router-vs-model-shard split of an
inference serving stack:

- :class:`IngressProxy` — N stateless processes, each owning its OWN
  ``ExternalApi`` instance (same listener/servant/bounded-queue/shed
  machinery, under the ``proxy_*`` metric namespace).  A proxy accepts
  client connections, **dedupes** by ``(client, req_id)`` (a bounded
  replay cache answers retried-already-replied requests locally),
  **batches** accepted ops, and **routes** them to per-group owner
  shards through a :class:`RoutingTable` built on
  ``utils/keyrange.KeyRangeMap``.  The forwarded unit is ONE
  ``ApiRequest("batch")`` per owner per cycle — one slot in the shard's
  bounded ingress queue regardless of how many client ops it aggregates,
  which is exactly the fan-in amortization that moves the shed point off
  the shard and onto the proxy tier (visible as ``api_shed`` staying
  flat while ``proxy_shed`` absorbs the overload).

- the **learner read tier** (:class:`LearnerReadTier`, one per proxy) —
  subscribes to a non-proposer replica's commit feed
  (``ApiRequest("sub")`` -> snapshot + ordered ``"note"`` streams of
  applied puts) and serves gets from its learned state, gated by a
  per-read freshness **probe**: the upstream replica answers — on its
  own tick thread, exactly where the fused lease-read decision is made —
  whether a lease-local read of that key's group is allowed right now,
  plus the feed seq its applied state corresponds to.  Because probe
  replies and notes ride ONE writer FIFO, a probe reply's arrival
  implies every note up to its seq has been learned, so "serve iff
  ``lease_ok`` and ``learned_seq >= probe_seq``" inherits the identical
  lease-safety argument as the replica's own ``_can_local_read`` path —
  and the value bytes never touch the proposer.

- :class:`ServingPlane` — the assembly: brings up N proxies (plus read
  tiers) in front of a live cluster and exposes per-tier scrape /
  flight / crash-restart handles for benches, soaks, and the
  ``proxy_crash`` nemesis class.  **Fused single-process mode remains
  the default everywhere**: with zero proxies constructed, no wire
  message changes shape, no client behavior changes, and every existing
  test/bench/soak digest is untouched (clients only enter proxy mode
  when the manager actually lists registered proxies).

The port keeps the JAX module's classes, constants and wire behaviour.
Its one difference is the embedded ``ExternalApi``: the port's has no
batch ticker, so ``get_req_batch`` wakes on the first queued request and
``tick_interval`` bounds the forward loop's wait only.  A proxy touches
no accelerator and this module imports no ``torch``: a proxy process
(``cli/proxy.py``) never makes a CUDA context.

Failure semantics: a proxy registers with the manager over its ctrl
connection (``CtrlRequest("proxy_join")``) and is deregistered the
moment that connection drops — client rediscovery after a proxy crash is
one ``query_info`` away (the ``rotate``/backoff machinery clients
already have).  A proxy NEVER retries an op after it was sent upstream
unless the shard explicitly refused it without proposing (redirect /
shed): re-sending a possibly-proposed put would double-execute it, which
the workload soak's linearizability checker would correctly flag.  Ops
stranded by an upstream or proxy death surface as client timeouts and
are recorded unacked — the same contract as a fused-server crash.
"""

from __future__ import annotations

import bisect
import collections
import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..utils import safetcp, wirecodec
from ..utils.errors import SummersetError
from ..utils.keyrange import KeyRangeMap
from ..utils.logging import pf_info, pf_logger, pf_warn
from .external import ExternalApi
from .messages import ApiReply, ApiRequest, CtrlRequest
from .resharding import RangeHeat
from .statemach import CommandResult
from .telemetry import MetricsRegistry, PROXY_DECLARED
from .tracing import FlightRecorder

logger = pf_logger("ingress")

#: learner connections offset their wire identity by this so a proxy's
#: forward and learner connections to the SAME shard never collide in
#: the shard ExternalApi's per-client writer table (manager-assigned
#: cids start at 1000 and increment; collision would need 500k clients)
LEARNER_ID_OFFSET = 500_000


def scrape_proxy(addr: Tuple[str, int], timeout: float = 5.0
                 ) -> Optional[dict]:
    """One-shot per-tier scrape of a live ingress proxy over its data
    plane (``ApiRequest("stats")``): returns the proxy's
    ``metrics_snapshot()`` dict, or None when unreachable — best-effort
    like ``scrape_metrics``, so bench artifact writers never die on
    their own diagnostics."""
    try:
        sock = socket.create_connection(tuple(addr), timeout=timeout)
        try:
            sock.settimeout(timeout)
            safetcp.send_msg_sync(sock, SCRAPE_CLIENT_ID)
            safetcp.send_msg_sync(sock, ApiRequest("stats", req_id=1))
            while True:
                rep = safetcp.recv_msg_sync(sock)
                if getattr(rep, "kind", None) == "stats":
                    return rep.notes
        finally:
            sock.close()
    # graftlint: disable=H106 -- best-effort diagnostics by contract: the
    # None return IS the signal (docstring above), and bench artifact
    # writers must never die on their own scrape
    except Exception:
        return None


#: wire identity scrape connections present (outside the manager cid,
#: learner, and fleet id bands)
SCRAPE_CLIENT_ID = 900_000


class RoutingTable:
    """Proxy-side routing state: a ``KeyRangeMap`` from key ranges to
    owner shard ids, the server address book, and the lease-responder
    conf (for read-tier upstream selection).

    Updates swap immutable maps (build-then-assign), so readers on the
    forward/pump threads never see a half-built table and no lock is
    held on the routing hot path.  The default map is one full range
    owned by the cluster leader — deployments with per-range ownership
    (the manager's ``RespondersConf`` generalizes to key ranges) install
    finer ranges through :meth:`set_owner` and the lookup cost stays one
    bisect either way.
    """

    def __init__(self) -> None:
        self.version = 0
        self.servers: Dict[int, Tuple[str, int]] = {}
        self.leader: Optional[int] = None
        self.responders: List[int] = []
        self._owners: KeyRangeMap = KeyRangeMap()
        self._overrides: List[Tuple[str, Optional[str], int]] = []
        # manager-announced installed ranges (live resharding): replaced
        # wholesale on refresh, applied below manual overrides
        self._ranges: List[Tuple[str, Optional[str], int]] = []
        self._hint_fresh_until = 0.0

    # -- update side (refresher thread + redirect hints) ------------------
    def update(self, servers: Dict[int, Tuple[str, int]],
               leader: Optional[int],
               responders: Optional[List[int]] = None) -> None:
        self.servers = dict(servers)
        # a data-plane redirect hint is FRESHER than the manager's view
        # (which can lag a whole election): a recent note_leader wins
        # over a conflicting manager refresh for a short grace window,
        # or post-crash forwards would flap back to the dead leader
        # every refresh until the manager catches up
        hint_fresh = (
            time.monotonic() < self._hint_fresh_until
            and self.leader in self.servers
        )
        if (leader is not None or self.leader not in self.servers) \
                and not (hint_fresh and leader != self.leader):
            self.leader = leader
        if responders is not None:
            self.responders = [int(r) for r in responders]
        self._rebuild()

    def note_leader(self, sid: Optional[int]) -> None:
        """Fold a data-plane redirect hint into the owner map (the
        freshest leadership signal available — the manager's view can
        lag a whole election)."""
        if sid is not None and sid >= 0:
            self._hint_fresh_until = time.monotonic() + 2.0
            if sid != self.leader:
                self.leader = int(sid)
                self._rebuild()

    def set_owner(self, start: str, end: Optional[str], sid: int) -> None:
        """Install a per-key-range owner override (kept across leader
        updates; later inserts overwrite overlapped spans — rangemap
        semantics).  Re-setting the same span replaces its entry instead
        of growing the override list without bound."""
        self._overrides = [
            o for o in self._overrides if (o[0], o[1]) != (start, end)
        ] + [(start, end, int(sid))]
        self._rebuild()

    def set_ranges(
        self, triples: List[Tuple[str, Optional[str], int]],
    ) -> None:
        """Replace the manager-announced installed-range set (live
        resharding, host/resharding.py) wholesale.  No-op when unchanged
        so the 0.5s refresh loop doesn't churn the routing version."""
        triples = [(s, e, int(sid)) for s, e, sid in triples]
        if triples == self._ranges:
            return
        self._ranges = triples
        self._rebuild()

    def _rebuild(self) -> None:
        m: KeyRangeMap = KeyRangeMap()
        default = self.leader
        if default is None or default not in self.servers:
            default = min(self.servers) if self.servers else None
        if default is not None:
            m.full_range(default)
        # overrides whose owner is gone from the address book fall back
        # to the default instead of wedging their range: _flush can
        # never resolve an upstream for a dead sid, and the leftover
        # would park every op in the range until the backlog shed
        for start, end, sid in self._ranges:
            if sid in self.servers:
                m.insert(start, end, sid)
        for start, end, sid in self._overrides:  # manual overrides win
            if sid in self.servers:
                m.insert(start, end, sid)
        self._owners = m  # atomic ref swap
        self.version += 1

    # -- lookup side (forward loop / pump threads) ------------------------
    def owner_for(self, key: str) -> Optional[int]:
        return self._owners.get(key)

    def write_target(self) -> Optional[int]:
        """Conf/default destination: the leader, else any known shard."""
        if self.leader is not None and self.leader in self.servers:
            return self.leader
        return min(self.servers) if self.servers else None

    def reader_sid(self) -> Optional[int]:
        """The read tier's upstream: a lease responder off the proposer
        path, else any non-leader replica (probes on a non-responder
        simply refuse, steering the read back to the owner) — never the
        leader, whose load is exactly what the tier exists to shed."""
        for r in self.responders:
            if r in self.servers and r != self.leader:
                return r
        rest = sorted(s for s in self.servers if s != self.leader)
        return rest[0] if rest else None


class _Upstream:
    """One forward connection proxy -> shard: a raw safetcp socket plus
    its reply pump thread.  All SENDS happen on the proxy's forward
    loop (single-writer — no per-socket lock needed, by construction);
    the pump only receives."""

    __slots__ = ("sid", "sock", "alive", "inflight", "pump")

    def __init__(self, sid: int, sock: socket.socket):
        self.sid = sid
        self.sock = sock
        self.alive = True
        self.inflight: set = set()  # outstanding batch ids (proxy lock)
        self.pump: Optional[threading.Thread] = None


class LearnerReadTier:
    """The learner half of the read tier, embedded one-per-proxy: a
    commit-feed subscription to a non-proposer replica plus the learned
    KV it maintains, serving probe-gated lease-local gets.

    Thread shape: this class's own thread owns (re)connecting, the
    subscription handshake, and the receive loop (notes + probe
    replies); probe SENDS come from the proxy's forward loop after the
    socket is published — the two never send concurrently because the
    socket is only published after the handshake writes finish, and is
    retired (``ready = False``) before any reconnect."""

    def __init__(self, proxy: "IngressProxy"):
        self.proxy = proxy
        self.kv: Dict[str, Any] = {}
        # ordered index over the learned keys (bisect-maintained,
        # learner thread only): the sorted view scans slice — one
        # insort per NEW key amortizes far below re-sorting per scan
        self._keys: List[str] = []
        self.seq = 0
        self.ready = False
        self.upstream: Optional[int] = None
        self._sock: Optional[socket.socket] = None
        self._probes: Dict[int, float] = {}  # prid -> deadline (proxy lock)
        self._live_sock: Optional[socket.socket] = None
        # probe refusal backoff: a protocol without held leases (or a
        # revoked responder) refuses EVERY probe — without this gate the
        # read tier would burn one shard queue slot per get just to be
        # told no, stealing ingress capacity from the write path under
        # exactly the overload the tier exists to absorb
        self._refuse_until = 0.0
        self.refusal_backoff_s = 0.5
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="ingress-learner"
        )
        self._thread.start()

    # -- forward-loop side ---------------------------------------------------
    def try_probe(self, prid: int, cmd) -> bool:
        """Route a get through the read tier: send a freshness probe on
        the learner connection.  Returns False (caller falls back to
        owner forwarding) when the tier is not ready."""
        if not self.ready:
            return False
        if time.monotonic() < self._refuse_until:
            return False  # recently refused: owner path serves reads
        sock = self._sock
        if sock is None:
            return False
        # book-keep BEFORE the send (same discipline as _send_batch): a
        # reply racing a post-send registration would find no probe
        # entry and silently drop the get
        with self.proxy._lock:
            self._probes[prid] = time.monotonic() + 2.0
            depth = len(self._probes)
        try:
            safetcp.send_msg_sync(
                sock, ApiRequest("probe", req_id=prid, cmd=cmd),
                codec=self.proxy.codec,
            )
        # graftlint: disable=H106 -- the False return IS the recorded
        # signal: ready drops, the probe entry is unwound, and the caller
        # routes the get through the owner path instead
        except Exception:
            self.ready = False
            with self.proxy._lock:
                self._probes.pop(prid, None)
            return False
        self.proxy.metrics.gauge_set("read_tier_backlog", depth)
        return True

    def _gauge_backlog(self) -> None:
        """Refresh the backlog gauge after probes SHRINK too — a gauge
        only written on insertion would stick at the burst high-water
        mark forever in the committed scrapes."""
        self.proxy.metrics.gauge_set(
            "read_tier_backlog", len(self._probes)
        )

    def expire_probes(self, now: float) -> None:
        """Drop probes that never answered (upstream wedged): the pend
        is dropped too — the client's own timeout/retry machinery owns
        recovery, and a late probe reply finds nothing to serve."""
        with self.proxy._lock:
            dead = [p for p, dl in self._probes.items() if now > dl]
            for p in dead:
                del self._probes[p]
        for p in dead:
            self.proxy._drop_pend(p)
        if dead:
            self._gauge_backlog()

    # -- learner-thread side -------------------------------------------------
    def _fail_outstanding(self) -> None:
        """Subscription died: fall every in-flight probe back to the
        owner-forward path (a probe is read-only — re-routing it can
        never double-execute anything)."""
        with self.proxy._lock:
            pend = list(self._probes)
            self._probes.clear()
        for prid in pend:
            self.proxy._requeue.append(prid)
        self._gauge_backlog()

    def _on_probe_reply(self, rep: ApiReply) -> None:
        with self.proxy._lock:
            dl = self._probes.pop(rep.req_id, None)
        self._gauge_backlog()
        if dl is None:
            return  # expired / failed over already
        if rep.kind == "probe" and rep.success and self.seq >= rep.seq:
            pend = self.proxy._pop_pend(rep.req_id)
            if pend is None:
                return
            cmd = pend["cmd"]
            if cmd.kind == "scan":
                # ordered range read off the learned state: the probe
                # verdict covered the WHOLE span (sealed-cutover overlap
                # + all-groups lease freshness), so the sorted-index
                # slice at learned_seq >= probe_seq is a linearizable
                # cut that never touched the proposer
                res = CommandResult(
                    "scan", items=self.scan_learned(
                        cmd.key, cmd.end, cmd.limit,
                    ),
                )
                self.proxy.metrics.counter_add("read_tier_scans")
                self.proxy.flight.record(
                    "scan_serve", client=pend["client"],
                    req_id=pend["req_id"], seq=self.seq,
                )
            else:
                res = CommandResult("get", value=self.kv.get(cmd.key))
                self.proxy.flight.record(
                    "read_serve", client=pend["client"],
                    req_id=pend["req_id"], seq=self.seq,
                )
            self.proxy.metrics.counter_add("read_tier_served")
            self.proxy._reply_client(pend, ApiReply(
                "reply", req_id=pend["req_id"],
                result=res, local=True,
            ))
        else:
            # no lease / not quiescent / shed: the owner-forward path
            # serves it (the same fallback the fused server takes), and
            # probing pauses briefly so a lease-less upstream is not
            # re-asked once per get
            self._refuse_until = (
                time.monotonic() + self.refusal_backoff_s
            )
            self.proxy._requeue.append(rep.req_id)

    def scan_learned(self, start: str, end: Optional[str],
                     limit: int) -> tuple:
        """Slice the ordered learned index over ``[start, end)`` —
        learner thread only (the index and kv mutate on this thread
        between receives, never under a scan)."""
        lo = bisect.bisect_left(self._keys, start)
        hi = (len(self._keys) if end is None
              else bisect.bisect_left(self._keys, end))
        keys = self._keys[lo:hi]
        if limit and limit > 0:
            keys = keys[:limit]
        return tuple((k, self.kv[k]) for k in keys)

    def _run(self) -> None:
        stop = self.proxy._stop
        while not stop.is_set():
            sid = self.proxy.routing.reader_sid()
            addr = self.proxy.routing.servers.get(sid) if sid is not None \
                else None
            if addr is None:
                stop.wait(0.3)
                continue
            sock = None
            try:
                sock = socket.create_connection(tuple(addr), timeout=2.0)
                self._live_sock = sock
                sock.settimeout(None)
                safetcp.send_msg_sync(
                    sock, self.proxy.cid + LEARNER_ID_OFFSET
                )
                safetcp.send_msg_sync(sock, ApiRequest("sub", req_id=0))
            # graftlint: disable=H106 -- connect/subscribe retry loop:
            # failure closes the half-open socket and retries after a
            # backoff; the tier simply stays not-ready until it lands
            except Exception:
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                stop.wait(0.5)
                continue
            self.upstream = sid
            try:
                while not stop.is_set():
                    rep = safetcp.recv_msg_sync(sock)
                    if not isinstance(rep, ApiReply):
                        continue
                    if rep.kind == "sub":
                        # snapshot installs BEFORE the socket is
                        # published for probes: a probe can never race a
                        # half-installed learner state
                        self.kv = dict(rep.notes or {})
                        self._keys = sorted(self.kv)
                        self.seq = int(rep.seq)
                        self._sock = sock
                        self.ready = True
                        pf_info(
                            logger,
                            f"read tier subscribed to replica {sid} "
                            f"(seq {self.seq}, {len(self.kv)} keys)",
                        )
                    elif rep.kind == "note":
                        for s, k, v in rep.notes or ():
                            if k not in self.kv:
                                bisect.insort(self._keys, k)
                            self.kv[k] = v
                        self.seq = max(self.seq, int(rep.seq))
                    else:  # probe verdicts (incl. shed/error fallbacks)
                        self._on_probe_reply(rep)
                    # bring-up can pick an upstream before the manager
                    # knows the leader; once routing learns this IS the
                    # proposer, resubscribe off it (the tier's whole
                    # point is reads that never touch the proposer)
                    better = self.proxy.routing.reader_sid()
                    if (
                        sid == self.proxy.routing.leader
                        and better is not None and better != sid
                    ):
                        break
            # graftlint: disable=H106 -- any recv/apply failure falls
            # through to the full teardown right below: ready drops, the
            # socket is unpublished, and _fail_outstanding() records the
            # failure to every waiting probe before the resubscribe
            except Exception:
                pass
            self.ready = False
            self._sock = None
            self._live_sock = None
            self.upstream = None
            self._fail_outstanding()
            try:
                sock.close()
            except OSError:
                pass
            stop.wait(0.5)

    def close(self) -> None:
        """Tear the subscription down NOW (proxy stop/crash): shutdown
        wakes the thread out of its blocked recv — a closed fd alone
        would not — so the upstream replica sees the connection drop and
        GCs this subscriber instead of buffering notes for a ghost."""
        sock = self._live_sock
        self.ready = False
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        self._thread.join(timeout=2)


class IngressProxy:
    """One stateless ingress proxy: accept + dedupe + batch + route.

    Bounded at every layer (the overload contract): the embedded
    ``ExternalApi``'s ``max_pending`` sheds at the front door under the
    ``proxy_*`` metric namespace; the internal forward backlog is capped
    at ``backlog_limit`` (when full, the front queue stops draining and
    fills, which is what arms the front-door shed); each upstream
    carries at most ``upstream_window`` un-acked batches of at most
    ``forward_batch`` commands — so a saturated shard backpressures the
    proxy instead of growing an unbounded queue anywhere.
    """

    def __init__(
        self,
        manager_addr: Tuple[str, int],
        api_addr: Tuple[str, int],
        *,
        max_batch: int = 4096,
        max_pending: int = 1024,
        forward_batch: int = 64,
        upstream_window: int = 4,
        backlog_limit: Optional[int] = None,
        tick_interval: float = 0.001,
        read_tier: bool = True,
        refresh_s: float = 0.5,
        dedupe_cap: int = 4096,
        retry_redirects: int = 3,
        pend_timeout: float = 15.0,
        flight_capacity: int = 4096,
        codec: Optional[bool] = None,
    ):
        from ..client.endpoint import ClientCtrlStub

        self.manager_addr = tuple(manager_addr)
        self.api_addr = (str(api_addr[0]), int(api_addr[1]))
        # wire codec for the tier's hot hops: client-facing replies (the
        # embedded ExternalApi below) AND the upstream forward batches /
        # read-tier probes.  None = process default; ingress of either
        # format dispatches per frame (utils/wirecodec.py)
        self.codec = (
            wirecodec.default_on() if codec is None else bool(codec)
        )
        self.forward_batch = max(1, int(forward_batch))
        self.upstream_window = max(1, int(upstream_window))
        self.backlog_limit = int(
            backlog_limit if backlog_limit is not None
            else 4 * self.forward_batch
        )
        self.tick_interval = float(tick_interval)
        self.refresh_s = float(refresh_s)
        self.dedupe_cap = max(16, int(dedupe_cap))
        self.retry_redirects = int(retry_redirects)
        self.pend_timeout = float(pend_timeout)

        self.metrics = MetricsRegistry()
        self.flight = FlightRecorder(capacity=flight_capacity)
        # pre-register the proxy-tier series (PROXY_DECLARED): zero must
        # read as "never happened", not "not measured" — the external
        # api contributes its namespace family below
        for name in ("proxy_requests_total", "proxy_replies_total",
                     "proxy_routed", "proxy_dedupe_hits",
                     "proxy_upstream_shed", "read_tier_served",
                     "read_tier_scans"):
            self.metrics.counter_add(name, 0)
        for name in ("proxy_backlog", "read_tier_backlog"):
            self.metrics.gauge_set(name, 0)
        # per-key-range heat lane (live resharding, host/resharding.py)
        self.metrics.gauge_set("range_heat", 0.0)
        self._range_heat = RangeHeat()

        # control plane: register with the manager; identity = ctrl cid
        # (liveness and registration share one socket — deregistration
        # IS the connection drop)
        self.ctrl = ClientCtrlStub(self.manager_addr)
        self.cid = self.ctrl.id
        self.flight.me = self.cid
        rep = self.ctrl.request(CtrlRequest(
            "proxy_join", payload={"api_addr": list(self.api_addr)},
        ))
        if not rep.done:
            raise SummersetError("manager refused proxy_join")
        self.routing = RoutingTable()
        self._stop = threading.Event()
        self._refresh_routing(timeout=10.0)

        # forward state (one proxy-wide lock; no blocking I/O inside it)
        self._lock = threading.Lock()
        self._pends: Dict[int, dict] = {}
        self._inflight: Dict[Tuple[int, int], int] = {}
        self._replied: "collections.OrderedDict" = collections.OrderedDict()
        self._batches: Dict[int, set] = {}
        self._bid_sid: Dict[int, int] = {}
        self._backlog: collections.deque = collections.deque()
        self._requeue: collections.deque = collections.deque()
        self._next_rid = 1
        self._next_gc = 0.0
        self._ups: Dict[int, _Upstream] = {}
        self._up_fail: Dict[int, float] = {}

        # the front door: the SAME ExternalApi class the fused server
        # runs, under the proxy metric namespace — accept, bounded
        # queue, shed hints, reply routing all inherited
        self.external = ExternalApi(
            self.api_addr, max_batch_size=max_batch, max_pending=max_pending,
            registry=self.metrics, flight=self.flight,
            metric_ns="proxy", codec=self.codec,
        )

        self.read_tier: Optional[LearnerReadTier] = (
            LearnerReadTier(self) if read_tier else None
        )
        self._fwd_thread = threading.Thread(
            target=self._forward_loop, daemon=True, name="ingress-fwd"
        )
        self._fwd_thread.start()
        self._refresh_thread = threading.Thread(
            target=self._refresh_loop, daemon=True, name="ingress-refresh"
        )
        self._refresh_thread.start()
        pf_info(
            logger,
            f"ingress proxy {self.cid} serving @ {self.api_addr}",
        )

    # ----------------------------------------------------------- control
    def _refresh_routing(self, timeout: float = 5.0) -> None:
        info = self.ctrl.request(CtrlRequest("query_info"),
                                 timeout=timeout)
        responders = None
        try:
            conf = self.ctrl.request(CtrlRequest("query_conf"),
                                     timeout=timeout)
            if conf.conf:
                responders = list(conf.conf.get("responders") or [])
        # graftlint: disable=H106 -- the responder conf is an optional
        # refinement: on failure responders stays None and the routing
        # update below still lands with the fresh server/leader info
        except Exception:
            pass
        self.routing.update(
            servers={
                int(sid): tuple(addrs[0])
                for sid, addrs in (info.servers or {}).items()
            },
            leader=info.leader,
            responders=responders,
        )
        # live resharding: installed ranges arrive on the SAME refresh
        # round (manager re-announce path).  Each installed range routes
        # to its per-group OWNER sid — the destination-group leader that
        # announced the install (the manager stamps it) — so steering
        # tracks where the range actually adopted instead of pinning
        # every range to the cluster-wide announced leader; entries
        # without an owner stamp (pre-stamp manager state) fall back to
        # the leader sid as before.
        triples = []
        for e in (getattr(info, "ranges", None) or ()):
            own = e.get("owner")
            sid = int(own) if own is not None else info.leader
            if sid is None:
                continue
            triples.append((e["start"], e.get("end"), int(sid)))
        if triples or info.leader is not None:
            self.routing.set_ranges(triples)

    def _refresh_loop(self) -> None:
        while not self._stop.wait(self.refresh_s):
            try:
                self._refresh_routing()
            # graftlint: disable=H106 -- manager mid-fault is the
            # expected cause: the proxy keeps serving off the cached
            # routing table and the next refresh tick retries
            except Exception:
                pass

    # ------------------------------------------------------ forward loop
    def _forward_loop(self) -> None:
        while not self._stop.is_set():
            try:
                drained = self._cycle()
            except Exception as e:  # never let the loop die silently
                pf_warn(logger, f"proxy forward cycle error: {e!r}")
                drained = False
            if not drained:
                # backlog full (or error): front queue keeps filling —
                # that is the designed backpressure — but this thread
                # must not spin while upstream windows stay closed
                time.sleep(self.tick_interval)

    def _cycle(self) -> bool:
        now = time.monotonic()
        if now >= self._next_gc:
            # coarse cadence: deadline GC walks every pend under the
            # lock — at a 1ms forward tick that sweep must not ride the
            # hot path whose drain rate the shed point measures
            self._next_gc = now + 0.25
            self._gc(now)
            if self.read_tier is not None:
                self.read_tier.expire_probes(now)
        while True:
            try:
                self._backlog.append(self._requeue.popleft())
            except IndexError:
                break
        drained = False
        if len(self._backlog) < self.backlog_limit:
            batch = self.external.get_req_batch(
                timeout=self.tick_interval
            )
            drained = True
            for client, req in batch:
                self._classify(int(client), req)
        self._flush(now)
        self.metrics.gauge_set("proxy_backlog", len(self._backlog))
        return drained

    def _mint(self, client: int, req: ApiRequest, kind: str) -> int:
        with self._lock:
            prid = self._next_rid
            self._next_rid += 1
            self._pends[prid] = {
                "client": client, "req_id": req.req_id, "kind": kind,
                "cmd": req.cmd, "conf_delta": req.conf_delta,
                "attempts": 0, "force": None,
                "deadline": time.monotonic() + self.pend_timeout,
                "bid": None, "sid": None,
            }
            self._inflight[(client, req.req_id)] = prid
        return prid

    def _classify(self, client: int, req: ApiRequest) -> None:
        key = (client, req.req_id)
        with self._lock:
            cached = self._replied.get(key)
            dup_inflight = cached is None and key in self._inflight
        if cached is not None:
            # dedupe: a retransmitted already-replied request replays
            # the cached reply without touching any shard
            self.metrics.counter_add("proxy_dedupe_hits")
            self.external.send_reply(cached, client)
            return
        if dup_inflight:
            # duplicate of an op still in flight: exactly one reply is
            # already on its way — forwarding again could double-propose
            self.metrics.counter_add("proxy_dedupe_hits")
            return
        if req.kind == "stats":
            # per-tier scrape over the data plane: works identically
            # for thread- and process-mode proxies (no manager change),
            # bypasses the bound like any control-plane op
            self.external.send_reply(ApiReply(
                "stats", req_id=req.req_id, success=True,
                notes=self.metrics_snapshot(),
            ), client)
            return
        if req.kind == "conf":
            self._backlog.append(self._mint(client, req, "conf"))
            return
        if req.kind == "scan" and req.cmd is not None:
            # "scan" as an ApiRequest kind normalizes to a Command
            # riding "req" — one pend shape for the whole forward path
            req = ApiRequest("req", req_id=req.req_id, cmd=req.cmd)
        if req.kind != "req" or req.cmd is None:
            self.external.send_reply(ApiReply(
                "error", req_id=req.req_id, success=False,
            ), client)
            return
        # per-key-range heat at the proxy seam (live resharding input)
        self._range_heat.note(req.cmd.key)
        prid = self._mint(client, req, "req")
        if (
            req.cmd.kind in ("get", "scan")
            and self.read_tier is not None
            and self.read_tier.try_probe(prid, req.cmd)
        ):
            return  # the learner serves it or falls it back to us
        self._backlog.append(prid)

    def _flush(self, now: float) -> None:
        if not self._backlog:
            return
        groups: Dict[int, List[int]] = {}
        confs: List[Tuple[int, int]] = []
        leftover: collections.deque = collections.deque()
        while self._backlog:
            prid = self._backlog.popleft()
            pend = self._pends.get(prid)
            if pend is None:
                continue
            if pend["kind"] == "conf":
                sid = self.routing.write_target()
                if sid is None:
                    leftover.append(prid)
                else:
                    confs.append((sid, prid))
                continue
            sid = pend["force"]
            if sid is None:
                sid = self.routing.owner_for(pend["cmd"].key)
            if sid is None:
                leftover.append(prid)
                continue
            groups.setdefault(sid, []).append(prid)
        for sid, prids in groups.items():
            up = self._upstream(sid, now)
            if up is None:
                # unreachable target: clear any redirect-derived force
                # so the NEXT cycle re-routes via the (refreshed) owner
                # map instead of pinning the op to a dead replica until
                # the pend GC
                for prid in prids:
                    pend = self._pends.get(prid)
                    if pend is not None:
                        pend["force"] = None
                leftover.extend(prids)
                continue
            i = 0
            while i < len(prids):
                if up is None or len(up.inflight) >= self.upstream_window:
                    leftover.extend(prids[i:])
                    break
                chunk = prids[i:i + self.forward_batch]
                i += len(chunk)
                if not self._send_batch(up, chunk):
                    up = None
                    leftover.extend(prids[i:])
                    break
        for sid, prid in confs:
            up = self._upstream(sid, now)
            if up is None or not self._send_conf(up, prid):
                leftover.append(prid)
        self._backlog = leftover

    def _send_batch(self, up: _Upstream, prids: List[int]) -> bool:
        with self._lock:
            bid = self._next_rid
            self._next_rid += 1
            entries = []
            for prid in prids:
                pend = self._pends.get(prid)
                if pend is None:
                    continue
                pend["sid"] = up.sid
                pend["bid"] = bid
                entries.append((prid, pend["cmd"]))
            if not entries:
                return True
            self._batches[bid] = {p for p, _ in entries}
            self._bid_sid[bid] = up.sid
            up.inflight.add(bid)
        try:
            safetcp.send_msg_sync(up.sock, ApiRequest(
                "batch", req_id=bid, batch=entries,
            ), codec=self.codec)
        # graftlint: disable=H106 -- send failure means the upstream is
        # gone: _kill_upstream records it (connect cooldown + stranding
        # its in-flight batches) and the False return re-queues nothing,
        # matching the fused-server-crash contract
        except Exception:
            self._kill_upstream(up)
            return False
        self.metrics.counter_add("proxy_routed", len(entries))
        # one hop event per forwarded batch: pairs with the shard's
        # api_ingress at (client == fwd_id, req_id == prid)
        self.flight.record(
            "proxy_fwd", sid=up.sid, prid=bid, n=len(entries),
            fwd_id=self.cid,
        )
        return True

    def _send_conf(self, up: _Upstream, prid: int) -> bool:
        pend = self._pends.get(prid)
        if pend is None:
            return True
        with self._lock:
            pend["sid"] = up.sid
        try:
            safetcp.send_msg_sync(up.sock, ApiRequest(
                "conf", req_id=prid, conf_delta=pend["conf_delta"],
            ))
        # graftlint: disable=H106 -- same contract as _send_batch: the
        # dead upstream is recorded by _kill_upstream and the caller
        # sees False
        except Exception:
            self._kill_upstream(up)
            return False
        self.flight.record(
            "proxy_fwd", sid=up.sid, prid=prid, n=1, fwd_id=self.cid,
        )
        return True

    # -------------------------------------------------- upstream plumbing
    def _upstream(self, sid: int, now: float) -> Optional[_Upstream]:
        up = self._ups.get(sid)
        if up is not None and up.alive:
            return up
        if now - self._up_fail.get(sid, 0.0) < 0.5:
            return None  # connect cooldown: no reconnect storm
        addr = self.routing.servers.get(sid)
        if addr is None:
            return None
        try:
            sock = socket.create_connection(tuple(addr), timeout=2.0)
            sock.settimeout(None)
            safetcp.send_msg_sync(sock, self.cid)
        # graftlint: disable=H106 -- connect failure is recorded in the
        # per-sid cooldown stamp (no reconnect storm) and the None
        # return routes the batch elsewhere or sheds it
        except Exception:
            self._up_fail[sid] = now
            return None
        up = _Upstream(sid, sock)
        up.pump = threading.Thread(
            target=self._pump, args=(up,), daemon=True,
            name=f"ingress-pump-{sid}",
        )
        self._ups[sid] = up
        up.pump.start()
        return up

    def _kill_upstream(self, up: _Upstream) -> None:
        up.alive = False
        try:
            up.sock.close()
        except OSError:
            pass
        with self._lock:
            if self._ups.get(up.sid) is up:
                del self._ups[up.sid]
            self._up_fail[up.sid] = time.monotonic()
            # strand this upstream's in-flight ops: a sent op may have
            # been proposed by the (probably dead) shard, so re-sending
            # could double-execute — clients time out and record unacked,
            # the same contract as a fused-server crash
            doomed: List[int] = []
            for bid in list(up.inflight):
                doomed.extend(self._batches.pop(bid, ()))
                self._bid_sid.pop(bid, None)
            up.inflight.clear()
            for prid in doomed:
                pend = self._pends.pop(prid, None)
                if pend is not None:
                    self._inflight.pop(
                        (pend["client"], pend["req_id"]), None
                    )

    def _pump(self, up: _Upstream) -> None:
        while up.alive and not self._stop.is_set():
            try:
                rep = safetcp.recv_msg_sync(up.sock)
            # graftlint: disable=H106 -- recv failure breaks to the
            # _kill_upstream below the loop, which records the death and
            # strands this upstream's in-flight ops
            except Exception:
                break
            if isinstance(rep, ApiReply):
                try:
                    self._on_reply(up, rep)
                except Exception as e:
                    pf_warn(logger, f"proxy reply handling error: {e!r}")
        self._kill_upstream(up)

    # --------------------------------------------------- reply handling
    def _detach(self, prid: int, pend: dict) -> None:
        """(lock held) Remove prid from its batch bookkeeping."""
        bid = pend.get("bid")
        if bid is None:
            return
        prids = self._batches.get(bid)
        if prids is not None:
            prids.discard(prid)
            if not prids:
                del self._batches[bid]
                sid = self._bid_sid.pop(bid, None)
                up = self._ups.get(sid)
                if up is not None:
                    up.inflight.discard(bid)
        pend["bid"] = None

    def _pop_pend(self, prid: int) -> Optional[dict]:
        with self._lock:
            pend = self._pends.pop(prid, None)
            if pend is None:
                return None
            self._inflight.pop((pend["client"], pend["req_id"]), None)
            self._detach(prid, pend)
        return pend

    def _drop_pend(self, prid: int) -> None:
        self._pop_pend(prid)

    def _reply_client(self, pend: dict, reply: ApiReply,
                      cache: bool = True) -> None:
        if cache:
            key = (pend["client"], pend["req_id"])
            with self._lock:
                self._replied[key] = reply
                while len(self._replied) > self.dedupe_cap:
                    self._replied.popitem(last=False)
        self.external.send_reply(reply, pend["client"])

    def _on_reply(self, up: _Upstream, rep: ApiReply) -> None:
        self.flight.record(
            "proxy_rcv", sid=up.sid, prid=rep.req_id, kind=rep.kind,
        )
        if rep.kind == "shed":
            # the shard refused (batch: the WHOLE batch; conf: one op)
            # before proposing — relay the negative ack + hint to every
            # affected client (shard-tier shed, attributable as such)
            with self._lock:
                prids = self._batches.pop(rep.req_id, None)
                self._bid_sid.pop(rep.req_id, None)
                up.inflight.discard(rep.req_id)
            targets = list(prids) if prids is not None else [rep.req_id]
            pends = [self._pop_pend(p) for p in targets]
            pends = [p for p in pends if p is not None]
            if pends:
                self.metrics.counter_add(
                    "proxy_upstream_shed", len(pends)
                )
            for pend in pends:
                self._reply_client(pend, ApiReply(
                    "shed", req_id=pend["req_id"], success=False,
                    retry_after_ms=rep.retry_after_ms,
                ), cache=False)
            return
        if rep.kind == "redirect":
            self.routing.note_leader(rep.redirect)
            give_up = False
            with self._lock:
                pend = self._pends.get(rep.req_id)
                if pend is None:
                    return
                pend["attempts"] += 1
                give_up = pend["attempts"] > self.retry_redirects
                if not give_up:
                    # refused WITHOUT proposing: re-forwarding is safe
                    self._detach(rep.req_id, pend)
                    pend["force"] = (
                        rep.redirect
                        if rep.redirect is not None and rep.redirect >= 0
                        else None
                    )
            if give_up:
                pend = self._pop_pend(rep.req_id)
                if pend is not None:
                    # hand the client a proxy-space rotate (no server id
                    # leaks through the tier boundary)
                    self._reply_client(pend, ApiReply(
                        "redirect", req_id=pend["req_id"],
                        redirect=None, success=False,
                    ), cache=False)
            else:
                self._requeue.append(rep.req_id)
            return
        if rep.kind in ("reply", "conf", "error"):
            pend = self._pop_pend(rep.req_id)
            if pend is None:
                return
            out = ApiReply(
                rep.kind if rep.kind != "error" else "error",
                req_id=pend["req_id"], result=rep.result,
                success=rep.success, local=rep.local,
            )
            self._reply_client(
                pend, out, cache=rep.kind in ("reply", "conf"),
            )

    # ------------------------------------------------------------- misc
    def _gc(self, now: float) -> None:
        with self._lock:
            dead = [
                p for p, pend in self._pends.items()
                if now > pend["deadline"]
            ]
        for prid in dead:
            self._drop_pend(prid)

    def metrics_snapshot(self) -> dict:
        self.metrics.gauge_set(
            "range_heat", float(self._range_heat.total())
        )
        for k, n in self._range_heat.top(8):
            self.metrics.gauge_set("range_heat", float(n), key=k)
        return {
            "cid": self.cid,
            "tier": "proxy",
            "api_addr": list(self.api_addr),
            "routing_version": self.routing.version,
            "read_tier_upstream": (
                self.read_tier.upstream
                if self.read_tier is not None else None
            ),
            "host": self.metrics.snapshot(),
        }

    def flight_snapshot(self, last_n: Optional[int] = None) -> dict:
        out = self.flight.dump(last_n=last_n)
        out["tier"] = "proxy"
        return out

    def stop(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        self.external.stop()
        if self.read_tier is not None:
            self.read_tier.close()
        for up in list(self._ups.values()):
            self._kill_upstream(up)
        try:
            self.ctrl.close()  # the manager deregisters on this close
        # graftlint: disable=H106 -- best-effort shutdown: a manager that
        # is already gone must not keep stop() from joining the forward
        # thread and releasing the port
        except Exception:
            pass
        self._fwd_thread.join(timeout=3)


class ServingPlane:
    """Assembly of the compartmentalized serving plane: N ingress
    proxies (each optionally carrying a learner read tier) in front of a
    live cluster, with per-tier scrape / flight / crash handles.

    ``proxies == 0`` IS fused mode: nothing is constructed, clients see
    no registered proxies, and every code path is byte-identical to the
    pre-split serving plane — which is why fused stays the default for
    all existing tests, benches, and soaks.
    """

    def __init__(
        self,
        manager_addr: Tuple[str, int],
        proxies: int = 2,
        *,
        host: str = "127.0.0.1",
        ports: Optional[List[int]] = None,
        read_tier: bool = True,
        proxy_config: Optional[dict] = None,
        mode: str = "thread",
        cpus: Optional[set] = None,
    ):
        self.manager_addr = tuple(manager_addr)
        self.n = int(proxies)
        self.host = host
        self.read_tier = bool(read_tier)
        self.cfg = dict(proxy_config or {})
        # "thread": proxies live in this process (soaks/tests — cheap
        # crash/restart/scrape handles); "process": each proxy is its
        # own OS process via cli/proxy.py — the deployment shape, and
        # what the >= 10k-client bench uses so the serving process's
        # GIL never pays for proxy-side pickling
        self.mode = str(mode)
        # optional CPU set for process-mode proxies: when the bench
        # co-locates every tier on one box, pinning the frontend off
        # the serving cores keeps the device scan's thread pool
        # uncontended (deployment puts proxies on separate hosts)
        self.cpus = set(cpus) if cpus else None
        if ports is None:
            ports = []
            socks = []
            for _ in range(self.n):
                s = socket.socket()
                s.bind((host, 0))
                socks.append(s)
                ports.append(s.getsockname()[1])
            for s in socks:
                s.close()
        self.ports = list(ports)
        self.proxies: List[Optional[IngressProxy]] = [None] * self.n
        self.procs: List[Optional[Any]] = [None] * self.n

    # ------------------------------------------------------ process mode
    _CFG_FLAGS = {
        "max_batch": "--max-batch",
        "max_pending": "--max-pending",
        "forward_batch": "--forward-batch",
        "upstream_window": "--upstream-window",
        "backlog_limit": "--backlog-limit",
        "tick_interval": "--tick-interval",
    }

    def _spawn(self, i: int):
        import subprocess
        import sys

        argv = [
            sys.executable, "-m", "summerset_tpu_torch.cli.proxy",
            "-m", f"{self.manager_addr[0]}:{self.manager_addr[1]}",
            "--bind-ip", self.host, "-a", str(self.ports[i]),
        ]
        for k, flag in self._CFG_FLAGS.items():
            if k in self.cfg and self.cfg[k] is not None:
                argv += [flag, str(self.cfg[k])]
        if not self.read_tier:
            argv.append("--no-read-tier")
        # the child finds this package from any working directory
        env = dict(os.environ)
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH")) if p
        )
        if self.cfg.get("codec") is not None:
            # wire-codec pin rides the env into the child (the same
            # SMR_WIRE_CODEC default the A/B bench flips process-wide)
            env["SMR_WIRE_CODEC"] = "1" if self.cfg["codec"] else "0"
        cpus = self.cpus

        def _deprioritize() -> None:
            # the stateless tier yields CPU to the device plane when
            # co-located on one box (deployment runs it on frontend
            # hosts; the bench must not let it slow the scan it meters)
            try:
                os.nice(5)
                if cpus and hasattr(os, "sched_setaffinity"):
                    os.sched_setaffinity(0, cpus)
            except OSError:
                pass

        return subprocess.Popen(
            argv, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            preexec_fn=_deprioritize, env=env,
        )

    def _wait_registered(self, want: int, timeout: float = 20.0) -> None:
        from ..client.endpoint import ClientCtrlStub

        stub = ClientCtrlStub(self.manager_addr)
        try:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                rep = stub.request(CtrlRequest("query_info"), timeout=5)
                if len(rep.proxies or {}) >= want:
                    return
                dead = {i: p.returncode for i, p in enumerate(self.procs)
                        if p is not None and p.poll() is not None}
                if dead:
                    raise SummersetError(
                        f"proxy processes exited before registering "
                        f"(index: exit code) {dead}"
                    )
                time.sleep(0.2)
            raise SummersetError(
                f"proxy tier never registered {want} proxies"
            )
        finally:
            stub.close()

    def start(self) -> "ServingPlane":
        if self.mode == "process":
            for i in range(self.n):
                if self.procs[i] is None:
                    self.procs[i] = self._spawn(i)
            self._wait_registered(self.n)
            return self
        for i in range(self.n):
            if self.proxies[i] is None:
                self.proxies[i] = IngressProxy(
                    self.manager_addr, (self.host, self.ports[i]),
                    read_tier=self.read_tier, **self.cfg,
                )
        return self

    @property
    def addrs(self) -> List[Tuple[str, int]]:
        return [(self.host, p) for p in self.ports]

    def crash_proxy(self, i: int) -> None:
        """Kill proxy ``i`` abruptly: its ctrl connection drops, the
        manager deregisters it, clients rediscover on their next
        rotate — the proxy_crash nemesis action."""
        if self.mode == "process":
            p = self.procs[i]
            self.procs[i] = None
            if p is not None:
                p.kill()
                p.wait(timeout=10)
            return
        p = self.proxies[i]
        self.proxies[i] = None
        if p is not None:
            p.stop()

    def restart_proxy(self, i: int) -> None:
        """Bring proxy ``i`` back on its original port (a fresh
        incarnation: empty dedupe cache, fresh routing — exactly what a
        process supervisor restart would produce)."""
        if self.mode == "process":
            if self.procs[i] is None:
                self.procs[i] = self._spawn(i)
            return
        if self.proxies[i] is None:
            self.proxies[i] = IngressProxy(
                self.manager_addr, (self.host, self.ports[i]),
                read_tier=self.read_tier, **self.cfg,
            )

    def proxy_ctl(self, action: str, spec: dict) -> None:
        """The ``NemesisRunner.proxy_ctl`` hook: play a plan's
        ``proxy_crash``/``proxy_restart`` on this plane (targets are
        proxy indices, taken modulo the plane's size)."""
        for idx in spec.get("proxies", ()):
            i = int(idx) % self.n
            if action == "proxy_crash":
                self.crash_proxy(i)
            else:
                self.restart_proxy(i)

    def pids(self) -> List[int]:
        """OS pids of the live process-mode proxies (none in thread
        mode)."""
        return [p.pid for p in self.procs if p is not None]

    def scrape(self) -> Dict[str, dict]:
        if self.mode == "process":
            out = {}
            for i, proc in enumerate(self.procs):
                if proc is None:
                    continue
                snap = scrape_proxy((self.host, self.ports[i]))
                if snap is not None:
                    out[f"p{i}"] = snap
            return out
        return {
            f"p{i}": p.metrics_snapshot()
            for i, p in enumerate(self.proxies) if p is not None
        }

    def flight_dumps(self, last_n: Optional[int] = None
                     ) -> Dict[str, dict]:
        """Per-proxy flight-recorder dumps for trace_export (the
        client→proxy→shard chain).  THREAD MODE ONLY: process-mode
        proxies keep their rings in their own address space and no
        remote dump channel exists yet — the empty result is flagged so
        a debugging session never mistakes it for an idle tier."""
        if self.mode == "process" and any(
            p is not None for p in self.procs
        ):
            pf_warn(
                logger,
                "flight_dumps: process-mode proxies have no remote "
                "flight channel; returning no events (use thread mode "
                "for proxy-hop traces)",
            )
        return {
            f"p{i}": p.flight_snapshot(last_n=last_n)
            for i, p in enumerate(self.proxies) if p is not None
        }

    def shed_counts(self) -> Dict[str, int]:
        """Per-proxy front-door shed counters (the proxy-tier half of
        shed attribution; the shard half is the api_shed scrape)."""
        if self.mode == "process":
            return {
                pid: snap.get("host", {}).get("counters", {})
                         .get("proxy_shed", 0)
                for pid, snap in self.scrape().items()
            }
        return {
            f"p{i}": p.metrics.counter_value("proxy_shed")
            for i, p in enumerate(self.proxies) if p is not None
        }

    def stop(self) -> None:
        for i, p in enumerate(self.proxies):
            self.proxies[i] = None
            if p is not None:
                p.stop()
        for i, proc in enumerate(self.procs):
            self.procs[i] = None
            if proc is not None:
                proc.terminate()
                try:
                    proc.wait(timeout=10)
                # graftlint: disable=H106 -- escalation IS the handling:
                # a child that ignores terminate for 10s gets kill()ed so
                # plane teardown always completes
                except Exception:
                    proc.kill()


# keep the declared proxy series and this module in lockstep (import
# side effect free; referenced here so a rename breaks loudly at import)
_ = PROXY_DECLARED
