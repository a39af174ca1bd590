"""Wire message types for the three TCP planes, counterpart of
``summerset_tpu/host/messages.py``.

Parity: reference ``ApiRequest``/``ApiReply`` (``src/server/external.rs:
33-183``), ``CtrlMsg`` (``src/manager/reigner.rs:30-83``), ``CtrlRequest``/
``CtrlReply`` (``src/manager/reactor.rs:29-105``).  Dataclasses are pickled
through the safetcp frames.  Field names and defaults equal the JAX
package's, but the pickled class paths differ, so a port cluster talks to
the port's client only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from .statemach import Command, CommandResult


# --------------------------------------------------------------- data plane
@dataclasses.dataclass(frozen=True)
class ApiRequest:
    """Client -> server (parity: ``ApiRequest::{Req, Conf, Leave}``).

    The port's server serves ``"req"`` puts, gets and scans (a scan also
    as the ``"scan"`` kind), ``"conf"`` changes (``conf_delta``:
    ``responders``, a list of replica ids, and on Bodega an optional
    ``leader``) and the read-tier kinds:

    - ``"sub"``   — a commit-feed subscription: the reply carries a full
      KV snapshot and the feed sequence number it covers, then every
      applied put streams as a ``"note"`` reply;
    - ``"probe"`` — a freshness probe for ``cmd``'s key (or scan span):
      may a lease-local read be served right now, and at which feed seq.

    Every other kind is answered with an ``"error"`` reply (``"leave"``
    is answered by the api plane itself).  ``batch`` (a proxy's
    ``[(proxy req id, Command)]`` forward) is a data field only: the
    port has no proxy tier yet.  Fields in the JAX declaration order (the
    wire codec's struct id 1)."""

    kind: str                      # "req" | "conf" | "leave" | "scan"
    #                              # | "sub" | "probe" | else: error
    req_id: int = 0
    cmd: Optional[Command] = None  # kind == "req" | "scan" | "probe"
    conf_delta: Optional[dict] = None  # kind == "conf"
    batch: Optional[list] = None   # kind == "batch": [(prid, Command)]


@dataclasses.dataclass(frozen=True)
class ApiReply:
    """Server -> client (parity: ``ApiReply``, external.rs:155-183).

    ``kind == "shed"`` is the ingress-backpressure negative ack: the
    bounded api queue was full and the request was refused before
    entering it, so it was never proposed; ``retry_after_ms`` hints when
    to retry.  ``rq_retry`` marks a near-quorum read that fell back to
    the leader (its redirect).  The commit feed: ``"sub"`` carries the
    KV snapshot in ``notes`` with ``seq`` the feed position it covers;
    ``"note"`` streams ``[(seq, key, value), ...]`` applied puts in apply
    order; ``"probe"`` answers ``success`` = the local-read verdict and
    the current ``seq``.  Fields in the JAX declaration order (the wire
    codec's struct id 2)."""

    kind: str   # "reply" | "conf" | "redirect" | "error" | "shed"
    #             | "leave" | "sub" | "note" | "probe"
    req_id: int = 0
    result: Optional[CommandResult] = None
    redirect: Optional[int] = None  # hinted leader id
    success: bool = True
    rq_retry: bool = False          # read-query retry hint
    local: bool = False             # served as a local read
    retry_after_ms: int = 0         # shed: suggested client backoff
    seq: int = 0                    # commit feed position
    notes: Optional[Any] = None     # sub: KV snapshot; note: the puts


# Server-to-server tick frames are plain dicts (host/server.py builds
# them, host/transport.py ships them): ``msg`` carries the kernel outbox
# slices; the payload plane rides alongside:
#   pp: {(group, vid): ReqBatch}            full-copy piggybacks
#   ps: {(group, vid): ShardPayload}        proposer -> peer assigned shards
#   cw: {(group, vid): ShardPayload}        gossip replies (held shards)
#   cw_need: [(group, vid, have_mask, urgent)]   shard-gossip requests
#   need: [(group, vid)]                    payloads this replica is missing
#   kv_need / kv / kv_floor: the install-snapshot plane
#   rq: [(rid, key, g)] / rqr: [(rid, value, wslot, tail hit)]
#                                           near-quorum read queries/replies
#   ts: the sender's time.monotonic() (delivery samples)
@dataclasses.dataclass(frozen=True)
class ShardPayload:
    """A subset of one value's RS codeword on the wire (parity role: the
    shard-subset ``RSCodeword`` carried by Accept and Reconstruct
    messages, ``rspaxos/mod.rs:597-608``)."""

    data_len: int        # original serialized ReqBatch byte length
    shards: Dict[int, Any] = dataclasses.field(default_factory=dict)
    # shard id -> [L] int32 lane array (4 packed bytes per lane)


# ------------------------------------------------------------ control plane
@dataclasses.dataclass(frozen=True)
class CtrlMsg:
    """Server <-> manager (parity: ``CtrlMsg``, reigner.rs:30-83).

    Kinds: new_server_join (protocol, api_addr, p2p_addr) ->
    connect_to_peers (population, to_peers {id: p2p_addr});
    leader_status (step_up); responders_conf (new_conf: the installed
    ``responders`` and, on Bodega, ``leader``); conf_forward (delta: a
    client ConfChange a server that does not lead every group relays) ->
    install_conf (delta, seq: the manager's total order, newest wins) to
    every server; pause / resume / reset_state (durable) /
    take_snapshot and their ``_reply`` forms; metrics_dump ->
    metrics_reply (snapshot), flight_dump -> flight_reply (flight);
    range_change -> range_reply (change), range_installed (entry),
    install_ranges (seq, installed, pending, expired), adopt_intent ->
    adopt_decision (rc_id, ok), range_expire (rc_id); autopilot_ctl ->
    autopilot_reply (act + actuator fields); fault_ctl -> fault_reply
    (net, wal, seed); watch_frame (one graftwatch delta frame, one-way);
    leave / leave_reply."""

    kind: str
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class CtrlRequest:
    """Client -> manager (parity: ``CtrlRequest``, reactor.rs:29-64).

    Kinds: query_info | query_conf | pause_servers | resume_servers |
    reset_servers | take_snapshot | leave; the observability and control
    planes: metrics_dump | flight_dump (payload ``{"last_n": n}`` trims
    each replica's ring to its n newest events) | watch_series (the
    manager's graftwatch ring, answered without a fan-out) |
    inject_faults (payload ``{"net": spec, "wal": spec, "seed": n}``,
    relayed to each target server as a ``fault_ctl``) | range_change
    (payload op/start/end/dst_group, replied with ``conf={"rc_id": n}``)
    | autopilot_ctl (payload act + actuator fields, relayed verbatim)."""

    kind: str
    servers: Optional[List[int]] = None  # None = all
    durable: bool = True                 # reset: keep durable files?
    payload: Optional[Dict[str, Any]] = None


@dataclasses.dataclass(frozen=True)
class CtrlReply:
    """Manager -> client (parity: ``CtrlReply``, reactor.rs:66-105)."""

    kind: str
    population: int = 0
    servers: Dict[int, Tuple[str, str]] = dataclasses.field(
        default_factory=dict
    )  # id -> (api_addr, p2p_addr)
    leader: Optional[int] = None
    # query_conf: the last conf a server reported installed;
    # range_change: {"rc_id": n}
    conf: Optional[dict] = None
    done: Optional[List[int]] = None
    # fan-out targets that did not answer within the gather's deadline
    # (or could not be reached)
    missing: Optional[List[int]] = None
    # per-server reply payloads of a gather (metrics_dump: sid ->
    # snapshot; watch_series: {"fleet": export})
    payloads: Optional[Dict[int, Any]] = None
    # registered ingress proxies (no proxy tier in the port yet)
    proxies: Optional[Dict[int, Any]] = None
    # installed range overrides, in adoption order (query_info)
    ranges: Optional[list] = None
