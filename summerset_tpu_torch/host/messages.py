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

    The port's server serves ``"req"`` puts and gets and ``"conf"``
    changes (``conf_delta``: ``responders``, a list of replica ids, and on
    Bodega an optional ``leader``); every other kind is answered with an
    ``"error"`` reply (``"leave"`` is answered by the api plane itself)."""

    kind: str                      # "req" | "conf" | "leave" | else: error
    req_id: int = 0
    cmd: Optional[Command] = None  # kind == "req"
    conf_delta: Optional[dict] = None  # kind == "conf"


@dataclasses.dataclass(frozen=True)
class ApiReply:
    """Server -> client (parity: ``ApiReply``, external.rs:155-183).

    ``kind == "shed"`` is the ingress-backpressure negative ack: the
    bounded api queue was full and the request was refused before
    entering it, so it was never proposed; ``retry_after_ms`` hints when
    to retry."""

    kind: str   # "reply" | "conf" | "redirect" | "error" | "shed"
    #             | "leave"
    req_id: int = 0
    result: Optional[CommandResult] = None
    redirect: Optional[int] = None  # hinted leader id
    success: bool = True
    retry_after_ms: int = 0         # shed: suggested client backoff
    local: bool = False             # served as a leased local read


# Server-to-server tick frames are plain dicts (host/server.py builds
# them, host/transport.py ships them): ``msg`` carries the kernel outbox
# slices; the payload plane rides alongside:
#   pp: {(group, vid): ReqBatch}            full-copy piggybacks
#   ps: {(group, vid): ShardPayload}        proposer -> peer assigned shards
#   cw: {(group, vid): ShardPayload}        gossip replies (held shards)
#   cw_need: [(group, vid, have_mask, urgent)]   shard-gossip requests
#   need: [(group, vid)]                    payloads this replica is missing
#   kv_need / kv / kv_floor: the install-snapshot plane
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
    every server; pause / resume / reset_state (durable) and their
    ``_reply`` forms; leave / leave_reply."""

    kind: str
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class CtrlRequest:
    """Client -> manager (parity: ``CtrlRequest``, reactor.rs:29-64).

    Kinds: query_info | query_conf | pause_servers | resume_servers |
    reset_servers | leave."""

    kind: str
    servers: Optional[List[int]] = None  # None = all
    durable: bool = True                 # reset: keep durable files?


@dataclasses.dataclass(frozen=True)
class CtrlReply:
    """Manager -> client (parity: ``CtrlReply``, reactor.rs:66-105)."""

    kind: str
    population: int = 0
    servers: Dict[int, Tuple[str, str]] = dataclasses.field(
        default_factory=dict
    )  # id -> (api_addr, p2p_addr)
    leader: Optional[int] = None
    done: Optional[List[int]] = None
    # query_conf: the last conf a server reported installed
    conf: Optional[dict] = None
    # fan-out targets that did not answer (or could not be reached)
    missing: Optional[List[int]] = None
