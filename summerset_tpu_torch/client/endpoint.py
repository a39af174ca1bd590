"""Client endpoint + stubs, counterpart of
``summerset_tpu/client/endpoint.py``.

Parity: ``ClientApiStub`` sends the client id as its first frame and then
exchanges ``ApiRequest``/``ApiReply`` (apistub.rs:16-95);
``ClientCtrlStub`` receives its assigned id on connect and exchanges
``CtrlRequest``/``CtrlReply`` (ctrlstub.rs); ``GenericEndpoint`` composes
both and handles server (re)selection with leader failover
(endpoint.rs:17-54).  The data-plane stub speaks the wire codec for its hot
requests (``req``/``probe``) unless pinned off (``wire_codec=False``); the
control stub stays pickle.  ``scrape_metrics``, ``scrape_flight`` and
``scrape_fleet`` are one-shot scrapes through the manager
(``metrics_dump``, ``flight_dump``, ``watch_series``).  The
ingress-proxy tier is not ported.
"""

from __future__ import annotations

import socket
import time
from typing import Optional, Tuple

from ..host.messages import ApiReply, ApiRequest, CtrlReply, CtrlRequest
from ..host.statemach import Command
from ..utils import safetcp
from ..utils.errors import SummersetError


def _ctrl_scrape(manager_addr: Tuple[str, int], req: "CtrlRequest",
                 timeout: float) -> Optional[dict]:
    """Best-effort one-shot gather through the manager ctrl plane: send
    ``req``, return ``{server id (str): payload}`` sorted by id, or
    ``None`` when the manager is unreachable/mid-fault — the shared
    plumbing under every ``*_dump`` scrape helper."""
    try:
        stub = ClientCtrlStub(manager_addr)
        try:
            rep = stub.request(req, timeout=timeout)
        finally:
            stub.close()
    except Exception:
        return None
    return {
        str(sid): payload
        for sid, payload in sorted((rep.payloads or {}).items())
    }


def scrape_metrics(manager_addr: Tuple[str, int],
                   timeout: float = 30.0, compact: bool = False) -> dict:
    """One-shot telemetry scrape: ``metrics_dump`` through the manager,
    returning ``{server id (str): snapshot}`` — the JSON-able per-server
    combination of device metric lanes, host registry histograms, and
    sampled slot traces (``server.metrics_snapshot``).  ``compact=True``
    trims each snapshot to the device lane totals plus the headline
    histograms (for artifacts committing many runs, e.g. the soak
    matrix).  Best-effort: an unreachable manager or mid-fault cluster
    yields ``{}`` rather than failing the caller's bench/soak run."""
    # only the NETWORK half is best-effort: a snapshot-schema mismatch in
    # the trimming below must raise loudly, not silently commit
    # server_metrics: {} into bench artifacts while CI stays green
    out = _ctrl_scrape(
        manager_addr, CtrlRequest("metrics_dump"), timeout
    )
    if out is None:
        return {}
    if compact:
        keep = ("ticks_to_commit", "api_request_latency_us",
                "wal_fsync_us", "wal_group_commit_batch")
        out = {
            sid: {
                "tick": snap["tick"],
                "device_lanes": snap["device"]["lanes"],
                "histograms": {
                    k: v
                    for k, v in snap["host"]["histograms"].items()
                    if k.split("{", 1)[0] in keep
                },
            }
            for sid, snap in out.items()
        }
    return out


def scrape_flight(manager_addr: Tuple[str, int],
                  last_n: Optional[int] = None,
                  timeout: float = 30.0) -> dict:
    """One-shot graftscope scrape: ``flight_dump`` through the manager,
    returning ``{server id (str): flight dump}`` — each replica's typed
    event ring (``server.flight_snapshot``), trimmed to the ``last_n``
    newest events per replica when given.  Best-effort like
    :func:`scrape_metrics`: an unreachable manager yields ``{}`` so a
    failing soak's bundle writer never dies on its own diagnostics."""
    out = _ctrl_scrape(
        manager_addr,
        CtrlRequest(
            "flight_dump",
            payload=(
                {"last_n": int(last_n)}
                if last_n is not None else None
            ),
        ),
        timeout,
    )
    return {} if out is None else out


def scrape_fleet(manager_addr: Tuple[str, int],
                 timeout: float = 15.0) -> Optional[dict]:
    """One-shot graftwatch scrape: ``watch_series`` through the manager,
    returning the FleetSeries export (``{"v", "retain", "series": [...]}``)
    or ``None`` when the manager is unreachable.  Answered from the
    manager's own ring — no server fan-out, so it stays cheap enough
    for a dashboard to poll every second."""
    out = _ctrl_scrape(
        manager_addr, CtrlRequest("watch_series"), timeout
    )
    if out is None:
        return None
    return out.get("fleet")


class ClientCtrlStub:
    def __init__(self, manager_addr: Tuple[str, int]):
        self.sock = socket.create_connection(manager_addr, timeout=15)
        self.sock.settimeout(None)
        self.id: int = int(safetcp.recv_msg_sync(self.sock))

    def request(self, req: CtrlRequest, timeout: float = 30.0) -> CtrlReply:
        self.sock.settimeout(timeout)
        try:
            safetcp.send_msg_sync(self.sock, req)
            return safetcp.recv_msg_sync(self.sock)
        finally:
            self.sock.settimeout(None)

    def close(self) -> None:
        try:
            safetcp.send_msg_sync(self.sock, CtrlRequest("leave"))
            safetcp.recv_msg_sync(self.sock)
        except (OSError, SummersetError):
            pass
        self.sock.close()


class ClientApiStub:
    """Data-plane stub.  ``codec=None`` follows the process-wide wire
    codec default: hot requests leave in the codec's binary form; the
    reply side dispatches per frame, so the stub talks to codec-on and
    codec-off servers alike."""

    def __init__(self, client_id: int, api_addr: Tuple[str, int],
                 connect_timeout: float = 15.0,
                 codec: Optional[bool] = None):
        self.codec = codec
        self.sock = socket.create_connection(
            tuple(api_addr), timeout=max(connect_timeout, 0.05)
        )
        self.sock.settimeout(None)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        safetcp.send_msg_sync(self.sock, client_id)

    def send_req(self, req: ApiRequest) -> None:
        safetcp.send_msg_sync(self.sock, req, codec=self.codec)

    def recv_reply(self, timeout: Optional[float] = None) -> ApiReply:
        self.sock.settimeout(timeout)
        try:
            return safetcp.recv_msg_sync(self.sock)
        finally:
            self.sock.settimeout(None)

    def close(self) -> None:
        self.sock.close()


class GenericEndpoint:
    """Manager-guided endpoint with redirect-aware server selection."""

    def __init__(self, manager_addr: Tuple[str, int],
                 server_id: Optional[int] = None,
                 wire_codec: Optional[bool] = None):
        self.ctrl = ClientCtrlStub(manager_addr)
        self.id = self.ctrl.id
        self.prefer = server_id
        # wire codec pin for the data-plane stub (None = process default)
        self.wire_codec = wire_codec
        self.api: Optional[ClientApiStub] = None
        self.servers = {}
        self.current: Optional[int] = None
        # the freshest leader hint observed (redirect replies or the
        # manager's query_info); the data-plane hint is fresher
        self.leader_cache: Optional[int] = None

    def note_leader(self, sid: Optional[int]) -> None:
        """Record a data-plane leader hint."""
        if sid is not None and sid >= 0:
            self.leader_cache = sid

    def _refresh_info(self, info) -> None:
        if info.servers:
            self.servers = info.servers
        if info.leader is not None:
            self.leader_cache = info.leader

    def connect(self, timeout: Optional[float] = None) -> None:
        """``timeout`` bounds the server connect only."""
        info = self.ctrl.request(CtrlRequest("query_info"))
        self._refresh_info(info)
        if not info.servers:
            raise SummersetError("no servers joined yet")
        target = self.prefer
        if target is None or target not in info.servers:
            target = (
                info.leader
                if info.leader is not None and info.leader in info.servers
                else sorted(info.servers)[0]
            )
        self._connect_to(target, timeout=timeout)

    def _connect_to(self, sid: int,
                    timeout: Optional[float] = None) -> None:
        if self.api is not None:
            self.api.close()
            self.api = None
        api_addr, _ = self.servers[sid]
        self.api = ClientApiStub(
            self.id, api_addr,
            connect_timeout=15.0 if timeout is None else timeout,
            codec=self.wire_codec,
        )
        self.current = sid

    def reconnect(self, sid: Optional[int] = None,
                  timeout: Optional[float] = None) -> None:
        if sid is not None and sid in self.servers:
            self._connect_to(sid, timeout=timeout)
        else:
            self.connect(timeout=timeout)

    def rotate(self, avoid: Optional[int] = None,
               deadline: Optional[float] = None) -> None:
        """Fail over to a different server after a timeout: the freshest
        leader hint first (unless it is the server being avoided), then
        round-robin so repeated timeouts walk the whole membership.
        ``deadline`` (monotonic seconds) bounds the whole walk."""

        def budget() -> Optional[float]:
            if deadline is None:
                return None
            return deadline - time.monotonic()

        leader = None
        b = budget()
        # the ctrl query keeps a FIXED 5 s timeout (a shorter one could
        # strand a late reply in the ctrl stream); with the caller's
        # budget nearly gone, walk the cached membership instead
        if b is None or b >= 1.0:
            try:
                info = self.ctrl.request(
                    CtrlRequest("query_info"), timeout=5
                )
                self._refresh_info(info)
                leader = info.leader
            except (OSError, SummersetError):
                pass
        if avoid is None:
            avoid = self.current
        if not self.servers:
            return
        order = self._walk_order(
            sorted(self.servers), avoid, (self.leader_cache, leader),
        )
        for cand in order:
            b = budget()
            if b is not None and b <= 0:
                return
            try:
                self._connect_to(cand, timeout=b)
                return
            except OSError:
                continue

    @staticmethod
    def _walk_order(cands, avoid, hints):
        """Usable ``hints`` first, then round-robin from ``avoid``, with
        ``avoid`` itself as the last resort."""
        order = []
        for hint in hints:
            if (
                hint is not None and hint in cands
                and hint != avoid and hint not in order
            ):
                order.append(hint)
        start = cands.index(avoid) if avoid in cands else -1
        for off in range(1, len(cands) + 1):
            cand = cands[(start + off) % len(cands)]
            if cand != avoid and cand not in order:
                order.append(cand)
        if avoid in cands:
            order.append(avoid)
        return order

    def follow_redirect(self, hint: Optional[int],
                        deadline: Optional[float] = None) -> None:
        """The redirect-failover policy every driver shares: note the
        leader hint, reconnect toward it when it is a usable different
        server, else walk the membership, bounded by ``deadline`` and
        swallowing connect errors (the caller's next retry rotates)."""
        self.note_leader(hint)
        budget = (
            None if deadline is None else deadline - time.monotonic()
        )
        if budget is not None and budget <= 0:
            return
        try:
            if hint is not None and hint >= 0 and hint != self.current:
                self.reconnect(hint, timeout=budget)
            else:
                self.rotate(deadline=deadline)
        except (OSError, SummersetError):
            pass  # hinted server down: the next retry rotates

    def send_req(self, req_id: int, cmd: Command) -> None:
        assert self.api is not None, "connect() first"
        self.api.send_req(ApiRequest("req", req_id=req_id, cmd=cmd))

    def send_scan(self, req_id: int, start: str, end: Optional[str],
                  limit: int = 0) -> None:
        """Issue an ordered range read over ``[start, end)`` (``end``
        None = unbounded, ``limit`` 0 = no cap), as a scan Command riding
        the ``req`` kind."""
        self.send_req(req_id, Command(
            "scan", start, end=end, limit=int(limit),
        ))

    def send_conf(self, req_id: int, conf_delta: dict) -> None:
        """Issue a ConfChange (parity: ApiRequest::Conf,
        external.rs:106-121)."""
        assert self.api is not None, "connect() first"
        self.api.send_req(
            ApiRequest("conf", req_id=req_id, conf_delta=conf_delta)
        )

    def recv_reply(self, timeout: Optional[float] = None) -> ApiReply:
        assert self.api is not None
        return self.api.recv_reply(timeout=timeout)

    def leave(self, keep_ctrl: bool = False) -> None:
        if self.api is not None:
            try:
                self.api.send_req(ApiRequest("leave"))
                self.api.recv_reply(timeout=2)
            except (OSError, SummersetError):
                pass
            self.api.close()
            self.api = None
        if not keep_ctrl:
            self.ctrl.close()
