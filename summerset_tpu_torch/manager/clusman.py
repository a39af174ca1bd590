"""ClusterManager: the oracle event loop plus its two TCP endpoints,
counterpart of ``summerset_tpu/manager/clusman.py``.

Parity: reference ``src/manager/clusman.rs`` composed of
``ServerReigner`` (server-facing control) and ``ClientReactor``
(client-facing control).  The two endpoints are asyncio servers feeding
one event loop; ids are assigned on connect, joins answer with
``connect_to_peers`` carrying the addresses of every joined peer, the
leader of group 0 is tracked from ``leader_status`` (cleared when its
connection drops and nobody steps up within a grace window), and client
control requests (query_info, pause / resume, the serialized durable
reset, take_snapshot) fan out ``CtrlMsg``s and gather replies.  The conf
plane: a server's ``responders_conf`` notice sets the conf
``query_conf`` answers; a ``conf_forward`` relay gets the next sequence
number and goes to every server as ``install_conf``, and the newest one
is re-announced to every server that joins later.

Not ported yet: watch series, ranges, fault injection, scrapes and the
autopilot plane.
"""

from __future__ import annotations

import asyncio
from typing import Dict, Optional, Tuple

from ..host.messages import CtrlMsg, CtrlReply, CtrlRequest
from ..utils import safetcp
from ..utils.logging import pf_info, pf_logger, pf_warn, set_me
from ..utils.timer import Timer

logger = pf_logger("clusman")


class _ServerConn:
    def __init__(self, sid, reader, writer):
        self.sid = sid
        self.reader = reader
        self.writer = writer
        self.api_addr: Optional[Tuple[str, int]] = None
        self.p2p_addr: Optional[Tuple[str, int]] = None
        self.joined = False


class ClusterManager:
    def __init__(
        self,
        protocol: str,
        srv_addr: Tuple[str, int],
        cli_addr: Tuple[str, int],
        population: int,
    ):
        self.protocol = protocol
        self.srv_addr = srv_addr
        self.cli_addr = cli_addr
        self.population = population
        # reset orchestration budgets (shrunk by unit tests)
        self.ack_timeout = 30.0
        self.rejoin_timeout = 120.0
        self.settle_delay = 0.5
        self.servers: Dict[int, _ServerConn] = {}
        self.leader: Optional[int] = None
        # the conf plane: the last installed conf a server reported, the
        # total order over relayed ConfChanges and the newest relay
        # (re-announced to late joiners; receivers apply newest-seq-wins,
        # so the replay never regresses a fresher conf)
        self.conf: Optional[dict] = None
        self._conf_seq = 0
        self._conf_last: Optional[dict] = None
        self._next_cid = 1000
        # kind -> list of waiter queues: every waiter sees every reply of
        # that kind (and filters by sid), so concurrent ctrl clients can't
        # steal each other's acks
        self._pending_replies: Dict[str, list] = {}
        self._join_event = asyncio.Event()
        # leader staleness: when the tracked leader's control connection
        # drops and nobody steps up within the grace window, stop steering
        # clients at a ghost
        self._leader_timer = Timer(explode_callback=self._leader_expired)
        self._leader_lost: Optional[int] = None

    def _leader_expired(self) -> None:
        if self._leader_lost is not None and self.leader == self._leader_lost:
            pf_warn(
                logger,
                f"leader {self.leader} gone with no successor; clearing",
            )
            self.leader = None
        self._leader_lost = None

    # ------------------------------------------------------- server plane
    async def _serve_server(self, reader, writer) -> None:
        # id assignment: reuse the lowest free id (a restarted server takes
        # its old id back once the dead connection is reaped)
        sid = None
        for cand in range(self.population):
            conn = self.servers.get(cand)
            if conn is None or conn.writer.is_closing():
                sid = cand
                break
        if sid is None:
            writer.close()
            return
        conn = _ServerConn(sid, reader, writer)
        self.servers[sid] = conn
        await safetcp.send_msg(writer, (sid, self.population))
        pf_info(logger, f"assigned server id {sid}")
        try:
            while True:
                msg = await safetcp.recv_msg(reader)
                if not isinstance(msg, CtrlMsg):
                    continue
                await self._handle_ctrl(conn, msg)
                if msg.kind == "leave":
                    break
        except (asyncio.IncompleteReadError, ConnectionError):
            pf_warn(logger, f"server {sid} connection lost")
        finally:
            writer.close()
            # free the id once this connection is truly gone
            if self.servers.get(sid) is conn:
                del self.servers[sid]
            if self.leader == sid:
                self._leader_lost = sid
                self._leader_timer.kickoff(5.0)

    async def _handle_ctrl(self, conn: _ServerConn, msg: CtrlMsg) -> None:
        p = msg.payload
        if msg.kind == "new_server_join":
            conn.api_addr = p["api_addr"]
            conn.p2p_addr = p["p2p_addr"]
            conn.joined = True
            self._join_event.set()
            # the joiner connects to ALL known peers (clusman.rs:209-233):
            # a restarted low-id server must rebuild its links itself
            to_peers = {
                s.sid: s.p2p_addr
                for s in self.servers.values()
                if s.joined and s.sid != conn.sid
                and not s.writer.is_closing()
            }
            await safetcp.send_msg(
                conn.writer,
                CtrlMsg(
                    "connect_to_peers",
                    {"population": self.population, "to_peers": to_peers},
                ),
            )
            if self._conf_last is not None:
                # late joiner catch-up: a server restarted after a relayed
                # ConfChange converges on the same final conf
                try:
                    await safetcp.send_msg(
                        conn.writer, CtrlMsg("install_conf", self._conf_last)
                    )
                except (ConnectionError, OSError):
                    pass
            pf_info(logger, f"server {conn.sid} joined")
        elif msg.kind == "leader_status":
            if p.get("step_up"):
                self.leader = conn.sid
                self._leader_timer.cancel()
                self._leader_lost = None
            elif self.leader == conn.sid:
                self.leader = None
            pf_info(logger, f"leader status: {self.leader}")
        elif msg.kind == "responders_conf":
            self.conf = p.get("new_conf")
        elif msg.kind == "conf_forward":
            # a server that does not lead every group relays a client
            # ConfChange: every server gets it, so each group's leader
            # proposes it.  The sequence number is assigned on this one
            # event loop, so concurrent relays are totally ordered.
            self._conf_seq += 1
            payload = {"delta": p.get("delta") or {}, "seq": self._conf_seq}
            self._conf_last = payload
            for s in list(self.servers.values()):
                if s.joined and not s.writer.is_closing():
                    try:
                        await safetcp.send_msg(
                            s.writer, CtrlMsg("install_conf", payload)
                        )
                    except (ConnectionError, OSError):
                        pass
            pf_info(logger, f"conf relayed (seq {self._conf_seq}): "
                            f"{p.get('delta')}")
        elif msg.kind == "snapshot_up_to":
            pf_info(logger, f"server {conn.sid} snapshot up to "
                            f"{p.get('new_start')}")
        elif msg.kind in ("pause_reply", "resume_reply", "reset_reply",
                          "snapshot_reply"):
            for q in self._pending_replies.get(msg.kind, ()):
                q.put_nowait((conn.sid, msg.payload))
        elif msg.kind == "leave":
            await safetcp.send_msg(conn.writer, CtrlMsg("leave_reply"))

    # ------------------------------------------------------- client plane
    async def _serve_client(self, reader, writer) -> None:
        cid = self._next_cid
        self._next_cid += 1
        await safetcp.send_msg(writer, cid)
        try:
            while True:
                req = await safetcp.recv_msg(reader)
                if not isinstance(req, CtrlRequest):
                    continue
                if req.kind == "leave":
                    await safetcp.send_msg(writer, CtrlReply("leave"))
                    break
                reply = await self._handle_request(req)
                await safetcp.send_msg(writer, reply)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    def _targets(self, req: CtrlRequest):
        ids = req.servers
        return [
            s for s in self.servers.values()
            if s.joined and not s.writer.is_closing()
            and (ids is None or s.sid in ids)
        ]

    async def _fanout_wait(
        self, kind: str, reply_kind: str, req: CtrlRequest
    ) -> CtrlReply:
        """Fan a CtrlMsg to target servers, await one reply from each
        (15 s per reply; parity: clusman.rs:382-606)."""
        q: asyncio.Queue = asyncio.Queue()
        self._pending_replies.setdefault(reply_kind, []).append(q)
        done = []
        want = set()
        failed = []
        try:
            for s in self._targets(req):
                try:
                    await safetcp.send_msg(s.writer, CtrlMsg(kind, {}))
                    want.add(s.sid)
                except (ConnectionError, OSError):
                    failed.append(s.sid)
                    pf_warn(logger, f"{kind}: send to {s.sid} failed")
            while want:
                sid, _rp = await asyncio.wait_for(q.get(), timeout=15.0)
                if sid in want:
                    want.discard(sid)
                    done.append(sid)
        except asyncio.TimeoutError:
            pf_warn(logger, f"{kind}: missing {sorted(want)}")
        finally:
            self._pending_replies[reply_kind].remove(q)
        return CtrlReply(kind, done=done,
                         missing=sorted(set(want) | set(failed)))

    async def _reset_servers(self, req: CtrlRequest) -> CtrlReply:
        """Reset targets ONE AT A TIME: each step waits for the old
        connection's ack, frees its id and waits for the restarted
        server to re-join before touching the next (parity:
        clusman.rs:382-438)."""
        targets = sorted(s.sid for s in self._targets(req))
        done = []
        for sid in targets:
            conn = self.servers.get(sid)
            if conn is None or conn.writer.is_closing():
                continue
            q: asyncio.Queue = asyncio.Queue()
            self._pending_replies.setdefault("reset_reply", []).append(q)
            acked = True
            try:
                await safetcp.send_msg(
                    conn.writer,
                    CtrlMsg("reset_state", {"durable": req.durable}),
                )
                while True:  # drain until THIS sid acks
                    got, _rp = await asyncio.wait_for(
                        q.get(), timeout=self.ack_timeout
                    )
                    if got == sid:
                        break
            except (asyncio.TimeoutError, ConnectionError, OSError):
                pf_warn(logger, f"reset: no ack from server {sid}")
                acked = False
            finally:
                self._pending_replies["reset_reply"].remove(q)
            # free the id; the restarting server reclaims it
            if self.servers.get(sid) is conn:
                del self.servers[sid]
            rejoin_deadline = asyncio.get_event_loop().time() + (
                self.rejoin_timeout if acked else self.rejoin_timeout / 8
            )
            rejoined = False
            while True:
                c = self.servers.get(sid)
                if c is not None and c.joined and c is not conn:
                    rejoined = True
                    break
                self._join_event.clear()
                budget = rejoin_deadline - asyncio.get_event_loop().time()
                if budget <= 0:
                    pf_warn(logger, f"reset: server {sid} never rejoined")
                    break
                try:
                    await asyncio.wait_for(
                        self._join_event.wait(), timeout=budget
                    )
                except asyncio.TimeoutError:
                    pass
            # settle so the rejoined server's mesh completes before the
            # next victim goes down (clusman.rs 500ms sleep)
            await asyncio.sleep(self.settle_delay)
            if acked and rejoined:
                done.append(sid)
        return CtrlReply("reset_state", done=done)

    async def _handle_request(self, req: CtrlRequest) -> CtrlReply:
        if req.kind == "query_info":
            return CtrlReply(
                "info",
                population=self.population,
                servers={
                    s.sid: (s.api_addr, s.p2p_addr)
                    for s in self.servers.values()
                    if s.joined
                },
                leader=self.leader,
            )
        if req.kind == "query_conf":
            return CtrlReply("conf", conf=self.conf, leader=self.leader)
        if req.kind == "pause_servers":
            return await self._fanout_wait("pause", "pause_reply", req)
        if req.kind == "resume_servers":
            return await self._fanout_wait("resume", "resume_reply", req)
        if req.kind == "reset_servers":
            return await self._reset_servers(req)
        if req.kind == "take_snapshot":
            return await self._fanout_wait(
                "take_snapshot", "snapshot_reply", req
            )
        return CtrlReply("unknown")

    # ------------------------------------------------------------- runner
    async def run(self) -> None:
        set_me("m")
        srv = await safetcp.tcp_bind_with_retry(
            self.srv_addr[0], self.srv_addr[1], self._serve_server
        )
        cli = await safetcp.tcp_bind_with_retry(
            self.cli_addr[0], self.cli_addr[1], self._serve_client
        )
        pf_info(
            logger,
            f"manager up: srv @ {self.srv_addr} cli @ {self.cli_addr} "
            f"population {self.population}",
        )
        async with srv, cli:
            await asyncio.gather(srv.serve_forever(), cli.serve_forever())
