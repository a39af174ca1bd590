"""ClusterManager: the oracle event loop plus its two TCP endpoints,
counterpart of ``summerset_tpu/manager/clusman.py``.

Parity: reference ``src/manager/clusman.rs`` composed of
``ServerReigner`` (server-facing control) and ``ClientReactor``
(client-facing control).  The two endpoints are asyncio servers feeding
one event loop; ids are assigned on connect, joins answer with
``connect_to_peers`` carrying the addresses of every joined peer, the
leader of group 0 is tracked from ``leader_status`` (cleared when its
connection drops and nobody steps up within a grace window), and client
control requests fan out ``CtrlMsg``s and gather replies.

The conf plane: a server's ``responders_conf`` notice sets the conf
``query_conf`` answers; a ``conf_forward`` relay gets the next sequence
number and goes to every server as ``install_conf``, and the newest one
is re-announced to every server that joins later.

The observability and control planes: ``metrics_dump`` and
``flight_dump`` gather every server's scrape under one total deadline
(``gather_timeout``) and name the servers that missed it in
``missing``; servers stream graftwatch ``watch_frame`` deltas into the
``FleetSeries`` ring that ``watch_series`` answers from;
``inject_faults`` relays a ``fault_ctl`` and ``autopilot_ctl`` an
actuation.  Live resharding: ``range_change`` validates a
``RangeChange``, assigns its rc_id, fans the seal to every server and
grants seal-complete only when the whole population acked it; the
adopting leader's ``adopt_intent`` is granted here (the one event loop
that also decides ``range_expire``, so adopt and seal-TTL expiry never
both win), and ``range_installed`` moves the change to the installed set
that ``install_ranges`` re-announces (newest seq wins, late joiners too)
and ``query_info`` returns.  Ingress proxies (``host/ingress.py``)
register with ``proxy_join`` over their ctrl connection and are
deregistered the moment it drops; ``query_info`` lists them, so a client
rediscovers the tier after a proxy crash in one manager round.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

from ..host.graftwatch import FleetSeries
from ..host.messages import CtrlMsg, CtrlReply, CtrlRequest
from ..host.resharding import RangeChange
from ..utils.errors import SummersetError
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
        # gather fan-outs (metrics_dump / flight_dump) run against a
        # TOTAL deadline instead of a per-reply 15s wait: one slow-but-
        # alive server (fail-slow: its ctrl handling rides its limping
        # tick loop) must not stall every scrape for the full window —
        # the reply returns partial with the straggler in ``missing``
        self.gather_timeout = 5.0
        self.servers: Dict[int, _ServerConn] = {}
        self.leader: Optional[int] = None
        self.conf: Optional[dict] = None
        # registered ingress proxies: ctrl-conn cid -> api_addr (a proxy
        # lives exactly as long as its ctrl connection)
        self.proxies: Dict[int, Tuple[str, int]] = {}
        self._next_cid = 1000
        self._conf_seq = 0  # total order over relayed ConfChanges
        # the newest relayed install_conf payload; re-announced to every
        # later joiner so a server that (re)joins AFTER a ConfChange was
        # relayed still observes it (receivers apply newest-seq-wins, so
        # the replay can never regress a fresher conf)
        self._conf_last: Optional[dict] = None
        # live resharding (host/resharding.py): rc_id assignment plus the
        # installed/pending range sets, re-announced to proxies via
        # query_info and to (late-joining) servers via install_ranges —
        # the same newest-seq-wins contract as install_conf.  The seq is
        # seeded from the wall clock, NOT 0: surviving servers keep their
        # adopted-rc_id idempotency sets and newest-seq-seen watermarks
        # across a manager restart, so a reborn manager restarting at 0
        # would mint colliding rc_ids (seals silently skipped yet acked)
        # and re-announce seqs below every survivor's watermark —
        # resharding would silently stop converging
        self._range_seq = int(time.time() * 1000)
        self._ranges_installed: Dict[int, dict] = {}
        self._ranges_pending: Dict[int, dict] = {}
        # seal-TTL escape hatch: pending changes expired on a source
        # server's range_expire request (destination leaderless past
        # seal_ttl_ticks).  Kept forever (rc_ids are unique) so a
        # straggling re-announce can list them and a late seal replay
        # cannot resurrect a rolled-back change.  _adopt_granted is the
        # pivot that makes adopt-vs-expire race-free: both the grant
        # (adopt_intent) and the expiry resolve HERE, on the one event
        # loop, and an expiry is refused once the grant was issued.
        # Grants are deliberately non-revocable — post-grant liveness
        # rides the idempotent adopt re-propose (a new destination
        # leader re-asks and gets ok=True again), not the TTL.
        self._ranges_expired: Dict[int, dict] = {}
        self._adopt_granted: set = set()
        # graftwatch (host/graftwatch.py): the fleet time-series ring —
        # servers stream one-way watch_frame deltas on their tick
        # cadence; clients read the aligned ring via watch_series
        self.fleet = FleetSeries(retain=256)
        # kind -> list of waiter queues: every waiter sees every reply of
        # that kind (and filters by sid), so concurrent ctrl clients can't
        # steal each other's acks
        self._pending_replies: Dict[str, list] = {}
        self._join_event = asyncio.Event()
        # leader staleness: when the tracked leader's control connection
        # drops and nobody steps up within the grace window, stop steering
        # clients at a ghost (utils.Timer — the reference Timer's role as
        # liveness backbone, timer.rs:39-143)
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
            # free the id once this connection is truly gone so a
            # restarted server can reclaim it (clusman.rs assigned_ids)
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
            # the joiner proactively connects to ALL existing known peers
            # (clusman.rs:209-233) — a restarted low-id server must rebuild
            # its links itself, since live higher-id peers never re-dial
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
                # late joiner catch-up: the _conf_seq total order only
                # helps servers that were connected at relay time — a
                # crash-restarted server re-joining after a ConfChange
                # must still converge on the same final conf
                try:
                    await safetcp.send_msg(
                        conn.writer, CtrlMsg("install_conf", self._conf_last)
                    )
                except (ConnectionError, OSError):
                    pass
            if self._ranges_installed or self._ranges_pending \
                    or self._ranges_expired:
                # same late-joiner contract for range installs: a server
                # re-joining after a RangeChange must converge on the
                # installed range table (and re-seal still-pending ones)
                try:
                    await safetcp.send_msg(
                        conn.writer,
                        CtrlMsg("install_ranges", self._ranges_payload()),
                    )
                except (ConnectionError, OSError):
                    pass
            if any(not ch.get("sealed_ok")
                   for ch in self._ranges_pending.values()):
                # a pending cutover is still waiting for cluster-wide
                # seal confirmation (a server was down during the
                # original fan-out — possibly this very rejoiner):
                # re-drive the seal now that the membership changed
                asyncio.ensure_future(self._retry_pending_seals())
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
            # ConfChange here; re-announce it to ALL servers so each
            # group's leader proposes the conf entry for its groups.
            # The seq is assigned synchronously (single event loop) so
            # concurrent relays are totally ordered; receivers apply
            # newest-seq-wins, which keeps every group converging on the
            # same final conf even when per-connection deliveries of two
            # racing changes interleave differently.
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
        elif msg.kind == "range_installed":
            # the adopting proposer's notice that a RangeChange finished
            # its cutover; move it pending -> installed and re-announce
            # the whole table (newest-seq-wins at receivers) so every
            # server — including ones that missed the original fan-out —
            # converges on the same installed set
            entry = dict(p.get("entry") or {})
            # stamp the announcing server as the range's owner sid: the
            # announcer IS the adopting proposer (destination-group
            # leader), which is where proxies should steer ops for this
            # range — per-group owner routing instead of pinning every
            # installed range to the cluster-wide announced leader
            entry.setdefault("owner", int(conn.sid))
            rc_id = int(entry.get("rc_id", 0))
            fresh = rc_id not in self._ranges_installed
            self._ranges_pending.pop(rc_id, None)
            self._ranges_installed[rc_id] = entry
            if fresh:
                self._range_seq += 1
                payload = self._ranges_payload()
                for s in list(self.servers.values()):
                    if s.joined and not s.writer.is_closing():
                        try:
                            await safetcp.send_msg(
                                s.writer,
                                CtrlMsg("install_ranges", payload),
                            )
                        except (ConnectionError, OSError):
                            pass
                pf_info(logger, f"range {rc_id} installed: "
                                f"[{entry.get('start')!r}, "
                                f"{entry.get('end')!r}) -> "
                                f"group {entry.get('group')}")
        elif msg.kind == "adopt_intent":
            # the adopting leader's barrier cleared and it asks to
            # propose the cutover.  Granting here — on the single event
            # loop that also resolves range_expire — is what makes
            # adopt-vs-seal-TTL-expiry race-free: once granted, the
            # change can no longer expire; once expired, the intent is
            # refused (the server rolls its seal back).  Re-asks after a
            # grant (a new destination leader re-driving an idempotent
            # adopt) are answered ok again.
            rc_id = int(p.get("rc_id", 0))
            ch = self._ranges_pending.get(rc_id)
            ok = (
                rc_id not in self._ranges_expired
                and (rc_id in self._adopt_granted
                     or (ch is not None and bool(ch.get("sealed_ok"))))
            )
            if ok:
                self._adopt_granted.add(rc_id)
            try:
                await safetcp.send_msg(conn.writer, CtrlMsg(
                    "adopt_decision", {"rc_id": rc_id, "ok": ok},
                ))
            except (ConnectionError, OSError):
                pass
            if not ok and rc_id in self._ranges_pending:
                pf_warn(logger, f"range {rc_id}: adopt intent from "
                                f"server {conn.sid} refused")
        elif msg.kind == "range_expire":
            # seal-TTL escape hatch: a source server reports the sealed
            # range's destination stayed leaderless past its TTL.
            # Honored only while the change is pending AND un-granted;
            # the rollback is a normal re-announce (the expired list
            # rides install_ranges), so paused/partitioned servers
            # un-seal when they drain their queues — per-connection
            # FIFO puts the expiry after any straggling seal.
            rc_id = int(p.get("rc_id", 0))
            ch = self._ranges_pending.get(rc_id)
            if ch is not None and rc_id not in self._adopt_granted:
                self._ranges_pending.pop(rc_id, None)
                self._ranges_expired[rc_id] = ch
                self._range_seq += 1
                await self._announce_ranges()
                pf_warn(logger, f"range {rc_id}: seal expired "
                                f"(reported by server {conn.sid}) — "
                                "change rolled back")
        elif msg.kind == "snapshot_up_to":
            pf_info(
                logger,
                f"server {conn.sid} snapshot up to {p.get('new_start')}",
            )
        elif msg.kind == "watch_frame":
            # graftwatch delta frame: one-way ingest into the fleet
            # time-series ring (no reply — the server's tick loop never
            # blocks on the manager)
            self.fleet.ingest(conn.sid, p)
        elif msg.kind in (
            "pause_reply", "resume_reply", "reset_reply", "snapshot_reply",
            "fault_reply", "metrics_reply", "flight_reply", "range_reply",
            "autopilot_reply",
        ):
            # waiters get (sid, payload): orchestration kinds ignore the
            # payload, gather kinds (metrics_reply) collect it per sid
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
                reply = await self._handle_request(req, cid=cid)
                await safetcp.send_msg(writer, reply)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()
            # the pop IS the deregistration clients rediscover through
            if self.proxies.pop(cid, None) is not None:
                pf_warn(logger, f"proxy {cid} deregistered")

    def _ranges_payload(self) -> dict:
        """install_ranges payload: full installed + pending sets under a
        monotone seq (receivers apply newest-seq-wins, the install_conf
        convergence rule)."""
        return {
            "seq": self._range_seq,
            "installed": [
                self._ranges_installed[k]
                for k in sorted(self._ranges_installed)
            ],
            "pending": [
                self._ranges_pending[k]
                for k in sorted(self._ranges_pending)
            ],
            "expired": sorted(self._ranges_expired),
        }

    async def _announce_ranges(self) -> None:
        """Fan the current install_ranges payload to every joined server
        (fire-and-forget; receivers converge newest-seq-wins)."""
        payload = self._ranges_payload()
        for s in list(self.servers.values()):
            if s.joined and not s.writer.is_closing():
                try:
                    await safetcp.send_msg(
                        s.writer, CtrlMsg("install_ranges", payload)
                    )
                except (ConnectionError, OSError):
                    pass

    async def _maybe_seal_complete(self, rc_id: int, reply) -> None:
        """Grant seal-complete for a pending RangeChange iff EVERY member
        of the population acked the seal fan-out, then re-announce so the
        adopting leader's barrier can clear (_range_progress gates on the
        flag).  A partial fan-out must NOT clear it: an unreached server
        is still admitting writes to the range, and an adopt proposed
        against only the local vote window could let the old group
        overwrite a newer destination-group write after the cutover."""
        ch = self._ranges_pending.get(rc_id)
        if ch is None or ch.get("sealed_ok"):
            return
        done = set(reply.done or ())
        if len(done) < self.population:
            pf_warn(
                logger,
                f"range {rc_id}: seal acked by {sorted(done)} of "
                f"{self.population} — cutover held (sheds) until every "
                "server seals",
            )
            return
        ch["sealed_ok"] = True
        self._range_seq += 1
        await self._announce_ranges()
        pf_info(logger, f"range {rc_id}: seal confirmed cluster-wide")

    async def _retry_pending_seals(self) -> None:
        """Re-drive the seal fan-out for pending RangeChanges still
        missing cluster-wide confirmation (a server was down or
        unreachable the first time).  Sealing is idempotent per rc_id and
        every server always acks the fan-out, so re-fanning is safe; on a
        full-population ack the cutover finally unblocks."""
        for rc_id in sorted(self._ranges_pending):
            ch = self._ranges_pending.get(rc_id)
            if ch is None or ch.get("sealed_ok"):
                continue
            reply = await self._fanout_wait(
                "range_change", "range_reply",
                CtrlRequest("range_change"),
                extra={"change": dict(ch)},
            )
            await self._maybe_seal_complete(rc_id, reply)

    def _targets(self, req: CtrlRequest):
        ids = req.servers
        return [
            s for s in self.servers.values()
            if s.joined and not s.writer.is_closing()
            and (ids is None or s.sid in ids)
        ]

    async def _fanout_wait(
        self, kind: str, reply_kind: str, req: CtrlRequest, extra=None
    ) -> CtrlReply:
        """Fan a CtrlMsg to target servers, await one reply from each
        (parity: clusman.rs:382-606 orchestration handlers)."""
        targets = self._targets(req)
        q: asyncio.Queue = asyncio.Queue()
        self._pending_replies.setdefault(reply_kind, []).append(q)
        payload = dict(extra or {})
        done = []
        gathered: Dict[int, Any] = {}
        # gather kinds return per-sid payloads; orchestration kinds ack
        gather_key = {
            "metrics_dump": "snapshot", "flight_dump": "flight",
        }.get(kind)
        # gather kinds run under a TOTAL per-request deadline (a limping
        # server's ctrl replies ride its slowed tick loop — the scrape
        # returns partial, marking it); orchestration kinds keep the
        # 15s PER-REPLY wait they always had (their acks gate real
        # process control, and serial-but-live acks must not share one
        # window)
        deadline = (
            asyncio.get_event_loop().time() + self.gather_timeout
            if gather_key is not None else None
        )
        want = set()
        failed = []
        try:
            for s in targets:
                try:
                    await safetcp.send_msg(s.writer, CtrlMsg(kind, payload))
                    want.add(s.sid)
                except (ConnectionError, OSError):
                    # this target died mid-fan-out; the rest still
                    # count, but the dead sid must stay VISIBLE in
                    # `missing` (neither done nor silently absent)
                    failed.append(s.sid)
                    pf_warn(logger, f"{kind}: send to {s.sid} failed")
            while want:
                if deadline is not None:
                    budget = deadline - asyncio.get_event_loop().time()
                    if budget <= 0:
                        raise asyncio.TimeoutError
                else:
                    budget = 15.0
                sid, rp = await asyncio.wait_for(q.get(), timeout=budget)
                if sid in want:
                    want.discard(sid)
                    done.append(sid)
                    gathered[sid] = rp
        except asyncio.TimeoutError:
            pf_warn(
                logger,
                f"{kind}: deadline hit; missing {sorted(want)} — "
                "returning partial",
            )
        finally:
            self._pending_replies[reply_kind].remove(q)
        missing = sorted(set(want) | set(failed))
        if gather_key is not None:
            return CtrlReply(kind, done=done, missing=missing,
                             payloads={
                sid: rp.get(gather_key) for sid, rp in gathered.items()
            })
        return CtrlReply(kind, done=done, missing=missing)

    async def _reset_servers(self, req: CtrlRequest) -> CtrlReply:
        """Reset targets ONE AT A TIME, each step waiting for the old
        connection's reply, freeing its id, and waiting for the restarted
        server to re-join before touching the next — concurrent restarts
        would otherwise race id reclamation and mesh rebuild (parity:
        clusman.rs:382-438 pops targets one by one with an id re-assign
        wait + settle sleep in between)."""
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
                # the server may still have received reset_state and be
                # restarting — free the id anyway so its reconnect is not
                # refused at the handshake (the old conn is dead either way)
                pf_warn(logger, f"reset: no ack from server {sid}")
                acked = False
            finally:
                self._pending_replies["reset_reply"].remove(q)
            # free the id; the restarting server reclaims it (it is the
            # only one connecting right now), then wait for its re-join
            if self.servers.get(sid) is conn:
                del self.servers[sid]
            # an un-acked server may still restart (its conn died after
            # receiving reset_state) — give it a short rejoin window, vs
            # the long one for a confirmed restart
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
            # settle so the rejoined server's transport mesh completes
            # before the next victim goes down (clusman.rs 500ms sleep)
            await asyncio.sleep(self.settle_delay)
            if acked and rejoined:
                done.append(sid)
        return CtrlReply("reset_state", done=done)

    async def _handle_request(self, req: CtrlRequest,
                              cid: Optional[int] = None) -> CtrlReply:
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
                proxies=dict(self.proxies),
                ranges=[
                    self._ranges_installed[k]
                    for k in sorted(self._ranges_installed)
                ],
            )
        if req.kind == "proxy_join":
            # the proxy's identity is its ctrl-connection cid:
            # registration and liveness share one socket
            addr = tuple((req.payload or {}).get("api_addr") or ())
            if cid is None or len(addr) != 2:
                return CtrlReply("proxy_join", done=[])
            self.proxies[cid] = (str(addr[0]), int(addr[1]))
            pf_info(logger, f"proxy {cid} joined @ {addr}")
            return CtrlReply("proxy_join", done=[cid])
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
        if req.kind == "inject_faults":
            # nemesis plane: relay the fault spec to each target server
            # (host/nemesis.py composes these into seeded schedules)
            return await self._fanout_wait(
                "fault_ctl", "fault_reply", req, extra=req.payload
            )
        if req.kind == "range_change":
            # live resharding: validate, assign the rc_id, fan the seal
            # to EVERY server (each replica of the source group must stop
            # admitting ops for the range before the destination adopts),
            # and await their acks.  Only when the FULL population acked
            # does the manager grant seal-complete (re-announced via
            # install_ranges) — the adopting leader's barrier gates on
            # that flag, making the cutover two-phase; adoption then
            # rides the destination group's own log asynchronously.  The
            # reply means "sealed everywhere reachable", with conf
            # carrying the rc_id for the caller to poll installation via
            # query_info.
            try:
                change = RangeChange.from_payload(dict(req.payload or {}))
            except SummersetError as e:
                pf_warn(logger, f"range_change refused: {e}")
                return CtrlReply("error")
            self._range_seq += 1
            change = dataclasses.replace(change, rc_id=self._range_seq)
            self._ranges_pending[change.rc_id] = change.as_dict()
            reply = await self._fanout_wait(
                "range_change", "range_reply", req,
                extra={"change": change.as_dict()},
            )
            await self._maybe_seal_complete(change.rc_id, reply)
            return dataclasses.replace(reply, conf={"rc_id": change.rc_id})
        if req.kind == "autopilot_ctl":
            # autopilot actuation (host/autopilot.py driver in act
            # mode): relay the act to the target servers and await
            # their applied-acks — the same orchestration shape as
            # inject_faults
            return await self._fanout_wait(
                "autopilot_ctl", "autopilot_reply", req,
                extra=req.payload,
            )
        if req.kind == "metrics_dump":
            # telemetry scrape: gather each live server's snapshot
            # (device metric lanes + host registry + sampled traces)
            return await self._fanout_wait(
                "metrics_dump", "metrics_reply", req
            )
        if req.kind == "flight_dump":
            # graftscope scrape: gather each live server's flight-
            # recorder ring (payload relays e.g. {"last_n": n})
            return await self._fanout_wait(
                "flight_dump", "flight_reply", req, extra=req.payload
            )
        if req.kind == "watch_series":
            # graftwatch: answered straight from the manager's fleet
            # ring — no server fan-out, so a limping replica can't
            # stall the dashboard (its STALE frames are the signal)
            return CtrlReply(
                "watch_series", payloads={"fleet": self.fleet.export()}
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
