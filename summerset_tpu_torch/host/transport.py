"""TransportHub: the server-to-server TCP mesh, counterpart of
``summerset_tpu/host/transport.py``.

Parity: reference ``src/server/transport.rs`` — an acceptor thread plus
one receiver per peer, full mesh built by proactively connecting to
lower-id peers and accepting from higher ids (transport.rs:388-849).

Lockstep adaptation: a server process owns replica index ``me`` of every
group.  Each tick it sends one frame per peer carrying (tick number, its
outbox slices for that destination, the payload piggyback) and assembles
its inbox from the freshest frame available from each peer.

Delivery is deliberately NOT tick-aligned: replica tick counters skew
freely, so ``recv_tick`` waits until the deadline for at least one frame
per peer and returns every frame that arrived, oldest to newest.
The server unions the payload piggybacks from all frames and takes the
kernel lanes from the newest (lanes carry cumulative state), keeping an
older frame owed where its event bits are missing from the newest
(``ServerReplica._peer_lanes``).  A peer with no frame by the deadline
is a drop, which the kernels' loss machinery recovers.

Each received frame stamped with its sender's ``ts`` (``time.monotonic``)
from a peer on this machine leaves a delivery sample ``(peer, body bytes,
delay ms)`` in ``samples``, which Crossword's adaptive shard assignment
folds (``host/adaptive.py``); monotonic clocks of two machines are not
comparable, so other peers leave none.

Frames leave through the wire codec (``utils/wirecodec.py``) when the
``codec`` knob is on (server config ``wire_codec``, default the process
default ``SMR_WIRE_CODEC``, on unless disabled): one vectored ``sendmsg``
per peer carries the length prefix, the small fields and the kernel lanes
as zero-copy views of the outbox's host buffers.  The send is synchronous
(every byte is in the socket buffer when ``send_tick`` returns), so the
pinned buffers a card replica's outbox views are free to be written again
by a later prefetch.  Ingress always dispatches per frame on the body's
first byte, so codec and pickle peers share one mesh.  Every 64th encoded
frame is also pickled to meter the bytes the codec saved
(``wire_bytes_saved``); ``wire_codec_on`` gauges the knob.

Seams of the observability and control planes: ``flight`` (a
``host/tracing.FlightRecorder``) gets ``frame_tx``/``frame_rx`` events
with the sender's tick as ``seq`` and a ``transport_handshake_fail`` event
per failed dial; ``health`` (a ``host/health.HealthScorer``, attached by
the server) gets every same-host delivery delay, which also feeds the
``peer_ack_delay_us`` histogram; ``set_faults`` installs a
``safetcp.FrameFaults`` spec (the ``net`` plane of ``fault_ctl``) that
drops, duplicates, delays and rate-limits frames.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Tuple

from ..utils import safetcp, wirecodec
from ..utils.errors import SummersetError
from ..utils.logging import pf_info, pf_logger, pf_warn

logger = pf_logger("transport")

#: every n-th codec frame is also pickled to meter ``wire_bytes_saved``
_SAVE_EVERY = 64


def hard_close(sock: socket.socket) -> None:
    """Abortive close (SO_LINGER 0 -> RST): releases the local port at
    once, which an in-process crash-restart rebinding it needs; frames
    are idempotent cumulative snapshots, so a lost tail is a drop."""
    try:
        sock.setsockopt(
            socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0)
        )
    except OSError:
        pass
    try:
        # wake any thread blocked in recv() on this socket
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def _same_host(sock: socket.socket) -> bool:
    """Loopback, or the peer's source address equals our own address on
    this connection (the same machine through its real address)."""
    try:
        rip = sock.getpeername()[0]
        lip = sock.getsockname()[0]
    except OSError:
        return False
    # dual-stack listeners hand back IPv4-mapped IPv6 addresses
    rip, lip = (ip[7:] if ip.startswith("::ffff:") else ip
                for ip in (rip, lip))
    return rip.startswith("127.") or rip == "::1" or (rip != "" and rip == lip)


class TransportHub:
    def __init__(self, me: int, population: int, p2p_addr: Tuple[str, int],
                 registry=None, flight=None, codec: Optional[bool] = None):
        self.me = me
        self.population = population
        self.p2p_addr = p2p_addr
        # wire codec: None follows the process default (SMR_WIRE_CODEC)
        self.codec = wirecodec.default_on() if codec is None else bool(codec)
        self._enc = wirecodec.FrameEncoder()
        self._save_probe = 0
        # telemetry seam: per-peer frame and byte counters both ways, the
        # codec's gauge and its sampled byte savings
        self.registry = registry
        if registry is not None:
            registry.counter_add("wire_bytes_saved", 0)
            registry.gauge_set("wire_codec_on", 1 if self.codec else 0)
        self.flight = flight
        self.health = None
        # FrameFaults verdict engine (None = the zero-cost fast path)
        self._faults: Optional[safetcp.FrameFaults] = None
        self._conns: Dict[int, socket.socket] = {}
        self._wlocks: Dict[int, threading.Lock] = {}
        # (peer, frame bytes, delay ms) delivery samples; deque appends
        # are thread-safe, the replica loop drains them
        self.samples: deque = deque(maxlen=4096)
        # per peer: does its send stamp share our monotonic clock?
        self._same_host: Dict[int, bool] = {}
        # per-peer receive queues of (tick, payload)
        self._rq: Dict[int, queue.Queue] = {
            p: queue.Queue() for p in range(population) if p != me
        }
        self._listener = None
        deadline = time.monotonic() + 10.0
        while True:
            try:
                self._listener = socket.create_server(
                    p2p_addr, reuse_port=False, backlog=population
                )
                break
            except OSError:
                # transient rebind race after a crash-restart
                if time.monotonic() > deadline:
                    pf_warn(logger, f"bind {p2p_addr} failed")
                    raise
                time.sleep(0.1)
        self._accept_thread = threading.Thread(
            target=self._acceptor, daemon=True
        )
        self._accept_thread.start()

    # ------------------------------------------------------ fault injection
    def set_faults(self, spec: Optional[dict], seed: int = 0) -> None:
        """Install (or clear, with ``spec=None``) a message-fault spec:
        partitions (mute/deaf), iid drop, duplication, added delay, the
        egress bandwidth cap and CPU starve (``safetcp.FrameFaults``),
        with verdicts drawn from a RNG seeded by ``seed``."""
        self._faults = safetcp.FrameFaults(spec, seed) if spec else None

    # ---------------------------------------------------------- mesh setup
    def peers(self) -> list:
        """Currently connected peer ids."""
        return sorted(self._conns)

    def connected(self, peer: int) -> bool:
        return peer in self._conns

    def connect_to_peer(self, peer: int, addr: Tuple[str, int]) -> None:
        """Proactively connect to a peer (transport.rs:162)."""
        sock = None
        for _ in range(50):
            try:
                sock = socket.create_connection(tuple(addr), timeout=5.0)
                break
            except OSError:
                time.sleep(0.2)
        if sock is None:
            raise SummersetError(f"cannot connect to peer {peer} @ {addr}")
        sock.settimeout(None)
        safetcp.send_msg_sync(sock, self.me)  # identify ourselves
        self._register(peer, sock)

    def wait_for_group(self, timeout: float = 30.0) -> None:
        """Block until the full mesh is connected (transport.rs:181)."""
        deadline = time.monotonic() + timeout
        while len(self._conns) < self.population - 1:
            if time.monotonic() > deadline:
                raise SummersetError(
                    f"mesh incomplete: {sorted(self._conns)} of "
                    f"{self.population - 1} peers"
                )
            time.sleep(0.05)
        pf_info(logger, f"p2p mesh complete ({self.population} replicas)")

    def _register(self, peer: int, sock: socket.socket) -> None:
        # close a replaced connection: leaking it would hold the port past
        # shutdown and wedge an in-process crash-restart on rebind
        old = self._conns.get(peer)
        if old is not None and old is not sock:
            hard_close(old)
        self._same_host[peer] = _same_host(sock)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._conns[peer] = sock
        self._wlocks[peer] = threading.Lock()
        if self.registry is not None:
            self.registry.counter_add("transport_connects", peer=peer)
        t = threading.Thread(
            target=self._messenger_recv, args=(peer, sock), daemon=True
        )
        t.start()

    def _acceptor(self) -> None:
        while True:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            try:
                peer = int(safetcp.recv_msg_sync(sock))
            except Exception as e:
                # a dialer that never completes the id handshake
                if self.flight is not None:
                    self.flight.record("transport_handshake_fail",
                                       error=f"{type(e).__name__}: {e}")
                sock.close()
                continue
            self._register(peer, sock)

    def _messenger_recv(self, peer: int, sock: socket.socket) -> None:
        rx = safetcp.FrameReceiver()
        reg = self.registry
        try:
            while True:
                body = rx.recv_raw(sock)
                nbytes = len(body)
                # the decode is timed alone: the blocking recv waits out
                # the peer's tick interval
                t_dec = time.monotonic()
                tick, payload = wirecodec.decode_body(body)
                if reg is not None:
                    reg.observe_s("wire_decode_us",
                                  time.monotonic() - t_dec, plane="p2p")
                faults = self._faults
                if faults is not None and faults.ingress_drop(peer):
                    continue  # deaf to this peer (one partition half)
                if reg is not None:
                    reg.counter_add("transport_frames_recv", peer=peer)
                    reg.counter_add("transport_bytes_recv", nbytes,
                                    peer=peer)
                if faults is not None:
                    d = faults.ingress_delay(peer)
                    if d > 0:
                        # the per-peer messenger sleeps: a slow link,
                        # never a reordering
                        time.sleep(d)
                if self.flight is not None:
                    self.flight.record("frame_rx", peer=peer, seq=int(tick),
                                       nbytes=nbytes)
                self._rq[peer].put((tick, payload))
                ts = payload.get("ts") if isinstance(payload, dict) else None
                if ts is not None and self._same_host.get(peer, False):
                    delay_s = time.monotonic() - ts
                    self.samples.append((peer, nbytes, delay_s * 1e3))
                    # the frame delay is the heartbeat-delivery latency
                    # of the tick mesh: the health scorer's slow_peer
                    # signal
                    if reg is not None:
                        reg.observe_s("peer_ack_delay_us", delay_s,
                                      peer=peer)
                    if self.health is not None:
                        self.health.note_peer_delay(peer, delay_s)
        except Exception:
            pf_warn(logger, f"peer {peer} connection lost")
            if self._conns.get(peer) is sock:
                del self._conns[peer]
            hard_close(sock)

    # ------------------------------------------------------------ tick I/O
    def send_tick(self, tick: int, per_peer: Dict[int, Any],
                  fence=None) -> None:
        """Send this tick's frame to each connected peer.

        ``fence`` is the pipelined loop's durability gate
        (``ServerReplica._fence_wait``), called BEFORE the first byte of
        any frame leaves: the frames carry votes/acks computed by the
        step whose WAL records the fence covers, and a failed fence
        raises here, before anything escapes the process."""
        if fence is not None:
            fence()
        reg = self.registry
        enc = self._enc
        faults = self._faults
        for peer, payload in per_peer.items():
            sock = self._conns.get(peer)
            if sock is None:
                continue
            copies = 1
            if faults is not None:
                verdict = faults.egress(peer)
                if verdict == "drop":
                    continue  # lost: the kernels' loss machinery heals
                if verdict == "dup":
                    copies = 2
            t_enc = time.monotonic()
            segs, nbytes = safetcp.encode_frame_into(
                (tick, payload), enc, codec=self.codec
            )
            if reg is not None:
                reg.observe_s("wire_encode_us", time.monotonic() - t_enc,
                              plane="p2p")
                if self.codec:
                    self._save_probe += 1
                    if self._save_probe >= _SAVE_EVERY:
                        self._save_probe = 0
                        base = len(safetcp.encode_frame(
                            (tick, payload), codec=False
                        ))
                        reg.counter_add("wire_bytes_saved",
                                        max(0, base - nbytes))
            if copies > 1:
                segs = segs * copies
            if faults is not None:
                # fail-slow host: the egress token bucket and the CPU
                # starve stall the sender's own tick loop, after the
                # frame's ts stamp, so peers' delay samples see the limp
                stall = faults.host_stall(copies * nbytes, time.monotonic())
                if stall > 0:
                    time.sleep(stall)
            try:
                with self._wlocks[peer]:
                    safetcp.sendmsg_all(sock, segs, copies * nbytes)
                if reg is not None:
                    reg.counter_add("transport_frames_sent", copies,
                                    peer=peer)
                    reg.counter_add("transport_bytes_sent", copies * nbytes,
                                    peer=peer)
                if self.flight is not None:
                    self.flight.record("frame_tx", peer=peer, seq=int(tick),
                                       nbytes=copies * nbytes)
            except OSError:
                if self._conns.get(peer) is sock:
                    self._conns.pop(peer, None)
                hard_close(sock)
            finally:
                enc.release()

    def recv_tick(
        self, tick: int, deadline: float
    ) -> Dict[int, Optional[list]]:
        """Collect peers' queued frames, waiting until ``deadline``
        (monotonic seconds) for at least one frame from each connected
        peer.  Returns ``{peer: [frame, ...] oldest-to-newest}`` with
        ``None`` for peers that produced nothing (drop semantics)."""
        out: Dict[int, Optional[list]] = {p: None for p in self._rq}

        def drain() -> None:
            for p, q in self._rq.items():
                while True:
                    try:
                        _t, payload = q.get_nowait()
                    except queue.Empty:
                        break
                    if out[p] is None:
                        out[p] = []
                    out[p].append(payload)

        while True:
            drain()
            waiting = [
                p for p in self._rq
                if out[p] is None and p in self._conns
            ]
            budget = deadline - time.monotonic()
            if not waiting or budget <= 0:
                return out
            # block on one lagging peer's queue, then re-drain all
            try:
                _t, payload = self._rq[waiting[0]].get(timeout=budget)
                if out[waiting[0]] is None:
                    out[waiting[0]] = []
                out[waiting[0]].append(payload)
            except queue.Empty:
                pass

    def close(self) -> None:
        # shutdown() first: it forces the acceptor's blocked accept() to
        # return, so the listening port is really released
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._listener.close()
        for sock in list(self._conns.values()):
            hard_close(sock)
