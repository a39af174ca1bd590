"""ExternalApi: the client-facing TCP plane with request batching,
counterpart of ``summerset_tpu/host/external.py``.

Parity: reference ``src/server/external.rs`` — an acceptor spawning a
servant per client; requests accumulate in a queue the replica drains
once per tick (capped at ``max_batch_size``).  The JAX hub's 1 ms batch
ticker is not kept: the replica polls once per tick anyway, and a
ticker per replica wakes the interpreter a thousand times a second,
which starves the replica threads of an in-process cluster of the GIL.
Clients identify themselves by sending their id as the first frame;
replies are routed back through the servant owning that client's
connection.

Ingress backpressure: the pending queue is bounded at ``max_pending``.
A data-plane request (``BOUNDED_KINDS``) arriving at a full queue is
refused on the spot with ``ApiReply(kind="shed", retry_after_ms=...)``
before it ever enters the queue, so a shed op is guaranteed never
proposed; the rare control kinds (``conf``, ``sub``) bypass the bound.
The hint is the queue's estimated drain time.  Every shed is counted
(``api_shed``).

Wire codec: with the ``codec`` knob on (server config ``wire_codec``,
default the process default), hot replies (``reply``/``shed``/``note``/
``probe``) leave in the codec's binary form through one egress seam
(``_wire_send``); cold kinds stay pickle, and ingress dispatches per
frame, so codec and pickle clients share one server.
"""

from __future__ import annotations

import asyncio
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..utils import safetcp, wirecodec
from ..utils.errors import SummersetError
from ..utils.logging import pf_debug, pf_info, pf_logger
from .messages import ApiReply, ApiRequest

logger = pf_logger("external")


class ExternalApi:
    """The client-facing ingress tier of one server."""

    #: request kinds subject to the bounded-queue shed rule
    BOUNDED_KINDS = ("req", "batch", "probe", "scan")

    def __init__(
        self,
        api_addr: Tuple[str, int],
        max_batch_size: int = 5000,
        max_pending: int = 16384,
        registry=None,
        codec: Optional[bool] = None,
        flight=None,
    ):
        self.api_addr = api_addr
        self.max_batch_size = max_batch_size
        # wire codec for hot replies; None follows the process default
        self.codec = wirecodec.default_on() if codec is None else bool(codec)
        self._enc = wirecodec.FrameEncoder()  # event-loop-thread owned
        self.max_pending = max(1, int(max_pending))
        # EWMA of the replica's batch-take rate (reqs/s), written by
        # get_req_batch on the replica thread, read by servants for the
        # retry-after hints
        self._drain_rate = 0.0
        self._drain_t: Optional[float] = None
        # telemetry seam: request->reply latency at the socket plane,
        # request/reply/shed counts and the queue depth gauge
        self.registry = registry
        # flight seam (host/tracing.FlightRecorder): api_ingress,
        # api_reply and api_shed events
        self.flight = flight
        if registry is not None:
            registry.counter_add("api_shed", 0)
            registry.gauge_set("api_queue_depth", 0)
        self._arrivals: Dict[Tuple[int, int], float] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server = None
        self._writers: Dict[int, asyncio.StreamWriter] = {}
        self._pending: List[Tuple[int, ApiRequest]] = []
        self._batch_ready = threading.Event()
        self._lock = threading.Lock()
        self._started = threading.Event()
        self._start_error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        # a plane that could not bind must fail the replica's bring-up
        # (the supervisor retries it), not leave it serving no client
        if not self._started.wait(timeout=10) or self._start_error:
            raise SummersetError(
                f"api plane failed to start on {api_addr}: "
                f"{self._start_error!r}"
            )

    # -- hub API (called from the replica thread) ---------------------------
    def get_req_batch(
        self, timeout: Optional[float] = None
    ) -> List[Tuple[int, ApiRequest]]:
        """Batch take (parity: ``get_req_batch``, external.rs:323-345):
        waits up to ``timeout`` for a request, returns <= max_batch."""
        if not self._batch_ready.wait(timeout=timeout):
            return []
        with self._lock:
            batch = self._pending[: self.max_batch_size]
            del self._pending[: len(batch)]
            depth = len(self._pending)
            if not self._pending:
                self._batch_ready.clear()
        if batch:
            now = time.monotonic()
            t0 = self._drain_t
            if t0 is not None and now > t0:
                inst = len(batch) / (now - t0)
                self._drain_rate = (
                    inst if self._drain_rate <= 0.0
                    else 0.8 * self._drain_rate + 0.2 * inst
                )
            self._drain_t = now
            if self.registry is not None:
                self.registry.gauge_set("api_queue_depth", depth)
        return batch

    def has_client(self, client: int) -> bool:
        """Is ``client``'s connection still owned by a servant?  (A dict
        membership read, safe across threads: the commit feed drops
        subscribers whose connection died.)"""
        return int(client) in self._writers

    def _retry_after_ms(self, depth: int) -> int:
        """Shed hint: estimated ms until ``depth`` entries drained,
        clamped to [5, 1000]."""
        rate = self._drain_rate
        if rate <= 0.0:
            return 50
        return int(min(1000.0, max(5.0, 1000.0 * depth / rate)))

    def send_reply(self, reply: ApiReply, client: int) -> None:
        """Route a reply to the servant owning `client`'s connection."""
        loop = self._loop
        if loop is None:
            return
        asyncio.run_coroutine_threadsafe(self._send(client, reply), loop)

    def send_replies(
        self,
        items: List[Tuple[int, ApiReply]],
        fence=None,
    ) -> None:
        """Flush a batch of ``(client, reply)`` pairs, gated on the
        durability fence: ``fence`` (``ServerReplica._fence_wait``) runs
        BEFORE the first reply is handed to the event loop, and a failed
        fence raises here with every reply still unsent."""
        if fence is not None:
            fence()
        for client, reply in items:
            self.send_reply(reply, client)

    def stop(self) -> None:
        loop = self._loop
        if loop is not None:
            def _teardown() -> None:
                # close the listener and the client connections inside
                # the loop so the api port is released at once
                if self._server is not None:
                    self._server.close()
                for w in list(self._writers.values()):
                    # abortive close (RST): a graceful FIN would park the
                    # connection holding the api port
                    sock = w.get_extra_info("socket")
                    if sock is not None:
                        try:
                            sock.setsockopt(
                                socket.SOL_SOCKET, socket.SO_LINGER,
                                struct.pack("ii", 1, 0),
                            )
                        except OSError:
                            pass
                    w.transport.abort()
                loop.stop()

            try:
                loop.call_soon_threadsafe(_teardown)
            except RuntimeError:
                pass
        self._thread.join(timeout=5)

    # -- event loop side -----------------------------------------------------
    async def _wire_send(self, writer, reply: ApiReply) -> None:
        """The one reply egress seam: codec-aware encode (hot kinds only)
        through this instance's own encoder (every caller is a coroutine
        on the one event loop), timed into ``wire_encode_us``."""
        t0 = time.monotonic()
        buf = safetcp.encode_frame_bytes(reply, self._enc, codec=self.codec)
        if self.registry is not None:
            self.registry.observe_s("wire_encode_us",
                                    time.monotonic() - t0, plane="api")
        writer.write(buf)
        await writer.drain()

    async def _send(self, client: int, reply: ApiReply) -> None:
        reg = self.registry
        if reg is not None:
            t0 = self._arrivals.pop((client, reply.req_id), None)
            if t0 is not None and reply.kind == "reply":
                reg.observe_s("api_request_latency_us",
                              time.monotonic() - t0)
            reg.counter_add("api_replies_total", kind=reply.kind)
        if self.flight is not None:
            self.flight.record("api_reply", client=client,
                               req_id=reply.req_id, kind=reply.kind)
        w = self._writers.get(client)
        if w is None or w.is_closing():
            self._writers.pop(client, None)
            return
        try:
            await self._wire_send(w, reply)
        except (ConnectionError, asyncio.IncompleteReadError):
            self._writers.pop(client, None)

    async def _servant(self, reader, writer) -> None:
        """Per-client servant task (parity: external.rs:500+)."""
        try:
            client = await safetcp.recv_msg(reader)  # first frame: client id
        except (asyncio.IncompleteReadError, ConnectionError):
            writer.close()
            return
        self._writers[int(client)] = writer
        pf_debug(logger, f"accepted client {client}")
        reg = self.registry
        try:
            while True:
                req, t_dec = await safetcp.recv_msg_timed(reader)
                if reg is not None:
                    reg.observe_s("wire_decode_us", t_dec, plane="api")
                if not isinstance(req, ApiRequest):
                    continue
                if req.kind == "leave":
                    await safetcp.send_msg(
                        writer, ApiReply(kind="leave", req_id=req.req_id)
                    )
                    break
                # bounded ingress: servants are coroutines on THIS loop
                # and the replica thread only shrinks the queue, so the
                # depth read can only overestimate
                with self._lock:
                    depth = len(self._pending)
                if (req.kind in self.BOUNDED_KINDS
                        and depth >= self.max_pending):
                    hint = self._retry_after_ms(depth)
                    if reg is not None:
                        reg.counter_add("api_requests_total")
                        reg.counter_add("api_shed")
                        reg.counter_add("api_replies_total", kind="shed")
                    if self.flight is not None:
                        self.flight.record("api_shed", client=int(client),
                                           req_id=req.req_id, retry_ms=hint,
                                           depth=depth)
                    await self._wire_send(writer, ApiReply(
                        kind="shed", req_id=req.req_id, success=False,
                        retry_after_ms=hint,
                    ))
                    continue
                # stamped before the append: a request's api_ingress
                # precedes any propose that consumed it
                if self.flight is not None:
                    self.flight.record("api_ingress", client=int(client),
                                       req_id=req.req_id, kind=req.kind)
                if reg is not None:
                    reg.counter_add("api_requests_total")
                    arr = self._arrivals
                    arr[(int(client), req.req_id)] = time.monotonic()
                    if len(arr) > 8192:  # age out reply-less stamps
                        for k in list(arr)[:4096]:
                            del arr[k]
                        reg.counter_add("api_stamps_evicted", 4096)
                with self._lock:
                    self._pending.append((int(client), req))
                    self._batch_ready.set()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            self._writers.pop(int(client), None)
            try:
                writer.close()
            except RuntimeError:
                pass  # loop already closed during teardown

    async def _main(self) -> None:
        host, port = self.api_addr
        self._server = await safetcp.tcp_bind_with_retry(
            host, port, self._servant
        )
        # readiness log line, parsed by cluster scripts
        pf_info(logger, f"accepting clients @ {host}:{port}")
        self._started.set()

    def _run(self) -> None:
        from ..utils.loops import drain_and_close

        loop = asyncio.new_event_loop()
        self._loop = loop
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(self._main())
        except OSError as e:  # the bind failed
            self._loop = None
            self._start_error = e
            self._started.set()
            drain_and_close(loop)
            return
        try:
            loop.run_forever()
        finally:
            drain_and_close(loop)
