"""MuxClientFleet: a selector-multiplexed closed-loop client fleet,
counterpart of ``summerset_tpu/client/muxfleet.py``.

Ten thousand concurrent closed-loop clients cannot be ten thousand
threads (stack memory + scheduler churn alone sink the box long before
the serving path is the bottleneck).  This fleet multiplexes N virtual
clients over a handful of worker threads, each owning one
``selectors.DefaultSelector`` (epoll on Linux) and a slice of the
clients — the same event-loop shape the serving side's asyncio servants
already use, so client count stops being a thread count.

Each virtual client is a tiny nonblocking state machine speaking the
standard safetcp frame format (8-byte BE length + body, where the body
is the compact wirecodec form for hot ``ApiRequest``/``ApiReply``
kinds and pickle otherwise — replies dispatch per frame on the body's
tag byte, so the fleet follows whatever the serving tier emits):

    connect -> send id frame -> { send one op, await its reply } loop

Closed-loop semantics match ``DriverClosedLoop``: one outstanding op per
client; ``shed`` replies honor the server's retry-after hint with
jitter (the client parks, costing no socket traffic); ``redirect``
rotates to the next address; a reply timeout reconnects (round-robin)
and the op is NOT retried — like the threaded drivers, an unanswered op
is simply lost to the bench counters.

Client identities are minted from ``id_base`` upward (default well above
the manager-assigned cid space) — the api plane only uses the id as a
routing key, so a bench fleet does not need ten thousand manager ctrl
round-trips to exist.  ``setrlimit(RLIMIT_NOFILE)`` is raised on a
best-effort basis to fit the fleet's sockets.

Run it in subprocess fleet workers, each with a disjoint ``id_base``,
so the serving process's GIL never pays for client-side pickling:
``python -m summerset_tpu_torch.client.muxfleet SPEC_JSON`` runs one
worker and prints its result as one ``FLEET_RESULT {...}`` line.
"""

from __future__ import annotations

import random
import selectors
import socket
import string
import struct
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..host.messages import ApiReply, ApiRequest
from ..host.statemach import Command
from ..utils import safetcp, wirecodec

_LEN = struct.Struct(">Q")

#: default base for fleet-minted client ids: far above manager cids
#: (1000+) and the learner-id offset band (~500k)
FLEET_ID_BASE = 10_000_000


def raise_nofile(want: int) -> int:
    """Best-effort RLIMIT_NOFILE raise; returns the (possibly
    unchanged) soft limit so callers can scale down loudly instead of
    dying on EMFILE mid-connect."""
    try:
        import resource

        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft < want:
            new_soft = min(max(want, soft), hard)
            resource.setrlimit(resource.RLIMIT_NOFILE, (new_soft, hard))
            soft = new_soft
        return soft
    except Exception:
        return 1 << 20  # unknown platform: assume plenty


def _frame(obj: Any, codec: bool = False) -> bytes:
    # the one codec-or-pickle framing decision lives in safetcp
    return safetcp.encode_frame(obj, codec=codec)


class _VClient:
    """One virtual closed-loop client (owned by exactly one worker)."""

    __slots__ = (
        "idx", "cid", "sock", "out", "buf", "state", "rid", "t_sent",
        "deadline", "addr_i", "rng", "stream", "park_until", "lats",
        "issued", "acked", "shed", "timeouts", "reconnects", "preload",
    )

    def __init__(self, idx: int, cid: int, seed: int, stream=None):
        self.idx = idx
        self.cid = cid
        self.sock: Optional[socket.socket] = None
        self.out = b""
        self.buf = bytearray()
        self.state = "idle"   # idle|connecting|serving|parked
        self.rid = 0
        self.t_sent = 0.0
        self.deadline = 0.0
        self.addr_i = idx     # round-robin start spread over targets
        self.rng = random.Random(seed * 65537 + idx)
        self.stream = stream  # optional WorkloadPlan OpStream
        self.park_until = 0.0
        self.lats: List[float] = []
        self.issued = 0
        self.acked = 0
        self.shed = 0
        self.timeouts = 0
        self.reconnects = 0
        self.preload = True   # first op: put own key (known-key GETs)


class MuxWorker:
    """One selector loop over a slice of the fleet."""

    def __init__(
        self,
        addrs: Sequence[Tuple[str, int]],
        clients: List[_VClient],
        secs: float,
        *,
        put_ratio: float = 0.5,
        value_size: int = 64,
        num_keys: int = 64,
        op_timeout: float = 5.0,
        connect_timeout: float = 10.0,
        think: float = 0.0,
        codec: Optional[bool] = None,
    ):
        # wire codec for outgoing hot requests (None = process default)
        self.codec = (
            wirecodec.default_on() if codec is None else bool(codec)
        )
        self.addrs = [tuple(a) for a in addrs]
        self.clients = clients
        self.secs = float(secs)
        self.put_ratio = float(put_ratio)
        self.value_size = int(value_size)
        self.num_keys = int(num_keys)
        self.op_timeout = float(op_timeout)
        self.connect_timeout = float(connect_timeout)
        # per-client think time between an ack and the next op
        # (jittered ±50%): real closed-loop fleets are not hot loops —
        # 10k concurrent clients at think=30 offer ~330 ops/s total,
        # which is how a connection-scaling bench keeps the offered
        # rate a controlled variable instead of "whatever saturates"
        self.think = max(0.0, float(think))
        self.sel = selectors.DefaultSelector()
        self.connected_peak = 0
        # conservative simultaneity floor: the MIN of established
        # connections across all post-ramp sweeps.  Per-worker minima
        # sum to a valid lower bound of total simultaneous concurrency
        # at EVERY instant of the measured window (each worker's live
        # count never dipped below its min), which per-worker PEAKS
        # taken at different instants do not give
        self.connected_min: Optional[int] = None

    # ------------------------------------------------------- op stream
    def _next_cmd(self, c: _VClient) -> Command:
        if c.preload:
            c.preload = False
            return Command(
                "put", f"mk{c.idx % self.num_keys}",
                "".join(c.rng.choices(string.ascii_lowercase,
                                      k=self.value_size)),
            )
        if c.stream is not None:
            kind, key, size = c.stream.next()
            if kind == "put":
                return Command("put", key, "".join(
                    c.rng.choices(string.ascii_lowercase, k=max(1, size))
                ))
            if kind == "scan":
                # ordered range read starting at the picked key; the
                # stream's size slot carries the YCSB-E scan length
                return Command("scan", key, limit=max(1, int(size)))
            return Command("get", key)
        key = f"mk{c.rng.randrange(self.num_keys)}"
        if c.rng.random() < self.put_ratio:
            return Command("put", key, "".join(
                c.rng.choices(string.ascii_lowercase, k=self.value_size)
            ))
        return Command("get", key)

    # ------------------------------------------------------- plumbing
    def _close(self, c: _VClient) -> None:
        if c.sock is not None:
            try:
                self.sel.unregister(c.sock)
            except (KeyError, ValueError):
                pass
            try:
                c.sock.close()
            except OSError:
                pass
        c.sock = None
        c.out = b""
        c.buf.clear()
        c.state = "idle"

    def _connect(self, c: _VClient, now: float) -> None:
        self._close(c)
        addr = self.addrs[c.addr_i % len(self.addrs)]
        c.addr_i += 1
        s = socket.socket()
        s.setblocking(False)
        try:
            s.connect(addr)
        except BlockingIOError:
            pass
        except OSError:
            s.close()
            c.park_until = now + 0.2
            c.state = "parked"
            return
        c.sock = s
        c.state = "connecting"
        c.deadline = now + self.connect_timeout
        # id frame + first op queued now; flushed as the socket opens
        c.out = _frame(c.cid)
        self.sel.register(s, selectors.EVENT_WRITE, c)

    def _issue(self, c: _VClient, now: float) -> None:
        cmd = self._next_cmd(c)
        c.rid += 1
        c.out += _frame(
            ApiRequest("req", req_id=c.rid, cmd=cmd), codec=self.codec
        )
        c.issued += 1
        c.t_sent = now
        c.deadline = now + self.op_timeout
        self._want_write(c)

    def _want_write(self, c: _VClient) -> None:
        if c.sock is None:
            return
        ev = selectors.EVENT_READ | (
            selectors.EVENT_WRITE if c.out else 0
        )
        try:
            self.sel.modify(c.sock, ev, c)
        except (KeyError, ValueError):
            pass

    # ----------------------------------------------------------- events
    def _on_reply(self, c: _VClient, rep: ApiReply, now: float) -> None:
        if rep.req_id != c.rid:
            return  # stale (pre-reconnect) reply
        if rep.kind in ("reply", "conf") and rep.success:
            c.acked += 1
            c.lats.append(now - c.t_sent)
            if self.think > 0:
                c.park_until = now + self.think * c.rng.uniform(0.5, 1.5)
                c.state = "parked"
            else:
                self._issue(c, now)
        elif rep.kind == "shed":
            c.shed += 1
            hint = max(rep.retry_after_ms, 1) / 1e3
            c.park_until = now + hint * c.rng.uniform(0.5, 1.5)
            c.state = "parked"
        elif rep.kind == "redirect":
            # rotate: against a proxy tier this is "pick another proxy"
            c.reconnects += 1
            self._connect(c, now)
            if c.state == "connecting":
                self._issue(c, now)
        else:
            self._issue(c, now)  # error reply: move on

    def _readable(self, c: _VClient, now: float) -> None:
        try:
            data = c.sock.recv(1 << 16)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            data = b""
        if not data:
            c.reconnects += 1
            self._connect(c, now)
            if c.state == "connecting":
                self._issue(c, now)
            return
        c.buf += data
        while True:
            if len(c.buf) < 8:
                break
            n = _LEN.unpack_from(c.buf, 0)[0]
            if len(c.buf) < 8 + n:
                break
            body = bytes(c.buf[8:8 + n])
            del c.buf[:8 + n]
            try:
                rep = wirecodec.decode_body(body)
            except Exception:
                continue
            if isinstance(rep, ApiReply):
                self._on_reply(c, rep, now)
                if c.sock is None or c.state != "serving":
                    break

    def _writable(self, c: _VClient, now: float) -> None:
        if c.state == "connecting":
            err = c.sock.getsockopt(
                socket.SOL_SOCKET, socket.SO_ERROR
            )
            if err:
                c.reconnects += 1
                c.park_until = now + 0.2
                self._close(c)
                c.state = "parked"
                return
            # a staggered first op (think mode) parks until its slot
            c.state = "parked" if (
                self.think > 0 and c.rid == 0
            ) else "serving"
        if c.out:
            try:
                sent = c.sock.send(c.out)
                c.out = c.out[sent:]
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                c.reconnects += 1
                self._connect(c, now)
                if c.state == "connecting":
                    self._issue(c, now)
                return
        self._want_write(c)

    # -------------------------------------------------------------- run
    def run(self) -> Dict[str, Any]:
        t0 = time.monotonic()
        t_end = t0 + self.secs
        for c in self.clients:
            self._connect(c, t0)
            if c.state != "connecting":
                continue
            if self.think > 0:
                # stagger first ops across the think window: all
                # connections come up now (the concurrency target), but
                # a synchronized 10k-op volley at t0 would measure the
                # ramp, not the steady closed loop
                c.park_until = t0 + c.rng.uniform(0.0, self.think)
            else:
                self._issue(c, t0)
        next_sweep = t0
        while True:
            now = time.monotonic()
            if now >= t_end:
                break
            for key, mask in self.sel.select(timeout=0.05):
                c: _VClient = key.data
                now = time.monotonic()
                if mask & selectors.EVENT_WRITE:
                    self._writable(c, now)
                if c.sock is not None and (mask & selectors.EVENT_READ):
                    self._readable(c, now)
            if now >= next_sweep:
                next_sweep = now + 0.25
                live = 0
                est = 0
                for c in self.clients:
                    if c.state == "parked" and now >= c.park_until:
                        if c.sock is None:
                            self._connect(c, now)
                            if c.state == "connecting":
                                self._issue(c, now)
                        else:
                            c.state = "serving"
                            self._issue(c, now)
                    elif c.state in ("serving", "connecting") \
                            and now > c.deadline:
                        c.timeouts += 1
                        c.reconnects += 1
                        self._connect(c, now)
                        if c.state == "connecting":
                            self._issue(c, now)
                    if c.sock is not None and c.state in (
                        "serving", "parked", "connecting",
                    ):
                        # live = an actual socket fd exists (serving,
                        # parked-with-connection through a backoff, or
                        # a connect in flight); a sock-less parked
                        # client is a FAILED connect and must not count
                        # toward the concurrency claim
                        live += 1
                        if c.state != "connecting":
                            est += 1  # handshake actually completed
                self.connected_peak = max(self.connected_peak, live)
                if now - t0 >= min(10.0, self.secs * 0.5):
                    # capped at half the run so short runs still record
                    # a floor instead of reporting 0 concurrency
                    # past the ramp: track the established-connection
                    # floor (half-open connects deliberately excluded)
                    self.connected_min = (
                        est if self.connected_min is None
                        else min(self.connected_min, est)
                    )
        for c in self.clients:
            self._close(c)
        self.sel.close()
        lats = sorted(
            x for c in self.clients for x in c.lats
        )
        dt = time.monotonic() - t0

        def pct(q: float) -> float:
            if not lats:
                return 0.0
            return lats[min(len(lats) - 1, int(len(lats) * q))]

        return {
            "clients": len(self.clients),
            "connected_peak": self.connected_peak,
            "connected_min": (
                self.connected_min if self.connected_min is not None
                else 0
            ),
            "secs": round(dt, 3),
            "issued": sum(c.issued for c in self.clients),
            "acked": sum(c.acked for c in self.clients),
            "shed": sum(c.shed for c in self.clients),
            "timeouts": sum(c.timeouts for c in self.clients),
            "reconnects": sum(c.reconnects for c in self.clients),
            "tput": round(sum(c.acked for c in self.clients) / dt, 2),
            "lat_p50_ms": round(pct(0.50) * 1e3, 3),
            "lat_p99_ms": round(pct(0.99) * 1e3, 3),
        }


def run_fleet(
    addrs: Sequence[Tuple[str, int]],
    clients: int,
    secs: float,
    *,
    put_ratio: float = 0.5,
    value_size: int = 64,
    num_keys: int = 64,
    seed: int = 1,
    op_timeout: float = 5.0,
    id_base: int = FLEET_ID_BASE,
    plan=None,
    think: float = 0.0,
    codec: Optional[bool] = None,
) -> Dict[str, Any]:
    """Run ``clients`` multiplexed closed-loop clients against ``addrs``
    for ``secs`` on THIS thread (callers wanting parallel pickling run
    several of these in subprocess workers, each with a disjoint
    ``id_base``).  ``plan`` (a WorkloadPlan) swaps the uniform op mix
    for per-client seeded opstreams."""
    raise_nofile(clients + 64)
    vcs = [
        _VClient(
            i, id_base + i, seed,
            stream=plan.opstream(i % max(1, plan.clients))
            if plan is not None else None,
        )
        for i in range(int(clients))
    ]
    worker = MuxWorker(
        addrs, vcs, secs,
        put_ratio=put_ratio, value_size=value_size,
        num_keys=num_keys, op_timeout=op_timeout, think=think,
        codec=codec,
    )
    return worker.run()


def main(argv=None) -> int:
    """One fleet worker process: ``run_fleet`` on the JSON spec's
    arguments (``addrs`` as ``[[host, port], ...]``); prints the result
    as one ``FLEET_RESULT {...}`` line, after the soft nofile limit it
    got (``NOFILE n``) so a short fleet is never silent."""
    import json
    import sys

    spec = json.loads((argv if argv is not None else sys.argv[1:])[0])
    addrs = [tuple(a) for a in spec.pop("addrs")]
    clients = int(spec.pop("clients"))
    secs = float(spec.pop("secs"))
    limit = raise_nofile(clients + 64)
    print(f"NOFILE {limit}", flush=True)
    if limit < clients + 64:
        print(f"FLEET_ERROR nofile soft limit {limit} cannot hold "
              f"{clients} sockets", flush=True)
        return 1
    out = run_fleet(addrs, clients, secs, **spec)
    out["nofile"] = limit
    print("FLEET_RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
