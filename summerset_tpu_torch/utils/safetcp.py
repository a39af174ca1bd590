"""Length-prefixed message framing over TCP, counterpart of
``summerset_tpu/utils/safetcp.py``.

Parity: reference ``src/utils/safetcp.rs`` — 8-byte big-endian length
prefix + serialized body (``safe_tcp_read:31`` / ``safe_tcp_write:105``),
plus ``tcp_bind_with_retry``.

The body has two formats, dispatched per frame on its first byte
(``utils/wirecodec.py``, the port's copy of the JAX codec): pickle
(``0x80``; the universal fallback and the only format of the cold and
control kinds) and the codec (``0xC7``) for the hot data-plane kinds —
tick frames and ``req``/``reply``/``shed``/``batch``/``note``/``probe``
api messages.  Because dispatch is per frame, a codec-on sender and a
codec-off sender interoperate on one mesh with no negotiation, and a
port process decodes a JAX process's codec bodies (and the reverse)
wherever the pickled class paths allow.

Hot-path I/O: egress is one ``socket.sendmsg`` over the encoder's segment
list (the length prefix, the small-field chunks and zero-copy ndarray
views, no join copy); ingress reads the length prefix into a reusable
buffer and the body into one exact-size buffer with ``recv_into``.  Body
buffers are per frame on purpose: the codec decodes ndarray lanes as
views into the received body.  The JAX module's seeded frame faults
(``FrameFaults``) belong to the nemesis plane and are not ported.
"""

from __future__ import annotations

import asyncio
import errno
import pickle
import struct
import time
from typing import Any, List, Optional, Tuple

from . import wirecodec
from .errors import SummersetError

_LEN = struct.Struct(">Q")

# Refuse absurd frames (reference caps values at 16MB; give headroom).
MAX_FRAME = 64 * 1024 * 1024

#: sendmsg scatter-gather cap (IOV_MAX is 1024 on Linux; stay under it)
_IOV_MAX = 512

#: the one decode dispatch (codec bodies by magic, else pickle); raises
#: :class:`wirecodec.WireDecodeError` on a truncated or garbage body
decode_body = wirecodec.decode_body


def encode_frame(obj: Any, codec: Optional[bool] = None) -> bytes:
    """One joined frame (8-byte BE length + body).  ``codec=None``
    follows the process default; the codec engages only for hot objects
    (``wirecodec.is_hot``), everything else stays pickle."""
    if codec is None:
        codec = wirecodec.default_on()
    if codec and wirecodec.is_hot(obj):
        body = wirecodec.encode_body(obj)
    else:
        body = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    return _LEN.pack(len(body)) + body


def encode_frame_into(
    obj: Any, enc: "wirecodec.FrameEncoder", codec: Optional[bool] = None
) -> Tuple[List[Any], int]:
    """Encode one frame as a segment list for vectored egress: the
    length prefix, the encoder's small-field chunks and zero-copy
    ndarray views.  Returns ``(segments, total_bytes)``.  The segments
    borrow ``enc``'s scratch and the frame's own buffers: send them
    (:func:`sendmsg_all`), then ``enc.release()``."""
    if codec is None:
        codec = wirecodec.default_on()
    if codec and wirecodec.is_hot(obj):
        segs, blen = enc.encode_frame_into(obj)
        return [_LEN.pack(blen)] + segs, 8 + blen
    body = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    return [_LEN.pack(len(body)), body], 8 + len(body)


def _advance(segs: List[Any], sent: int) -> List[Any]:
    """The segments left after ``sent`` bytes of ``segs`` went out."""
    idx = 0
    while sent > 0:
        n = len(segs[idx])
        if sent >= n:
            sent -= n
            idx += 1
        else:
            segs = list(segs)
            segs[idx] = memoryview(segs[idx])[sent:]
            sent = 0
    return segs[idx:]


def sendmsg_all(sock, segs: List[Any], total: int) -> None:
    """``sendall`` over a segment list with ``socket.sendmsg``: the whole
    frame leaves in one syscall in the common case; a partial send
    resumes from the exact byte.  Returns once every byte is in the
    kernel's socket buffer, so the caller may reuse the arrays the
    segments view."""
    remaining = total
    while remaining > 0:
        sent = sock.sendmsg(segs[:_IOV_MAX])
        remaining -= sent
        if remaining > 0:
            segs = _advance(segs, sent)


def encode_frame_bytes(
    obj: Any, enc: "wirecodec.FrameEncoder",
    codec: Optional[bool] = None,
) -> bytes:
    """One joined frame through a caller-owned encoder (asyncio writers
    that need bytes)."""
    segs, _total = encode_frame_into(obj, enc, codec=codec)
    try:
        return b"".join(
            s if type(s) is bytes else bytes(s) for s in segs
        )
    finally:
        enc.release()


async def send_msg(writer: asyncio.StreamWriter, obj: Any) -> None:
    writer.write(encode_frame(obj))
    await writer.drain()


async def recv_msg(reader: asyncio.StreamReader) -> Any:
    return (await recv_msg_timed(reader))[0]


async def recv_msg_timed(reader: asyncio.StreamReader) -> Tuple[Any, float]:
    """:func:`recv_msg` plus the decode-only wall seconds (the socket
    wait excluded)."""
    hdr = await reader.readexactly(_LEN.size)
    (length,) = _LEN.unpack(hdr)
    if length > MAX_FRAME:
        raise SummersetError(f"frame length {length} exceeds cap {MAX_FRAME}")
    body = await reader.readexactly(length)
    t0 = time.monotonic()
    obj = decode_body(body)
    return obj, time.monotonic() - t0


def send_msg_sync(sock, obj: Any, codec: Optional[bool] = None) -> None:
    """Blocking-socket variant (CLI tools, ctrl planes, the api stub)."""
    sock.sendall(encode_frame(obj, codec=codec))


def _recv_exact_into(sock, view: memoryview, consumed_before: int) -> None:
    """Fill ``view`` with ``recv_into``.

    A timeout on a timeout-armed socket propagates as ``socket.timeout``
    only when zero bytes of the frame were consumed (the stream is still
    frame-aligned and the caller may retry in place); after partial
    consumption it raises :class:`SummersetError`, because the next read
    would start mid-frame."""
    got = 0
    n = len(view)
    while got < n:
        try:
            k = sock.recv_into(view[got:])
        except TimeoutError:
            if consumed_before or got:
                raise SummersetError(
                    f"recv timed out mid-frame ({consumed_before + got} "
                    "bytes consumed): stream no longer frame-aligned"
                ) from None
            raise
        if not k:
            raise SummersetError("connection closed mid-frame")
        got += k


class FrameReceiver:
    """Per-connection ingress state for a receive loop: a reusable
    length-prefix buffer plus one exact-size body buffer per frame
    (decoded ndarray lanes are views into it, so it is never reused)."""

    __slots__ = ("_hdr", "_hdr_mv")

    def __init__(self):
        self._hdr = bytearray(_LEN.size)
        self._hdr_mv = memoryview(self._hdr)

    def recv_raw(self, sock) -> memoryview:
        """Receive one frame's body bytes, undecoded."""
        _recv_exact_into(sock, self._hdr_mv, 0)
        (length,) = _LEN.unpack(self._hdr)
        if length > MAX_FRAME:
            raise SummersetError(
                f"frame length {length} exceeds cap {MAX_FRAME}"
            )
        body = bytearray(length)
        _recv_exact_into(sock, memoryview(body), _LEN.size)
        return memoryview(body)

    def recv(self, sock) -> Tuple[Any, int]:
        """Receive and decode one frame; returns ``(obj, body_len)``."""
        body = self.recv_raw(sock)
        return decode_body(body), len(body)


def recv_msg_sync(sock) -> Any:
    """Receive and decode one frame from a blocking socket."""
    return FrameReceiver().recv(sock)[0]


async def tcp_bind_with_retry(
    host: str, port: int, handler, retries: int = 10, delay: float = 0.2
) -> asyncio.base_events.Server:
    """Bind a TCP server, retrying on transient EADDRINUSE."""
    for attempt in range(retries + 1):
        try:
            return await asyncio.start_server(handler, host, port)
        except OSError as e:
            if e.errno != errno.EADDRINUSE or attempt == retries:
                raise
            await asyncio.sleep(delay)
    raise SummersetError("unreachable")
