"""Length-prefixed message framing over TCP, counterpart of
``summerset_tpu/utils/safetcp.py``.

Parity: reference ``src/utils/safetcp.rs`` — 8-byte big-endian length
prefix + serialized body (``safe_tcp_read:31`` / ``safe_tcp_write:105``),
plus ``tcp_bind_with_retry``.

Frame bodies are pickle only (first byte ``0x80``).  The JAX package's
compact wire codec (body magic ``0xC7``) is not ported: such a body
raises :class:`SummersetError` naming the missing codec instead of being
misread.
"""

from __future__ import annotations

import asyncio
import errno
import pickle
import struct
from typing import Any

from .errors import SummersetError

_LEN = struct.Struct(">Q")

# Refuse absurd frames (reference caps values at 16MB; give headroom).
MAX_FRAME = 64 * 1024 * 1024

#: first byte of a pickle body (protocol >= 2)
PICKLE_MAGIC = 0x80
#: first byte of a wire-codec body (summerset_tpu/utils/wirecodec.py)
CODEC_MAGIC = 0xC7


def decode_body(body) -> Any:
    """Decode one frame body; only pickle bodies are understood."""
    if len(body) == 0:
        raise SummersetError("empty frame body")
    first = body[0]
    if first == CODEC_MAGIC:
        raise SummersetError(
            "frame body in the wire-codec format (magic 0xC7): the codec "
            "(summerset_tpu/utils/wirecodec.py) is not ported to "
            "summerset_tpu_torch; send pickle frames"
        )
    if first != PICKLE_MAGIC:
        raise SummersetError(
            f"unknown frame body format (first byte {first:#04x})"
        )
    return pickle.loads(body)


def encode_frame(obj: Any) -> bytes:
    """One joined frame (8-byte BE length + pickle body)."""
    body = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    return _LEN.pack(len(body)) + body


async def send_msg(writer: asyncio.StreamWriter, obj: Any) -> None:
    writer.write(encode_frame(obj))
    await writer.drain()


async def recv_msg(reader: asyncio.StreamReader) -> Any:
    hdr = await reader.readexactly(_LEN.size)
    (length,) = _LEN.unpack(hdr)
    if length > MAX_FRAME:
        raise SummersetError(f"frame length {length} exceeds cap {MAX_FRAME}")
    return decode_body(await reader.readexactly(length))


def send_msg_sync(sock, obj: Any) -> None:
    """Blocking-socket variant (CLI tools, ctrl planes, the tick mesh)."""
    sock.sendall(encode_frame(obj))


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


def recv_body_sync(sock) -> bytearray:
    """Receive one frame's body (undecoded) from a blocking socket."""
    hdr = bytearray(_LEN.size)
    _recv_exact_into(sock, memoryview(hdr), 0)
    (length,) = _LEN.unpack(hdr)
    if length > MAX_FRAME:
        raise SummersetError(f"frame length {length} exceeds cap {MAX_FRAME}")
    body = bytearray(length)
    _recv_exact_into(sock, memoryview(body), _LEN.size)
    return body


def recv_msg_sync(sock) -> Any:
    """Receive and decode one frame from a blocking socket."""
    return decode_body(recv_body_sync(sock))


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

