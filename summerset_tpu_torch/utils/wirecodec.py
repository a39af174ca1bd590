"""Wire-plane binary codec, the port's own copy of
``summerset_tpu/utils/wirecodec.py``: compact, versioned, self-describing
frames for the HOT message kinds, with pickle as the universal fallback.
The grammar, the tags, the struct ids and their field order equal the JAX
package's, so the two codecs write byte-identical bodies for equal content
wherever no pickle blob is involved (hot requests and replies, struct-id
bodies, notes, batches); a tick frame's rest-pickle blob carries the
payload parts, whose pickled class paths name each package's own message
classes.  ``_ensure_structs`` registers the port's classes.  One
difference: ``decode_body`` refuses a body that opens with neither the
codec magic nor the pickle PROTO opcode instead of unpickling it.

Every safetcp frame is ``8-byte BE length + body``.  Historically the
body was always ``pickle.dumps`` of a plain Python object; on the hot
planes (p2p tick frames, client ``req``/``reply``/``shed`` traffic,
proxy forward batches) that pays a full serialize + copy per frame per
peer per tick.  This module adds a second body format distinguished by
its FIRST BYTE:

- ``0x80`` (pickle protocol 2+ opcode)  -> legacy pickle body;
- :data:`MAGIC` (``0xC7``)              -> wirecodec body.

Because the decoder dispatches per frame on that tag byte, a mixed mesh
(codec-on peer talking to a codec-off peer) interoperates frame by
frame with no negotiation: every NEW decoder reads both formats, and a
codec-off sender simply keeps emitting pickle.  The codec is only ever
an ENCODER-side choice, flipped by the ``wire_codec`` server knob / the
``SMR_WIRE_CODEC`` env default (see :func:`default_on`).

Body grammar (all fixed-width ints little-endian; lengths ``u32``)::

    body    := MAGIC(0xC7) VERSION(0x01) value
    value   := tag(u8) payload
    tags      0x01 None | 0x02 False | 0x03 True
              0x04 i8 scalar | 0x05 i64 scalar | 0x0F bigint (u32 len,
                   signed little-endian bytes)
              0x06 f64 | 0x07 bytes (u32 len) | 0x08 str (u32 len, utf8)
              0x09 tuple (u32 n) | 0x0A list (u32 n)
              0x0B dict (u32 n, key value pairs)
              0x0C ndarray: u8 dtype-str len, dtype.str utf8 (carries
                   endianness, e.g. "<i4"), u8 ndim, ndim * u32 dims,
                   zero-pad to 8-byte alignment FROM BODY START, raw
                   bytes — decoded zero-copy via ``np.frombuffer`` over
                   a memoryview of the received body
              0x0D struct: u8 struct-id, then the registered fields in
                   declaration order (ApiRequest / ApiReply / Command /
                   CommandResult / ShardPayload)
              0x0E pickle escape (u32 len, pickle bytes): any value the
                   grammar does not cover rides through verbatim, so a
                   codec frame can always be built — "hot" is a fast
                   path, never a compatibility wall

Four SPECIALIZED top-level tags cover the steady-state frame shapes,
where a generic per-value walk would give back most of the win (they
appear only as the body's first value; nested occurrences of the same
objects use the generic tags):

              0x10 tick frame: i64 tick, u32 rest-pickle len + blob
                   (every non-lane payload key, C-speed both ways),
                   u8 lane count, u16 schema len + a CONTIGUOUS schema
                   block (per lane: u8 name len, name, u8 dtype len,
                   dtype.str, u8 ndim, ndim * u32 dims), then the raw
                   lane arrays each 8-aligned from body start.  The
                   contiguous schema is the decode accelerator: its
                   bytes are memoized, so a steady mesh decodes each
                   frame's lane table with one dict hit + one zero-copy
                   view per lane instead of re-parsing dtype/shape
                   strings every tick
              0x11 hot ApiRequest (req/probe with a get/put Command):
                   u8 kind, i64 req_id, u8 cmd kind, u32 key len,
                   u32 value len + 1 (0 = None), key utf8, value utf8
              0x12 hot ApiReply (reply/shed/note/probe): u8 kind,
                   i64 req_id, u8 flag bits (success/rq_retry/local/
                   has_result/has_redirect/has_notes), u32
                   retry_after_ms, i64 seq, then the optional result
                   (u8 kind, u32 len + 1 value/old_value pairs),
                   i32 redirect, and a packed note list (u32 n, then
                   per note i64 seq, u32 key len, u32 value len + 1)
              0x13 batch ApiRequest (proxy forward): i64 req_id, u32 n,
                   then per op i64 prid, u8 cmd kind, u32 key len,
                   u32 value len + 1, key, value

Encoding is segment-oriented: :class:`FrameEncoder` writes scalars and
small fields into a reusable scratch list that one C-speed join
coalesces, and emits ndarray payloads as zero-copy ``memoryview``
segments referencing the array's own buffer — the segment list feeds
``socket.sendmsg`` (vectored I/O), so a tick frame's lane arrays go
from kernel outbox to the NIC without a single Python-side copy.
Decoding never raises a bare ``struct.error``: truncated, garbage, or
over-cap bodies raise the typed :class:`WireDecodeError`.
"""

from __future__ import annotations

import os
import pickle
import struct
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .errors import SummersetError

MAGIC = 0xC7
VERSION = 1
#: first byte of every pickle body at protocol >= 2 (the PROTO opcode)
PICKLE_PROTO = 0x80

#: hard caps enforced on decode (a garbage length field must fail the
#: frame, never allocate unboundedly); MAX_BODY mirrors safetcp's frame
#: cap so the two layers agree on "absurd"
MAX_BODY = 64 * 1024 * 1024
MAX_ITEMS = 1 << 24
MAX_DEPTH = 32

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_I32 = struct.Struct("<i")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")

T_NONE = 0x01
T_FALSE = 0x02
T_TRUE = 0x03
T_I8 = 0x04
T_I64 = 0x05
T_F64 = 0x06
T_BYTES = 0x07
T_STR = 0x08
T_TUPLE = 0x09
T_LIST = 0x0A
T_DICT = 0x0B
T_NDARRAY = 0x0C
T_STRUCT = 0x0D
T_PICKLE = 0x0E
T_BIGINT = 0x0F
T_TICKFRAME = 0x10
T_REQ = 0x11
T_REPLY = 0x12
T_BATCH = 0x13

# fast-path field packers (fixed little-endian layouts)
_REQ_HDR = struct.Struct("<BqBII")       # kind, req_id, ck, klen, vlen+1
_REPLY_HDR = struct.Struct("<BqBIq")     # kind, req_id, flags, retry, seq
_RESULT_HDR = struct.Struct("<BII")      # kind, vlen+1, ovlen+1
_BATCH_HDR = struct.Struct("<qI")        # req_id, n ops
_BOP_HDR = struct.Struct("<qBII")        # prid, ck, klen, vlen+1
_NOTE_HDR = struct.Struct("<qII")        # seq, klen, vlen+1
_TICK_HDR = struct.Struct("<qI")         # tick, rest-pickle len

_REQ_KINDS = ("req", "probe")
_REPLY_KINDS = ("reply", "shed", "note", "probe")
_CMD_KINDS = ("get", "put")
_REQ_KIND_ID = {k: i for i, k in enumerate(_REQ_KINDS)}
_REPLY_KIND_ID = {k: i for i, k in enumerate(_REPLY_KINDS)}
_CMD_KIND_ID = {k: i for i, k in enumerate(_CMD_KINDS)}

_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


class WireEncodeError(SummersetError):
    """A value the caller asserted codec-encodable was not."""


class WireDecodeError(SummersetError):
    """Truncated / garbage / over-cap codec body.  The one decode
    error type: callers treat it exactly like a pickle failure (dead
    frame), and it NEVER surfaces as a bare ``struct.error``."""


# --------------------------------------------------------------- registry
# Struct ids are wire format: appending is fine, renumbering or field
# reordering breaks mixed-version meshes (same contract as the frame
# tags).  Fields are encoded positionally in declaration order.
_STRUCTS: List[Optional[Tuple[type, Tuple[str, ...]]]] = [None] * 8
_STRUCT_ID: Dict[type, int] = {}
_structs_ready = False
# class refs for the specialized fast paths (set by _ensure_structs)
_CLS_REQ = _CLS_REPLY = _CLS_CMD = _CLS_RESULT = None


def _register(sid: int, cls: type, fields: Tuple[str, ...]) -> None:
    _STRUCTS[sid] = (cls, fields)
    _STRUCT_ID[cls] = sid


def _ensure_structs() -> None:
    """Lazy one-shot registration of the port's host message dataclasses
    under the JAX package's ids and field tuples.

    Lives here (not in host/messages.py) so a bare ``utils`` import
    never drags the host package in, while any process that actually
    encodes/decodes these types resolves them on first use."""
    global _structs_ready, _CLS_REQ, _CLS_REPLY, _CLS_CMD, _CLS_RESULT
    if _structs_ready:
        return
    from ..host.messages import ApiReply, ApiRequest, ShardPayload
    from ..host.statemach import Command, CommandResult

    _register(1, ApiRequest,
              ("kind", "req_id", "cmd", "conf_delta", "batch"))
    _register(2, ApiReply,
              ("kind", "req_id", "result", "redirect", "success",
               "rq_retry", "local", "retry_after_ms", "seq", "notes"))
    # scan fields appended (wire-safe per the registry contract above):
    # old decoders drop them, old encoders omit them and the dataclass
    # defaults fill in — only scan traffic, which old peers never
    # originate, actually populates them
    _register(3, Command, ("kind", "key", "value", "end", "limit"))
    _register(4, CommandResult, ("kind", "value", "old_value", "items"))
    _register(5, ShardPayload, ("data_len", "shards"))
    _CLS_REQ, _CLS_REPLY = ApiRequest, ApiReply
    _CLS_CMD, _CLS_RESULT = Command, CommandResult
    _structs_ready = True


# tick-frame lane-schema memos: encode side keys the built block by the
# lanes' (name, dtype, shape) tuple; decode side keys the parsed
# [(name, dtype, shape, nbytes), ...] table by the block's bytes.  Both
# are tiny (one entry per kernel config variant in the mesh) and live
# for the process.
_SCHEMA_ENC: Dict[tuple, bytes] = {}
_SCHEMA_DEC: Dict[bytes, list] = {}

# the encoder-side hot gate: only these ApiRequest/ApiReply kinds ride
# the codec — cold/ctrl kinds (conf, leave, sub, stats, redirect,
# error, ...) stay pickle, per the wire-plane contract
HOT_REQUEST_KINDS = frozenset(("req", "batch", "probe"))
HOT_REPLY_KINDS = frozenset(("reply", "shed", "note", "probe"))

_default_on = os.environ.get(
    "SMR_WIRE_CODEC", "1"
).strip().lower() not in ("0", "off", "false", "no")


def default_on() -> bool:
    """Process-wide codec default (env ``SMR_WIRE_CODEC``, on unless
    explicitly disabled).  Components take ``codec=None`` to mean
    "follow this": one env var flips a whole child process for A/B
    runs, while explicit ``codec=True/False`` pins one instance (the
    mixed-mesh tests)."""
    return _default_on


def set_default(on: bool) -> bool:
    """Flip the process default (tests / bench harnesses); returns the
    previous value."""
    global _default_on
    prev = _default_on
    _default_on = bool(on)
    return prev


def payload_nbytes(obj: Any) -> int:
    """Wire size of a payload-plane object (the ``pp`` piggyback) as the
    frame formats actually serialize it.  BOTH formats pickle it at
    ``HIGHEST_PROTOCOL``: the codec tick frame carries every non-lane
    payload key in its C-speed rest-pickle blob, and the pickle fallback
    pickles the whole frame the same way — so the shard-economy meters
    (``pp_bytes``) size with this one helper instead of a bare default-
    protocol ``pickle.dumps`` that diverges from the wire."""
    return len(pickle.dumps(obj, pickle.HIGHEST_PROTOCOL))


def is_hot(obj: Any) -> bool:
    """Should this object take the codec fast path?  Hot = the data
    plane's steady-state kinds; everything else is rare enough that
    pickle's universality wins."""
    _ensure_structs()
    t = type(obj)
    if t is _CLS_REQ:
        return obj.kind in HOT_REQUEST_KINDS
    if t is _CLS_REPLY:
        return obj.kind in HOT_REPLY_KINDS
    # transport tick frames: (tick:int, payload:dict)
    return (
        t is tuple and len(obj) == 2
        and type(obj[0]) is int and type(obj[1]) is dict
    )


# ---------------------------------------------------------------- encoder
# Hot-path notes: the specialized paths dispatch BEFORE the generic
# closures are built (their construction alone costs more than a small
# frame), append a handful of small ``bytes`` objects that one C-speed
# ``b"".join`` coalesces, and emit ndarray payloads as ZERO-COPY
# memoryview segments straight into ``socket.sendmsg``.  This is what
# lets a pure-Python codec beat C pickle per frame: pickle walks every
# array through a Python-level ``__reduce_ex__`` AND copies the raw
# bytes into its output; here the raw bytes are never touched.


class FrameEncoder:
    """Reusable segment-oriented encoder (one per hub hot loop).

    ``encode_frame_into(obj)`` returns ``(segments, body_len)`` where
    ``segments`` is a list of buffer objects (joined small-field chunks
    + zero-copy ndarray views) whose concatenation is the codec body.
    The internal scratch list is reused across calls; ndarray segments
    reference live array buffers, so callers finish the send (or copy)
    before mutating the arrays — the tick loop's natural discipline
    (encode, sendmsg, next tick).  :meth:`release` drops the buffer
    references afterwards."""

    __slots__ = ("_parts", "_segs")

    def __init__(self):
        self._parts: list = []
        self._segs: list = []

    def encode_frame_into(self, obj: Any) -> Tuple[List[Any], int]:
        if not _structs_ready:
            _ensure_structs()
        segs = self._segs
        parts = self._parts
        del segs[:]
        del parts[:]
        ap = parts.append
        ap(b"\xc7\x01")
        # ---- specialized fast paths.  Each validates fully BEFORE its
        # first append, so a fallback leaves only the magic prefix in
        # ``parts`` and the generic walk below re-encodes from scratch.
        t = type(obj)
        if t is _CLS_REQ:
            if _fast_request(obj, ap):
                body = b"".join(parts)
                del parts[:]
                segs.append(body)
                return segs, len(body)
        elif t is _CLS_REPLY:
            if _fast_reply(obj, ap):
                body = b"".join(parts)
                del parts[:]
                segs.append(body)
                return segs, len(body)
        elif (
            t is tuple and len(obj) == 2 and type(obj[0]) is int
            and type(obj[1]) is dict and type(obj[1].get("msg")) is dict
        ):
            blen = _fast_tick(obj, ap, parts, segs)
            if blen:
                if parts:
                    segs.append(b"".join(parts))
                    del parts[:]
                return segs, blen
        return self._generic(obj, parts, segs)

    def _generic(self, obj: Any, parts: list, segs: list
                 ) -> Tuple[List[Any], int]:
        ap = parts.append
        blen = 2  # MAGIC + VERSION already in parts
        # local bindings: the recursion below is the per-frame hot loop
        pk_i64 = _I64.pack
        pk_u32 = _U32.pack
        pk_f64 = _F64.pack
        struct_id = _STRUCT_ID
        structs = _STRUCTS
        ndarray_t = np.ndarray

        def flush() -> None:
            if parts:
                segs.append(b"".join(parts))
                del parts[:]

        def enc(obj, depth: int) -> None:
            nonlocal blen
            if depth > MAX_DEPTH:
                raise WireEncodeError("wirecodec: nesting too deep")
            t = type(obj)
            if t is int:
                if -128 <= obj <= 127:
                    ap(bytes((T_I8, obj & 0xFF)))
                    blen += 2
                elif _I64_MIN <= obj <= _I64_MAX:
                    ap(b"\x05" + pk_i64(obj))
                    blen += 9
                else:
                    raw = obj.to_bytes(
                        (obj.bit_length() + 8) // 8, "little", signed=True
                    )
                    ap(b"\x0f" + pk_u32(len(raw)) + raw)
                    blen += 5 + len(raw)
            elif t is str:
                raw = obj.encode("utf-8")
                ap(b"\x08" + pk_u32(len(raw)))
                ap(raw)
                blen += 5 + len(raw)
            elif obj is None:
                ap(b"\x01")
                blen += 1
            elif t is bool:
                ap(b"\x03" if obj else b"\x02")
                blen += 1
            elif t is float:
                ap(b"\x06" + pk_f64(obj))
                blen += 9
            elif t is tuple:
                ap(b"\x09" + pk_u32(len(obj)))
                blen += 5
                for x in obj:
                    enc(x, depth + 1)
            elif t is list:
                ap(b"\x0a" + pk_u32(len(obj)))
                blen += 5
                for x in obj:
                    enc(x, depth + 1)
            elif t is dict:
                ap(b"\x0b" + pk_u32(len(obj)))
                blen += 5
                for k, v in obj.items():
                    enc(k, depth + 1)
                    enc(v, depth + 1)
            elif t is ndarray_t:
                if obj.dtype.hasobject:
                    raw = pickle.dumps(obj, pickle.HIGHEST_PROTOCOL)
                    ap(b"\x0e" + pk_u32(len(raw)))
                    ap(raw)
                    blen += 5 + len(raw)
                    return
                if not obj.flags.c_contiguous:
                    obj = np.ascontiguousarray(obj)
                ds = obj.dtype.str.encode("ascii")
                hdr = (
                    bytes((T_NDARRAY, len(ds)))
                    + ds
                    + bytes((obj.ndim,))
                    + b"".join(pk_u32(d) for d in obj.shape)
                )
                blen += len(hdr)
                pad = (-blen) % 8  # align raw data from body start
                if pad:
                    hdr += b"\x00" * pad
                    blen += pad
                ap(hdr)
                nb = obj.nbytes
                if nb:
                    blen += nb
                    if nb > 128:
                        # zero-copy: segment references the array buffer
                        flush()
                        segs.append(obj.data.cast("B"))
                    else:
                        ap(obj.tobytes())
            elif t is bytes:
                n = len(obj)
                ap(b"\x07" + pk_u32(n))
                blen += 5 + n
                if n > 512:
                    flush()
                    segs.append(obj)
                else:
                    ap(obj)
            else:
                sid = struct_id.get(t)
                if sid is not None:
                    ap(bytes((T_STRUCT, sid)))
                    blen += 2
                    for f in structs[sid][1]:
                        enc(getattr(obj, f), depth + 1)
                elif isinstance(obj, np.generic):
                    # numpy scalars leak into frames; canonicalize
                    # rather than pickle-escape them
                    if isinstance(obj, np.bool_):
                        enc(bool(obj), depth)
                    elif isinstance(obj, np.integer):
                        enc(int(obj), depth)
                    elif isinstance(obj, np.floating):
                        enc(float(obj), depth)
                    else:
                        raw = pickle.dumps(obj, pickle.HIGHEST_PROTOCOL)
                        ap(b"\x0e" + pk_u32(len(raw)))
                        ap(raw)
                        blen += 5 + len(raw)
                else:
                    raw = pickle.dumps(obj, pickle.HIGHEST_PROTOCOL)
                    ap(b"\x0e" + pk_u32(len(raw)))
                    ap(raw)
                    blen += 5 + len(raw)

        enc(obj, 0)
        flush()
        return segs, blen

    def encode_bytes(self, obj: Any) -> bytes:
        """Joined-body convenience (asyncio writers, tests)."""
        segs, _n = self.encode_frame_into(obj)
        try:
            if len(segs) == 1 and type(segs[0]) is bytes:
                return segs[0]
            return b"".join(
                s if type(s) is bytes else bytes(s) for s in segs
            )
        finally:
            self.release()

    def release(self) -> None:
        """Drop buffer references (ndarray views) so the frame's
        arrays are mutable again.  Send paths call this after the bytes
        are on the wire."""
        del self._segs[:]
        del self._parts[:]


# -- specialized encoders (module level: no per-call closure builds) ------
def _fast_request(obj, ap) -> bool:
    """T_REQ / T_BATCH for hot ApiRequests; False = generic fallback."""
    kid = _REQ_KIND_ID.get(obj.kind)
    cmd = obj.cmd
    rid = obj.req_id
    if type(rid) is not int or not _I64_MIN <= rid <= _I64_MAX:
        return False
    if (
        kid is not None and type(cmd) is _CLS_CMD
        and obj.conf_delta is None and obj.batch is None
    ):
        ck = _CMD_KIND_ID.get(cmd.kind)
        v = cmd.value
        if ck is None or type(cmd.key) is not str \
                or not (v is None or type(v) is str):
            return False
        k = cmd.key.encode("utf-8")
        vb = b"" if v is None else v.encode("utf-8")
        ap(b"\x11" + _REQ_HDR.pack(
            kid, rid, ck, len(k), 0 if v is None else len(vb) + 1,
        ))
        ap(k)
        ap(vb)
        return True
    if obj.kind == "batch" and cmd is None and obj.conf_delta is None \
            and type(obj.batch) is list:
        chunks = []
        cap = chunks.append
        pk = _BOP_HDR.pack
        for item in obj.batch:
            if type(item) is not tuple or len(item) != 2:
                return False
            prid, c = item
            if type(prid) is not int or type(c) is not _CLS_CMD \
                    or not _I64_MIN <= prid <= _I64_MAX:
                return False
            ck = _CMD_KIND_ID.get(c.kind)
            v = c.value
            if ck is None or type(c.key) is not str \
                    or not (v is None or type(v) is str):
                return False
            k = c.key.encode("utf-8")
            vb = b"" if v is None else v.encode("utf-8")
            cap(pk(prid, ck, len(k), 0 if v is None else len(vb) + 1))
            cap(k)
            cap(vb)
        ap(b"\x13" + _BATCH_HDR.pack(rid, len(obj.batch)))
        ap(b"".join(chunks))
        return True
    return False


def _fast_reply(obj, ap) -> bool:
    kid = _REPLY_KIND_ID.get(obj.kind)
    rid, seq = obj.req_id, obj.seq
    if (
        kid is None
        or type(rid) is not int or not _I64_MIN <= rid <= _I64_MAX
        or type(seq) is not int or not _I64_MIN <= seq <= _I64_MAX
    ):
        return False
    flags = (
        (1 if obj.success else 0)
        | (2 if obj.rq_retry else 0)
        | (4 if obj.local else 0)
    )
    res = obj.result
    res_tail = None
    if res is not None:
        if type(res) is not _CLS_RESULT:
            return False
        rk = _CMD_KIND_ID.get(res.kind)
        v, ov = res.value, res.old_value
        if rk is None or not (v is None or type(v) is str) \
                or not (ov is None or type(ov) is str):
            return False
        vb = b"" if v is None else v.encode("utf-8")
        ovb = b"" if ov is None else ov.encode("utf-8")
        res_tail = (
            _RESULT_HDR.pack(
                rk,
                0 if v is None else len(vb) + 1,
                0 if ov is None else len(ovb) + 1,
            ),
            vb, ovb,
        )
        flags |= 8
    red = obj.redirect
    if red is not None:
        if type(red) is not int or not -(1 << 31) <= red < (1 << 31):
            return False
        flags |= 16
    notes = obj.notes
    note_chunks = None
    if notes is not None:
        # the hot notes shape is the commit feed's [(seq, key, value)]
        # stream; anything else (the "sub" snapshot dict rides a cold
        # kind anyway) falls back to the generic grammar
        if type(notes) is not list:
            return False
        note_chunks = []
        ncap = note_chunks.append
        npk = _NOTE_HDR.pack
        for e in notes:
            if type(e) is not tuple or len(e) != 3:
                return False
            s, k, v = e
            if type(s) is not int or not _I64_MIN <= s <= _I64_MAX \
                    or type(k) is not str \
                    or not (v is None or type(v) is str):
                return False
            kb = k.encode("utf-8")
            vb = b"" if v is None else v.encode("utf-8")
            ncap(npk(s, len(kb), 0 if v is None else len(vb) + 1))
            ncap(kb)
            ncap(vb)
        flags |= 32
    retry = obj.retry_after_ms
    if type(retry) is not int or not 0 <= retry < (1 << 32):
        return False
    ap(b"\x12" + _REPLY_HDR.pack(kid, rid, flags, retry, seq))
    if res_tail is not None:
        ap(res_tail[0])
        ap(res_tail[1])
        ap(res_tail[2])
    if red is not None:
        ap(_I32.pack(red))
    if note_chunks is not None:
        ap(_U32.pack(len(notes)))
        ap(b"".join(note_chunks))
    return True


def _fast_tick(obj, ap, parts, segs) -> int:
    """T_TICKFRAME: raw zero-copy lane segments + one C-speed pickle
    blob for the rest of the payload.  Returns the body length, or 0
    to fall back."""
    tick, payload = obj
    msg = payload["msg"]
    if len(msg) > 255 or not _I64_MIN <= tick <= _I64_MAX:
        return 0
    lanes = []
    skey_parts = []
    for name, a in msg.items():
        if (
            type(name) is not str or type(a) is not np.ndarray
            or a.dtype.hasobject or a.ndim > 255 or len(name) > 255
        ):
            return 0
        lanes.append(a)
        skey_parts.append((name, a.dtype.str, a.shape))
    skey = tuple(skey_parts)
    sch = _SCHEMA_ENC.get(skey)
    if sch is None:
        bb = bytearray()
        for name, ds, shape in skey_parts:
            nb = name.encode("utf-8")
            db = ds.encode("ascii")
            if len(nb) > 255 or len(db) > 255:
                return 0
            bb.append(len(nb))
            bb += nb
            bb.append(len(db))
            bb += db
            bb.append(len(shape))
            for d in shape:
                bb += _U32.pack(d)
        if len(bb) > 0xFFFF:
            return 0
        sch = _SCHEMA_ENC[skey] = bytes(bb)
    rest = {k: v for k, v in payload.items() if k != "msg"}
    rp = pickle.dumps(rest, pickle.HIGHEST_PROTOCOL)
    ap(b"\x10" + _TICK_HDR.pack(tick, len(rp)))
    ap(rp)
    ap(bytes((len(lanes),)) + _U16.pack(len(sch)))
    ap(sch)
    blen = 2 + 1 + _TICK_HDR.size + len(rp) + 3 + len(sch)
    for a in lanes:
        nb = a.nbytes
        if not nb:
            continue
        pad = (-blen) % 8
        if pad:
            ap(b"\x00" * pad)
            blen += pad
        blen += nb
        if a.flags.c_contiguous:
            # zero-copy: the segment references the array's own buffer
            if parts:
                segs.append(b"".join(parts))
                del parts[:]
            segs.append(a.data.cast("B"))
        else:
            # the outbox slicer hands strided views ([G, R] lanes cut
            # at src, [G, R, R] pair fields cut at (src, dst)); a
            # strided buffer cannot ride the wire raw, so pay the one
            # C-level copy (pickle pays the same inside its reduce)
            ap(a.tobytes())
    return blen


# one shared encoder for the convenience entry points (the hubs own
# their private instances on their hot loops)
_shared = FrameEncoder()
_shared_lock = threading.Lock()


def encode_body(obj: Any) -> bytes:
    """One-shot codec body (joined bytes)."""
    with _shared_lock:
        return _shared.encode_bytes(obj)


# ---------------------------------------------------------------- decoder
# Like the encoder, the specialized tags decode through module-level
# straight-line functions (no closure builds) and construct the frozen
# message dataclasses the way pickle does — ``__new__`` + ``__dict__``
# fill — because a frozen dataclass ``__init__`` pays object.__setattr__
# per field.
_NEW = object.__new__
_SETATTR = object.__setattr__  # frozen dataclasses block plain __dict__
#                              # assignment; the base-class hook does not


def _mk_cmd(kind: str, key: str, value) -> Any:
    c = _NEW(_CLS_CMD)
    _SETATTR(c, "__dict__", {"kind": kind, "key": key, "value": value})
    return c


def _dec_str_pair(mv, pos: int, lk: int, lv: int, total: int):
    """(key, value, pos) for the codec's u32 klen / u32 vlen+1 pairs."""
    if lk + (lv - 1 if lv else 0) > total - pos:
        raise WireDecodeError("wirecodec: truncated key/value")
    key = str(mv[pos:pos + lk], "utf-8")
    pos += lk
    if lv:
        value = str(mv[pos:pos + lv - 1], "utf-8")
        pos += lv - 1
    else:
        value = None
    return key, value, pos


def _dec_req(mv, total: int):
    kid, rid, ck, lk, lv = _REQ_HDR.unpack_from(mv, 3)
    if kid >= len(_REQ_KINDS) or ck >= len(_CMD_KINDS):
        raise WireDecodeError("wirecodec: bad T_REQ kinds")
    key, value, pos = _dec_str_pair(mv, 3 + _REQ_HDR.size, lk, lv, total)
    r = _NEW(_CLS_REQ)
    _SETATTR(r, "__dict__", {
        "kind": _REQ_KINDS[kid], "req_id": rid,
        "cmd": _mk_cmd(_CMD_KINDS[ck], key, value),
        "conf_delta": None, "batch": None,
    })
    return r, pos


def _dec_batch(mv, total: int):
    rid, n = _BATCH_HDR.unpack_from(mv, 3)
    pos = 3 + _BATCH_HDR.size
    if n > MAX_ITEMS or n * _BOP_HDR.size > total - pos:
        raise WireDecodeError(f"wirecodec: batch length {n} over cap")
    unpack = _BOP_HDR.unpack_from
    sz = _BOP_HDR.size
    kinds = _CMD_KINDS
    nk = len(kinds)
    new = _NEW
    setattr_ = _SETATTR
    cmd_cls = _CLS_CMD
    ops = [None] * n
    for i in range(n):
        prid, ck, lk, lv = unpack(mv, pos)
        pos += sz
        if ck >= nk or lk + (lv - 1 if lv else 0) > total - pos:
            raise WireDecodeError("wirecodec: bad batch op")
        key = str(mv[pos:pos + lk], "utf-8")
        pos += lk
        if lv:
            value = str(mv[pos:pos + lv - 1], "utf-8")
            pos += lv - 1
        else:
            value = None
        c = new(cmd_cls)
        setattr_(c, "__dict__",
                 {"kind": kinds[ck], "key": key, "value": value})
        ops[i] = (prid, c)
    r = _NEW(_CLS_REQ)
    _SETATTR(r, "__dict__", {
        "kind": "batch", "req_id": rid, "cmd": None,
        "conf_delta": None, "batch": ops,
    })
    return r, pos


def _dec_reply(mv, total: int):
    kid, rid, flags, retry, seq = _REPLY_HDR.unpack_from(mv, 3)
    pos = 3 + _REPLY_HDR.size
    if kid >= len(_REPLY_KINDS):
        raise WireDecodeError("wirecodec: bad T_REPLY kind")
    result = None
    if flags & 8:
        rk, lv, lov = _RESULT_HDR.unpack_from(mv, pos)
        if rk >= len(_CMD_KINDS):
            raise WireDecodeError("wirecodec: bad T_REPLY result kind")
        v, ov, pos = _dec_str_pair(
            mv, pos + _RESULT_HDR.size, (lv - 1 if lv else 0), lov, total
        )
        if not lv:
            v = None
        result = _NEW(_CLS_RESULT)
        _SETATTR(result, "__dict__", {
            "kind": _CMD_KINDS[rk], "value": v, "old_value": ov,
        })
    redirect = None
    if flags & 16:
        redirect = _I32.unpack_from(mv, pos)[0]
        pos += 4
    notes = None
    if flags & 32:
        n = _U32.unpack_from(mv, pos)[0]
        pos += 4
        if n > MAX_ITEMS or n * _NOTE_HDR.size > total - pos:
            raise WireDecodeError(f"wirecodec: note count {n} over cap")
        unpack = _NOTE_HDR.unpack_from
        sz = _NOTE_HDR.size
        notes = [None] * n
        for i in range(n):
            s, lk, lv = unpack(mv, pos)
            pos += sz
            if lk + (lv - 1 if lv else 0) > total - pos:
                raise WireDecodeError("wirecodec: truncated note")
            k = str(mv[pos:pos + lk], "utf-8")
            pos += lk
            if lv:
                v = str(mv[pos:pos + lv - 1], "utf-8")
                pos += lv - 1
            else:
                v = None
            notes[i] = (s, k, v)
    r = _NEW(_CLS_REPLY)
    _SETATTR(r, "__dict__", {
        "kind": _REPLY_KINDS[kid], "req_id": rid, "result": result,
        "redirect": redirect, "success": bool(flags & 1),
        "rq_retry": bool(flags & 2), "local": bool(flags & 4),
        "retry_after_ms": retry, "seq": seq, "notes": notes,
    })
    return r, pos


def _dec_tick(mv, total: int):
    tick, rl = _TICK_HDR.unpack_from(mv, 3)
    pos = 3 + _TICK_HDR.size
    if rl > total - pos:
        raise WireDecodeError("wirecodec: truncated tick rest")
    try:
        rest = pickle.loads(mv[pos:pos + rl])
    except Exception as e:
        raise WireDecodeError(
            f"wirecodec: tick rest pickle failed: {e!r}"
        ) from None
    if type(rest) is not dict:
        raise WireDecodeError("wirecodec: tick rest not a dict")
    pos += rl
    if total - pos < 3:
        raise WireDecodeError("wirecodec: truncated lane header")
    nl = mv[pos]
    slen = _U16.unpack_from(mv, pos + 1)[0]
    pos += 3
    if slen > total - pos:
        raise WireDecodeError("wirecodec: truncated lane schema")
    skey = bytes(mv[pos:pos + slen])
    table = _SCHEMA_DEC.get(skey)
    if table is None:
        table = _parse_lane_schema(skey, nl)
        _SCHEMA_DEC[skey] = table
    elif len(table) != nl:
        raise WireDecodeError("wirecodec: lane count mismatch")
    pos += slen
    msg = {}
    nda = np.ndarray
    for name, dt, shape, nbytes in table:
        if not nbytes:
            msg[name] = np.empty(shape, dtype=dt)
            continue
        pos += (-pos) % 8
        if nbytes > total - pos:
            raise WireDecodeError("wirecodec: truncated lane body")
        # zero-copy read-only view over the received body
        msg[name] = nda(shape, dt, mv[pos:pos + nbytes])
        pos += nbytes
    rest["msg"] = msg
    return (tick, rest), pos


def _parse_lane_schema(skey: bytes, nl: int) -> list:
    table = []
    p = 0
    slen = len(skey)
    for _ in range(nl):
        if p >= slen:
            raise WireDecodeError("wirecodec: truncated lane schema")
        ln = skey[p]
        name = str(skey[p + 1:p + 1 + ln], "utf-8")
        p += 1 + ln
        if p >= slen:
            raise WireDecodeError("wirecodec: truncated lane schema")
        dl = skey[p]
        try:
            dt = np.dtype(str(skey[p + 1:p + 1 + dl], "ascii"))
        except (TypeError, ValueError, UnicodeDecodeError) as e:
            raise WireDecodeError(f"wirecodec: bad lane dtype: {e}") from None
        if dt.hasobject:
            raise WireDecodeError("wirecodec: object lane dtype refused")
        p += 1 + dl
        if p >= slen:
            raise WireDecodeError("wirecodec: truncated lane schema")
        nd = skey[p]
        p += 1
        if nd > 16:
            raise WireDecodeError(f"wirecodec: lane ndim {nd} over cap")
        shape = []
        count = 1
        for _ in range(nd):
            if p + 4 > slen:
                raise WireDecodeError("wirecodec: truncated lane schema")
            d = _U32.unpack_from(skey, p)[0]
            p += 4
            shape.append(d)
            count *= d
        nbytes = count * dt.itemsize
        if nbytes > MAX_BODY:
            raise WireDecodeError(f"wirecodec: lane {nbytes}B over cap")
        table.append((name, dt, tuple(shape), nbytes))
    if p != slen:
        raise WireDecodeError("wirecodec: lane schema length mismatch")
    return table


_FAST_DEC = {}  # tag -> decoder, filled below


def decode_codec_body(buf) -> Any:
    """Decode a body known to start with :data:`MAGIC`.

    Every malformation — truncation, garbage tags/lengths, over-cap
    allocations, bad utf-8/dtype, a length field pointing past the end
    — raises :class:`WireDecodeError`; ``struct.error``/``IndexError``
    never escape (bounds checks stay implicit where the struct module
    already does them, and the outer handler retypes)."""
    if not _structs_ready:
        _ensure_structs()
    mv = buf if isinstance(buf, memoryview) else memoryview(buf)
    total = len(mv)
    if total > MAX_BODY:
        raise WireDecodeError(f"wirecodec: body {total}B over cap")
    if total < 3 or mv[0] != MAGIC:
        raise WireDecodeError("wirecodec: not a codec body")
    if mv[1] != VERSION:
        raise WireDecodeError(
            f"wirecodec: unsupported version {mv[1]} (have {VERSION})"
        )
    fast = _FAST_DEC.get(mv[2])
    if fast is not None:
        try:
            obj, pos = fast(mv, total)
        except WireDecodeError:
            raise
        except (struct.error, IndexError, UnicodeDecodeError):
            raise WireDecodeError(
                "wirecodec: truncated or garbage body"
            ) from None
        if pos != total:
            raise WireDecodeError(
                f"wirecodec: {total - pos} trailing bytes after value"
            )
        return obj
    return _decode_generic(mv, total)


_FAST_DEC[T_REQ] = _dec_req
_FAST_DEC[T_REPLY] = _dec_reply
_FAST_DEC[T_BATCH] = _dec_batch
_FAST_DEC[T_TICKFRAME] = _dec_tick


def _decode_generic(mv: memoryview, total: int) -> Any:
    pos = 2
    up_i64 = _I64.unpack_from
    up_u32 = _U32.unpack_from
    up_f64 = _F64.unpack_from
    structs = _STRUCTS

    def val(depth: int):
        nonlocal pos
        if depth > MAX_DEPTH:
            raise WireDecodeError("wirecodec: nesting too deep")
        tag = mv[pos]
        pos += 1
        if tag == T_I8:
            v = mv[pos]
            pos += 1
            return v - 256 if v >= 128 else v
        if tag == T_I64:
            v = up_i64(mv, pos)[0]
            pos += 8
            return v
        if tag == T_STR:
            n = up_u32(mv, pos)[0]
            pos += 4
            if n > total - pos:
                raise WireDecodeError("wirecodec: truncated string")
            raw = mv[pos:pos + n]
            pos += n
            try:
                return str(raw, "utf-8")
            except UnicodeDecodeError as e:
                raise WireDecodeError(
                    f"wirecodec: bad utf-8: {e}"
                ) from None
        if tag == T_NONE:
            return None
        if tag == T_TRUE:
            return True
        if tag == T_FALSE:
            return False
        if tag == T_F64:
            v = up_f64(mv, pos)[0]
            pos += 8
            return v
        if tag == T_TUPLE or tag == T_LIST:
            n = up_u32(mv, pos)[0]
            pos += 4
            if n > MAX_ITEMS or n > total - pos:
                raise WireDecodeError(
                    f"wirecodec: sequence length {n} over cap"
                )
            out = [None] * n
            for i in range(n):
                out[i] = val(depth + 1)
            return tuple(out) if tag == T_TUPLE else out
        if tag == T_DICT:
            n = up_u32(mv, pos)[0]
            pos += 4
            if n > MAX_ITEMS or 2 * n > total - pos:
                raise WireDecodeError(
                    f"wirecodec: dict length {n} over cap"
                )
            d = {}
            for _ in range(n):
                try:
                    k = val(depth + 1)
                    d[k] = val(depth + 1)
                except TypeError:
                    raise WireDecodeError(
                        "wirecodec: unhashable dict key"
                    ) from None
            return d
        if tag == T_STRUCT:
            sid = mv[pos]
            pos += 1
            entry = structs[sid] if sid < len(structs) else None
            if entry is None:
                raise WireDecodeError(
                    f"wirecodec: unknown struct id {sid}"
                )
            cls, fields = entry
            vals = [val(depth + 1) for _ in fields]
            try:
                return cls(*vals)
            except TypeError as e:
                raise WireDecodeError(
                    f"wirecodec: bad {cls.__name__} fields: {e}"
                ) from None
        if tag == T_NDARRAY:
            dlen = mv[pos]
            pos += 1
            if dlen > total - pos:
                raise WireDecodeError("wirecodec: truncated dtype")
            try:
                dt = np.dtype(str(mv[pos:pos + dlen], "ascii"))
            except (TypeError, ValueError, UnicodeDecodeError) as e:
                raise WireDecodeError(
                    f"wirecodec: bad dtype: {e}"
                ) from None
            if dt.hasobject:
                raise WireDecodeError("wirecodec: object dtype refused")
            pos += dlen
            ndim = mv[pos]
            pos += 1
            if ndim > 16:
                raise WireDecodeError(f"wirecodec: ndim {ndim} over cap")
            shape = []
            count = 1
            for _ in range(ndim):
                d = up_u32(mv, pos)[0]
                pos += 4
                shape.append(d)
                count *= d
            nbytes = count * dt.itemsize
            if nbytes > MAX_BODY:
                raise WireDecodeError(
                    f"wirecodec: array {nbytes}B over cap"
                )
            pos += (-pos) % 8  # the encoder's alignment pad
            if nbytes > total - pos:
                raise WireDecodeError("wirecodec: truncated array body")
            if count:
                # zero-copy: a read-only view over the received body
                a = np.frombuffer(
                    mv[pos:pos + nbytes], dtype=dt
                ).reshape(shape)
            else:
                a = np.empty(shape, dtype=dt)
            pos += nbytes
            return a
        if tag == T_BYTES:
            n = up_u32(mv, pos)[0]
            pos += 4
            if n > total - pos:
                raise WireDecodeError("wirecodec: truncated bytes")
            raw = bytes(mv[pos:pos + n])
            pos += n
            return raw
        if tag == T_PICKLE:
            n = up_u32(mv, pos)[0]
            pos += 4
            if n > total - pos:
                raise WireDecodeError("wirecodec: truncated pickle blob")
            raw = mv[pos:pos + n]
            pos += n
            try:
                return pickle.loads(raw)
            except Exception as e:
                raise WireDecodeError(
                    f"wirecodec: embedded pickle failed: {e!r}"
                ) from None
        if tag == T_BIGINT:
            n = up_u32(mv, pos)[0]
            pos += 4
            if n > 4096 or n > total - pos:
                raise WireDecodeError("wirecodec: bigint over cap")
            v = int.from_bytes(mv[pos:pos + n], "little", signed=True)
            pos += n
            return v
        raise WireDecodeError(f"wirecodec: unknown value tag 0x{tag:02x}")

    try:
        obj = val(0)
    except WireDecodeError:
        raise
    except (struct.error, IndexError, UnicodeDecodeError):
        raise WireDecodeError(
            f"wirecodec: truncated or garbage body at offset "
            f"{pos}/{total}"
        ) from None
    if pos != total:
        raise WireDecodeError(
            f"wirecodec: {total - pos} trailing bytes after value"
        )
    return obj


def decode_body(buf) -> Any:
    """The one ingress dispatch: codec bodies by :data:`MAGIC`, pickle
    bodies by :data:`PICKLE_PROTO` (the mixed-version path — an
    old/codec-off peer keeps sending pickle and is decoded
    transparently).  Unlike the JAX module, any other first byte fails
    the frame at once: every sender pickles at protocol >= 2, whose
    bodies open with the PROTO opcode, and ``pickle.loads`` on garbage
    can grow its memo table to a ``LONG_BINPUT`` index read from the
    garbage (gigabytes) before it fails."""
    mv = buf if isinstance(buf, memoryview) else memoryview(buf)
    if len(mv) >= 1 and mv[0] == MAGIC:
        return decode_codec_body(mv)
    if len(mv) < 1 or mv[0] != PICKLE_PROTO:
        raise WireDecodeError(
            "wirecodec: unknown body format (first byte "
            f"{mv[0] if len(mv) else None!r})"
        )
    try:
        return pickle.loads(mv)
    except WireDecodeError:
        raise
    except Exception as e:
        raise WireDecodeError(f"wirecodec: pickle body failed: {e!r}") from e
