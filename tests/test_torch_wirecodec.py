"""The port's wire codec (``summerset_tpu_torch/utils/wirecodec.py``)
against the JAX package's (``summerset_tpu/utils/wirecodec.py``), on the
CPU.  Exact: no tolerance anywhere.

- Hot request/reply bodies, struct-id bodies, note and batch bodies made
  from one seed are byte-identical in both packages (no pickle blob is
  involved, so no class path differs).
- Tick frames (lanes from the seed, the port's int32 ``flags`` against the
  JAX uint32) decode to equal lanes in either package, from either
  package's encoder.
- Each package decodes the other's bodies to its own classes.
- The decode hardening cases of ``tests/test_wirecodec.py::
  TestDecodeHardening`` raise ``WireDecodeError`` in the port.
- The port's framing: vectored sends over a socketpair, strided outbox
  slices on the tick fast path, hot kinds on the codec and cold kinds on
  pickle, a live mesh of codec and pickle replicas.
"""

import os
import random
import socket
import struct
import sys
import threading
import time

import numpy as np
import pytest

from summerset_tpu.host import messages as jmsg
from summerset_tpu.host import statemach as jsm
from summerset_tpu.utils import safetcp as jsafetcp
from summerset_tpu.utils import wirecodec as jwc
from summerset_tpu_torch.host import messages as tmsg
from summerset_tpu_torch.host import statemach as tsm
from summerset_tpu_torch.utils import safetcp as tsafetcp
from summerset_tpu_torch.utils import wirecodec as twc

SEED = 20261017
PKGS = {"jax": (jmsg, jsm), "torch": (tmsg, tsm)}


def _rand_str(rng, n):
    return "".join(chr(int(c)) for c in rng.integers(97, 123, n))


def hot_messages(pkg, seed=SEED):
    """The hot kinds of ``tests/test_wirecodec.py::HOT_MESSAGES`` with
    keys, values, ids and sequence numbers drawn from ``seed``, built
    from one package's classes (``pkg`` is "jax" or "torch")."""
    msg, sm = PKGS[pkg]
    Req, Rep, Cmd, Res = (msg.ApiRequest, msg.ApiReply, sm.Command,
                          sm.CommandResult)
    rng = np.random.default_rng(seed)
    ids = [int(x) for x in rng.integers(0, 1 << 40, 16)]
    keys = [_rand_str(rng, int(n)) for n in rng.integers(1, 12, 8)]
    vals = [_rand_str(rng, int(n)) for n in rng.integers(0, 600, 8)]
    seqs = [int(x) for x in rng.integers(1, 1 << 30, 4)]
    return [
        Req("req", req_id=ids[0], cmd=Cmd("put", keys[0], vals[0])),
        Req("req", req_id=ids[1], cmd=Cmd("get", keys[1])),
        Req("req", req_id=ids[2], cmd=Cmd("put", keys[2] + "é", "")),
        Req("probe", req_id=ids[3], cmd=Cmd("get", keys[3])),
        Req("batch", req_id=ids[4], batch=[]),
        Req("batch", req_id=ids[5], batch=[
            (ids[6], Cmd("put", keys[4], vals[1])),
            (ids[7], Cmd("get", keys[5])),
        ]),
        Rep("reply", req_id=ids[8],
            result=Res("put", old_value=vals[2] or None)),
        Rep("reply", req_id=ids[9], result=Res("get", value=vals[3]),
            local=True),
        Rep("shed", req_id=ids[10], success=False,
            retry_after_ms=int(rng.integers(5, 1000))),
        Rep("probe", req_id=ids[11], success=True, seq=seqs[0]),
        Rep("note", req_id=0, seq=seqs[1], notes=[]),
        Rep("note", req_id=0, seq=seqs[2] + 1, notes=[
            (seqs[2], keys[6], vals[4]), (seqs[2] + 1, keys[7], None),
        ]),
        Rep("redirect", req_id=ids[12], redirect=2, success=False,
            rq_retry=True),
        Rep("reply", req_id=ids[13], redirect=1, success=False,
            rq_retry=True),
        # scans: their Command and CommandResult ride the struct ids
        Req("req", req_id=ids[14], cmd=Cmd("scan", keys[0], end=keys[1],
                                           limit=8)),
        Req("scan", req_id=ids[15], cmd=Cmd("scan", keys[2])),
        Rep("reply", req_id=ids[0], result=Res(
            "scan", items=tuple(sorted(zip(keys[:3], vals[:3]))))),
        Rep("reply", req_id=ids[1], result=Res("scan", items=())),
    ]


def struct_bodies(pkg, seed=SEED):
    """Values that take the generic grammar's struct ids (1-5): cold
    kinds, nested structs, a ShardPayload with seeded rows."""
    msg, sm = PKGS[pkg]
    rng = np.random.default_rng(seed + 1)
    rows = {int(s): rng.integers(-(1 << 31), 1 << 31, 40, dtype=np.int64)
            .astype(np.int32) for s in (0, 2)}
    return [
        msg.ApiRequest("conf", req_id=3, conf_delta={"responders": [0, 1]}),
        msg.ApiRequest("sub", req_id=0),
        msg.ApiReply("sub", req_id=0, seq=7, notes={"a": "1", "b": "2"}),
        msg.ApiReply("error", req_id=9, success=False),
        msg.ShardPayload(int(rng.integers(1, 4000)), rows),
        [(5, msg.ApiRequest("req", req_id=1, cmd=sm.Command("put", "k",
                                                             "v")))],
        {"res": sm.CommandResult("get", value="x"), "n": [1, 2.5, None]},
    ]


def _eq(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b))
    if hasattr(a, "__dataclass_fields__"):
        return type(a) is type(b) and all(
            _eq(getattr(a, f), getattr(b, f)) for f in a.__dataclass_fields__)
    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) == set(b)
                and all(_eq(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_eq(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


HOT_IDS = [f"{type(m).__name__}-{m.kind}-{i}"
           for i, m in enumerate(hot_messages("torch"))]
STRUCT_IDS = [f"struct-{i}" for i in range(len(struct_bodies("torch")))]


# ------------------------------------------------------ byte identity
@pytest.mark.parametrize("i", range(len(HOT_IDS)), ids=HOT_IDS)
def test_hot_bodies_byte_identical(i):
    j = hot_messages("jax")[i]
    t = hot_messages("torch")[i]
    jb, tb = jwc.encode_body(j), twc.encode_body(t)
    assert tb == jb
    assert tb[0] == twc.MAGIC and twc.is_hot(t) == jwc.is_hot(j)
    if twc.is_hot(t):
        # the framed form, through each package's safetcp
        assert tsafetcp.encode_frame(t, codec=True) == \
            jsafetcp.encode_frame(j, codec=True)


@pytest.mark.parametrize("i", range(len(STRUCT_IDS)), ids=STRUCT_IDS)
def test_struct_bodies_byte_identical(i):
    j = struct_bodies("jax")[i]
    t = struct_bodies("torch")[i]
    assert twc.encode_body(t) == jwc.encode_body(j)


@pytest.mark.parametrize("i", range(len(HOT_IDS)), ids=HOT_IDS)
def test_each_package_decodes_the_others_hot_bodies(i):
    j = hot_messages("jax")[i]
    t = hot_messages("torch")[i]
    back_t = twc.decode_body(jwc.encode_body(j))
    back_j = jwc.decode_body(twc.encode_body(t))
    assert type(back_t) is type(t) and back_t == t
    assert type(back_j) is type(j) and back_j == j


@pytest.mark.parametrize("i", range(len(STRUCT_IDS)), ids=STRUCT_IDS)
def test_each_package_decodes_the_others_struct_bodies(i):
    j = struct_bodies("jax")[i]
    t = struct_bodies("torch")[i]
    assert _eq(twc.decode_body(jwc.encode_body(j)), t)
    assert _eq(jwc.decode_body(twc.encode_body(t)), j)


def test_struct_registry_matches_the_jax_package():
    twc._ensure_structs()
    jwc._ensure_structs()
    for sid in range(1, 6):
        (tc, tf), (jc, jf) = twc._STRUCTS[sid], jwc._STRUCTS[sid]
        assert tc.__name__ == jc.__name__ and tf == jf
        assert tc.__module__.startswith("summerset_tpu_torch.")
    assert twc.HOT_REQUEST_KINDS == jwc.HOT_REQUEST_KINDS
    assert twc.HOT_REPLY_KINDS == jwc.HOT_REPLY_KINDS


# ------------------------------------------------------------ tick frames
def tick_frame(pkg, G=8, R=3, seed=SEED, strided=False):
    """A tick frame with seeded lanes: the port's ``flags`` is int32 with
    the JAX uint32 bits.  The non-lane parts are plain data, so both
    packages' rest-pickle blobs decode to equal values.  ``strided``
    slices the lanes out of ``[G, R, R]`` outboxes, as ``_slice_outbox``
    does."""
    rng = np.random.default_rng(seed)
    flags_u = rng.integers(0, 1 << 32, (G, R, R), dtype=np.uint64
                           ).astype(np.uint32)
    flags = flags_u if pkg == "jax" else flags_u.view(np.int32)
    bal = rng.integers(0, 1 << 20, (G, R, R)).astype(np.int32)
    win = rng.integers(0, 1 << 30, (G, R, 16)).astype(np.int32)
    ok = rng.integers(0, 2, (G, R, R)).astype(bool)
    if strided:
        msg = {"flags": flags[:, 1, 2], "bal": bal[:, 1, 2],
               "win": win[:, 1], "ok": ok[:, 1]}
    else:
        msg = {"flags": np.ascontiguousarray(flags[:, 1, 2]),
               "bal": np.ascontiguousarray(bal[:, 1, 2]),
               "win": np.ascontiguousarray(win[:, 1]),
               "ok": np.ascontiguousarray(ok[:, 1])}
    payload = {
        "msg": msg, "pp": {}, "kv_need": False, "ts": 12.5,
        "need": [(0, int(x)) for x in rng.integers(1, 99, 3)],
        "rq": [(0, "k1", 1)], "rqr": [(3, "v", 7, False)],
    }
    return (int(rng.integers(0, 1 << 40)), payload)


def _lanes_equal(a, b):
    """Lanes equal with the port's int32 flags viewed as uint32."""
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if k == "flags":
            x, y = x.view(np.uint32), y.view(np.uint32)
        assert x.shape == y.shape and np.array_equal(x, y), k


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("G", [1, 8])
def test_tick_frames_decode_to_equal_lanes(G, strided):
    jf, tf = tick_frame("jax", G, strided=strided), \
        tick_frame("torch", G, strided=strided)
    jb, tb = jwc.encode_body(jf), twc.encode_body(tf)
    assert jb[2] == tb[2] == twc.T_TICKFRAME
    for body in (jb, tb):
        for dec in (jwc.decode_body, twc.decode_body):
            tick, p = dec(body)
            assert tick == tf[0]
            _lanes_equal(p["msg"], tf[1]["msg"])
            assert {k: v for k, v in p.items() if k != "msg"} == \
                {k: v for k, v in tf[1].items() if k != "msg"}
    # the port's own roundtrip keeps its dtypes exactly
    back = twc.decode_body(tb)[1]["msg"]
    for k, a in tf[1]["msg"].items():
        assert back[k].dtype == a.dtype and np.array_equal(back[k], a)


def test_tick_frame_pp_batches_cross_decode():
    """A frame's piggybacked batches ride the rest-pickle blob: each
    package decodes the other's into the other's classes, equal field by
    field."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_cluster import norm_batch

    frames = {}
    for pkg, (msg, sm) in PKGS.items():
        tick, p = tick_frame(pkg)
        p = dict(p, pp={(1, 4): [(7, msg.ApiRequest(
            "req", req_id=3, cmd=sm.Command("put", "k", "v")))]})
        frames[pkg] = (tick, p)
    for src, enc in (("jax", jwc), ("torch", twc)):
        body = enc.encode_body(frames[src])
        for dec in (jwc, twc):
            got = dec.decode_body(body)[1]
            assert norm_batch(got["pp"][(1, 4)]) == norm_batch(
                frames["torch"][1]["pp"][(1, 4)])


def test_decoded_lanes_are_read_only_views():
    body = twc.encode_body(tick_frame("torch"))
    msg = twc.decode_body(body)[1]["msg"]
    for a in msg.values():
        assert not a.flags.owndata


# --------------------------------------------------------------- hardening
def _valid_bodies():
    enc = twc.FrameEncoder()
    frames = (hot_messages("torch") + struct_bodies("torch")
              + [tick_frame("torch"), tick_frame("torch", strided=True),
                 {"generic": [1, 2.5, np.arange(6, dtype=np.int16)]}])
    return [enc.encode_bytes(f) for f in frames]


def _try(body):
    try:
        twc.decode_body(bytes(body))
    except twc.WireDecodeError:
        pass
    # any other exception type propagates and fails the test


class TestTorchDecodeHardening:
    """``tests/test_wirecodec.py::TestDecodeHardening`` on the port."""

    def test_truncations(self):
        for body in _valid_bodies():
            for cut in range(0, len(body), max(1, len(body) // 37)):
                _try(body[:cut])

    def test_bitflips_seeded(self):
        rng = random.Random(1234)
        for body in _valid_bodies():
            for _ in range(64):
                b = bytearray(body)
                i = rng.randrange(len(b))
                b[i] ^= 1 << rng.randrange(8)
                _try(b)

    def test_trailing_garbage(self):
        for body in _valid_bodies():
            _try(body + b"\x00")
            _try(body + b"garbage!")

    def test_garbage_prefixes(self):
        _try(b"")
        _try(bytes([twc.MAGIC]))
        _try(bytes([twc.MAGIC, 99, 1]))  # bad version
        _try(bytes([twc.MAGIC, 1, 0xEE]))  # unknown tag
        with pytest.raises(twc.WireDecodeError):
            twc.decode_body(b"\x00not pickle or codec")

    def test_overcap_lengths_do_not_allocate(self):
        body = bytes([twc.MAGIC, 1, 0x08]) + struct.pack("<I", 0xFFFFFFF0)
        with pytest.raises(twc.WireDecodeError):
            twc.decode_body(body)
        body = bytes([twc.MAGIC, 1, 0x0C, 3]) + b"<i4" + bytes(
            [4]) + struct.pack("<IIII", 65535, 65535, 65535, 65535)
        with pytest.raises(twc.WireDecodeError):
            twc.decode_body(body)

    def test_garbage_first_byte_fails_before_unpickling(self, monkeypatch):
        """A codec scan reply with the magic's top bit flipped opens with
        BINFLOAT then ``LONG_BINPUT 2037149797``: unpickled, the memo
        table grows to that index (tens of seconds and gigabytes here).
        The port refuses any first byte but the codec magic and the
        pickle PROTO opcode without unpickling."""
        body = bytearray(twc.encode_body(hot_messages("torch")[-1]))
        body[0] ^= 0x80
        monkeypatch.setattr(twc.pickle, "loads", lambda *a, **k: (
            pytest.fail("a garbage body reached pickle.loads")))
        with pytest.raises(twc.WireDecodeError, match="unknown body"):
            twc.decode_body(bytes(body))

    def test_never_bare_struct_error(self):
        body = bytes([twc.MAGIC, 1, 0x05, 1, 2])  # i64 cut short
        with pytest.raises(twc.WireDecodeError):
            twc.decode_body(body)


# ----------------------------------------------------------------- framing
class TestTorchFraming:
    def test_hot_kinds_codec_cold_kinds_pickle(self):
        for m in hot_messages("torch"):
            on = tsafetcp.encode_frame(m, codec=True)
            off = tsafetcp.encode_frame(m, codec=False)
            assert on[8] == (twc.MAGIC if twc.is_hot(m) else 0x80)
            assert off[8] == 0x80
            (ln,) = struct.unpack(">Q", on[:8])
            assert ln == len(on) - 8
            assert tsafetcp.decode_body(on[8:]) == \
                tsafetcp.decode_body(off[8:]) == m
        for m in struct_bodies("torch")[:4]:
            assert tsafetcp.encode_frame(m, codec=True)[8] == 0x80

    def test_sendmsg_roundtrip_over_socketpair(self):
        a, b = socket.socketpair()
        try:
            # a tiny send buffer forces partial sendmsg progress
            a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
            frame = tick_frame("torch", G=512, strided=True)
            enc = twc.FrameEncoder()
            segs, total = tsafetcp.encode_frame_into(frame, enc, codec=True)
            done = threading.Event()

            def sender():
                tsafetcp.sendmsg_all(a, segs, total)
                done.set()

            t = threading.Thread(target=sender, daemon=True)
            t.start()
            obj, nbytes = tsafetcp.FrameReceiver().recv(b)
            t.join(timeout=5)
            assert done.is_set()
            enc.release()
            assert nbytes == total - 8 and obj[0] == frame[0]
            _lanes_equal(obj[1]["msg"], frame[1]["msg"])
        finally:
            a.close()
            b.close()

    def test_many_tiny_segments(self):
        a, b = socket.socketpair()
        try:
            segs = [struct.pack(">Q", 3 * 700)] + [b"abc"] * 700
            t = threading.Thread(target=tsafetcp.sendmsg_all,
                                 args=(a, segs, 8 + 3 * 700), daemon=True)
            t.start()
            body = tsafetcp.FrameReceiver().recv_raw(b)
            t.join(timeout=5)
            assert bytes(body) == b"abc" * 700
        finally:
            a.close()
            b.close()

    def test_default_follows_the_env_knob(self):
        prev = twc.set_default(False)
        try:
            m = hot_messages("torch")[0]
            assert tsafetcp.encode_frame(m)[8] == 0x80
            twc.set_default(True)
            assert tsafetcp.encode_frame(m)[8] == twc.MAGIC
        finally:
            twc.set_default(prev)


# ------------------------------------------------------ live mixed formats
def test_mixed_format_mesh_and_clients(tmp_path):
    """One replica sends pickle frames and replies (``wire_codec`` 0),
    the other two the codec; a codec client and a pickle client each
    read back the other's acked writes through every replica, and the
    codec replicas meter the bytes the codec saved."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_cluster import Cluster

    from summerset_tpu_torch.client.drivers import DriverClosedLoop
    from summerset_tpu_torch.client.endpoint import GenericEndpoint

    c = Cluster("MultiPaxos", 3, tmp_path, num_groups=2,
                slot_config={0: {"wire_codec": False},
                             1: {"wire_codec": True},
                             2: {"wire_codec": True}})
    eps = []
    try:
        assert sorted(r.wire_codec for r in c.replicas.values()) == \
            [False, True, True]
        drivers = {}
        for codec in (True, False):
            ep = GenericEndpoint(c.manager_addr, wire_codec=codec)
            ep.connect()
            eps.append(ep)
            drivers[codec] = DriverClosedLoop(ep, timeout=3.0)
        for i in range(6):
            for codec, drv in drivers.items():
                drv.checked_put(f"mx{codec}{i}", f"v{codec}{i}",
                                retries=40)
        for codec, drv in drivers.items():
            for i in range(6):
                drv.checked_get(f"mx{not codec}{i}", f"v{not codec}{i}",
                                retries=40)
        # every replica applied every write (frames of both formats)
        deadline = time.monotonic() + 20
        want = {f"mx{codec}{i}": f"v{codec}{i}"
                for codec in (True, False) for i in range(6)}
        while True:
            kvs = [dict(r.statemach.snapshot_items())
                   for r in c.replicas.values()]
            if all(all(kv.get(k) == v for k, v in want.items())
                   for kv in kvs):
                break
            assert time.monotonic() < deadline, kvs
            time.sleep(0.2)
        for r in c.replicas.values():
            saved = r.metrics.counter_value("wire_bytes_saved")
            assert r.metrics.gauge_value("wire_codec_on") == \
                (1 if r.wire_codec else 0)
            if r.wire_codec:
                assert saved > 0, r.me
            else:
                assert saved == 0, r.me
    finally:
        for ep in eps:
            ep.leave()
        c.stop()
    assert not c.faults(), f"replica faults: {c.faults()}"
