"""The port's ServerReplica against the JAX package's, on the CPU.

Three gates, every one exact (no tolerance: integer state, byte-equal
digests, equal Python records):

(a) Seam lockstep.  Three JAX replicas and three port replicas, each
    built by its own constructor with in-memory stand-ins for the
    manager, the p2p mesh and the client plane (no sockets, no threads
    beyond the WAL logger), step the same scripted serial ticks for
    MultiPaxos and Raft at G=2, R=3, W=16.  Intake batches are fixed per
    tick; frames move in memory, sent in one round and delivered in the
    next; replica 0's frames are withheld for a stretch so leadership
    moves.  Per tick: every state leaf's sha256, each frame's kernel
    lanes (``flags`` as uint32) and payload parts (``pp``, ``need``,
    ``kv_need``; not the ``ts`` stamp), the WAL records, ``applied``, the
    KV, the replies and the manager notices.
(b) Single replica.  24 sequential puts on a 1-replica JAX cluster and a
    1-replica port cluster, in both loop modes: durable-state digests, KV,
    ``applied`` and the WAL entries equal.
(c) Recovery.  Each package's ``_recover_from_wal`` over its WAL from (b)
    rebuilds the same state, KV and floors.
"""

import hashlib
import os
import shutil
import sys
import time
import types
from collections import deque

import numpy as np
import pytest
import torch

import summerset_tpu.host.server as jsrv
import summerset_tpu_torch.host.server as tsrv
from summerset_tpu.host import messages as jmsg
from summerset_tpu.host import statemach as jsm
from summerset_tpu.host.storage import LogAction as JLogAction
from summerset_tpu.host.storage import StorageHub as JStorageHub
from summerset_tpu.protocols.multipaxos import AR_NACK
from summerset_tpu_torch.host import messages as tmsg
from summerset_tpu_torch.host import statemach as tsm
from summerset_tpu_torch.host.storage import LogAction as TLogAction
from summerset_tpu_torch.host.storage import StorageHub as TStorageHub
from summerset_tpu_torch.utils.errors import SummersetError

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_cluster import (  # noqa: E402
    durable_digest, norm_batch, norm_wal, read_wal,
)

torch.set_num_threads(1)

ADDR = ("127.0.0.1", 1)
# JAX-only host planes off (health beacons, watch frames, the flight
# recorder, slot traces, the wire codec); the port ignores these keys
BASE_CFG = {
    "health_enabled": False, "graftwatch": False, "flight_record": False,
    "trace_sample": 0, "wire_codec": False,
}


# ------------------------------------------------------------ stand-ins
class FakeNet:
    """In-memory tick mesh: frames sent in round t are delivered at the
    start of round t + 1; ``mute`` withholds one replica's frames.
    ``drops`` lists ``((src, dst), lo, hi)``: that link loses its frames
    in rounds lo..hi-1.  ``holds`` lists ``(src, dst, round)``: that frame
    is delivered a round late, in one batch with the link's next frame,
    which supersedes it under the newest-frame rule."""

    def __init__(self, R, drops=(), holds=()):
        self.R = R
        self.pending = []
        self.held = []
        self.delivered = {r: {} for r in range(R)}
        self.sent = []
        self.mute = None
        self.drops = list(drops)
        self.holds = set(holds)
        self.round = 0

    def send(self, src, per_peer):
        for dst, f in per_peer.items():
            self.sent.append((src, dst, f))
            if src == self.mute or any(
                    lo <= self.round < hi and link == (src, dst)
                    for link, lo, hi in self.drops):
                continue
            if (src, dst, self.round) in self.holds:
                self.held.append((src, dst, f))
            else:
                self.pending.append((src, dst, f))

    def recv(self, me):
        got = {p: None for p in range(self.R) if p != me}
        for src, fl in self.delivered[me].items():
            got[src] = fl
        self.delivered[me] = {}
        return got

    def flush(self):
        for src, dst, f in self.pending:
            self.delivered[dst].setdefault(src, []).append(f)
        self.pending, self.held = self.held, []
        self.round += 1
        sent, self.sent = self.sent, []
        return sent


class FakeCtrl:
    def __init__(self, me, population):
        self.me = me
        self.population = population
        self.sent = []

    def send_ctrl(self, msg):
        self.sent.append((msg.kind, dict(msg.payload)))

    def recv_ctrl(self, timeout=None):
        return types.SimpleNamespace(
            kind="connect_to_peers",
            payload={"population": self.population, "to_peers": {}},
        )

    def try_recv_ctrl(self):
        return None

    def close(self):
        pass


class FakeTransport:
    def __init__(self, me, net):
        self.me = me
        self.net = net
        self.health = None
        self.samples = deque()
        self.bytes_sent = {}

    def connected(self, peer):
        return True

    def connect_to_peer(self, peer, addr):
        pass

    def wait_for_group(self, timeout=None):
        pass

    def peers(self):
        return []

    def send_tick(self, tick, per_peer, fence=None):
        if fence is not None:
            fence()
        self.net.send(self.me, per_peer)

    def recv_tick(self, tick, deadline):
        return self.net.recv(self.me)

    def close(self):
        pass


class FakeExternal:
    def __init__(self):
        self.batches = []
        self.replies = []
        self.max_batch_size = 5000

    def get_req_batch(self, timeout=None):
        return self.batches.pop(0) if self.batches else []

    def send_reply(self, reply, client):
        self.replies.append((client, reply))

    def send_replies(self, items, fence=None):
        if fence is not None:
            fence()
        for client, reply in items:
            self.send_reply(reply, client)

    def has_client(self, client):
        return True

    def stop(self):
        pass


def build(mod, protocol, me, R, G, W, backer_dir, config, net=None,
          **kw):
    """Run ``mod.ServerReplica.__init__`` with the stand-ins patched into
    the module (restored afterwards); returns the replica."""
    saved = (mod.ControlHub, mod.TransportHub, mod.ExternalApi)
    ctrl = FakeCtrl(me, R)
    mod.ControlHub = lambda *a, **k: ctrl
    mod.TransportHub = lambda *a, **k: FakeTransport(me, net or FakeNet(R))
    mod.ExternalApi = lambda *a, **k: FakeExternal()
    try:
        rep = mod.ServerReplica(
            protocol, ADDR, ADDR, ADDR, config=dict(config),
            num_groups=G, window=W, tick_interval=0.0,
            backer_dir=str(backer_dir), **kw,
        )
    finally:
        mod.ControlHub, mod.TransportHub, mod.ExternalApi = saved
    return rep


# -------------------------------------------------------- normalization


def norm_reply(client, rep):
    res = rep.result
    return (client, rep.kind, rep.req_id, rep.success, rep.redirect,
            None if res is None else (res.kind, res.value, res.old_value))


def norm_frame(f, port):
    msg = {}
    for k, v in f["msg"].items():
        a = np.asarray(v)
        if port and k == "flags":
            a = a.view(np.uint32)
        msg[k] = (a.dtype.str, a.shape, a.tobytes())
    return {
        "msg": msg,
        "pp": {k: norm_batch(b) for k, b in f["pp"].items()},
        "need": [tuple(x) for x in f["need"]],
        "kv_need": f["kv_need"],
        "kv": f.get("kv"),
    }


def leaf_digests(state):
    out = {}
    for k, v in state.items():
        a = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        out[k] = (a.shape, hashlib.sha256(a.tobytes()).hexdigest())
    return out


def record_wal(rep):
    """Capture every WAL record the replica appends."""
    log = []
    orig = rep._wal_append

    def wrapped(entry):
        log.append(norm_wal(entry))
        orig(entry)

    rep._wal_append = wrapped
    return log


def requests(pkg, t, r):
    """Replica ``r``'s intake batch at tick ``t``: a put, a get and,
    every fifth tick, a request with no command (answered error)."""
    msg, sm = pkg
    base = 1000 * t + 10 * r
    out = [
        (100 + r, msg.ApiRequest("req", req_id=base, cmd=sm.Command(
            "put", f"k{(3 * t + r) % 5}", f"v{t}.{r}"))),
        (200 + r, msg.ApiRequest("req", req_id=base + 1, cmd=sm.Command(
            "get", f"k{(t + 2 * r) % 5}"))),
    ]
    if t % 5 == 0:
        out.append((300 + r, msg.ApiRequest("req", req_id=base + 2)))
    return out


# ------------------------------------------------------ (a) lockstep gate
LOCK = dict(G=2, R=3, W=16, ticks=60, mute=(12, 40))
LOCK_CFG = dict(BASE_CFG, pipeline=False, hear_timeout_lo=8,
                hear_timeout_hi=16)
SIDES = (("jax", jsrv, (jmsg, jsm), {}),
         ("torch", tsrv, (tmsg, tsm), {"device": "cpu"}))


def lockstep_sides(tmp_path, protocol, sides=SIDES, **net_kw):
    """Three replicas per package on their own in-memory mesh."""
    G, R, W = LOCK["G"], LOCK["R"], LOCK["W"]
    out = {}
    for name, mod, pkg, kw in sides:
        net = FakeNet(R, **net_kw)
        reps = [build(mod, protocol, r, R, G, W, tmp_path / name / str(r),
                      LOCK_CFG, net=net, **kw) for r in range(R)]
        out[name] = (reps, net, pkg, [record_wal(rep) for rep in reps])
    return out


def lockstep_tick(sides, t, mute=None):
    """One scripted serial tick on every side; returns per side what the
    gate compares."""
    seen = {}
    for name, (reps, net, pkg, wals) in sides.items():
        net.mute = mute
        for r, rep in enumerate(reps):
            rep.external.batches.append(requests(pkg, t, r))
            rep._tick_serial(time.monotonic())
        sent = net.flush()
        port = name == "torch"
        seen[name] = {
            "frames": [(s, d, norm_frame(f, port)) for s, d, f in sent],
            "state": [leaf_digests(rep.state) for rep in reps],
            "wal": [list(w) for w in wals],
            "applied": [list(rep.applied) for rep in reps],
            "kv": [dict(rep.statemach.snapshot_items()) for rep in reps],
            "replies": [[norm_reply(c, x) for c, x in
                         rep.external.replies] for rep in reps],
            "ctrl": [list(rep.ctrl.sent) for rep in reps],
        }
        for rep in reps:
            rep.external.replies.clear()
        for w in wals:
            w.clear()
    return seen


def shutdown_sides(sides):
    for reps, *_ in sides.values():
        for rep in reps:
            rep.shutdown()


@pytest.mark.parametrize("protocol", ["MultiPaxos", "Raft"])
def test_seam_lockstep(tmp_path, protocol):
    G = LOCK["G"]
    sides = lockstep_sides(tmp_path, protocol)
    leaders = set()
    replies = redirects = 0
    try:
        for t in range(LOCK["ticks"]):
            lo, hi = LOCK["mute"]
            seen = lockstep_tick(sides, t, mute=0 if lo <= t < hi else None)
            j, p = seen["jax"], seen["torch"]
            for part in j:
                assert j[part] == p[part], f"tick {t}: {part} differs"
            for rep in sides["torch"][0]:
                for g in range(G):
                    if rep._is_leader[g]:
                        leaders.add((g, rep.me))
            for rr in p["replies"]:
                replies += sum(1 for x in rr if x[1] == "reply")
                redirects += sum(1 for x in rr if x[1] == "redirect")
        # the schedule did what it is for: leadership moved, writes
        # committed and were answered, followers redirected
        assert any(me != 0 for _g, me in leaders), leaders
        assert min(sum(rep.applied) for rep in sides["torch"][0]) > 10
        assert replies > 20 and redirects > 20
    finally:
        shutdown_sides(sides)


# MultiPaxos: replica 0 leads; its links to 1 and 2 lose frames until
# replica 2 takes over; in round 40 replica 1 meets the new leader's run
# above its commit bar and nacks once, to replica 2.  Holding that frame
# makes it arrive with replica 1's next frame, which lacks the bit.
SUPERSEDE = dict(drops=[((0, 1), 22, 37), ((0, 2), 26, 42),
                        ((0, 1), 28, 47)],
                 nack=(1, 2, 40), ticks=70)


def test_superseded_nack_lockstep(tmp_path):
    """Two frames from one peer before the receiver ticks, the older one
    holding the only AR_NACK.  The JAX server takes the newest frame's
    lanes only: the leader never rewinds and the follower's applied
    floors freeze for good.  The port delivers the older frame first
    (``_peer_lanes``), so the follower ends where it ends when nothing
    is superseded.  Both packages agree exactly up to the tick the two
    frames arrive."""
    src, dst, rnd = SUPERSEDE["nack"]
    held = lockstep_sides(tmp_path / "held", "MultiPaxos",
                          drops=SUPERSEDE["drops"], holds=[(src, dst, rnd)])
    free = lockstep_sides(tmp_path / "free", "MultiPaxos", sides=SIDES[:1],
                          drops=SUPERSEDE["drops"])
    applied = {"jax": [], "torch": [], "free": []}
    try:
        for t in range(SUPERSEDE["ticks"]):
            seen = lockstep_tick(held, t)
            seen["free"] = lockstep_tick(free, t)["jax"]
            if t in (rnd, rnd + 1):
                # the held frame nacks, the one that supersedes it not
                bits = [np.frombuffer(fr["msg"]["flags"][2], np.uint32)
                        for s, d, fr in seen["jax"]["frames"]
                        if (s, d) == (src, dst)]
                assert bool((bits[0] & AR_NACK).any()) == (t == rnd)
            if t <= rnd + 1:  # the two frames arrive at tick rnd + 2
                for part in seen["jax"]:
                    assert seen["jax"][part] == seen["torch"][part], \
                        f"tick {t}: {part} differs"
            for k in applied:
                applied[k].append(seen[k]["applied"])
    finally:
        shutdown_sides(held)
        shutdown_sides(free)
    j, p, f = applied["jax"], applied["torch"], applied["free"]
    # the JAX follower is stuck from the lost nack on, its peers are not
    assert all(a[src] == j[rnd][src] for a in j[rnd:])
    assert sum(j[-1][dst]) > sum(j[rnd][src]) + 20
    # the port's follower ends where the unsuperseded run ends
    assert p[-1] == f[-1]
    assert p[-1][src] == p[-1][0]


# -------------------------------------------- (b) single replica, (c) WAL
def run_single(cluster_cls, drivers, tmpdir, pipeline, leaves, **kw):
    """24 strictly sequential puts on a 1-replica cluster, 2 groups."""
    c = cluster_cls("MultiPaxos", 1, str(tmpdir), config={"pipeline": pipeline},
                    tick=0.004, num_groups=2, **kw)
    ep = None
    try:
        ep = drivers.GenericEndpoint(c.manager_addr)
        ep.connect()
        drv = drivers.DriverClosedLoop(ep, timeout=20.0)
        for i in range(24):
            drv.checked_put(f"k{i % 7}", f"v{i}")
        rep = c.replicas[0]
        assert rep.pipeline is pipeline
        out = {
            "digest": durable_digest(rep.kernel,
                                     lambda k: leaves(rep.state[k])),
            "kv": dict(rep.statemach.snapshot_items()),
            "applied": list(rep.applied),
        }
    finally:
        if ep is not None:
            ep.leave()
        c.stop()
    out["wal_path"] = os.path.join(str(tmpdir), "r0.wal")
    return out


@pytest.fixture(scope="module", params=[False, True],
                ids=["serial", "pipelined"])
def single(request, tmp_path_factory):
    from summerset_tpu.client import drivers as jdrv
    from summerset_tpu.client import endpoint as jep
    from summerset_tpu_torch.client import drivers as tdrv
    from summerset_tpu_torch.client import endpoint as tep
    from test_cluster import Cluster as JCluster
    from test_torch_cluster import Cluster as TCluster

    pipeline = request.param
    base = tmp_path_factory.mktemp("single_pl" if pipeline else "single_ser")
    jd = types.SimpleNamespace(GenericEndpoint=jep.GenericEndpoint,
                               DriverClosedLoop=jdrv.DriverClosedLoop)
    td = types.SimpleNamespace(GenericEndpoint=tep.GenericEndpoint,
                               DriverClosedLoop=tdrv.DriverClosedLoop)
    j = run_single(JCluster, jd, base / "jax", pipeline, np.asarray)
    p = run_single(TCluster, td, base / "torch", pipeline,
                   lambda v: v.numpy(), window=32, settle=0.5)
    j["wal"] = read_wal(j["wal_path"], JStorageHub, JLogAction)
    p["wal"] = read_wal(p["wal_path"])
    return {"jax": j, "torch": p, "base": base, "pipeline": pipeline}


class TestSingleReplica:
    def test_durable_digest_equal(self, single):
        assert single["jax"]["digest"] == single["torch"]["digest"]

    def test_kv_and_applied_equal(self, single):
        j, p = single["jax"], single["torch"]
        assert sum(p["applied"]) == 24
        assert p["kv"] == {
            f"k{k}": f"v{max(i for i in range(24) if i % 7 == k)}"
            for k in range(7)
        }
        assert (j["kv"], j["applied"]) == (p["kv"], p["applied"])

    def test_wal_entries_equal(self, single):
        j, p = single["jax"]["wal"], single["torch"]["wal"]
        assert len(p) > 24
        assert j == p

    def test_recovery_rebuilds_same_rows(self, single):
        """(c): each package's WAL replay, on a fresh replica, rebuilds
        the same state leaves, KV and floors."""
        out = {}
        for name, mod, kw in (("jax", jsrv, {}),
                              ("torch", tsrv, {"device": "cpu"})):
            d = single["base"] / f"recover_{name}"
            os.makedirs(d)
            shutil.copy(single[name]["wal_path"], d / "r0.wal")
            rep = build(mod, "MultiPaxos", 0, 1, 2, 32, d,
                        dict(BASE_CFG, pipeline=single["pipeline"]), **kw)
            try:
                out[name] = (leaf_digests(rep.state),
                             dict(rep.statemach.snapshot_items()),
                             list(rep.applied))
            finally:
                rep.shutdown()
        assert out["torch"][2] == single["torch"]["applied"]
        assert out["jax"] == out["torch"]


def test_snapshot_compacted_wal_is_refused(tmp_path):
    hub = TStorageHub(os.path.join(str(tmp_path), "r0.wal"))
    hub.do_sync_action(TLogAction("append", entry=("snap_floor", [5]),
                                  sync=True))
    hub.stop()
    with pytest.raises(SummersetError, match="snapshots are not ported"):
        build(tsrv, "MultiPaxos", 0, 3, 1, 32, tmp_path, {}, device="cpu")


def test_event_bits_of_superseded_frames_are_delivered(tmp_path):
    """Two frames from one peer in one tick: a group whose older frame
    holds a flag bit the newer lacks (an AR_NACK) gets the older frame's
    lanes this tick and the newer frame's next tick; the other groups
    get the newest frame at once (the JAX rule)."""
    rep = build(tsrv, "MultiPaxos", 0, 3, 2, 16, tmp_path, {},
                device="cpu")
    try:
        zero = {k: np.asarray(v)[:, 0, 1] if k not in
                rep.kernel.broadcast_lanes else np.asarray(v)[:, 0]
                for k, v in rep._last_out.items()}
        old = {k: v.copy() for k, v in zero.items()}
        new = {k: v.copy() for k, v in zero.items()}
        old["flags"][:] = [2 | 64, 2]    # group 0 nacks, group 1 acks
        old["ar_hint"][:] = [5, 0]
        new["flags"][:] = [2, 2]
        new["ar_f"][:] = [9, 9]
        got = rep._peer_lanes(1, [old, new])
        assert got["flags"].tolist() == [2 | 64, 2]
        assert got["ar_hint"].tolist() == [5, 0]
        assert got["ar_f"].tolist() == [0, 9]
        # the newer frame is still owed to group 0 only
        nxt = rep._peer_lanes(1, [])
        assert nxt["flags"].tolist() == [2, 2]
        assert nxt["ar_f"].tolist() == [9, 9]
        assert rep._peer_lanes(1, []) is None
        # one frame per tick is the newest-frame rule, nothing owed
        assert rep._peer_lanes(1, [old])["ar_hint"].tolist() == [5, 0]
        assert rep._owed[1] == []
    finally:
        rep.shutdown()
