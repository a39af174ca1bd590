"""The port's ServerReplica against the JAX package's, on the CPU.

Three gates, every one exact (no tolerance: integer state, byte-equal
digests, equal Python records):

(a) Seam lockstep.  Three JAX replicas and three port replicas, each
    built by its own constructor with in-memory stand-ins for the
    manager, the p2p mesh and the client plane (no sockets, no threads
    beyond the WAL logger), step the same scripted serial ticks for
    MultiPaxos, Raft, RSPaxos, CRaft and Crossword at G=2, R=3, W=16.
    Intake batches are fixed per tick; frames move in memory, sent in one
    round and delivered in the next; replica 0's frames are withheld for
    a stretch so leadership moves (and, on the codeword family, the new
    leader rebuilds adopted values from shards; CRaft falls back to full
    copies).  Per tick: every state leaf's sha256, each frame's kernel
    lanes (``flags`` as uint32) and payload parts (``pp``, ``need``,
    ``kv_need``, ``cw_need``; not the ``ts`` stamp), the WAL records,
    ``applied``, the KV, the replies and the manager notices.  Shard
    records (``ps``/``cw`` frame parts, ``cw`` in vote records) compare
    as their shard ids and the batch they encode, each first checked
    byte-exact against its own package's encoding of that batch: the two
    packages pickle different class paths, so their shard bytes differ.
(b) Single replica.  24 sequential puts on a 1-replica JAX cluster and a
    1-replica port cluster, in both loop modes: durable-state digests, KV,
    ``applied`` and the WAL entries equal.
(c) Recovery.  Each package's ``_recover_from_wal`` over its WAL from (b)
    rebuilds the same state, KV and floors.
"""

import os
import shutil
import sys
import types

import numpy as np
import pytest
import torch

import summerset_tpu.host.server as jsrv
import summerset_tpu_torch.host.server as tsrv
from summerset_tpu.host import messages as jmsg
from summerset_tpu.host import statemach as jsm
from summerset_tpu.host.storage import LogAction as JLogAction
from summerset_tpu.host.storage import StorageHub as JStorageHub
from summerset_tpu.ops import rscoding as jrs
from summerset_tpu.protocols.multipaxos import AR_NACK
from summerset_tpu_torch.host import messages as tmsg
from summerset_tpu_torch.host import statemach as tsm
from summerset_tpu_torch.host.storage import LogAction as TLogAction
from summerset_tpu_torch.host.storage import StorageHub as TStorageHub
from summerset_tpu_torch.ops import rscoding as trs
from summerset_tpu_torch.protocols.multipaxos import STALL_RENACK_TICKS
from summerset_tpu_torch.utils.errors import SummersetError

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_cluster import (  # noqa: E402
    build, durable_digest, leaf_digests, read_wal, shutdown_sides,
)
from test_torch_cluster import lockstep_sides as _lockstep_sides  # noqa: E402
from test_torch_cluster import (  # noqa: E402
    LEASE_CASES, lease_requests, lockstep_tick, norm_reply, norm_wal,
    requests, restart_replica, serving_requests,
)

torch.set_num_threads(1)

# host planes off in both packages (health beacons, watch frames, the
# flight recorder, slot traces, the wire codec), so these gates hold the
# serving core alone; tests/test_torch_{health,tracing,resharding}.py
# hold the planes on
BASE_CFG = {
    "health_enabled": False, "graftwatch": False, "flight_record": False,
    "trace_sample": 0, "wire_codec": False,
}


# ------------------------------------------------------ (a) lockstep gate
LOCK = dict(G=2, R=3, W=16, ticks=60, mute=(12, 40))
LOCK_CFG = dict(BASE_CFG, pipeline=False, hear_timeout_lo=8,
                hear_timeout_hi=16)
#: the codeword family: commit at a majority (RS(2,1) at R=3), CRaft's
#: peers declared dead 8 ticks after their last reply and a wider
#: election spread (so the mute elects a new leader that falls back to
#: full copies), Crossword's width pinned
CW_CFG = {"fault_tolerance": 0, "alive_timeout": 8, "hear_timeout_hi": 24,
          "assignment_adaptive": False}
CODEWORD = ("RSPaxos", "CRaft", "Crossword")
SIDES = (
    ("jax", jsrv, types.SimpleNamespace(msg=jmsg, sm=jsm), jrs.encode_payload,
     {}),
    ("torch", tsrv, types.SimpleNamespace(msg=tmsg, sm=tsm),
     trs.encode_payload, {"device": "cpu"}),
)


def lock_cfg(protocol):
    return dict(LOCK_CFG, **(CW_CFG if protocol in CODEWORD else {}))


def lockstep_sides(tmp_path, protocol, sides=SIDES, **net_kw):
    """Three replicas per package on their own in-memory mesh."""
    return _lockstep_sides(tmp_path, protocol, sides, lock_cfg(protocol),
                           LOCK["G"], LOCK["R"], LOCK["W"], **net_kw)


def count_calls(obj, name, pred=bool):
    """Wrap ``obj.name`` to count the calls whose result ``pred`` holds."""
    box = [0]
    orig = getattr(obj, name)

    def wrapped(*a, **k):
        out = orig(*a, **k)
        if pred(out):
            box[0] += 1
        return out

    setattr(obj, name, wrapped)
    return box


@pytest.mark.parametrize("protocol", ["MultiPaxos", "Raft"] + list(CODEWORD))
def test_seam_lockstep(tmp_path, protocol):
    G = LOCK["G"]
    sides = lockstep_sides(tmp_path, protocol)
    leaders = set()
    replies = redirects = 0
    # the port's rebuilds from shards and CRaft's full-copy intakes
    reps = sides["torch"][0]
    rebuilt = [count_calls(r.codewords, "reconstruct_batch",
                           lambda b: b is not None)
               for r in reps if r.codewords is not None]
    fallback = [count_calls(r, "_craft_fallback_groups",
                            lambda m: m is not None and bool(m.any()))
                for r in reps]
    shard_frames = 0
    try:
        for t in range(LOCK["ticks"]):
            lo, hi = LOCK["mute"]
            seen = lockstep_tick(sides, t, mute=0 if lo <= t < hi else None)
            j, p = seen["jax"], seen["torch"]
            for part in j:
                assert j[part] == p[part], f"tick {t}: {part} differs"
            for rep in reps:
                for g in range(G):
                    if rep._is_leader[g]:
                        leaders.add((g, rep.me))
            for rr in p["replies"]:
                replies += sum(1 for x in rr if x[1] == "reply")
                redirects += sum(1 for x in rr if x[1] == "redirect")
            shard_frames += sum(1 for _s, _d, f in p["frames"] if f["ps"])
        # the schedule did what it is for: leadership moved, writes
        # committed and were answered, followers redirected
        assert any(me != 0 for _g, me in leaders), leaders
        assert min(sum(rep.applied) for rep in reps) > 10
        assert replies > 20 and redirects > 20
        if protocol in CODEWORD:
            # shards went out, and the new leader rebuilt values it held
            # only as shards
            assert shard_frames > 10
            assert sum(b[0] for b in rebuilt) > 0
        if protocol == "CRaft":
            assert sum(b[0] for b in fallback) > 0
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
    from summerset_tpu_torch.cluster import Cluster as TCluster

    pipeline = request.param
    base = tmp_path_factory.mktemp("single_pl" if pipeline else "single_ser")
    jd = types.SimpleNamespace(GenericEndpoint=jep.GenericEndpoint,
                               DriverClosedLoop=jdrv.DriverClosedLoop)
    td = types.SimpleNamespace(GenericEndpoint=tep.GenericEndpoint,
                               DriverClosedLoop=tdrv.DriverClosedLoop)
    j = run_single(JCluster, jd, base / "jax", pipeline, np.asarray)
    p = run_single(TCluster, td, base / "torch", pipeline,
                   lambda v: v.numpy(), window=32, settle=0.5,
                   device="cpu")
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
    """A WAL compacted by a snapshot (its ``snap_floor`` marker first)
    with no snapshot file beside it: the apply history below the marker
    is gone, so the replica refuses to serve."""
    hub = TStorageHub(os.path.join(str(tmp_path), "r0.wal"))
    hub.do_sync_action(TLogAction("append", entry=("snap_floor", [5]),
                                  sync=True))
    hub.stop()
    with pytest.raises(SummersetError, match="snapshot missing"):
        build(tsrv, "MultiPaxos", 0, 3, 1, 32, tmp_path, {}, device="cpu")


def test_event_bits_of_superseded_frames_are_delivered(tmp_path):
    """Two frames from one peer in one tick: a group whose older frame
    holds a flag bit the newer lacks (an AR_NACK) gets the older frame's
    lanes this tick and the newer frame's next tick; the other groups
    get the newest frame at once (the JAX rule), and zero lanes on the
    next tick, when they are owed nothing (a JAX replica's inbox slot
    of a peer that sent nothing)."""
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
        # the newer frame is still owed to group 0 only: group 1 gets
        # zero lanes
        nxt = rep._peer_lanes(1, [])
        assert nxt["flags"].tolist() == [2, 0]
        assert nxt["ar_f"].tolist() == [9, 0]
        assert all(not v[1].any() for v in nxt.values())
        assert rep._peer_lanes(1, []) is None
        # one frame per tick is the newest-frame rule, nothing owed
        assert rep._peer_lanes(1, [old])["ar_hint"].tolist() == [5, 0]
        assert rep._owed[1] == []
    finally:
        rep.shutdown()


def test_owed_frames_beyond_the_cap_are_dropped_and_counted(tmp_path):
    """Ten frames from one peer in one tick, each with a flag bit the
    newest lacks in group 0: nine stay owed, one beyond the cap of
    eight.  The oldest owed frame is dropped and counted on
    ``owed_frames_dropped``; the eight kept are delivered one per tick
    to group 0 only, group 1 getting zero lanes."""
    rep = build(tsrv, "MultiPaxos", 0, 3, 2, 16, tmp_path, {},
                device="cpu")
    try:
        zero = {k: np.asarray(v)[:, 0, 1] if k not in
                rep.kernel.broadcast_lanes else np.asarray(v)[:, 0]
                for k, v in rep._last_out.items()}
        frames = []
        for i in range(10):
            f = {k: v.copy() for k, v in zero.items()}
            # frame i carries bit 8 + i in group 0 (none in the newest)
            f["flags"][:] = [2 | ((1 << (8 + i)) if i < 9 else 0), 2]
            f["ar_f"][:] = [i, i]
            frames.append(f)
        got = rep._peer_lanes(1, frames)
        assert got["ar_f"].tolist() == [0, 9]
        assert len(rep._owed[1]) == rep.OWED_FRAMES == 8
        assert rep.metrics.counter_value("owed_frames_dropped", peer=1) == 1
        # frame 1 was dropped with its bit; 2..8 and then the newest
        for i in list(range(2, 9)) + [9]:
            nxt = rep._peer_lanes(1, [])
            assert nxt["ar_f"].tolist() == [i, 0], i
            assert nxt["flags"][1] == 0
        assert rep._peer_lanes(1, []) is None
        assert rep.metrics.counter_value("owed_frames_dropped", peer=1) == 1
    finally:
        rep.shutdown()


#: MultiPaxos: the leader's (0) frame to 1 in round 5 holds a flag bit in
#: group 0 that its round-6 frame lacks; it is held a round, and the
#: round-7 frame on that link is lost
FRAMELESS = dict(src=0, dst=1, rnd=5)


def test_frameless_tick_after_superseded_frames_lockstep(tmp_path):
    """Two frames from one peer in one tick, the older with a flag bit
    the newer lacks in one group only, then a tick with no frame from
    that peer: the port delivers the owed newer frame in that group and
    zero lanes in every other group, exactly the JAX replica's inbox
    there (a slot of zeros)."""
    src, dst, rnd = (FRAMELESS[k] for k in ("src", "dst", "rnd"))
    sides = lockstep_sides(
        tmp_path, "MultiPaxos",
        drops=[((src, dst), rnd + 2, rnd + 3)], holds=[(src, dst, rnd)],
    )
    inboxes = {}
    for name, (reps, *_rest) in sides.items():
        rep = reps[dst]
        orig = rep._assemble_inbox

        def wrapped(own, got, rep=rep, orig=orig, name=name):
            out = orig(own, got)
            inboxes[(name, rep.tick)] = {
                k: np.asarray(v)[:, src] if k in rep.kernel.broadcast_lanes
                else np.asarray(v)[:, dst, src] for k, v in out.items()
            }
            return out

        rep._assemble_inbox = wrapped
    owed = None
    try:
        for t in range(rnd + 4):
            if t == rnd + 3:
                port = sides["torch"][0][dst]
                owed = [m for _f, m in port._owed.get(src, [])]
            lockstep_tick(sides, t)
    finally:
        shutdown_sides(sides)
    # the two frames arrived at tick rnd + 2; at rnd + 3 none did
    assert owed, "no frame was owed after the superseded pair"
    due = np.logical_or.reduce(owed)
    assert due.any() and not due.all(), due
    j, p = inboxes[("jax", rnd + 3)], inboxes[("torch", rnd + 3)]
    for k in j:
        assert not np.asarray(j[k]).any(), k  # JAX: a slot of zeros
        pk = np.asarray(p[k])
        if k == "flags":
            pk = pk.view(np.uint32)
        np.testing.assert_array_equal(pk[~due], np.asarray(j[k])[~due])
    # the owed group got the newer frame
    assert np.asarray(p["flags"])[due].all()


class _PinnedQdisc:
    """A QdiscInfo stand-in with fixed netem readings (no ``tc``)."""

    def __init__(self, delay_ms, rate_gbps):
        self.delay_ms, self.jitter_ms, self.rate_gbps = delay_ms, 0.0, \
            rate_gbps

    def update(self):
        return False


def test_crossword_adaptive_width_equals_jax(tmp_path, monkeypatch):
    """Crossword with the adaptive width on, one replica per package:
    the same delivery-sample stream, batch-size EWMA and netem readings
    under one pinned clock give equal ``overrides()`` and an equal
    ``spr_override`` kernel input, round after round, while the choice
    moves between shards (a slow peer: full copies; peers alike:
    narrow shards)."""
    from summerset_tpu.host import adaptive as jad
    from summerset_tpu_torch.host import adaptive as tad

    clock = [100.0]
    for mod in (jad, tad):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            monotonic=lambda: clock[0]))
    cfg = dict(BASE_CFG, pipeline=False, fault_tolerance=0)
    reps = [build(jsrv, "Crossword", 0, 3, 2, 16, tmp_path / "j", cfg),
            build(tsrv, "Crossword", 0, 3, 2, 16, tmp_path / "t", cfg,
                  device="cpu")]
    rng = np.random.default_rng(7)
    seen = []
    try:
        for rep in reps:
            assert rep._adaptive is not None
            rep._adaptive._qdisc = _PinnedQdisc(0.5, 1.0)
        for rnd in range(12):
            clock[0] += 0.6  # past the refit interval
            slow = 1 if rnd % 3 else 2  # peer 1 slow in most rounds
            samples = [
                (p, float(nb), float(nb) * 1e-4 * (40.0 if p == slow and
                                                   rnd % 2 else 1.0))
                for p in (1, 2) for nb in rng.integers(500, 50000, 6)
            ]
            bb = float(rng.integers(1000, 100000))
            got = []
            for rep in reps:
                rep.transport.samples.extend(samples)
                rep._batch_bytes = bb
                rep._fold_adaptive()
                inputs = rep._build_inputs(np.zeros(2, np.int32),
                                           np.zeros(2, np.int32))
                got.append((list(rep._spr_tick),
                            np.asarray(inputs["spr_override"]).tolist()))
            assert got[0] == got[1], (rnd, got)
            assert got[1][0] == got[1][1]
            seen.append(got[1][1][0])
        assert len(set(seen)) > 1, seen  # the width moved
    finally:
        for rep in reps:
            rep.shutdown()


NETEM = (
    "qdisc netem 8001: root refcnt 2 limit 1000 delay 10ms 2ms rate 1Gbit",
    "qdisc netem 8002: root refcnt 2 limit 1000 delay 250us",
    "qdisc fq_codel 0: root refcnt 2 limit 10240p flows 1024",
    "qdisc netem 8003: root rate 500Mbit\nqdisc netem 8004: delay 1s",
)


def test_qdisc_and_linreg_equal_jax_and_degrade(monkeypatch):
    """The port's copies parse netem lines and fit delivery samples as
    the JAX modules do, and ``QdiscInfo.update`` degrades to False with
    its fields untouched (never raising) without a device, without
    ``tc`` or when ``tc`` cannot run."""
    import subprocess

    from summerset_tpu.utils import linreg as jlr
    from summerset_tpu.utils import qdisc as jqd
    from summerset_tpu_torch.utils import linreg as tlr
    from summerset_tpu_torch.utils import qdisc as tqd

    for out in NETEM:
        j, t = jqd.QdiscInfo("lo"), tqd.QdiscInfo("lo")
        assert j.parse_output(out) == t.parse_output(out)
        assert (j.delay_ms, j.jitter_ms, j.rate_gbps) == \
            (t.delay_ms, t.jitter_ms, t.rate_gbps)
    rng = np.random.default_rng(3)
    regs = (jlr.LinearRegressor(window=16), tlr.LinearRegressor(window=16))
    for i in range(40):
        x, y = float(rng.integers(1, 1 << 16)), float(rng.random() * 9)
        for reg in regs:
            reg.append_sample(float(i), x, y)
            reg.discard_before(float(i - 20))
        assert regs[0].calc_model() == regs[1].calc_model()
    assert tlr.PerfModel(1.0, 2.0, 0.5, 0.25).predict(4.0) == \
        jlr.PerfModel(1.0, 2.0, 0.5, 0.25).predict(4.0)

    q = tqd.QdiscInfo()
    assert q.update() is False                    # no device named
    q = tqd.QdiscInfo("lo")
    monkeypatch.setattr(tqd.shutil, "which", lambda name: None)
    assert q.update() is False                    # no tc
    monkeypatch.setattr(tqd.shutil, "which", lambda name: "/sbin/tc")

    def broken(*a, **k):
        raise OSError("tc cannot run")

    monkeypatch.setattr(tqd.subprocess, "run", broken)
    assert q.update() is False                    # tc fails to run

    def slow(*a, **k):
        raise subprocess.TimeoutExpired("tc", 2.0)

    monkeypatch.setattr(tqd.subprocess, "run", slow)
    assert q.update() is False
    assert (q.delay_ms, q.jitter_ms, q.rate_gbps) == (0.0, 0.0, 0.0)


# ------------------------------------- RSPaxos durable resets in lockstep
#: RSPaxos RS(2,1), 4 groups.  ``pause_leader``: the schedule of
#: ``chip_smoke.py`` phase 13 (the leader, 0, cut off while replica 2
#: takes over, a durable reset of 0, then of the group-0 leader).
#: ``isolated_follower``: replica 1 cut off while the leader changes
#: (0 stops reaching 2, so 2 campaigns), a durable reset of 1 while it
#: is still cut off (its applied floor below the new leader's run), the
#: links back, then a durable reset of the group-0 leader; puts go on
#: throughout.  ``follower_reset_at_new_ballot``: replica 0 (the leader)
#: cut off while replica 1 takes over at ballot 513 with its run starting
#: at its commit bar; replica 2, whose applied floor trails its commit bar
#: while it rebuilds values from shards, votes that run and is reset at
#: once (the state of the ``chip_smoke.py`` phase-13 lag dump).  ``None``
#: resets the leader of group 0; ``stall`` names the (replica, group)
#: that the reference's own recovery stalls from its reset to the end.
RS_RESET = {
    "pause_leader": dict(
        drops=[((0, 1), 10, 40), ((0, 2), 10, 40), ((1, 0), 10, 40),
               ((2, 0), 10, 40)],
        resets={44: 0, 56: None}, ticks=110),
    "isolated_follower": dict(
        drops=[((1, 0), 10, 40), ((1, 2), 10, 40), ((0, 1), 10, 40),
               ((2, 1), 10, 40), ((0, 2), 12, 30)],
        resets={38: 1, 56: None}, ticks=100),
    "follower_reset_at_new_ballot": dict(
        drops=[((0, 1), 14, 60), ((0, 2), 14, 60), ((1, 0), 14, 60),
               ((2, 0), 14, 60)],
        resets={31: 2}, ticks=100, stall=(2, 1)),
}


@pytest.mark.parametrize("schedule", sorted(RS_RESET))
def test_rspaxos_durable_reset_lockstep(tmp_path, schedule):
    """Durable resets of RSPaxos replicas after a missed run, JAX and port
    replicas in per-tick lockstep: every state leaf, frame, WAL record,
    floor, KV, reply and notice equal on every tick, through both
    resets and the leader changes.  In ``isolated_follower`` both
    packages stall the restarted follower alike: it campaigned while cut
    off, so its recovered ``bal_max`` is above the leader's ballot, it
    refuses the leader's accepts, and its commit bar stays at its
    restored floor in a group the leader commits in, until the next
    leader's run (found by this case, not a port fault).  Restarts on
    the JAX side follow the port's restore rule (``port_restore_rule``):
    in ``follower_reset_at_new_ballot``, where the reference's own rule
    stalls the restarted follower for good
    (``test_rspaxos_reference_stall_after_follower_reset``), both
    packages then nack the leader's next accept, and the follower
    commits up with its leader."""
    sc = RS_RESET[schedule]
    G, R, W = 4, 3, 16
    cfg = lock_cfg("RSPaxos")
    sides = _lockstep_sides(tmp_path, "RSPaxos", SIDES, cfg, G, R, W,
                            drops=sc["drops"])
    cbs = []
    try:
        for t in range(sc["ticks"]):
            if t in sc["resets"]:
                r = sc["resets"][t]
                if r is None:
                    r = next(rep.me for rep in sides["jax"][0]
                             if rep._is_leader[0])
                restart_replica(sides, SIDES, r, tmp_path, "RSPaxos", cfg,
                                G, R, W)
            seen = lockstep_tick(sides, t)
            j, p = seen["jax"], seen["torch"]
            for part in j:
                assert j[part] == p[part], f"tick {t}: {part} differs"
            cb = [[rep._np_state("commit_bar")[:, rep.me].tolist()
                   for rep in sides[name][0]] for name in ("jax", "torch")]
            assert cb[0] == cb[1], f"tick {t}: commit bars differ"
            cbs.append(cb[1])
        reps = sides["torch"][0]
        rows = {k: [rep._np_state(k)[:, rep.me].tolist() for rep in reps]
                for k in ("vote_from", "vote_bal", "bal_max")}
    finally:
        shutdown_sides(sides)
    assert min(sum(rep.applied) for rep in reps) > 40
    if schedule == "isolated_follower":
        # replica 1's commit bar in group 1 sits at its restored floor
        # from the reset (38) past the next reset (56) while the
        # leader's moves on; the next leader's run frees it
        stuck = [c[1][1] for c in cbs[38:60]]
        assert len(set(stuck)) == 1, stuck
        assert max(c[r][1] for c in cbs[38:60] for r in (0, 2)) \
            > stuck[0] + 10
        assert cbs[-1][1][1] > stuck[0] + 10
    if "stall" in sc:
        # the reference stalls this follower for good
        # (test_rspaxos_reference_stall_after_follower_reset); under the
        # port's restore rule its next accept is nacked, the leader
        # resends from its floor, and it commits up with its leader
        r, g = sc["stall"]
        t0 = min(sc["resets"])
        lead = next(rep.me for rep in reps if rep._is_leader[g])
        assert cbs[-1][lead][g] > cbs[t0][r][g] + 20, (lead, cbs[-1])
        assert cbs[-1][r][g] > cbs[t0][r][g] + 20, cbs[-1]
        assert cbs[-1][r][g] >= cbs[-1][lead][g] - 4, (lead, cbs[-1])
        assert rows["vote_from"][r][g] <= cbs[-1][r][g]
        assert rows["vote_bal"][r][g] == rows["bal_max"][lead][g]


def test_rspaxos_reference_stall_after_follower_reset(tmp_path):
    """The reference's side of ``follower_reset_at_new_ballot``, its own
    ``restore_durable`` unpatched: the restarted follower stalls for
    good.  Its vote run at the leader's ballot starts above the commit
    bar its reset restored (its applied floor), the follower commit rule
    needs ``vote_from <= commit_bar``, and the leader, which counts the
    run as matched, never resends below it (ROADMAP Queue 3; the port's
    restore rule is the repair)."""
    sc = RS_RESET["follower_reset_at_new_ballot"]
    G, R, W = 4, 3, 16
    cfg = lock_cfg("RSPaxos")
    name, mod, _pkg, _enc, kw = SIDES[0]
    sides = _lockstep_sides(tmp_path, "RSPaxos", SIDES[:1], cfg, G, R, W,
                            drops=sc["drops"])
    reps = sides[name][0]
    r, g = sc["stall"]
    t0 = min(sc["resets"])
    cbs = []
    try:
        for t in range(sc["ticks"]):
            if t == t0:
                reps[r].shutdown()
                reps[r] = build(mod, "RSPaxos", r, R, G, W,
                                os.path.join(str(tmp_path), name, str(r)),
                                cfg, net=sides[name][1], **kw)
            lockstep_tick(sides, t)
            cbs.append([rep._np_state("commit_bar")[:, rep.me].tolist()
                        for rep in reps])
        rows = {k: [rep._np_state(k)[:, rep.me].tolist() for rep in reps]
                for k in ("vote_from", "vote_bal", "bal_max")}
    finally:
        shutdown_sides(sides)
    lead = next(rep.me for rep in reps if rep._is_leader[g])
    stuck = [c[r][g] for c in cbs[t0:]]
    assert len(set(stuck)) == 1, stuck
    assert cbs[-1][lead][g] > stuck[0] + 20, (lead, cbs[-1])
    assert rows["vote_from"][r][g] > stuck[0]
    assert rows["vote_bal"][r][g] == rows["bal_max"][lead][g]


# ---------------------------------------- lease and conf planes, lockstep
@pytest.mark.parametrize("protocol", sorted(LEASE_CASES))
def test_lease_serving_lockstep(tmp_path, protocol):
    """QuorumLeases with a client conf change and follower local gets;
    Bodega with a roster conf announced at a non-leader and responder
    local gets; MultiPaxos with leader leases, leader local gets and a
    get of a key with a put in the voted tail, which goes through the
    log.  Per tick every state leaf, frame, WAL record, floor, KV, reply
    (with its ``local`` flag) and manager notice equal the JAX
    replicas'.  Then a durable reset of replica 1 on both sides rebuilds
    equal state, QuorumLeases' installed conf included."""
    case = LEASE_CASES[protocol]
    G, R, W = 2, 3, 16
    cfg = dict(BASE_CFG, pipeline=False, hear_timeout_lo=16,
               hear_timeout_hi=32, **case["cfg"])
    sides = _lockstep_sides(tmp_path, protocol, SIDES, cfg, G, R, W)
    reqs = lease_requests(protocol, case["conf"])
    local = {r: 0 for r in range(R)}
    conf_ok = notices = 0
    logged_tail_gets = []
    try:
        for t in range(case["ticks"]):
            seen = lockstep_tick(sides, t, reqs=reqs)
            j, p = seen["jax"], seen["torch"]
            for part in j:
                assert j[part] == p[part], f"tick {t}: {part} differs"
            for r, rr in enumerate(p["replies"]):
                for x in rr:
                    local[r] += x[5]
                    conf_ok += x[1] == "conf" and x[3]
                    if x[2] % 1000 == 1 and (x[2] // 1000) % 9 == 1:
                        logged_tail_gets.append((x[2], x[5]))
            notices += sum(k == "responders_conf"
                           for c in p["ctrl"] for k, _ in c)
        restart_replica(sides, SIDES, 1, tmp_path, protocol, cfg, G, R, W)
        rebuilt = {name: leaf_digests(sides[name][0][1].state)
                   for name in ("jax", "torch")}
        assert rebuilt["jax"] == rebuilt["torch"]
        rep1 = sides["torch"][0][1]
    finally:
        shutdown_sides(sides)
    if protocol == "MultiPaxos":
        assert local[0] > 10 and local[1] == local[2] == 0, local
        # the gets of a key put one tick before went through the log
        assert logged_tail_gets and not any(
            loc for _rid, loc in logged_tail_gets), logged_tail_gets
    else:
        assert conf_ok == 1 and notices >= 1
        assert local[1] + local[2] > 5, local
        if protocol == "Bodega":
            assert local[0] == 0
    if protocol == "QuorumLeases":
        assert rep1._np_state("conf_cur")[:, 1].tolist() == [7] * G


def test_resume_holds_off_local_reads(tmp_path):
    """Leases count ticks, and a paused replica's count stands still: on
    resume its pre-pause lease view may have lapsed at the grantor.  The
    port serves no local read (neither a responder's nor a leader's
    leased get) for ``OWED_FRAMES`` + 1 + the longest lease plus margin
    of its own ticks after a resume; the JAX replica serves from its
    pre-pause view at once (found by ``chip_smoke.py`` phase 14's
    rehearsal: a resumed QuorumLeases leader answered a get with a value
    a newer leader had overwritten)."""
    cfg = dict(BASE_CFG, pipeline=False, hear_timeout_lo=16,
               hear_timeout_hi=32)
    reps = {name: build(mod, "QuorumLeases", 0, 3, 2, 16, tmp_path / name,
                        cfg, **kw)
            for name, mod, _pkg, _enc, kw in SIDES}
    try:
        for name, rep in reps.items():
            K = rep.kernel.config.num_key_buckets
            rep._last_extra = {
                "lease_held": np.ones((2, 3), bool),
                "n_local_buckets": np.full((2, 3), K, np.int32),
                "leader_read_ok": np.ones((2, 3), bool),
            }
            assert rep._can_local_read(0) and rep._leader_read_ok(0)
            for kind in ("pause", "resume"):
                msg = types.SimpleNamespace(kind=kind, payload={})
                rep.ctrl.try_recv_ctrl = lambda msg=msg: msg
                assert rep._handle_ctrl() is None
            assert not rep.paused
        assert reps["jax"]._can_local_read(0)
        assert reps["jax"]._leader_read_ok(0)
        port = reps["torch"]
        kc = port.kernel.config
        hold = (port.OWED_FRAMES + 1 + kc.lease_margin
                + max(kc.lease_len, kc.leader_lease_len))
        t0 = port.tick
        for port.tick in range(t0, t0 + hold):
            assert not port._can_local_read(0)
            assert not port._leader_read_ok(0)
        port.tick = t0 + hold
        assert port._can_local_read(0) and port._leader_read_ok(0)
    finally:
        for rep in reps.values():
            rep.shutdown()


# ------------------------- EPaxos and the basic kernels, served in lockstep
#: per case: the protocol, the loop, and the durable reset (tick,
#: replica): EPaxos resets a proposer (its eapply records replay), the
#: basic kernels their head or serving replica
SERVE_CASES = {
    "EPaxos-serial": dict(protocol="EPaxos", pipelined=False, reset=(24, 1)),
    "EPaxos-pipelined": dict(protocol="EPaxos", pipelined=True,
                             reset=(24, 1)),
    "ChainRep": dict(protocol="ChainRep", pipelined=False, reset=(24, 0)),
    "SimplePush": dict(protocol="SimplePush", pipelined=False,
                       reset=(24, 0)),
    "RepNothing": dict(protocol="RepNothing", pipelined=False,
                       reset=(24, 0)),
}


def _flush_replica(sides, r):
    """Settle replica ``r``'s pipeline on every side (its queued replies
    go out), so a restart drops nothing whose release raced the fsync."""
    for reps, *_rest in sides.values():
        reps[r]._pipeline_flush()


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_serving_lockstep_every_protocol(tmp_path, case):
    """EPaxos (both loop modes), ChainRep, SimplePush and RepNothing
    served by three JAX and three port replicas in per-tick lockstep:
    every state leaf, frame, WAL record (``eapply`` records included),
    floor, KV and manager notice equal on every tick, and the replies
    equal (per tick in the serial loop, summed over the run in the
    pipelined one, whose replies leave when their fsync settles).  A
    durable reset mid-run rebuilds equal state from each side's WAL.
    EPaxos proposed at every replica and at least two key buckets of one
    group in one tick."""
    sc = SERVE_CASES[case]
    protocol, pipelined = sc["protocol"], sc["pipelined"]
    G, R, W, ticks = 2, 3, 16, 40
    cfg = dict(LOCK_CFG, pipeline=pipelined)
    sides = _lockstep_sides(tmp_path, protocol, SIDES, cfg, G, R, W)
    reps = sides["torch"][0]
    replies = {name: [[] for _ in range(R)] for name in sides}
    multi = 0
    proposers = set()
    try:
        for t in range(ticks):
            if t == sc["reset"][0]:
                r = sc["reset"][1]
                if pipelined:
                    _flush_replica(sides, r)
                restart_replica(sides, SIDES, r, tmp_path, protocol, cfg,
                                G, R, W)
                reps = sides["torch"][0]
                rebuilt = [leaf_digests(sides[n][0][r].state)
                           for n in ("jax", "torch")]
                assert rebuilt[0] == rebuilt[1], f"reset at tick {t}"
            seen = lockstep_tick(sides, t, pipelined=pipelined,
                                 reqs=serving_requests(protocol, G))
            j, p = seen["jax"], seen["torch"]
            for part in j:
                if part != "replies" or not pipelined:
                    assert j[part] == p[part], f"tick {t}: {part} differs"
            for name in sides:
                for r, rr in enumerate(seen[name]["replies"]):
                    replies[name][r].extend(rr)
            if protocol == "EPaxos":
                for rep in reps:
                    n = (rep._ep_prop_vids != 0).sum(axis=1)
                    multi = max(multi, int(n.max()))
                    if n.any():
                        proposers.add(rep.me)
        if pipelined:
            for r in range(R):
                _flush_replica(sides, r)
            for name, (rs, *_rest) in sides.items():
                for r, rep in enumerate(rs):
                    replies[name][r].extend(
                        norm_reply(c, x) for c, x in rep.external.replies)
    finally:
        shutdown_sides(sides)
    assert replies["jax"] == replies["torch"]
    acked = sum(x[1] == "reply" for rr in replies["torch"] for x in rr)
    assert acked > 20, acked
    assert min(sum(rep.applied) for rep in reps) > 5 or \
        protocol == "RepNothing"
    if protocol == "EPaxos":
        assert proposers == {0, 1, 2}, proposers
        assert multi >= 2, multi


# ------------------------------------------------- snapshots in lockstep
SNAP = dict(G=2, R=3, W=16, snap=24, restart=36, ticks=48)


def _wal_records(rep, action_cls, norm):
    """Every record of a replica's live WAL, normalized."""
    out, off = [], 0
    while True:
        res = rep.wal.do_sync_action(action_cls("read", offset=off))
        if not res.offset_ok or res.entry is None:
            return out
        out.append(norm_wal(res.entry, norm))
        off = res.end_offset


def _snap_file(rep):
    """A replica's snapshot as plain values: its KV and the meta keys the
    port writes (the JAX server's resharding keys must be empty)."""
    import pickle

    with open(rep.snap_path, "rb") as f:
        kind, kv, meta = pickle.load(f)
    for k in ("ranges", "radopted", "rseals"):
        assert not meta.pop(k, None), k
    return kind, dict(kv), meta


@pytest.mark.parametrize("protocol", ["MultiPaxos", "RSPaxos", "EPaxos"])
def test_snapshot_lockstep(tmp_path, protocol):
    """Both packages take a snapshot on every replica at the same tick:
    the compacted WALs (the ``snap_floor`` marker, then one vote record
    per group with its window payloads or, on RSPaxos, its shard rows)
    and the snapshot files (KV, ``applied``, ``wslots``, EPaxos
    ``ep_rows``) are equal, and each WAL shrank.  Later every replica
    restarts from snapshot plus WAL tail on both sides: equal state, KV
    and floors, and the lockstep holds after the restart."""
    G, R, W = SNAP["G"], SNAP["R"], SNAP["W"]
    cfg = lock_cfg(protocol)
    sides = _lockstep_sides(tmp_path, protocol, SIDES, cfg, G, R, W)
    acts = {"jax": JLogAction, "torch": TLogAction}
    try:
        for t in range(SNAP["ticks"]):
            if t == SNAP["snap"]:
                got = {}
                for name, (reps, _net, _pkg, _w, norm) in sides.items():
                    before = [rep.wal.size for rep in reps]
                    after = [rep._take_snapshot() for rep in reps]
                    assert all(a < b for a, b in zip(after, before)), \
                        (name, before, after)
                    got[name] = ([_wal_records(rep, acts[name], norm)
                                  for rep in reps],
                                 [_snap_file(rep) for rep in reps])
                assert got["jax"][0] == got["torch"][0], "compacted WALs"
                assert got["jax"][1] == got["torch"][1], "snapshots"
                wal0 = got["torch"][0][0]
                assert wal0[0][0] == "snap_floor"
                assert len(wal0) == 1 + G
                meta = got["torch"][1][0][2]
                assert ("ep_rows" in meta) == (protocol == "EPaxos")
                assert sum(meta["applied"]) > 0
            if t == SNAP["restart"]:
                for r in range(R):
                    restart_replica(sides, SIDES, r, tmp_path, protocol,
                                    cfg, G, R, W)
                out = {name: [(leaf_digests(rep.state),
                               dict(rep.statemach.snapshot_items()),
                               list(rep.applied)) for rep in reps]
                       for name, (reps, *_rest) in sides.items()}
                assert out["jax"] == out["torch"], "recovered replicas"
                assert all(o[1] for o in out["torch"])
            seen = lockstep_tick(sides, t, reqs=serving_requests(protocol, G))
            j, p = seen["jax"], seen["torch"]
            for part in j:
                assert j[part] == p[part], f"tick {t}: {part} differs"
        reps = sides["torch"][0]
        final = [sum(rep.applied) for rep in reps]
    finally:
        shutdown_sides(sides)
    assert min(final) > sum(meta["applied"]), final


#: EPaxos: replica 1 restarted from its WAL at tick 25 and kept from its
#: peers for 45 ticks (a rejoin that outlasts ``alive_timeout``, 30),
#: load at replicas 0 and 2 meanwhile, none after tick 60
EP_ABSENCE = dict(G=2, R=3, W=16, reset=25, absent=45, load=60, ticks=100)


def test_epaxos_rejoin_after_long_absence_lockstep(tmp_path):
    """A restarted EPaxos replica that rejoins after more than
    ``alive_timeout`` ticks, while its peers committed without it (and
    recovered its row): JAX and port replicas equal on every tick, and
    in both alike the restarted replica never learns the commits it
    missed, so its exec floors stay behind in every group long after the
    load stopped (found by ``chip_smoke.py`` phase 17's reset under load
    on the card; a reference defect, ROADMAP Queue 3)."""
    sc = EP_ABSENCE
    G, R, W = sc["G"], sc["R"], sc["W"]
    t0, k = sc["reset"], sc["absent"]
    cfg = dict(LOCK_CFG)
    drops = [((a, b), t0, t0 + k) for a, b in ((0, 1), (2, 1), (1, 0),
                                                (1, 2))]
    sides = _lockstep_sides(tmp_path, "EPaxos", SIDES, cfg, G, R, W,
                            drops=drops)
    sched = serving_requests("EPaxos", G)

    def reqs(pkg, t, r):
        if t >= sc["load"] or (r == 1 and t0 <= t < t0 + k):
            return []
        return sched(pkg, t, r)

    try:
        assert k > sides["torch"][0][0].kernel.config.alive_timeout
        for t in range(sc["ticks"]):
            if t == t0:
                restart_replica(sides, SIDES, 1, tmp_path, "EPaxos", cfg,
                                G, R, W)
            seen = lockstep_tick(sides, t, reqs=reqs)
            for part in seen["jax"]:
                assert seen["jax"][part] == seen["torch"][part], \
                    f"tick {t}: {part} differs"
        reps = sides["torch"][0]
        applied = [list(rep.applied) for rep in reps]
        cmt = [rep._np_state("cmt_row")[:, rep.me].sum(axis=1).tolist()
               for rep in reps]
    finally:
        shutdown_sides(sides)
    # replicas 0 and 2 agree and executed everything they committed
    assert applied[0] == applied[2] == cmt[0] == cmt[2], (applied, cmt)
    # replica 1 stays behind in every group, 40 ticks after the load
    assert all(a1 + 20 < a0 for a1, a0 in zip(applied[1], applied[0])), \
        applied
    assert all(c1 < c0 for c1, c0 in zip(cmt[1], cmt[0])), cmt


# ------------------------------------------------- the read tier, lockstep
def nqr_requests(pkg, t, r):
    """Near-quorum read schedule: replica 0 (the leader) puts ``q0``..
    ``q2`` in turn every third tick; replicas 1 and 2 get the key put one
    or two ticks before (a voted tail at some replica: ``rq_retry``) and
    a quiet key (served by quorum, ``local``)."""
    Req, Cmd = pkg.msg.ApiRequest, pkg.sm.Command
    base = 1000 * t + 10 * r
    if r == 0:
        if t % 3 == 0 and t < 36:
            return [(100, Req("req", req_id=base, cmd=Cmd(
                "put", f"q{(t // 3) % 3}", f"v{t}")))]
        return []
    if t < 4:
        return []
    recent = f"q{((t - r) // 3) % 3}"
    return [(200 + r, Req("req", req_id=base + 1, cmd=Cmd("get", recent))),
            (300 + r, Req("req", req_id=base + 2,
                          cmd=Cmd("get", "quiet")))]


def test_near_quorum_reads_lockstep(tmp_path):
    """MultiPaxos with ``near_quorum_reads``: follower gets fan out as
    ``rq`` frame parts, the peers answer with ``rqr`` samples, and the
    follower serves a quiet key by quorum (``local``) and turns a key
    with a write in some voted tail into an ``rq_retry`` redirect.  Per
    tick every state leaf, frame (``rq``/``rqr`` included), WAL record,
    floor, KV and reply (``local``, ``rq_retry``) equal the JAX
    replicas'."""
    G, R, W = 2, 3, 16
    cfg = dict(BASE_CFG, pipeline=False, hear_timeout_lo=16,
               hear_timeout_hi=32, near_quorum_reads=True)
    sides = _lockstep_sides(tmp_path, "MultiPaxos", SIDES, cfg, G, R, W)
    served = retried = rq_parts = 0
    try:
        for t in range(48):
            seen = lockstep_tick(sides, t, reqs=nqr_requests)
            j, p = seen["jax"], seen["torch"]
            for part in j:
                assert j[part] == p[part], f"tick {t}: {part} differs"
            rq_parts += sum(bool(f["rq"]) + bool(f["rqr"])
                            for _s, _d, f in p["frames"])
            for r, rr in enumerate(p["replies"]):
                for x in rr:
                    if r and x[1] == "reply" and x[5]:
                        served += 1
                    if r and x[1] == "redirect" and x[6]:
                        retried += 1
        assert all(rep._nqr_ok for rep in sides["torch"][0])
    finally:
        shutdown_sides(sides)
    assert rq_parts > 20, rq_parts
    assert served > 10 and retried > 3, (served, retried)


def scan_requests(protocol, lead=0):
    """Scan schedule: the leader puts ``s0``..``s5`` and ``t0`` (outside
    the span) in the first ticks and again every seventh; from tick 8 it
    scans ``[s0, s9)`` (every fourth tick, limit 0 or 3) and a follower
    scans too (a redirect, or a lease read)."""

    def reqs(pkg, t, r):
        Req, Cmd = pkg.msg.ApiRequest, pkg.sm.Command
        base = 1000 * t + 10 * r
        out = []
        if r == lead and (t < 7 or t % 7 == 0):
            key = "t0" if t == 3 else f"s{t % 6}"
            out.append((100, Req("req", req_id=base, cmd=Cmd(
                "put", key, f"v{t}"))))
        if t >= 8 and t % 4 == 0:
            lim = 3 if t % 8 == 0 else 0
            if r == lead:
                out.append((400, Req("req", req_id=base + 4, cmd=Cmd(
                    "scan", "s0", end="s9", limit=lim))))
            elif r == (lead + 1) % 3:
                out.append((500 + r, Req("scan", req_id=base + 5,
                                         cmd=Cmd("scan", "s", end="t"))))
        return out

    return reqs


SCAN_CASES = {
    # the commit-bar barrier: markers into every group's log
    "barrier": ("MultiPaxos", {}),
    # leader leases: served from applied state when no tail write
    "lease": ("MultiPaxos", {"leader_leases": True}),
    # the markers are encoded at the leader and rebuilt at followers
    "rspaxos_barrier": ("RSPaxos", CW_CFG),
    # leaderless: a scan is answered with an error
    "epaxos": ("EPaxos", {}),
}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scan_lockstep(tmp_path, case):
    """Scans on three JAX and three port replicas in per-tick lockstep:
    every state leaf, frame (the markers in ``pp``/``ps``), WAL record,
    floor, KV and reply (``items``, ``local``) equal on every tick.  The
    leader's scans return every key of the span it acked, in order; the
    barrier marker applies with no effect, after a rebuild from shards
    too; EPaxos answers ``error``."""
    protocol, extra = SCAN_CASES[case]
    G, R, W = 2, 3, 16
    cfg = dict(BASE_CFG, pipeline=False, hear_timeout_lo=16,
               hear_timeout_hi=32)
    cfg.update(extra)
    sides = _lockstep_sides(tmp_path, protocol, SIDES, cfg, G, R, W)
    reps = sides["torch"][0]
    rebuilt = [count_calls(r.codewords, "reconstruct_batch",
                           lambda b: b is not None)
               for r in reps if r.codewords is not None]
    scans, errors, local, acked = [], 0, 0, {}
    try:
        for t in range(44):
            seen = lockstep_tick(sides, t, reqs=scan_requests(protocol))
            j, p = seen["jax"], seen["torch"]
            for part in j:
                assert j[part] == p[part], f"tick {t}: {part} differs"
            for r, rr in enumerate(p["replies"]):
                for x in rr:
                    if x[0] == 100 and x[1] == "reply":
                        acked[x[2]] = t
                    if x[0] in (400, 501) and x[1] == "reply":
                        scans.append((t, x[0], x[9][3]))
                        local += x[5]
                    if x[0] in (400, 501) and x[1] == "error":
                        errors += 1
        kv = dict(reps[0].statemach.snapshot_items())
        served = reps[0].metrics.counter_value("scan_served")
    finally:
        shutdown_sides(sides)
    if protocol == "EPaxos":
        assert errors >= 8 and not scans, (errors, scans)
        return
    assert len(scans) >= 4
    assert served == sum(1 for s in scans if s[1] == 400), (served, scans)
    for _t, _client, items in scans:
        keys = [k for k, _v in items]
        assert keys == sorted(keys) and all(k.startswith("s") for k in keys)
    # the last scan saw every key of the span the leader holds
    last = scans[-1][2]
    want = tuple(sorted((k, v) for k, v in kv.items() if "s0" <= k < "s9"))
    assert last == want or len(last) == 3, (last, want)
    if case == "lease":
        assert local > 0, scans
    else:
        assert local == 0, scans
    if case == "rspaxos_barrier":
        assert sum(b[0] for b in rebuilt) > 0


def feed_requests(sub_tick=5):
    """Commit feed schedule: a learner (client 700) subscribes at
    replica 1 at ``sub_tick``; the leader takes a put every tick for 30
    ticks over ``f0``..``f4``; probes for a key at the leader and at
    replica 1 every fifth tick, and for a span at replica 2."""

    def reqs(pkg, t, r):
        Req, Cmd = pkg.msg.ApiRequest, pkg.sm.Command
        base = 1000 * t + 10 * r
        out = []
        if r == 1 and t == sub_tick:
            out.append((700, Req("sub", req_id=base + 7)))
        if r == 0 and t < 30:
            out.append((100, Req("req", req_id=base, cmd=Cmd(
                "put", f"f{t % 5}", f"v{t}"))))
        if t % 5 == 2:
            if r < 2:
                out.append((600 + r, Req("probe", req_id=base + 6,
                                         cmd=Cmd("get", "f1"))))
            else:
                out.append((600 + r, Req("probe", req_id=base + 6,
                                         cmd=Cmd("scan", "f", end="g"))))
        return out

    return reqs


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["serial", "pipelined"])
def test_subscribe_and_notes_lockstep(tmp_path, pipelined):
    """A subscription at a follower and probes, in both loop modes: per
    tick every state leaf, frame, WAL record, floor and KV equal the JAX
    replicas', and the replies (the ``sub`` snapshot, every ``note`` with
    its ``seq``, the probe verdicts) per tick in the serial loop, summed
    over the run in the pipelined one.  The notes' seqs rise strictly by
    one, and the snapshot plus the notes equal the follower's applied
    KV."""
    G, R, W = 2, 3, 16
    cfg = dict(BASE_CFG, pipeline=pipelined, hear_timeout_lo=16,
               hear_timeout_hi=32)
    sides = _lockstep_sides(tmp_path, "MultiPaxos", SIDES, cfg, G, R, W)
    replies = {name: [[] for _ in range(R)] for name in sides}
    reqs = feed_requests()
    try:
        for t in range(40):
            seen = lockstep_tick(sides, t, reqs=reqs, pipelined=pipelined)
            j, p = seen["jax"], seen["torch"]
            for part in j:
                if part != "replies" or not pipelined:
                    assert j[part] == p[part], f"tick {t}: {part} differs"
            for name in sides:
                for r, rr in enumerate(seen[name]["replies"]):
                    replies[name][r].extend(rr)
        if pipelined:
            for r in range(R):
                _flush_replica(sides, r)
            for name, (rs, *_rest) in sides.items():
                for r, rep in enumerate(rs):
                    replies[name][r].extend(
                        norm_reply(c, x) for c, x in rep.external.replies)
        kv1 = dict(sides["torch"][0][1].statemach.snapshot_items())
    finally:
        shutdown_sides(sides)
    assert replies["jax"] == replies["torch"]
    feed = [x for x in replies["torch"][1] if x[0] == 700]
    assert feed and feed[0][1] == "sub"
    kv = dict(feed[0][8])
    seqs = [feed[0][7]]
    for x in feed[1:]:
        assert x[1] == "note"
        for s, k, v in x[8]:
            assert s == seqs[-1] + 1, (s, seqs[-1])
            seqs.append(s)
            kv[k] = v
        assert x[7] == seqs[-1]
    assert len(seqs) > 15 and kv == kv1
    probes = [x for rr in replies["torch"] for x in rr if x[1] == "probe"]
    assert len(probes) >= 20


# --------------------------------------- the nemesis planes of fault_ctl
def ctrl_msg(rep, pkg, kind, payload):
    """Deliver one manager message through the replica's ctrl handler."""
    box = [pkg.msg.CtrlMsg(kind, payload)]
    rep.ctrl.try_recv_ctrl = lambda: box.pop() if box else None
    return rep._handle_ctrl()


class ScriptedClock:
    """A stand-in for a server module's ``time``: ``monotonic()`` returns
    the scripted ``now``, ``sleep(s)`` records ``s``; everything else is
    the real module."""

    def __init__(self):
        import time as real

        self._real = real
        self.now = 1000.0
        self.sleeps = []

    def monotonic(self):
        return self.now

    def sleep(self, s):
        self.sleeps.append(round(s, 9))

    def __getattr__(self, name):
        return getattr(self._real, name)


#: replica 1's skew over the ticks: healthy, 2.5x, healed with None,
#: 1.6x, healed with 1.0
SKEW_PLAN = {3: 2.5, 7: None, 10: 1.6, 13: 1.0}
SKEW_TICKS = 16
SKEW_WORK = (0.004, 0.031, 0.012)   # each replica's loop time per tick


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["serial", "pipelined"])
def test_skew_pacing_lockstep(tmp_path, monkeypatch, pipelined):
    """``fault_ctl {"skew": f}`` and its heals (None, 1.0) on replica 1,
    stepped on the JAX and port replicas with the clock scripted: every
    tick's deadline and deadline sleep are equal on both sides (the
    stretch pads a compute-bound tick by ``(f - 1)`` times its loop
    time), and so are the flight recorder's ``fault_ctl`` events and
    their heal flags."""
    clocks = {"jax": ScriptedClock(), "torch": ScriptedClock()}
    monkeypatch.setattr(jsrv, "time", clocks["jax"])
    monkeypatch.setattr(tsrv, "time", clocks["torch"])
    cfg = dict(lock_cfg("MultiPaxos"), pipeline=pipelined,
               flight_record=True)
    sides = _lockstep_sides(tmp_path, "MultiPaxos", SIDES, cfg,
                            LOCK["G"], LOCK["R"], LOCK["W"])
    paced = {name: [] for name in sides}
    try:
        for name, (reps, *_r) in sides.items():
            clock = clocks[name]
            for r, rep in enumerate(reps):
                rep.tick_interval = 0.01
                real_end = rep._tick_end

                def tick_end(t0, deadline, rep=rep, r=r, clock=clock,
                             real_end=real_end, name=name):
                    clock.now = t0 + SKEW_WORK[r]
                    n = len(clock.sleeps)
                    real_end(t0, deadline)
                    paced[name].append((rep.tick, r, round(deadline - t0, 9),
                                        clock.sleeps[n:]))

                rep._tick_end = tick_end
        for t in range(SKEW_TICKS):
            for name, (reps, net, pkg, _w, _n) in sides.items():
                if t in SKEW_PLAN:
                    ctrl_msg(reps[1], pkg, "fault_ctl",
                             {"skew": SKEW_PLAN[t], "seed": 7})
                for r, rep in enumerate(reps):
                    rep.external.batches.append(requests(pkg, t, r))
                    clocks[name].now = 1000.0 + t
                    if pipelined:
                        rep._tick_pipelined(1000.0 + t)
                    else:
                        rep._tick_serial(1000.0 + t)
                net.flush()
        events = {name: [{k: e[k] for k in ("planes", "heal")}
                         for e in reps[1].flight.dump()["events"]
                         if e["type"] == "fault_ctl"]
                  for name, (reps, *_r) in sides.items()}
        scales = {name: reps[1]._tick_scale
                  for name, (reps, *_r) in sides.items()}
    finally:
        shutdown_sides(sides)
    assert paced["torch"] == paced["jax"]
    assert events["torch"] == events["jax"] == [
        {"planes": "skew", "heal": False}, {"planes": "skew", "heal": True},
        {"planes": "skew", "heal": False}, {"planes": "skew", "heal": True},
    ]
    assert scales == {"jax": 1.0, "torch": 1.0}
    skewed = [p for p in paced["torch"] if p[1] == 1 and 4 <= p[0] <= 7]
    assert skewed and all(p[2] == 0.025 for p in skewed), skewed
    # the compute-bound replica pads 1.5 x its 31 ms loop, not just to
    # the stretched 25 ms deadline
    assert all(p[3] == [round(1.5 * 0.031, 9)] for p in skewed), skewed


@pytest.mark.parametrize("protocol", ["MultiPaxos", "RSPaxos"])
def test_snap_crash_lockstep(tmp_path, protocol):
    """``fault_ctl {"snap_crash": 1}`` then ``take_snapshot`` on replica
    1, both through the ctrl handler, on the JAX and port replicas: both
    raise at the crash point with the snapshot file written and the WAL
    not compacted.  Replica 1 restarts from the new snapshot plus the
    old, longer WAL on both sides: equal state, KV and floors, the
    armed count spent, and the lockstep (frames, WAL records, replies)
    holds to the end."""
    G, R, W = SNAP["G"], SNAP["R"], SNAP["W"]
    cfg = lock_cfg(protocol)
    sides = _lockstep_sides(tmp_path, protocol, SIDES, cfg, G, R, W)
    try:
        for t in range(SNAP["ticks"]):
            if t == SNAP["snap"]:
                for name, (reps, _net, pkg, _w, _n) in sides.items():
                    rep = reps[1]
                    before = rep.wal.size
                    ctrl_msg(rep, pkg, "fault_ctl", {"snap_crash": 1})
                    assert rep._snap_crash == 1
                    err = (SummersetError if name == "torch"
                           else jsrv.SummersetError)
                    with pytest.raises(err, match="injected snapshot crash"):
                        ctrl_msg(rep, pkg, "take_snapshot", {})
                    assert rep._snap_crash == 0
                    assert os.path.exists(rep.snap_path)
                    assert rep.wal.size == before, name
                snaps = {name: _snap_file(reps[1])
                         for name, (reps, *_r) in sides.items()}
                assert snaps["jax"] == snaps["torch"]
                assert sum(snaps["torch"][2]["applied"]) > 0
                restart_replica(sides, SIDES, 1, tmp_path, protocol, cfg,
                                G, R, W)
                out = {name: (leaf_digests(reps[1].state),
                              dict(reps[1].statemach.snapshot_items()),
                              list(reps[1].applied), reps[1]._snap_crash)
                       for name, (reps, *_r) in sides.items()}
                assert out["jax"] == out["torch"], "recovered replica 1"
                assert out["torch"][2] == snaps["torch"][2]["applied"]
                assert out["torch"][3] == 0
            seen = lockstep_tick(sides, t, reqs=serving_requests(protocol, G))
            j, p = seen["jax"], seen["torch"]
            for part in j:
                assert j[part] == p[part], f"tick {t}: {part} differs"
        final = [sum(rep.applied) for rep in sides["torch"][0]]
    finally:
        shutdown_sides(sides)
    assert min(final) > sum(snaps["torch"][2]["applied"]), final


# ------------------------------ a stalled follower repeats its lost NACK
def _stall_row(rep, me):
    """Make follower ``me``'s group-0 vote run start one slot above its
    commit bar, as a new run does whose NACK was lost: its leader counts
    the run as matched and never resends below it."""
    cb = int(np.asarray(rep.state["commit_bar"])[0, me])
    vbar = int(np.asarray(rep.state["vote_bar"])[0, me])
    assert vbar > cb + 1, (cb, vbar)
    if isinstance(rep.state["vote_from"], torch.Tensor):
        vf = rep.state["vote_from"].clone()
        vf[0, me] = cb + 1
        rep.state["vote_from"] = vf
        rep._np_cache = {}
    else:
        rep.state["vote_from"] = rep.state["vote_from"].at[0, me].set(cb + 1)
    return cb


@pytest.mark.parametrize("proto", ["multipaxos", "rspaxos", "raft"])
def test_renack_hook_only_in_the_multipaxos_family(proto):
    """The kernel's ``renack`` hook on one follower's frames (replica 2,
    group 1 with a vote run above its commit bar, group 0 at it): the
    MultiPaxos family counts the stall and, at ``STALL_RENACK_TICKS``,
    sets ``AR_NACK`` with the commit bar as hint on its accept reply to
    the leader only in group 1, copying the lane it writes; other
    protocols keep the default (no count, no rewrite)."""
    from summerset_tpu_torch.protocols import make_protocol as tmake
    from summerset_tpu_torch.protocols.multipaxos import (
        ACCEPT_REPLY, MultiPaxosKernel,
    )

    ker = tmake(proto, 2, 3, 32, device="cpu")
    me, cbar = 2, np.array([5, 5])
    view = {"leader": np.zeros((2, 3), np.int64),
            "vote_from": np.array([[0, 0, 5], [0, 0, 7]])}.__getitem__
    outbox = np.full((2, 3, 3), ACCEPT_REPLY, np.int64)
    frames = {0: {"flags": outbox[:, me, 0],
                  "ar_hint": np.zeros((2, 3, 3), np.int64)[:, me, 0]},
              1: {"flags": outbox[:, me, 1].copy(),
                  "ar_hint": np.zeros(2, np.int64)}}
    stall, n = ker.renack(frames, view, me, cbar,
                          np.full(2, STALL_RENACK_TICKS - 1, np.int64))
    if not isinstance(ker, MultiPaxosKernel):
        assert n == 0 and (stall == STALL_RENACK_TICKS - 1).all()
        assert (outbox == ACCEPT_REPLY).all()
        return
    assert n == 1 and stall.tolist() == [0, STALL_RENACK_TICKS]
    assert frames[0]["flags"].tolist() == [ACCEPT_REPLY,
                                           ACCEPT_REPLY | AR_NACK]
    assert frames[0]["ar_hint"].tolist() == [0, 5]
    assert frames[1]["flags"].tolist() == [ACCEPT_REPLY, ACCEPT_REPLY]
    assert (outbox == ACCEPT_REPLY).all()   # the outbox view was copied


def test_stalled_follower_repeats_its_lost_nack_lockstep(tmp_path):
    """A MultiPaxos follower (replica 2) whose vote run starts above its
    commit bar with no NACK pending: its commit bar stays frozen in both
    packages, equal tick by tick, for ``STALL_RENACK_TICKS`` ticks.  Then
    the port's follower repeats the NACK on its accept reply (the
    kernel's ``renack`` hook, ``MultiPaxosKernel.renack``), the leader resends from the commit bar, and
    the follower commits again within a few ticks; the JAX follower
    stays frozen to the end (the reference stall, ROADMAP Queue 3)."""
    G, R, W = 1, 3, 16
    at, after = 12, 40
    sides = _lockstep_sides(tmp_path, "MultiPaxos", SIDES, LOCK_CFG,
                            G, R, W)
    frozen = {}
    try:
        for t in range(at + STALL_RENACK_TICKS + after):
            if t == at:
                for name, (reps, *_r) in sides.items():
                    frozen[name] = _stall_row(reps[2], 2)
                assert frozen["jax"] == frozen["torch"]
            seen = lockstep_tick(sides, t)
            # the stall is counted from tick ``at``, whose frames still
            # carry the previous step's replies: the NACK rides tick
            # at + STALL_RENACK_TICKS - 1 onwards
            if t < at + STALL_RENACK_TICKS - 1:
                j, p = seen["jax"], seen["torch"]
                for part in j:
                    assert j[part] == p[part], f"tick {t}: {part} differs"
        cbar = {name: [int(np.asarray(rep.state["commit_bar"])[0, r])
                       for r, rep in enumerate(reps)]
                for name, (reps, *_r) in sides.items()}
        renacks = sides["torch"][0][2].metrics.counter_value("stall_renacks")
    finally:
        shutdown_sides(sides)
    assert cbar["jax"][2] == frozen["jax"], cbar
    assert cbar["jax"][0] > frozen["jax"] + after, cbar
    assert renacks >= 1
    assert cbar["torch"][2] >= cbar["torch"][0] - 2, cbar
