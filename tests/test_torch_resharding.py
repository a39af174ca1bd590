"""Live resharding on the port against the JAX package.

The pure pieces (``RangeChange``, ``RangeTable``, ``RangeHeat``,
``ResharderPolicy``; the cases of ``tests/test_resharding.py``) give equal
results on both packages.  Then three serving replicas per package run in
per-tick lockstep behind one scripted manager each (the seal fan-out,
seal-complete, the adopt grant, the install re-announce and seal-TTL
expiry of ``manager/clusman.py``): a key range splits to another group
with puts in flight at the seal, and merges back.  Replies (sheds
included), WAL records (``rseal`` and the adopt), frames, state digests,
the KV and ``route_group`` are equal on every tick, on MultiPaxos and on
RSPaxos (where the adopt rides the codeword plane), also across a
snapshot and a restart of one replica, and through a seal that expires.
EPaxos and ChainRep refuse a cutover as the JAX server does.
"""

import os
import sys
import types
import zlib

import pytest
import torch

from summerset_tpu.host import resharding as jrs
from summerset_tpu.utils.errors import SummersetError as JErr
from summerset_tpu_torch.host import resharding as trs
from summerset_tpu_torch.utils.errors import SummersetError as TErr

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_cluster import (  # noqa: E402
    build, leaf_digests, lockstep_sides, norm_frame, norm_reply, norm_wal,
    requests, restart_replica, shutdown_sides,
)
from test_torch_server import SIDES, lock_cfg  # noqa: E402

torch.set_num_threads(1)

PKGS = {"jax": (jrs, JErr), "torch": (trs, TErr)}


# ------------------------------------------------------------------ units
def unit_trace(rs, err):
    """The cases of ``tests/test_resharding.py`` as one value."""
    out = []
    for op in ("split", "merge"):
        ch = rs.RangeChange.from_payload(
            {"op": op, "start": "a", "end": "b", "dst_group": 1})
        out.append((ch.op, ch.rc_id, ch.as_dict()))
    for payload in (
        {"op": "rotate", "start": "a", "end": "b", "dst_group": 0},
        {"op": "split", "start": "b", "end": "a", "dst_group": 0},
        {"op": "split", "start": "a", "end": "a", "dst_group": 0},
        {"op": "split", "start": "a", "end": "b", "dst_group": -1},
        {"op": "split", "start": 7, "end": None, "dst_group": 0},
    ):
        try:
            rs.RangeChange.from_payload(payload)
            out.append("accepted")
        except err as e:
            out.append(str(e))
    start, end = rs.single_key_range("wk")
    ch = rs.RangeChange("split", start, end, 1)
    out.append([ch.contains(k) for k in ("wk", "wk0", "wj", "wka")])
    ch = rs.RangeChange.from_payload(
        {"op": "split", "start": "m", "end": None, "dst_group": 1})
    out.append([ch.contains(k) for k in ("zzz", "a")])
    rt = rs.RangeTable()
    e = {"rc_id": 1, "op": "split", "start": "a", "end": "b", "group": 1}
    out += [rt.install(e), rt.install(dict(e)), rt.group_for("a"),
            rt.group_for("b"), rt.has(1), rt.has(2)]
    rt = rs.RangeTable()
    rt.install({"rc_id": 1, "op": "split", "start": "a", "end": "c",
                "group": 1})
    rt.install({"rc_id": 2, "op": "merge", "start": "a", "end": "b",
                "group": 0})
    out += [rt.group_for("a"), rt.group_for("b"), rt.entries(), len(rt),
            rt.lookup("bb")]
    h = rs.RangeHeat()
    for _ in range(5):
        h.note("hot")
    h.note("warm", 2)
    h.note("cold")
    out += [h.top(2), h.total()]
    h = rs.RangeHeat(cap=4)
    for i in range(10):
        h.note(f"k{i}")
    out += [sorted(h._counts.items()), h.total(), h.top(10)]

    def home(k):
        return zlib.crc32(k.encode()) % 2

    pol = rs.ResharderPolicy(2, home, hot_frac=0.25, min_total=10)
    heat = {"hot": 50, "a": 5, "b": 5}
    out += [pol.decide(heat), pol.decide(heat)]
    pol = rs.ResharderPolicy(2, home, hot_frac=0.25, cold_frac=0.05,
                             min_total=10)
    out.append(pol.decide({"hot": 50, "a": 5}))
    cooled = {"hot": 0, **{f"k{i}": 2 for i in range(10)}}
    out += [pol.decide(cooled), dict(pol._moved),
            pol.decide({"hot": 50, "a": 5})]
    out += [rs.ResharderPolicy(2, home, min_total=100).decide({"hot": 50}),
            rs.ResharderPolicy(1, lambda k: 0).decide({"hot": 1000})]
    gate = []
    pol = rs.ResharderPolicy(2, home, min_total=10,
                             budget_gate=lambda g: gate.append(g) or False)
    out += [pol.decide({"hot": 50, "a": 5}), gate]
    return [x.as_dict() if hasattr(x, "as_dict") else x for x in out]


def test_units_equal_jax():
    got = {name: unit_trace(*mods) for name, mods in PKGS.items()}
    assert got["jax"] == got["torch"]


# ---------------------------------------------------------- the manager
class ScriptedManager:
    """The resharding half of ``manager/clusman.py`` for one side of a
    lockstep: seal fan-out, seal-complete once ``acks_needed`` servers
    acked, adopt grants, install re-announces, seal-TTL expiry."""

    def __init__(self, reps, acks_needed=None):
        self.reps = reps
        self.inbox = [[] for _ in reps]
        self.acks_needed = len(reps) if acks_needed is None else acks_needed
        self.seq = 1000
        self.pending, self.installed, self.expired = {}, {}, {}
        self.granted = set()
        self.acks = {}
        self._fan = []
        for r, rep in enumerate(reps):
            self.attach(r, rep)

    def attach(self, r, rep):
        self.reps[r] = rep
        box = self.inbox[r]
        rep.ctrl.try_recv_ctrl = lambda: box.pop(0) if box else None

    def push(self, r, kind, payload):
        self.inbox[r].append(types.SimpleNamespace(kind=kind,
                                                   payload=payload))

    def payload(self):
        return {"seq": self.seq,
                "installed": [self.installed[k] for k in sorted(self.installed)],
                "pending": [dict(self.pending[k]) for k in sorted(self.pending)],
                "expired": sorted(self.expired)}

    def announce(self):
        self.seq += 1
        for r in range(len(self.reps)):
            self.push(r, "install_ranges", self.payload())

    def range_change(self, op, key, dst):
        start, end = trs.single_key_range(key)
        self.seq += 1
        ch = {"rc_id": self.seq, "op": op, "start": start, "end": end,
              "dst_group": dst}
        self.pending[self.seq] = ch
        self.acks[self.seq] = 0
        self._fan.append(self.seq)
        for r in range(len(self.reps)):
            self.push(r, "range_change", {"change": dict(ch)})
        return self.seq

    def drain(self):
        """Deliver queued ctrl messages (each replica runs its handler
        until its inbox is empty, as ``run()`` does between ticks)."""
        for r, rep in enumerate(self.reps):
            while self.inbox[r]:
                rep._handle_ctrl()

    def collect(self):
        """Answer what the replicas sent this tick."""
        for r, rep in enumerate(self.reps):
            for kind, p in rep.ctrl.sent:
                if kind == "range_reply" and self._fan:
                    rc = self._fan[0]
                    self.acks[rc] += 1
                    if self.acks[rc] == len(self.reps):
                        self._fan.pop(0)
                    if self.acks[rc] == self.acks_needed and \
                            rc in self.pending:
                        self.pending[rc]["sealed_ok"] = True
                        self.announce()
                elif kind == "adopt_intent":
                    rc = int(p["rc_id"])
                    ch = self.pending.get(rc)
                    ok = rc not in self.expired and (
                        rc in self.granted
                        or (ch is not None and bool(ch.get("sealed_ok"))))
                    if ok:
                        self.granted.add(rc)
                    self.push(r, "adopt_decision", {"rc_id": rc, "ok": ok})
                elif kind == "range_installed":
                    entry = dict(p["entry"])
                    entry.setdefault("owner", r)
                    rc = int(entry["rc_id"])
                    fresh = rc not in self.installed
                    self.pending.pop(rc, None)
                    self.installed[rc] = entry
                    if fresh:
                        self.announce()
                elif kind == "range_expire":
                    rc = int(p["rc_id"])
                    ch = self.pending.get(rc)
                    if ch is not None and rc not in self.granted:
                        self.pending.pop(rc)
                        self.expired[rc] = ch
                        self.announce()


def norm_rec(entry, norm):
    if isinstance(entry, tuple) and entry and entry[0] == "rseal":
        return ("rseal", dict(entry[1]))
    return norm_wal(entry, norm)


KEYS = [f"k{i}" for i in range(5)] + ["zz"]


def reshard_run(tmp_path, protocol, ticks, plan, cfg=None, acks_needed=None,
                restart=None, G=4, quiet=20):
    """``plan``: {tick: (op, key, dst or None = home)}; ``restart``:
    (tick, replica) snapshot + durable reset.  Returns the per-tick
    timeline of the port side and the sides."""
    cfg = dict(cfg or lock_cfg(protocol))
    R, W = 3, 16
    sides = lockstep_sides(tmp_path, protocol, SIDES, cfg, G, R, W)
    mgrs = {name: ScriptedManager(s[0], acks_needed)
            for name, s in sides.items()}
    timeline = []
    try:
        for t in range(ticks):
            if restart is not None and t == restart[0]:
                r = restart[1]
                for name, (reps, *_x) in sides.items():
                    reps[r]._take_snapshot()
                restart_replica(sides, SIDES, r, tmp_path, protocol, cfg,
                                G, R, W)
                for name, (reps, *_x) in sides.items():
                    mgrs[name].attach(r, reps[r])
            seen = {}
            for name, (reps, net, pkg, wals, norm) in sides.items():
                mgr = mgrs[name]
                if t in plan:
                    op, key, dst = plan[t]
                    home = reps[0].group_of(key)
                    mgr.range_change(op, key,
                                     home if dst is None else dst(home, G))
                mgr.drain()
                for r, rep in enumerate(reps):
                    # the last ``quiet`` ticks quiesce, so followers
                    # apply everything
                    rep.external.batches.append(
                        requests(pkg, t, r) if t < ticks - quiet else [])
                    rep._tick_serial(0.0)
                mgr.collect()
                sent = net.flush()
                seen[name] = {
                    "frames": [(s, d, norm_frame(f, norm, name != "jax"))
                               for s, d, f in sent],
                    "state": [leaf_digests(rep.state) for rep in reps],
                    "wal": [[norm_rec(e, norm) for e in w] for w in wals],
                    "kv": [dict(rep.statemach.snapshot_items())
                           for rep in reps],
                    "replies": [[norm_reply(c, x) for c, x in
                                 rep.external.replies] for rep in reps],
                    "ctrl": [list(rep.ctrl.sent) for rep in reps],
                    "route": [[rep.route_group(k) for k in KEYS]
                              for rep in reps],
                    "ranges": [(rep.rangetab.entries(),
                                sorted(rep._range_sealed),
                                sorted(rep._range_adopted),
                                sorted(rep._range_override))
                               for rep in reps],
                    "counters": [{k: rep.metrics.counter_value(k) for k in
                                  ("reshard_splits", "reshard_merges",
                                   "reshard_seal_expired")}
                                 for rep in reps],
                }
                for rep in reps:
                    rep.external.replies.clear()
                    rep.ctrl.sent.clear()
                for w in wals:
                    w.clear()
            for k in seen["jax"]:
                assert seen["jax"][k] == seen["torch"][k], (t, k)
            timeline.append(seen["torch"])
        return sides, timeline
    except BaseException:
        shutdown_sides(sides)
        raise


def away(home, G):
    return (home + 1) % G


@pytest.mark.parametrize("protocol", ["MultiPaxos", "RSPaxos"])
def test_split_then_merge_lockstep(tmp_path, protocol):
    # a codeword follower rebuilds a value whose shard gossip stalled
    # once the need turns urgent (40 ticks): a longer quiet tail
    quiet = 50 if protocol == "RSPaxos" else 20
    sides, tl = reshard_run(tmp_path, protocol, 52 + quiet,
                            {6: ("split", "k1", away),
                             34: ("merge", "k1", None)}, quiet=quiet)
    try:
        reps = sides["torch"][0]
        home = reps[0].group_of("k1")
        routes = [s["route"][0][1] for s in tl]
        assert away(home, 4) in routes, "the split never installed"
        assert routes[-1] == home, "the merge never installed"
        assert tl[-1]["counters"] == [{"reshard_splits": 1,
                                       "reshard_merges": 1,
                                       "reshard_seal_expired": 0}] * 3
        sheds = sum(1 for s in tl for rr in s["replies"] for x in rr
                    if x[1] == "shed")
        assert sheds > 0, "no op met the seal"
        # every replica holds the same KV, every put acked is in it
        kvs = tl[-1]["kv"]
        assert kvs[0] == kvs[1] == kvs[2]
        adopts = [e for s in tl for w in s["wal"] for e in w
                  if isinstance(e, tuple) and len(e) == 4 and e[3]
                  and e[3][0][3] and e[3][0][3][0] == "adopt"]
        rseals = [e for s in tl for w in s["wal"] for e in w
                  if e[0] == "rseal"]
        assert len(adopts) >= 6 and len(rseals) == 6  # 2 per replica
    finally:
        shutdown_sides(sides)


@pytest.mark.parametrize("protocol", ["MultiPaxos", "RSPaxos"])
def test_split_across_snapshot_restart_lockstep(tmp_path, protocol):
    """The split adopts, replica 2 takes a snapshot and restarts from it
    (``ranges``/``radopted`` restored), then the merge runs; equal on
    every tick, and the restarted replica routes like the others."""
    quiet = 50 if protocol == "RSPaxos" else 20
    sides, tl = reshard_run(tmp_path, protocol, 40 + quiet,
                            {4: ("split", "k3", away),
                             30: ("merge", "k3", None)},
                            restart=(24, 2), quiet=quiet)
    try:
        rep2 = sides["torch"][0][2]
        assert tl[25]["ranges"][2][0], "ranges lost across the restart"
        assert tl[-1]["route"][0] == tl[-1]["route"][2]
        if protocol == "MultiPaxos":
            # an RSPaxos follower restarted under load catches up on the
            # values whose shard gossip stalled only later (both packages
            # alike, tick for tick: the lockstep compares every KV)
            assert tl[-1]["kv"][0] == tl[-1]["kv"][2]
        assert rep2.rangetab.entries()
    finally:
        shutdown_sides(sides)


def test_seal_expires_lockstep(tmp_path):
    """Seal-complete never comes (one server never acks): the source
    asks for expiry after ``seal_ttl_ticks``, the manager expires the
    change, every replica un-seals and serves the key again."""
    cfg = dict(lock_cfg("MultiPaxos"), seal_ttl_ticks=12)
    sides, tl = reshard_run(tmp_path, "MultiPaxos", 40,
                            {5: ("split", "k2", away)}, cfg=cfg,
                            acks_needed=4)
    try:
        assert tl[-1]["counters"][0]["reshard_seal_expired"] == 1
        assert tl[-1]["ranges"][0] == ([], [], [], [])
        late = [x for s in tl[-8:] for rr in s["replies"] for x in rr
                if x[1] == "shed"]
        assert not late, "the key is still shed after the expiry"
    finally:
        shutdown_sides(sides)


@pytest.mark.parametrize("protocol", ["EPaxos", "ChainRep"])
def test_cutover_refused_like_jax(tmp_path, protocol):
    got = {}
    for name, mod, _pkg, _enc, kw in SIDES:
        rep = build(mod, protocol, 0, 3, 2, 16, tmp_path / name,
                    lock_cfg(protocol), **kw)
        try:
            rep._range_begin({"rc_id": 3, "op": "split", "start": "a",
                              "end": "b", "dst_group": 1})
            got[name] = (dict(rep._range_sealed), rep.route_group("a"),
                         rep.flight.dump()["recorded_by_type"])
        finally:
            rep.shutdown()
    assert got["jax"] == got["torch"]
    assert got["torch"][0] == {}
