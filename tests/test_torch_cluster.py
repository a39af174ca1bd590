"""Live port clusters in one process: a real manager + N port
``ServerReplica`` loops over localhost TCP, on ``device="cpu"`` here
(``chip_smoke.py`` runs the same harness on the card).

``Cluster`` (``summerset_tpu_torch/cluster.py``, which the other test
files and ``chip_smoke.py`` import from the package) is the counterpart
of ``tests/test_cluster.py::Cluster``: a manager thread, replica threads
under a crash-restart supervisor and free ports; the tests here pass it
``device="cpu"``.  The lockstep harness below (``FakeNet`` and the other
in-memory stand-ins, ``build``, ``lockstep_sides``, ``lockstep_tick``)
steps replicas built by their own constructors tick by tick with no
sockets.  This module imports nothing of JAX at import time, so
``chip_smoke.py``, ``tests/test_torch_server.py`` and
``tests/test_torch_pipeline.py`` import the harnesses from here.  The JAX
package's own checker is imported inside the one test that uses it.
"""

import contextlib
import hashlib
import os
import pickle
import random
import socket
import threading
import time
import types
from collections import deque

import numpy as np
import pytest
import torch

from summerset_tpu_torch.client.drivers import DriverClosedLoop
from summerset_tpu_torch.cluster import Cluster, free_ports
from summerset_tpu_torch.client.endpoint import GenericEndpoint
from summerset_tpu_torch.host.messages import CtrlRequest
from summerset_tpu_torch.host.server import STAGES, ServerReplica
from summerset_tpu_torch.utils.linearize import record_get, record_put

# the suite runs under xdist: one intra-op thread per worker keeps the
# three replica threads from oversubscribing the cores
torch.set_num_threads(1)


def history_worker(cluster, ci, ops, stop, keys=3, timeout=3.0, seed=100,
                   pin=None, put_share=0.5, n_local=None):
    """One closed-loop client recording a put/get history over ``keys``
    keys until ``stop`` is set (the shape of
    ``tests/test_cluster.py:257-344``), putting with probability
    ``put_share``.  With ``pin`` it works against that server and returns
    to it after a redirect or failover; ``n_local[0]`` counts the gets
    answered as leased local reads."""
    rng = random.Random(seed + ci)
    if pin is None:
        ep = cluster.endpoint()
    else:
        ep = GenericEndpoint(cluster.manager_addr, server_id=pin)
        ep.connect()
    drv = DriverClosedLoop(ep, timeout=timeout)
    seq = 0
    while not stop.is_set():
        if pin is not None and ep.current != pin:
            try:
                ep.reconnect(pin)
            except Exception:
                pass
        key = f"lin{seq % keys}"
        t0 = time.monotonic()
        if rng.random() < put_share:
            val = f"c{ci}-{seq}"
            rep = drv.put(key, val)
            t1 = time.monotonic()
            if rep.kind == "success":
                ops.append(record_put(ci, key, val, t0, t1, True))
            elif rep.kind in ("timeout", "failure", "disconnect"):
                # may or may not have executed
                ops.append(record_put(ci, key, val, t0, None, False))
                drv._failover(rep)
        else:
            rep = drv.get(key)
            t1 = time.monotonic()
            if rep.kind == "success":
                val = rep.result.value if rep.result else None
                ops.append(record_get(ci, key, val, t0, t1))
                if n_local is not None:
                    n_local[0] += rep.local
            elif rep.kind in ("timeout", "failure", "disconnect"):
                drv._failover(rep)
        seq += 1
    try:
        ep.leave()
    except Exception:
        pass


def kv_agreement(cluster):
    """Every replica's applied floors and KV map, after quiescing; the
    caller asserts they are all equal."""
    return {
        me: (list(rep.applied), dict(rep.statemach.snapshot_items()))
        for me, rep in sorted(cluster.replicas.items())
    }


def norm_batch(batch):
    """A ReqBatch as plain tuples (either package's message classes)."""
    if batch is None:
        return None
    return [
        (c, r.kind, r.req_id, None if r.cmd is None else
         (r.cmd.kind, r.cmd.key, r.cmd.value, r.cmd.end, r.cmd.limit))
        for c, r in batch
    ]


def norm_shards(dlen, shards):
    """Shard rows as plain values: ``(data_len, {sid: row bytes})``."""
    return (int(dlen),
            {int(sid): np.asarray(r).tobytes() for sid, r in shards.items()})


def norm_wal(entry, shard_norm=None):
    """A WAL record with its batches as plain tuples; a vote record's
    ``cw`` shard rows through ``shard_norm(g, vid, dlen, shards)``
    (default: ``norm_shards``); EPaxos ``eapply`` records and the
    ``snap_floor`` marker as plain tuples."""
    if isinstance(entry, tuple) and entry and entry[0] == "snap_floor":
        return ("snap_floor", [int(x) for x in entry[1]])
    if isinstance(entry, tuple) and entry and entry[0] == "eapply":
        _, g, row, col, vid, batch = entry
        return ("eapply", g, row, col, vid, norm_batch(batch))
    if isinstance(entry, tuple) and entry and entry[0] == "vote":
        _, g, rec = entry
        rec = dict(rec)
        rec["pp"] = {vid: norm_batch(b) for vid, b in rec["pp"].items()}
        if "cw" in rec:
            rec["cw"] = {
                vid: (shard_norm(g, vid, dlen, sh) if shard_norm
                      else norm_shards(dlen, sh))
                for vid, (dlen, sh) in rec["cw"].items()
            }
        return ("vote", g, rec)
    g, slot, vid, batch = entry
    return (g, slot, vid, norm_batch(batch))


def read_wal(path, hub_cls=None, action_cls=None):
    """Every record of a WAL file, normalized (the port's StorageHub
    unless another package's hub and action classes are given)."""
    from summerset_tpu_torch.host.storage import LogAction, StorageHub

    hub = (hub_cls or StorageHub)(path)
    action_cls = action_cls or LogAction
    out, off = [], 0
    try:
        while True:
            res = hub.do_sync_action(action_cls("read", offset=off))
            if not res.offset_ok or res.entry is None:
                break
            out.append(norm_wal(res.entry))
            off = res.end_offset
    finally:
        hub.stop()
    return out


def durable_digest(kernel, leaf) -> str:
    """sha256 over the kernel's durable leaves (``leaf(name)`` -> numpy)."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tuple(kernel.DURABLE_SCALARS)
                    + tuple(kernel.DURABLE_WINDOWS)):
        h.update(k.encode())
        h.update(leaf(k).tobytes())
    return h.hexdigest()


def sequential_puts(tmpdir, device, pipeline, n=24, groups=2, window=32):
    """``n`` strictly sequential puts on a 1-replica MultiPaxos port
    cluster: on one replica the durable state after a sequential history
    is a pure function of the op stream, so runs on the card and on the
    CPU, in either loop mode, must agree exactly.  Returns the durable
    digest, KV, applied floors and every WAL record."""
    c = Cluster("MultiPaxos", 1, str(tmpdir), config={"pipeline": pipeline},
                tick=0.004, num_groups=groups, window=window, device=device,
                settle=0.5)
    ep = None
    try:
        ep = c.endpoint()
        drv = DriverClosedLoop(ep, timeout=20.0)
        rep = c.replicas[0]
        t0, tick0 = time.monotonic(), rep.tick
        for i in range(n):
            drv.checked_put(f"k{i % 7}", f"v{i}")
        secs, ticks = time.monotonic() - t0, rep.tick - tick0
    finally:
        if ep is not None:
            ep.leave()
        c.stop()
    assert not c.faults(), f"replica faults: {c.faults()}"
    # stopped: the in-flight step was retired and the state is final
    return {
        "digest": durable_digest(
            rep.kernel, lambda k: rep.state[k].cpu().numpy()),
        "kv": dict(rep.statemach._kv),
        "applied": list(rep.applied),
        "wal": read_wal(os.path.join(str(tmpdir), "r0.wal")),
        "ticks_per_s": ticks / secs,
        "stage_mean_us": {
            st: h.mean() for st in STAGES
            for h in [rep.metrics.hist("loop_stage_us", stage=st)] if h
        },
    }


# ------------------------------------------------------ lockstep harness
class FakeNet:
    """In-memory tick mesh: frames sent in round t are delivered at the
    start of round t + 1; ``mute`` withholds one replica's frames.  Each
    frame is pickled and unpickled on send, as the TCP mesh does: a card
    replica's frames are views of pinned host buffers that its later
    prefetches overwrite.
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
            f = pickle.loads(pickle.dumps(f, pickle.HIGHEST_PROTOCOL))
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
        return [p for p in range(self.net.R) if p != self.me]

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


ADDR = ("127.0.0.1", 1)


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


def norm_reply(client, rep):
    res = rep.result
    notes = rep.notes
    if isinstance(notes, list):
        notes = [tuple(n) for n in notes]
    return (client, rep.kind, rep.req_id, rep.success, rep.redirect,
            rep.local, rep.rq_retry, rep.seq, notes,
            None if res is None else (res.kind, res.value, res.old_value,
                                      res.items))


def leaf_digests(state):
    out = {}
    for k, v in state.items():
        a = (v.cpu().numpy() if isinstance(v, torch.Tensor)
             else np.asarray(v))
        out[k] = (a.shape, hashlib.sha256(a.tobytes()).hexdigest())
    return out


def requests(pkg, t, r):
    """Replica ``r``'s intake batch at tick ``t`` (``pkg`` names the
    package's ``msg`` and ``sm`` modules): a put, a get and, every fifth
    tick, a request with no command (answered error)."""
    base = 1000 * t + 10 * r
    out = [
        (100 + r, pkg.msg.ApiRequest("req", req_id=base, cmd=pkg.sm.Command(
            "put", f"k{(3 * t + r) % 5}", f"v{t}.{r}"))),
        (200 + r, pkg.msg.ApiRequest("req", req_id=base + 1,
                                     cmd=pkg.sm.Command(
                                         "get", f"k{(t + 2 * r) % 5}"))),
    ]
    if t % 5 == 0:
        out.append((300 + r, pkg.msg.ApiRequest("req", req_id=base + 2)))
    return out


def ep_requests(G, K=8):
    """EPaxos intake over ``G`` groups and ``K`` key buckets: the
    ``requests`` schedule in two ticks of every six, and in the first of
    them two more puts at every replica to two keys of group 0 in
    distinct buckets (so one replica proposes two vids in one group in
    one tick at any ``G``).  Under conflicting puts at every replica in
    every tick the dependency chains never close and the Tarjan
    executors apply nothing (in both packages alike); the quiet ticks
    let them close."""
    import zlib

    burst, buckets = [], set()
    for i in range(4096):
        k = f"b{i}"
        b = zlib.crc32(k.encode() + b"#b") % K
        if zlib.crc32(k.encode()) % G == 0 and b not in buckets:
            burst.append(k)
            buckets.add(b)
            if len(burst) == 2:
                break

    def reqs(pkg, t, r):
        if t % 6 >= 2:
            return []
        out = requests(pkg, t, r)
        if t % 6 == 0:
            base = 1000 * t + 10 * r
            out += [(500 + r, pkg.msg.ApiRequest(
                "req", req_id=base + 3 + i,
                cmd=pkg.sm.Command("put", k, f"b{t}.{r}")))
                for i, k in enumerate(burst)]
        return out

    return reqs


def serving_requests(protocol, G):
    """The lockstep intake schedule of ``protocol`` at ``G`` groups."""
    return ep_requests(G) if protocol == "EPaxos" else requests


class ShardNorm:
    """Normalizes one side's shard records (``ps``/``cw`` frame parts,
    ``cw`` WAL records) to ``(shard ids, the batch they encode)``.

    Shard bytes differ between packages (the pickled class paths differ).
    So each record is first checked exact against its own side: the
    value's batch is taken from a replica's payload store (the proposer's
    holds it), pickled as the proposer pickled it and encoded by the
    side's own ``encode(buf) -> (data_len, rows)``; the record's
    ``data_len`` and every row must equal that encoding.  Two sides of one
    package (the card and the CPU share one lane geometry) also compare
    the rows' bytes: ``exact=True`` adds them to the normalized record."""

    def __init__(self, reps, encode, exact=False):
        self.reps = reps
        self.encode = encode
        self.exact = exact
        self._rows = {}
        self._batches = {}

    def batch(self, g, vid):
        """The value's batch, remembered once seen: a replica restarted
        by a durable reset holds only its logged shard rows."""
        b = self._batches.get((g, vid))
        if b is not None:
            return b
        for rep in self.reps:
            b = rep.payloads.get(g, vid)
            if b is not None:
                self._batches[(g, vid)] = b
                return b
        raise AssertionError(f"no replica holds the batch of ({g}, {vid})")

    def __call__(self, g, vid, dlen, shards):
        b = self.batch(g, vid)
        if (g, vid) not in self._rows:
            self._rows[(g, vid)] = self.encode(pickle.dumps(b))
        want_len, rows = self._rows[(g, vid)]
        assert int(dlen) == want_len, (g, vid, dlen, want_len)
        for sid, row in shards.items():
            assert np.array_equal(np.asarray(row), rows[sid]), (g, vid, sid)
        out = (tuple(sorted(int(s) for s in shards)), norm_batch(b))
        if self.exact:
            out += (tuple(np.asarray(shards[s]).tobytes()
                          for s in sorted(shards)),)
        return out


def norm_frame(f, shard_norm, port=True):
    """A tick frame as plain values: kernel lanes as (dtype, shape,
    bytes) (the port's int32 ``flags`` viewed as the JAX uint32), the
    payload parts, the codeword parts through ``shard_norm``; not the
    ``ts`` stamp."""
    msg = {}
    for k, v in f["msg"].items():
        a = np.asarray(v)
        if port and k == "flags":
            a = a.view(np.uint32)
        msg[k] = (a.dtype.str, a.shape, a.tobytes())
    out = {
        "msg": msg,
        "pp": {k: norm_batch(b) for k, b in f["pp"].items()},
        "need": [tuple(x) for x in f["need"]],
        "kv_need": f["kv_need"],
        "kv": f.get("kv"),
        "cw_need": [tuple(x) for x in f.get("cw_need", ())],
        "rq": [tuple(x) for x in f.get("rq", ())],
        "rqr": [tuple(x) for x in f.get("rqr", ())],
    }
    for key in ("ps", "cw"):
        out[key] = {(g, vid): shard_norm(g, vid, sp.data_len, sp.shards)
                    for (g, vid), sp in (f.get(key) or {}).items()}
    return out


def record_wal(rep):
    """Capture every WAL record the replica appends (raw)."""
    log = []
    orig = rep._wal_append

    def wrapped(entry):
        log.append(entry)
        orig(entry)

    rep._wal_append = wrapped
    return log


def lockstep_sides(base, protocol, sides, cfg, G, R, W, exact_rows=False,
                   **net_kw):
    """Three replicas per side on their own in-memory mesh: ``sides``
    holds ``(name, server module, pkg, encode, ServerReplica keywords)``,
    ``encode(code, buf)`` the side's codec entry (``encode_payload``);
    ``exact_rows`` compares shard rows byte for byte (one package)."""
    out = {}
    for name, mod, pkg, encode, kw in sides:
        net = FakeNet(R, **net_kw)
        reps = [build(mod, protocol, r, R, G, W,
                      os.path.join(str(base), name, str(r)), cfg, net=net,
                      **kw) for r in range(R)]
        code = reps[0].codewords.code if reps[0].codewords else None
        norm = ShardNorm(reps, lambda buf, c=code, e=encode: e(c, buf),
                         exact=exact_rows)
        out[name] = (reps, net, pkg, [record_wal(rep) for rep in reps],
                     norm)
    return out


@contextlib.contextmanager
def port_restore_rule(mod):
    """While a JAX replica (``mod`` the JAX server module) is built and
    recovers, its ``restore_durable`` follows the port's rules (ROADMAP
    Queue 3): in the MultiPaxos family a vote run starting above the
    restored floor comes back empty at the floor
    (``summerset_tpu_torch/protocols/multipaxos.py``); in the Raft family
    a row recovered into a term above the warm-start term comes back a
    follower with no known leader (``summerset_tpu_torch/protocols/
    raft.py``).  Everything else of the reference is unchanged, so the
    lockstep gates still compare the rest of a restart tick by tick.  A
    no-op for any other module."""
    if not mod.__name__.startswith("summerset_tpu."):
        yield
        return
    from summerset_tpu.protocols.multipaxos import MultiPaxosKernel
    from summerset_tpu.protocols.raft import RaftKernel

    orig_mp = MultiPaxosKernel.restore_durable
    orig_raft = RaftKernel.restore_durable

    def restore_mp(self, st, g, me, rec, floor):
        orig_mp(self, st, g, me, rec, floor)
        if int(rec["vote_from"]) > int(floor):
            for k in ("vote_from", "vote_bar", "dur_bar"):
                st[k] = st[k].at[g, me].set(int(floor))

    def restore_raft(self, st, g, me, rec, floor):
        orig_raft(self, st, g, me, rec, floor)
        warm_term = 1 if self.config.init_leader >= 0 else 0
        if int(st["term"][g, me]) > warm_term:
            st["is_leader"] = st["is_leader"].at[g, me].set(False)
            st["leader"] = st["leader"].at[g, me].set(-1)

    MultiPaxosKernel.restore_durable = restore_mp
    RaftKernel.restore_durable = restore_raft
    try:
        yield
    finally:
        MultiPaxosKernel.restore_durable = orig_mp
        RaftKernel.restore_durable = orig_raft


def restart_replica(sides, specs, r, base, protocol, cfg, G, R, W):
    """A durable reset of replica ``r`` on every side of ``specs`` (the
    ``sides`` argument of ``lockstep_sides``): the replica shuts down and
    a new one recovers from its WAL, on the same in-memory mesh.  The JAX
    side recovers under ``port_restore_rule``."""
    for name, mod, _pkg, _encode, kw in specs:
        reps, net, _p, wals, _norm = sides[name]
        reps[r].shutdown()
        with port_restore_rule(mod):
            reps[r] = build(mod, protocol, r, R, G, W,
                            os.path.join(str(base), name, str(r)), cfg,
                            net=net, **kw)
        wals[r] = record_wal(reps[r])


def lockstep_tick(sides, t, mute=None, port_sides=None, reqs=requests,
                  pipelined=False):
    """One scripted tick on every side, serial unless ``pipelined``;
    returns per side what the gates compare (``port_sides`` names the
    sides whose ``flags`` lane is the port's int32; default every side
    but ``"jax"``; ``reqs(pkg, t, r)`` gives replica ``r``'s intake
    batch, ``requests`` by default).  A pipelined tick releases a reply
    when its background fsync has settled, this tick or the next, so
    pipelined gates compare the replies summed over the run."""
    seen = {}
    for name, (reps, net, pkg, wals, norm) in sides.items():
        net.mute = mute
        for r, rep in enumerate(reps):
            rep.external.batches.append(reqs(pkg, t, r))
            if pipelined:
                rep._tick_pipelined(time.monotonic())
            else:
                rep._tick_serial(time.monotonic())
        sent = net.flush()
        port = (name != "jax") if port_sides is None else name in port_sides
        seen[name] = {
            "frames": [(s, d, norm_frame(f, norm, port)) for s, d, f in sent],
            "state": [leaf_digests(rep.state) for rep in reps],
            "wal": [[norm_wal(e, norm) for e in w] for w in wals],
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


#: one case per lease plane: the conf change (QuorumLeases at the leader,
#: Bodega announced at replica 1, a follower) at ``conf_tick``, puts at
#: the leader in the first ticks and every ninth, gets at every replica
#: (Bodega: not at the leader after the conf, so its key buckets go
#: quiet); MultiPaxos with leader leases gets the key it just put one
#: tick later, while the put is still in the voted tail
LEASE_CASES = {
    "QuorumLeases": dict(cfg={}, conf=(6, 0), ticks=40),
    "Bodega": dict(cfg={"lease_len": 40, "lease_margin": 8,
                        "grant_interval": 4, "conf_timeout": 80},
                   conf=(6, 1), ticks=48),
    "MultiPaxos": dict(cfg={"leader_leases": True}, conf=None, ticks=30),
}


def lease_requests(protocol, conf):
    """The lease schedule's intake: ``reqs(pkg, t, r)`` is replica
    ``r``'s batch at tick ``t`` (``conf``: the (tick, replica) of the
    conf change, or None)."""

    def reqs(pkg, t, r):
        base = 1000 * t + 10 * r
        Req, Cmd = pkg.msg.ApiRequest, pkg.sm.Command
        out = []
        if conf is not None and (t, r) == conf:
            out.append((400 + r, Req("conf", req_id=base + 5,
                                     conf_delta={"responders": [0, 1, 2]})))
        if r == 0 and (t < 4 or t % 9 == 0):
            out.append((100, Req("req", req_id=base, cmd=Cmd(
                "put", f"k{t % 5}", f"v{t}"))))
        if protocol == "Bodega" and r == 0 and t >= conf[0]:
            return out
        key = (f"k{(t - 1) % 5}" if protocol == "MultiPaxos" and t % 9 == 1
               else f"k{(t + r) % 5}")
        out.append((200 + r, Req("req", req_id=base + 1,
                                 cmd=Cmd("get", key))))
        return out

    return reqs



def shutdown_sides(sides):
    for reps, *_ in sides.values():
        for rep in reps:
            rep.shutdown()


#: the card-against-CPU codeword lockstep: replica 0 leads, then is muted
#: for ticks 8..29, so a new leader adopts values it holds as shards
CARD_CPU_LOCK = dict(G=16, R=3, W=32, ticks=40, mute=(8, 30))
CARD_CPU_CFG = {"pipeline": False, "hear_timeout_lo": 8,
                "hear_timeout_hi": 16, "fault_tolerance": 0}


def card_cpu_lockstep(base, device, protocol="RSPaxos", **shape):
    """Three port replicas on ``device`` and three on the CPU, each trio
    on its own in-memory mesh, step the same scripted serial ticks; per
    tick the state digests, frames (lanes, payload parts, shard records
    by the batch they encode and byte for byte), WAL records,
    ``applied``, KV, replies and manager notices must be equal.  Returns what the run did: the
    device side's rebuilds from shards, shard sends, leaders seen, its
    ``bitslice_gf256`` launches and the ticks run.  Raises
    AssertionError at the first difference."""
    import summerset_tpu_torch.host.server as srv
    from summerset_tpu_torch.host import messages, statemach
    from summerset_tpu_torch.ops import rscoding

    sh = dict(CARD_CPU_LOCK, **shape)
    pkg = types.SimpleNamespace(msg=messages, sm=statemach)
    sides = lockstep_sides(base, protocol, (
        ("card", srv, pkg, rscoding.encode_payload, {"device": device}),
        ("cpu", srv, pkg, rscoding.encode_payload, {"device": "cpu"}),
    ), CARD_CPU_CFG, sh["G"], sh["R"], sh["W"], exact_rows=True)
    reps = sides["card"][0]
    rebuilt, launches = [0], [0]
    for rep in reps:
        orig = rep.codewords.reconstruct_batch

        def counted(g, vid, orig=orig):
            out = orig(g, vid)
            rebuilt[0] += out is not None
            return out

        rep.codewords.reconstruct_batch = counted
        tick = rep._tick_serial

        def stepped(t0, tick=tick):
            # the replicas' own launches (not the checks' re-encodings)
            n0 = rscoding.bitslice_gf256.launches
            tick(t0)
            launches[0] += rscoding.bitslice_gf256.launches - n0

        rep._tick_serial = stepped
    leaders, shard_frames = set(), 0
    try:
        lo, hi = sh["mute"]
        for t in range(sh["ticks"]):
            seen = lockstep_tick(sides, t, mute=0 if lo <= t < hi else None,
                                 port_sides=("card", "cpu"))
            a, b = seen["card"], seen["cpu"]
            for part in a:
                if a[part] != b[part]:
                    where = ""
                    if part == "state":
                        where = ": " + ", ".join(
                            f"replica {r} leaf {k}"
                            for r, (x, y) in enumerate(zip(a[part], b[part]))
                            for k in x if x[k] != y.get(k))
                    raise AssertionError(f"{protocol} tick {t}: {part} "
                                         f"differs between {device} and "
                                         f"cpu{where}")
            shard_frames += sum(1 for _s, _d, f in a["frames"] if f["ps"])
            for rep in reps:
                leaders.update((g, rep.me) for g in
                               np.nonzero(rep._is_leader)[0].tolist())
    finally:
        shutdown_sides(sides)
    return {"ticks": sh["ticks"], "rebuilt": rebuilt[0],
            "shard_frames": shard_frames,
            "leaders": sorted({me for _g, me in leaders}),
            "launches": launches[0]}


#: the card-against-CPU lockstep of the leaderless and basic kernels
CARD_CPU_SERVE = dict(G=16, R=3, W=32, ticks=36, reset=(20, 1))


def card_cpu_serving_lockstep(base, device, protocol="EPaxos",
                              pipelined=False, **shape):
    """Three port replicas of ``protocol`` on ``device`` and three on the
    CPU step the schedule of ``serving_requests(protocol, G)`` in per-tick
    lockstep, through a durable reset of one replica on both trios; per
    tick the state digests, frames, WAL records (``eapply`` included),
    ``applied``, KV and manager notices must be equal, and the replies
    too (summed over the run in the pipelined loop, which releases a
    reply when its fsync settles).  Returns the ticks run, the replies
    acknowledged, the largest number of vids one replica proposed in one
    group in one tick and the mean ``ep_exec`` microseconds of the card
    side; raises AssertionError at the first difference."""
    import summerset_tpu_torch.host.server as srv
    from summerset_tpu_torch.host import messages, statemach
    from summerset_tpu_torch.ops import rscoding

    sh = dict(CARD_CPU_SERVE, **shape)
    cfg = dict(pipeline=pipelined, hear_timeout_lo=8, hear_timeout_hi=16)
    pkg = types.SimpleNamespace(msg=messages, sm=statemach)
    specs = (
        ("card", srv, pkg, rscoding.encode_payload, {"device": device}),
        ("cpu", srv, pkg, rscoding.encode_payload, {"device": "cpu"}),
    )
    sides = lockstep_sides(base, protocol, specs, cfg, sh["G"], sh["R"],
                           sh["W"], exact_rows=True)
    reqs = serving_requests(protocol, sh["G"])
    replies = {name: [[] for _ in range(sh["R"])] for name in sides}
    multi = 0
    try:
        for t in range(sh["ticks"]):
            if sh["reset"] is not None and t == sh["reset"][0]:
                r = sh["reset"][1]
                for reps, *_rest in sides.values():
                    reps[r]._pipeline_flush()
                restart_replica(sides, specs, r, base, protocol, cfg,
                                sh["G"], sh["R"], sh["W"])
            seen = lockstep_tick(sides, t, port_sides=("card", "cpu"),
                                 reqs=reqs, pipelined=pipelined)
            a, b = seen["card"], seen["cpu"]
            for part in a:
                if part == "replies" and pipelined:
                    continue
                if a[part] != b[part]:
                    raise AssertionError(f"{protocol} tick {t}: {part} "
                                         f"differs between {device} and "
                                         "cpu")
            for name in sides:
                for r, rr in enumerate(seen[name]["replies"]):
                    replies[name][r].extend(rr)
            for rep in sides["card"][0]:
                if rep._ep_prop_vids is not None:
                    multi = max(multi, int(
                        (rep._ep_prop_vids != 0).sum(axis=1).max()))
        for name, (reps, *_rest) in sides.items():
            for r, rep in enumerate(reps):
                rep._pipeline_flush()
                replies[name][r].extend(
                    norm_reply(c, x) for c, x in rep.external.replies)
        if replies["card"] != replies["cpu"]:
            raise AssertionError(f"{protocol}: replies differ between "
                                 f"{device} and cpu")
        hists = [rep.metrics.hist("loop_stage_us", stage="ep_exec")
                 for rep in sides["card"][0]]
    finally:
        shutdown_sides(sides)
    hists = [h for h in hists if h is not None]
    return {"ticks": sh["ticks"],
            "acked": sum(x[1] == "reply" for rr in replies["card"]
                         for x in rr),
            "multi": multi,
            "ep_exec_us": (sum(h.mean() for h in hists) / len(hists)
                           if hists else None)}


#: the card-against-CPU lease lockstep: the schedule of ``LEASE_CASES``
#: at 16 groups, through the conf change and the first local gets
CARD_CPU_LEASE = dict(G=16, R=3, W=32)


def card_cpu_lease_lockstep(base, device, protocol="QuorumLeases",
                            **shape):
    """Three port replicas on ``device`` and three on the CPU step the
    lease schedule of ``protocol`` (``lease_requests``) in per-tick
    lockstep; per tick the state digests, frames, WAL records,
    ``applied``, KV, replies (with their ``local`` flags) and manager
    notices must be equal.  Returns the ticks run, the local replies per
    replica and the successful conf replies; raises AssertionError at
    the first difference."""
    import summerset_tpu_torch.host.server as srv
    from summerset_tpu_torch.host import messages, statemach
    from summerset_tpu_torch.ops import rscoding

    case = LEASE_CASES[protocol]
    sh = dict(CARD_CPU_LEASE, ticks=case["ticks"], **shape)
    cfg = dict(pipeline=False, hear_timeout_lo=16, hear_timeout_hi=32,
               **case["cfg"])
    pkg = types.SimpleNamespace(msg=messages, sm=statemach)
    sides = lockstep_sides(base, protocol, (
        ("card", srv, pkg, rscoding.encode_payload, {"device": device}),
        ("cpu", srv, pkg, rscoding.encode_payload, {"device": "cpu"}),
    ), cfg, sh["G"], sh["R"], sh["W"], exact_rows=True)
    reqs = lease_requests(protocol, case["conf"])
    local = [0] * sh["R"]
    conf_ok = 0
    try:
        for t in range(sh["ticks"]):
            seen = lockstep_tick(sides, t, port_sides=("card", "cpu"),
                                 reqs=reqs)
            a, b = seen["card"], seen["cpu"]
            for part in a:
                if a[part] != b[part]:
                    raise AssertionError(f"{protocol} tick {t}: {part} "
                                         f"differs between {device} and "
                                         "cpu")
            for r, rr in enumerate(a["replies"]):
                local[r] += sum(x[5] for x in rr)
                conf_ok += sum(x[1] == "conf" and x[3] for x in rr)
    finally:
        shutdown_sides(sides)
    return {"ticks": sh["ticks"], "local": local, "conf_ok": conf_ok}


# ------------------------------------------------------------------ tests
@pytest.fixture(scope="module", params=["MultiPaxos", "Raft"])
def cluster(request, tmp_path_factory):
    """One live 3-replica port cluster per protocol, G=4, W=32."""
    # shorter election timers than the 30-60 tick defaults: three
    # replica threads share one interpreter here, so a CPU tick is slow
    c = Cluster(
        request.param, 3,
        tmp_path_factory.mktemp(f"torch_{request.param.lower()}"),
        num_groups=4, window=32,
        config={"hear_timeout_lo": 10, "hear_timeout_hi": 20},
        device="cpu",
    )
    c.manager.settle_delay = 0.2
    yield c
    c.stop()
    assert not c.faults(), f"replica faults: {c.faults()}"


def _driver(cluster, timeout=3.0):
    ep = cluster.endpoint()
    return ep, DriverClosedLoop(ep, timeout=timeout)


def _dumps(cluster):
    return {me: rep.debug_state()
            for me, rep in sorted(cluster.replicas.items())}


def _health_dumps(cluster):
    """``_dumps`` with each replica's health-plane view: its
    ``leader_demotions`` count and ``health_score`` gauge."""
    return {me: dict(rep.debug_state(),
                     leader_demotions=rep.metrics.counter_value(
                         "leader_demotions"),
                     health_score=rep.metrics.gauge_value(
                         "health_score", 1.0))
            for me, rep in sorted(cluster.replicas.items())}


def _await_leader(cluster, g, avoid=None, timeout=30.0):
    """The unpaused leader of group ``g`` other than ``avoid``, waited
    for up to ``timeout`` seconds (None if none appears)."""
    deadline = time.monotonic() + timeout
    while True:
        got = cluster.leader_of(g)
        if (got is not None and got != avoid) \
                or time.monotonic() >= deadline:
            return got
        time.sleep(0.1)


class TestTorchCluster:
    def test_primitive_put_get(self, cluster):
        ep, drv = _driver(cluster)
        try:
            for i in range(5):
                drv.checked_put(f"p{i}", f"v{i}", retries=40)
            for i in range(5):
                drv.checked_get(f"p{i}", f"v{i}", retries=40)
            drv.checked_get("never-written", None, retries=40)
        finally:
            ep.leave()

    def test_follower_redirects_to_leader(self, cluster):
        leader = None
        deadline = time.monotonic() + 30
        while leader is None and time.monotonic() < deadline:
            leader = cluster.leader_of(0)
            time.sleep(0.1)
        assert leader is not None, _dumps(cluster)
        follower = next(me for me in sorted(cluster.replicas)
                        if me != leader)
        ep = GenericEndpoint(cluster.manager_addr, server_id=follower)
        ep.connect()
        try:
            assert ep.current == follower
            drv = DriverClosedLoop(ep, timeout=3.0)
            # a key routed to group 0, which the follower does not lead
            key = next(f"r{i}" for i in range(1000)
                       if cluster.replicas[follower].group_of(f"r{i}") == 0)
            rep = drv.put(key, "x")
            assert rep.kind == "redirect", rep
            assert rep.redirect == leader
            # the endpoint followed the hint: the retry lands at the leader
            assert ep.current == leader
            drv.checked_put(key, "x", retries=40)
            drv.checked_get(key, "x", retries=40)
        finally:
            ep.leave()

    def test_leader_pause_failover(self, cluster):
        ep, drv = _driver(cluster)
        try:
            drv.checked_put("fo", "before", retries=40)
            leader = cluster.leader_of(0)
            assert leader is not None, _health_dumps(cluster)
            cluster.ctrl("pause_servers", servers=[leader], timeout=30)
            try:
                # the survivors elect a new leader of every group and
                # serve the key again
                drv.checked_get("fo", "before", retries=60)
                drv.checked_put("fo", "during", retries=60)
                # "fo" lives in group 3: group 0 elects on its own
                # timers, later than group 3 under a loaded CPU
                new = _await_leader(cluster, 0, avoid=leader)
                assert new is not None and new != leader, (
                    new, leader, _health_dumps(cluster))
            except AssertionError as e:
                raise AssertionError(
                    f"{e}\n{_health_dumps(cluster)}") from e
            finally:
                cluster.ctrl("resume_servers", servers=[leader], timeout=30)
            drv.checked_get("fo", "during", retries=60)
        finally:
            ep.leave()

    @pytest.mark.parametrize("which", ["leader", "all"])
    def test_durable_reset_recovers_acked_keys(self, cluster, which):
        ep, drv = _driver(cluster)
        want = {}
        try:
            for i in range(4):
                k, v = f"d{which}{i}", f"v{i}"
                drv.checked_put(k, v, retries=40)
                want[k] = v
        finally:
            ep.leave()
        servers = None
        if which == "leader":
            leader = cluster.leader_of(0)
            assert leader is not None, _dumps(cluster)
            servers = [leader]
        rep = cluster.ctrl("reset_servers", servers=servers, durable=True)
        assert sorted(rep.done) == sorted(servers or range(cluster.n))
        time.sleep(1.0)
        ep, drv = _driver(cluster)
        try:
            for k, v in want.items():
                drv.checked_get(k, v, retries=60)
        except AssertionError as e:
            raise AssertionError(f"{e}\n{_dumps(cluster)}") from e
        finally:
            ep.leave()

    def test_conf_rejected_without_conf_plane(self, cluster):
        """A conf request to a protocol with no conf plane gets an
        explicit failed ``conf`` reply, never silence."""
        ep = cluster.endpoint()
        try:
            ep.send_conf(0, {"responders": [0]})
            rep = ep.recv_reply(timeout=10)
            while rep.req_id != 0 or rep.kind == "redirect":
                rep = ep.recv_reply(timeout=10)
            assert rep.kind == "conf" and not rep.success
        finally:
            ep.leave()

    def test_linearizable_history_under_faults(self, cluster):
        """A 3-client, 3-key history under a pause/resume schedule,
        checked by the port's checker and by the JAX package's."""
        from summerset_tpu.utils import linearize as jlin
        from summerset_tpu_torch.utils.linearize import check_history

        ops = []
        stop = threading.Event()
        threads = [
            threading.Thread(target=history_worker,
                             args=(cluster, ci, ops, stop), daemon=True)
            for ci in range(3)
        ]
        for t in threads:
            t.start()
        rng = random.Random(7)
        try:
            for _ in range(2):
                time.sleep(1.5)
                victim = rng.choice(sorted(cluster.replicas))
                cluster.ctrl("pause_servers", servers=[victim], timeout=30)
                time.sleep(1.5)
                cluster.ctrl("resume_servers", servers=[victim], timeout=30)
            deadline = time.monotonic() + 30
            while len(ops) <= 20 and time.monotonic() < deadline:
                time.sleep(0.5)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=30)
        assert len(ops) > 20, f"history too small: {len(ops)}"
        ok, diag = check_history(ops)
        assert ok, diag
        jops = [jlin.Op(o.client, o.kind, o.key, o.value, o.t_inv,
                        o.t_resp, o.acked, o.shed) for o in ops]
        ok, diag = jlin.check_history(jops)
        assert ok, diag



def test_unserved_protocol_is_refused(tmp_path):
    """Every protocol of the package is served; a name that is none of
    them is refused before any resource is taken, naming the served
    ones."""
    from summerset_tpu_torch.host.server import SERVED
    from summerset_tpu_torch.utils.errors import SummersetError

    assert len(SERVED) == 11 and "epaxos" in SERVED
    with pytest.raises(SummersetError, match="served: multipaxos"):
        ServerReplica("NoSuchPaxos", ADDR, ADDR, ADDR,
                      backer_dir=str(tmp_path), device="cpu")


def test_device_mesh_is_refused(tmp_path):
    with pytest.raises(NotImplementedError, match="mesh"):
        ServerReplica("MultiPaxos", ADDR, ADDR, ADDR,
                      config={"device_mesh": "2x1"},
                      backer_dir=str(tmp_path), device="cpu")


def test_default_device_raises_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ServerReplica("MultiPaxos", ADDR, ADDR, ADDR,
                      backer_dir=str(tmp_path))


def test_cluster_default_device_raises_without_card(tmp_path):
    """The in-process ``Cluster`` follows the device rule too: with no
    ``device`` it asks for the card, and with no card it raises before
    it starts a manager or a replica."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Cluster("MultiPaxos", 1, str(tmp_path))
    assert threading.active_count() == before


def test_default_wal_dir_is_the_ports_own():
    """A port replica started with the defaults never opens the JAX
    CLI's WAL directory (its records would unpickle the JAX package)."""
    import inspect
    import tempfile

    from summerset_tpu_torch.host.server import DEFAULT_BACKER_DIR

    default = inspect.signature(ServerReplica).parameters["backer_dir"]
    assert default.default == DEFAULT_BACKER_DIR
    assert DEFAULT_BACKER_DIR == os.path.join(tempfile.gettempdir(),
                                              "summerset_tpu_torch")
    assert os.path.basename(DEFAULT_BACKER_DIR) != "summerset_tpu"


def test_cli_without_device_raises_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from summerset_tpu_torch.cli.server import main

    with pytest.raises(RuntimeError, match="no CUDA card"):
        main(["--backer-dir", str(tmp_path)])


def test_full_ingress_queue_sheds_with_retry_hint():
    """The bounded api queue refuses a request arriving at a full queue
    with a ``shed`` reply (never queued, so never proposed), counted in
    ``api_shed``; the queued one is still handed to the replica."""
    from summerset_tpu_torch.client.endpoint import ClientApiStub
    from summerset_tpu_torch.host.external import ExternalApi
    from summerset_tpu_torch.host.messages import ApiRequest
    from summerset_tpu_torch.host.statemach import Command
    from summerset_tpu_torch.host.telemetry import MetricsRegistry

    reg = MetricsRegistry()
    port = free_ports(1)[0]
    api = ExternalApi(("127.0.0.1", port), max_pending=1, registry=reg)
    stub = ClientApiStub(7, ("127.0.0.1", port))
    try:
        for rid in (1, 2):
            stub.send_req(ApiRequest("req", req_id=rid,
                                     cmd=Command("put", "k", str(rid))))
        rep = stub.recv_reply(timeout=10)
        assert rep.kind == "shed" and rep.req_id == 2
        assert not rep.success and rep.retry_after_ms > 0
        assert reg.counter_value("api_shed") == 1
        batch = api.get_req_batch(timeout=10)
        assert [(c, r.req_id) for c, r in batch] == [(7, 1)]
    finally:
        stub.close()
        api.stop()


def test_api_plane_that_cannot_bind_fails_bring_up():
    """A taken api port fails the hub's construction (so the replica's
    supervisor retries) instead of leaving a replica no client reaches."""
    from summerset_tpu_torch.host.external import ExternalApi
    from summerset_tpu_torch.utils.errors import SummersetError

    port = free_ports(1)[0]
    holder = socket.create_server(("127.0.0.1", port))
    try:
        with pytest.raises(SummersetError, match="failed to start"):
            ExternalApi(("127.0.0.1", port))
    finally:
        holder.close()


# ------------------------------------------------- the read tier, live
@pytest.fixture(scope="class")
def nqr_cluster(tmp_path_factory):
    c = Cluster("MultiPaxos", 3, tmp_path_factory.mktemp("torch_nqr"),
                num_groups=2, config={"near_quorum_reads": True}, device="cpu")
    yield c
    c.stop()
    assert not c.faults(), f"replica faults: {c.faults()}"


class TestTorchClusterNearQuorumReads:
    """The shape of ``tests/test_cluster.py::TestClusterNearQuorumReads``
    on port replicas (2 groups, the codec on), plus scans and the commit
    feed over the wire."""

    def test_follower_serves_quorum_read(self, nqr_cluster):
        ep = nqr_cluster.endpoint()
        drv = DriverClosedLoop(ep)
        drv.checked_put("nqr_key", "v1")
        time.sleep(0.5)  # let followers apply
        leader = ep.ctrl.request(CtrlRequest("query_info")).leader or 0
        follower = next(s for s in sorted(ep.servers) if s != leader)
        ep2 = GenericEndpoint(nqr_cluster.manager_addr, server_id=follower)
        ep2.connect()
        drv2 = DriverClosedLoop(ep2)
        got = None
        for _ in range(20):
            r = drv2.get("nqr_key")
            if r.kind == "success" and r.local:
                got = r
                break
            ep2.reconnect(follower)
            time.sleep(0.2)
        ep2.leave()
        ep.leave()
        assert got is not None, "follower never served a quorum read"
        assert got.result.value == "v1"
        assert all(rep.wal.native for rep in nqr_cluster.replicas.values())

    def test_quorum_read_history_linearizable(self, nqr_cluster):
        """A writer streams unique values while follower-pinned readers
        take the quorum-read path; the combined history must check out
        (the tail-hit fallback keeps in-flight writes safe)."""
        from summerset_tpu_torch.utils.linearize import check_history

        ops = []
        stop = threading.Event()
        ep = nqr_cluster.endpoint()
        drv = DriverClosedLoop(ep)
        leader = ep.ctrl.request(CtrlRequest("query_info")).leader or 0
        followers = [s for s in sorted(ep.servers) if s != leader][:2]
        n_local = [0]

        def reader(ci, sid):
            ep2 = GenericEndpoint(nqr_cluster.manager_addr, server_id=sid)
            ep2.connect()
            drv2 = DriverClosedLoop(ep2, timeout=3.0)
            while not stop.is_set():
                t0 = time.monotonic()
                r = drv2.get("nqr_hist")
                t1 = time.monotonic()
                if r.kind == "success":
                    val = r.result.value if r.result else None
                    ops.append(record_get(ci, "nqr_hist", val, t0, t1))
                    n_local[0] += r.local
                else:
                    ep2.reconnect(sid)
                    time.sleep(0.05)
            try:
                ep2.leave()
            except Exception:
                pass

        threads = [threading.Thread(target=reader, args=(10 + i, sid),
                                    daemon=True)
                   for i, sid in enumerate(followers)]
        for t in threads:
            t.start()
        for seq in range(12):
            val = f"w-{seq}"
            t0 = time.monotonic()
            rep = drv.put("nqr_hist", val)
            t1 = time.monotonic()
            if rep.kind == "success":
                ops.append(record_put(0, "nqr_hist", val, t0, t1, True))
            elif rep.kind in ("timeout", "failure", "disconnect"):
                ops.append(record_put(0, "nqr_hist", val, t0, None, False))
                drv._failover(rep)
            time.sleep(0.25)
        deadline = time.monotonic() + 20
        while (sum(1 for o in ops if o.kind == "get") <= 8
               and time.monotonic() < deadline):
            time.sleep(0.5)
        time.sleep(0.8)
        stop.set()
        for t in threads:
            t.join(timeout=15)
        ep.leave()
        reads = [o for o in ops if o.kind == "get"]
        assert len(reads) > 8, f"too few reads: {len(reads)}"
        assert n_local[0] > 0
        ok, diag = check_history(ops)
        assert ok, diag

    def test_barrier_scan_and_commit_feed_over_the_wire(self, nqr_cluster):
        """A learner subscribes at a follower (its snapshot plus its notes
        equal that replica's applied KV); the leader's barrier scans
        return every acked key of the span in order; probes answer."""
        from summerset_tpu_torch.client.endpoint import ClientApiStub
        from summerset_tpu_torch.host.messages import ApiRequest
        from summerset_tpu_torch.host.statemach import Command

        ep = nqr_cluster.endpoint()
        drv = DriverClosedLoop(ep, timeout=5.0)
        leader = ep.ctrl.request(CtrlRequest("query_info")).leader or 0
        follower = next(s for s in sorted(ep.servers) if s != leader)
        sub = ClientApiStub(9000 + ep.id, ep.servers[follower][0])
        sub.send_req(ApiRequest("sub", req_id=1))
        snap = sub.recv_reply(timeout=10)
        assert snap.kind == "sub" and snap.success
        kv, seq = dict(snap.notes), snap.seq
        acked = {}
        for i in range(10):
            drv.checked_put(f"sc{i:02d}", f"x{i}", retries=40)
            acked[f"sc{i:02d}"] = f"x{i}"
        drv.checked_put("sd", "out", retries=40)
        for _ in range(20):
            r = drv.scan("sc", end="sd")
            if r.kind == "success":
                break
            time.sleep(0.1)
        assert r.kind == "success" and not r.local
        assert r.result.items == tuple(sorted(acked.items()))
        r = drv.scan("sc", end="sd", limit=3)
        assert r.result.items == tuple(sorted(acked.items()))[:3]
        sub.send_req(ApiRequest("probe", req_id=2,
                                cmd=Command("get", "sc00")))
        deadline = time.monotonic() + 15
        probe = None
        rep = nqr_cluster.replicas[follower]
        while time.monotonic() < deadline:
            try:
                x = sub.recv_reply(timeout=1.0)
            except socket.timeout:
                if probe is not None and kv == dict(
                        rep.statemach.snapshot_items()):
                    break
                continue
            if x.kind == "probe":
                probe = x
                assert not x.success  # no leases on MultiPaxos
                continue
            assert x.kind == "note" and x.req_id == 0
            for s, k, v in x.notes:
                assert s == seq + 1, (s, seq)
                seq = s
                kv[k] = v
            assert x.seq == seq
        sub.close()
        ep.leave()
        assert probe is not None
        assert kv == dict(rep.statemach.snapshot_items())
        assert all(kv.get(k) == v for k, v in acked.items())


# ------------------------------------------ lease and conf planes, live
def query_conf(ep):
    """The manager's conf, polled: the server's notice races the
    client's query."""
    conf = None
    for _ in range(50):
        conf = ep.ctrl.request(CtrlRequest("query_conf"), timeout=10)
        if conf.conf:
            break
        time.sleep(0.1)
    return conf


def _local_get(cluster, sid, key, secs):
    """Gets of ``key`` pinned to server ``sid`` until one is answered as
    a leased local read (redirects bounce the endpoint off: it comes
    back), or None after ``secs``."""
    ep = GenericEndpoint(cluster.manager_addr, server_id=sid)
    ep.connect()
    try:
        drv = DriverClosedLoop(ep, timeout=3.0)
        deadline = time.monotonic() + secs
        while time.monotonic() < deadline:
            r = drv.get(key)
            if r.kind == "success" and r.local:
                return r
            ep.reconnect(sid)
            time.sleep(0.2)
        return None
    finally:
        ep.leave()


@pytest.fixture(scope="class")
def ql_cluster(tmp_path_factory):
    c = Cluster("QuorumLeases", 3, tmp_path_factory.mktemp("torch_ql"),
                device="cpu")
    yield c
    c.stop()
    assert not c.faults(), f"replica faults: {c.faults()}"


class TestTorchClusterQuorumLeases:
    """The shape of ``tests/test_cluster.py::TestClusterQuorumLeases`` on
    a port cluster."""

    def test_conf_change_and_local_read(self, ql_cluster):
        ep, drv = _driver(ql_cluster)
        try:
            drv.checked_put("lease_key", "v1", retries=40)
            rep = drv.conf_change({"responders": [0, 1, 2]})
            assert rep.kind == "success"
            conf = query_conf(ep)
            assert conf.conf and sorted(conf.conf["responders"]) == [0, 1, 2]
            leader = ep.ctrl.request(CtrlRequest("query_info")).leader or 0
        finally:
            ep.leave()
        follower = next(s for s in sorted(ql_cluster.replicas)
                        if s != leader)
        got = _local_get(ql_cluster, follower, "lease_key", 30)
        assert got is not None, "follower never served a local read"
        assert got.result.value == "v1"

    def test_linearizable_local_reads(self, ql_cluster):
        """A writer streams unique values while readers pinned to the
        followers get the key (served locally once the leases are
        quiescent); the combined history checks out."""
        from summerset_tpu_torch.utils.linearize import check_history

        ops, stop = [], threading.Event()
        ep, drv = _driver(ql_cluster)
        drv.conf_change({"responders": [0, 1, 2]})
        n_local = [0]

        def reader(ci, sid):
            ep2 = GenericEndpoint(ql_cluster.manager_addr, server_id=sid)
            ep2.connect()
            drv2 = DriverClosedLoop(ep2, timeout=2.0)
            while not stop.is_set():
                t0 = time.monotonic()
                rep = drv2.get("lr_key")
                t1 = time.monotonic()
                if rep.kind == "success":
                    val = rep.result.value if rep.result else None
                    ops.append(record_get(ci, "lr_key", val, t0, t1))
                    n_local[0] += rep.local
                else:
                    ep2.reconnect(sid)
                    time.sleep(0.05)
            try:
                ep2.leave()
            except Exception:
                pass

        leader = ep.ctrl.request(CtrlRequest("query_info")).leader or 0
        followers = [s for s in sorted(ql_cluster.replicas) if s != leader]
        threads = [threading.Thread(target=reader, args=(10 + i, sid),
                                    daemon=True)
                   for i, sid in enumerate(followers)]
        for t in threads:
            t.start()
        for seq in range(10):
            val = f"w-{seq}"
            t0 = time.monotonic()
            rep = drv.put("lr_key", val)
            t1 = time.monotonic()
            if rep.kind == "success":
                ops.append(record_put(0, "lr_key", val, t0, t1, True))
            elif rep.kind in ("timeout", "failure", "disconnect"):
                ops.append(record_put(0, "lr_key", val, t0, None, False))
                drv._failover(rep)
            time.sleep(0.4)  # leases need quiescence to serve locally
        deadline = time.monotonic() + 20
        while (sum(1 for o in ops if o.kind == "get") <= 5
               and time.monotonic() < deadline):
            time.sleep(0.5)
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(timeout=15)
        ep.leave()
        reads = [o for o in ops if o.kind == "get"]
        assert len(reads) > 5, f"too few reads observed: {len(reads)}"
        assert n_local[0] > 0, "no read was served locally"
        ok, diag = check_history(ops)
        assert ok, diag


@pytest.fixture(scope="class")
def bodega_cluster(tmp_path_factory):
    # long leases relative to the refresh period (the JAX cluster's
    # config): replicas' ticks skew under load
    c = Cluster("Bodega", 3, tmp_path_factory.mktemp("torch_bodega"),
                config={"lease_len": 40, "lease_margin": 8,
                        "grant_interval": 4, "conf_timeout": 80}, device="cpu")
    yield c
    c.stop()
    assert not c.faults(), f"replica faults: {c.faults()}"


class TestTorchClusterBodega:
    """The shape of ``tests/test_cluster.py::TestClusterBodega``."""

    def test_roster_conf_at_a_non_leader_and_local_read(self,
                                                         bodega_cluster):
        ep, drv = _driver(bodega_cluster)
        try:
            drv.checked_put("bod_key", "v1", retries=40)
            leader = ep.ctrl.request(CtrlRequest("query_info")).leader or 0
        finally:
            ep.leave()
        # the roster is announced at a non-leader (any replica may
        # announce: conflease.rs heard_new_conf)
        follower = next(s for s in sorted(bodega_cluster.replicas)
                        if s != leader)
        ep = GenericEndpoint(bodega_cluster.manager_addr, server_id=follower)
        ep.connect()
        try:
            rep = DriverClosedLoop(ep).conf_change({"responders": [0, 1, 2]})
            assert rep.kind == "success"
            conf = query_conf(ep)
            assert conf.conf and sorted(conf.conf["responders"]) == [0, 1, 2]
            assert conf.conf["leader"] == leader
        finally:
            ep.leave()
        got = _local_get(bodega_cluster, follower, "bod_key", 120)
        assert got is not None, "responder never served a local read"
        assert got.result.value == "v1"


@pytest.fixture(scope="class")
def ll_cluster(tmp_path_factory):
    c = Cluster("MultiPaxos", 3, tmp_path_factory.mktemp("torch_ll"),
                config={"leader_leases": True}, device="cpu")
    yield c
    c.stop()
    assert not c.faults(), f"replica faults: {c.faults()}"


class TestTorchClusterLeaderLease:
    """The shape of ``tests/test_cluster.py::TestClusterLeaderLease``."""

    def test_leader_serves_local_read(self, ll_cluster):
        ep, drv = _driver(ll_cluster)
        try:
            drv.checked_put("llk", "v1", retries=40)
            got = None
            for _ in range(30):
                r = drv.get("llk")
                if r.kind == "success" and r.local:
                    got = r
                    break
                time.sleep(0.1)
            assert got is not None, "leader never served a leased read"
            assert got.result.value == "v1"
        finally:
            ep.leave()

    def test_history_linearizable_under_leader_reset(self, ll_cluster):
        """A writer and two readers stream while the lease-holding
        leader takes a durable reset mid-run; the merged history
        linearizes (the lease veto keeps a second leader from serving
        reads)."""
        from summerset_tpu_torch.utils.linearize import check_history

        ops, stop = [], threading.Event()
        ep, drv = _driver(ll_cluster)
        leader = ep.ctrl.request(CtrlRequest("query_info")).leader or 0

        def reader(ci):
            ep2 = ll_cluster.endpoint()
            drv2 = DriverClosedLoop(ep2, timeout=3.0)
            while not stop.is_set():
                t0 = time.monotonic()
                r = drv2.get("ll_hist")
                t1 = time.monotonic()
                if r.kind == "success":
                    val = r.result.value if r.result else None
                    ops.append(record_get(ci, "ll_hist", val, t0, t1))
                else:
                    drv2._failover(r)
                    time.sleep(0.05)
            try:
                ep2.leave()
            except Exception:
                pass

        threads = [threading.Thread(target=reader, args=(10 + i,),
                                    daemon=True) for i in range(2)]
        for t in threads:
            t.start()
        for seq in range(14):
            if seq == 5:
                ll_cluster.ctrl("reset_servers", servers=[leader])
            val = f"w-{seq}"
            t0 = time.monotonic()
            rep = drv.put("ll_hist", val)
            t1 = time.monotonic()
            if rep.kind == "success":
                ops.append(record_put(0, "ll_hist", val, t0, t1, True))
            elif rep.kind in ("timeout", "failure", "disconnect"):
                ops.append(record_put(0, "ll_hist", val, t0, None, False))
                drv._failover(rep)
            time.sleep(0.25)
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(timeout=15)
        ep.leave()
        assert sum(1 for o in ops if o.kind == "get") > 5
        ok, diag = check_history(ops)
        assert ok, diag


def _conf_everywhere(cluster, want, secs=20):
    """Whether every replica's ``conf_cur`` equals ``want`` in every
    group within ``secs``."""
    deadline = time.monotonic() + secs
    while time.monotonic() < deadline:
        if all((r._np_state("conf_cur")[:, me] == want).all()
               for me, r in list(cluster.replicas.items())):
            return True
        time.sleep(0.3)
    return False


@pytest.fixture(scope="class", params=[4])
def qlg_cluster(request, tmp_path_factory):
    c = Cluster("QuorumLeases", 3, tmp_path_factory.mktemp("torch_qlg"),
                num_groups=request.param, device="cpu")
    yield c
    c.stop()
    assert not c.faults(), f"replica faults: {c.faults()}"


class TestTorchClusterConfRelay:
    """The manager relay of ``TestClusterMultiGroupConf``, made certain:
    a conf sent to a follower, which leads no group, is relayed through
    the manager to every server, each group's leader proposes it, and
    the follower replies once ``conf_cur`` reaches the target in every
    group (4 groups)."""

    def test_conf_at_a_follower_is_relayed(self, qlg_cluster):
        ep, drv = _driver(qlg_cluster)
        try:
            drv.checked_put("relay_key", "v1", retries=40)
            leader = ep.ctrl.request(CtrlRequest("query_info")).leader or 0
        finally:
            ep.leave()
        follower = next(s for s in sorted(qlg_cluster.replicas)
                        if s != leader)
        assert not qlg_cluster.replicas[follower]._is_leader.any()
        ep = GenericEndpoint(qlg_cluster.manager_addr, server_id=follower)
        ep.connect()
        try:
            rep = DriverClosedLoop(ep).conf_change({"responders": [0, 1]})
            assert rep.kind == "success"
            assert query_conf(ep).conf["responders"] == [0, 1]
        finally:
            ep.leave()
        assert qlg_cluster.manager._conf_seq >= 1
        assert _conf_everywhere(qlg_cluster, 0b011)


@pytest.fixture(scope="class")
def ql8_cluster(tmp_path_factory):
    c = Cluster("QuorumLeases", 3, tmp_path_factory.mktemp("torch_ql8"),
                num_groups=8, device="cpu")
    yield c
    c.stop()


@pytest.mark.slow
class TestTorchClusterMultiGroupConf:
    """The shape of ``tests/test_cluster.py::TestClusterMultiGroupConf``:
    8 groups whose leaderships split after a pause of the warm leader;
    the serving endpoint relays the conf through the manager when it
    does not lead every group."""

    def test_conf_installs_under_split_leadership(self, ql8_cluster):
        ep, drv = _driver(ql8_cluster)
        try:
            drv.checked_put("mgc_key", "v1", retries=40)
            ql8_cluster.ctrl("pause_servers", servers=[0], timeout=60)
            time.sleep(2.5)
            ql8_cluster.ctrl("resume_servers", servers=[0], timeout=60)
            time.sleep(1.0)
            ep.rotate()
            rep = drv.conf_change({"responders": [0, 1, 2]}, retries=30)
            assert rep.kind == "success"
        finally:
            ep.leave()
        assert _conf_everywhere(ql8_cluster, 7), {
            me: r._np_state("conf_cur")[:, me].tolist()
            for me, r in ql8_cluster.replicas.items()
        }
