"""The health plane of the port against the JAX package.

The scorer's decision table (the schedules of ``tests/test_health.py``)
runs on both packages' ``HealthScorer`` and every beacon and verdict
compares with ``==``; the fail-slow injectors (``FrameFaults``' token
bucket, starve and stall cap, the WAL's slow and mem faults) match; and
three serving replicas per package run in per-tick lockstep with health
on, their fsync and frame-delay signals and their clock scripted from the
test on both sides: frames (beacons included), verdicts, the kernel's
``demote`` input, state digests, replies and WAL records are equal on
every tick.  MultiPaxos: the leader is indicted, demotes and a successor
wins.  QuorumLeases: the indicted leader revokes its lease responders,
then demotes; and a false alarm restores them.
"""

import dataclasses
import os
import sys
import time
import types

import numpy as np
import pytest
import torch

import summerset_tpu.host.server as jsrv
import summerset_tpu_torch.host.server as tsrv
from summerset_tpu.host import health as jh
from summerset_tpu.host.storage import LogAction as JLogAction
from summerset_tpu.host.storage import StorageHub as JStorageHub
from summerset_tpu.utils import safetcp as jtcp
from summerset_tpu_torch.host import health as th
from summerset_tpu_torch.host.storage import LogAction as TLogAction
from summerset_tpu_torch.host.storage import StorageHub as TStorageHub
from summerset_tpu_torch.host.telemetry import MetricsRegistry
from summerset_tpu_torch.utils import safetcp as ttcp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_cluster import (  # noqa: E402
    lockstep_sides, norm_frame, norm_reply, norm_wal, leaf_digests,
    requests, shutdown_sides,
)
from test_torch_server import LOCK_CFG, SIDES  # noqa: E402

torch.set_num_threads(1)


# ------------------------------------------------------- decision table
def feed(s, now, fsync_us, peers=None, obs=None):
    """One tick of signals (``tests/test_health.py::feed``)."""
    s.note_fsync(fsync_us / 1e6)
    for subj, d in ((obs or {}).get(0) or {}).items():
        s.note_peer_delay(subj, d / 1e3)
    s.end_tick(queue_depth=0)
    for sid, f in (peers or {}).items():
        s.ingest(sid, {"f": f, "w": f, "q": 0.0,
                       "o": (obs or {}).get(sid, {})}, now)


def single_outlier(s, log):
    for i in range(10):
        feed(s, float(i), 40_000.0, peers={1: 1000.0, 2: 1200.0})
        log.append(s.evaluate(float(i)))


def uniform_slowness(s, log):
    for i in range(10):
        feed(s, float(i), 50_000.0, peers={1: 48_000.0, 2: 55_000.0})
        log.append(s.evaluate(float(i)))


def clock_skew(s, log):
    now = 0.0
    for i in range(10):
        now += 3.0 if i % 3 == 0 else 0.2
        feed(s, now, 900.0, peers={1: 1000.0, 2: 1100.0},
             obs={1: {0: 2.0, 2: 1.5}, 2: {0: 2.5, 1: 1.0},
                  0: {1: 1.2, 2: 1.9}})
        log.append(s.evaluate(now))


def no_quorum(s, log):
    for i in range(8):
        feed(s, float(i), 80_000.0)
        log.append(s.evaluate(float(i)))


def election_churn(s, log):
    for i in range(2):
        feed(s, float(i), 40_000.0, peers={1: 1000.0, 2: 1200.0})
        log.append(s.evaluate(float(i)))
    log.append(s.evaluate(100.0))
    s._fsync_us = 0.0
    feed(s, 101.0, 40_000.0, peers={1: 1000.0, 2: 1200.0})
    log.append(s.evaluate(101.0))


def oscillation(s, log):
    for i in range(20):
        bad = i % 2 == 0
        s._fsync_us = 40_000.0 if bad else 900.0
        s._wal_tick_us = 40_000.0 if bad else 900.0
        s._have_own = True
        s.ingest(1, {"f": 1000.0, "w": 1000.0, "q": 0, "o": {}}, float(i))
        s.ingest(2, {"f": 1200.0, "w": 1200.0, "q": 0, "o": {}}, float(i))
        log.append(s.evaluate(float(i)))


def recovery(s, log):
    for i in range(4):
        feed(s, float(i), 40_000.0, peers={1: 1000.0, 2: 1200.0})
        log.append(s.evaluate(float(i)))
    s._fsync_us = 900.0
    s._wal_tick_us = 900.0
    for i in range(4, 4 + s.clear_after):
        s.ingest(1, {"f": 1000.0, "w": 1000.0, "q": 0, "o": {}}, float(i))
        s.ingest(2, {"f": 1200.0, "w": 1200.0, "q": 0, "o": {}}, float(i))
        s.end_tick(0)
        log.append(s.evaluate(float(i)))


def observer_median(s, log):
    for i in range(6):
        feed(s, float(i), 900.0, peers={1: 1000.0, 2: 1100.0},
             obs={1: {0: 80.0, 2: 2.0}, 2: {0: 90.0, 1: 1.5},
                  0: {1: 1.0, 2: 1.0}})
        log.append(s.evaluate(float(i)))


SCHEDULES = {
    "single_outlier": (single_outlier, True),
    "uniform_slowness": (uniform_slowness, False),
    "clock_skew": (clock_skew, False),
    "no_quorum": (no_quorum, False),
    "election_churn": (election_churn, False),
    "oscillation": (oscillation, False),
    "recovery": (recovery, False),
    "observer_median": (observer_median, True),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_scorer_schedule_equals_jax(case):
    fn, indicts = SCHEDULES[case]
    got = {}
    for name, mod in (("jax", jh), ("torch", th)):
        s = mod.HealthScorer(0, 3, hysteresis=3, clear_after=2)
        log = []
        fn(s, log)
        got[name] = ([dataclasses.asdict(v) for v in log], s.beacon(),
                     s.self_indicted, sorted(s._indicted))
    assert got["jax"] == got["torch"]
    assert got["torch"][2] == indicts
    assert th._median([3.0, 1.0, 2.0, 10.0]) == jh._median([3.0, 1.0, 2.0,
                                                             10.0])
    assert th.SIGNALS == jh.SIGNALS


# ---------------------------------------------------- fail-slow injectors
def frame_fault_trace(mod):
    out = []
    f = mod.FrameFaults({"bw": 1000.0, "stall_cap": 10.0}, seed=0)
    t = 100.0
    out.append(f.host_stall(500, t))
    s = f.host_stall(1000, t)
    out += [s, f.host_stall(0, t + s)]
    f = mod.FrameFaults({"starve": 0.5, "stall_cap": 10.0}, seed=0)
    out.append(f.host_stall(0, 0.0))
    s = f.host_stall(0, 1.0)
    out += [s, f.host_stall(0, 1.0 + s)]
    f = mod.FrameFaults({"bw": 10.0, "starve": 0.9}, seed=0)
    f.host_stall(0, 0.0)
    out += [f.host_stall(10_000, 50.0), f._stall_cap]
    f = mod.FrameFaults({"drop": {"*": 0.3}, "dup": {"1": 0.2},
                         "mute": [2], "deaf": [1],
                         "delay": {"0": 0.01}}, seed=5)
    out.append([f.egress(p % 3) for p in range(60)])
    out.append([(f.ingress_drop(p), f.ingress_delay(p)) for p in range(3)])
    return out


def test_frame_faults_equal_jax():
    got = frame_fault_trace(ttcp)
    assert got == frame_fault_trace(jtcp)
    assert 0.45 <= got[1] <= 0.55          # 500 B short at 1000 B/s
    assert got[4] == pytest.approx(1.0, rel=0.01)   # starve 0.5
    assert got[6] <= got[7] + 1e-9          # the stall cap holds


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_wal_slow_and_mem_faults(tmp_path, pkg):
    """The slow disk inflates every sync point inside the timed region
    (and feeds the health scorer); ``slow_count`` disarms it; the mem
    fault forces a sync point per overflowing append.  Both packages."""
    hub_cls, act = ((JStorageHub, JLogAction) if pkg == "jax"
                    else (TStorageHub, TLogAction))
    reg = (MetricsRegistry() if pkg == "torch" else
           __import__("summerset_tpu.host.telemetry",
                      fromlist=["x"]).MetricsRegistry())
    hub = hub_cls(str(tmp_path / "w.wal"), prefer_native=False, registry=reg)
    scorer = (th if pkg == "torch" else jh).HealthScorer(0, 3)
    hub.health = scorer
    try:
        hub.set_faults({"slow": 6.0, "slow_floor": 0.01, "slow_count": 1})
        t0 = time.monotonic()
        hub.do_sync_action(act("append", entry=b"a", sync=True))
        assert time.monotonic() - t0 >= 0.045
        assert scorer._fsync_us >= 45_000
        t0 = time.monotonic()
        hub.do_sync_action(act("append", entry=b"b", sync=True))
        assert time.monotonic() - t0 < 0.045  # the count ran out
        n0 = reg.hist("wal_fsync_us").count
        hub.set_faults({"mem": 64, "mem_stall": 0.001})
        for _ in range(4):
            hub.do_sync_action(act("append", entry=b"q" * 300, sync=False))
        assert reg.hist("wal_fsync_us").count >= n0 + 4
    finally:
        hub.stop()


# ------------------------------------------------ serving lockstep, health on
HEALTH_CFG = dict(LOCK_CFG, health_enabled=True, health_eval_ticks=2,
                  health_demote_ticks=12, health_cooldown_ticks=400,
                  health_clear_after=1)


class Clock:
    """The scripted clock both packages' servers read (``time`` in the
    server modules): it advances 10 ms per round."""

    def __init__(self):
        self.now = 5000.0

    def shim(self):
        return types.SimpleNamespace(monotonic=lambda: self.now,
                                     sleep=lambda s: None)


def script_signals(reps, slow, t):
    """This tick's fsync and frame-delay samples, fed to both packages'
    scorers alike: replica ``r`` in ``slow`` fsyncs in 40 ms, the rest
    in 1 ms; every frame arrives in 2 ms."""
    for r, rep in enumerate(reps):
        h = rep.health
        h.note_fsync(0.040 if r in slow else 0.001)
        for p in range(len(reps)):
            if p != r:
                h.note_peer_delay(p, 0.002)


def capture_demote(rep, box):
    orig = rep._build_inputs

    def wrapped(n_prop, vbase):
        out = orig(n_prop, vbase)
        box.append(np.asarray(out["demote"]).copy()
                   if "demote" in out else None)
        return out

    rep._build_inputs = wrapped


def health_run(tmp_path, monkeypatch, protocol, cfg, ticks, slow_at,
               heal_at=None, conf_tick=None, reqs=requests):
    clock = Clock()
    monkeypatch.setattr(jsrv, "time", clock.shim())
    monkeypatch.setattr(tsrv, "time", clock.shim())
    sides = lockstep_sides(tmp_path, protocol, SIDES, cfg, 2, 3, 16)
    demotes = {name: [[] for _ in range(3)] for name in sides}
    for name, (reps, *_r) in sides.items():
        for r, rep in enumerate(reps):
            # the scripted signals stand in for the measured ones
            rep.wal.health = None
            capture_demote(rep, demotes[name][r])
    timeline = []
    try:
        for t in range(ticks):
            slow = {0} if slow_at <= t and (heal_at is None
                                            or t < heal_at) else set()
            seen = {}
            for name, (reps, net, pkg, wals, norm) in sides.items():
                script_signals(reps, slow, t)
                if heal_at is not None and t == heal_at:
                    # the limp is gone: the own EWMAs drop at once
                    reps[0].health._fsync_us = 900.0
                    reps[0].health._wal_tick_us = 900.0
                for r, rep in enumerate(reps):
                    batch = list(reqs(pkg, t, r))
                    if conf_tick is not None and (t, r) == conf_tick:
                        batch.append((400, pkg.msg.ApiRequest(
                            "conf", req_id=77,
                            conf_delta={"responders": [0, 1, 2]})))
                    rep.external.batches.append(batch)
                    rep._tick_serial(clock.now)
                sent = net.flush()
                seen[name] = {
                    "frames": [(s, d, norm_frame(f, norm, name != "jax"),
                                f.get("hb")) for s, d, f in sent],
                    "state": [leaf_digests(rep.state) for rep in reps],
                    "wal": [[norm_wal(e, norm) for e in w] for w in wals],
                    "replies": [[norm_reply(c, x) for c, x in
                                 rep.external.replies] for rep in reps],
                    "ctrl": [list(rep.ctrl.sent) for rep in reps],
                    "health": [(rep._health_self_bad, rep._demote_until,
                                rep._demote_revoke_deadline,
                                rep._demote_restore_resp,
                                rep.metrics.counter_value("leader_demotions"),
                                rep.metrics.gauge_value("health_score"),
                                rep.health.beacon()) for rep in reps],
                    "demote": [None if not d or d[-1] is None
                               else d[-1].tolist() for d in demotes[name]],
                    "leader": [rep._is_leader.tolist() for rep in reps],
                }
                for rep in reps:
                    rep.external.replies.clear()
                    rep.ctrl.sent.clear()
                for w in wals:
                    w.clear()
            for k in seen["jax"]:
                assert seen["jax"][k] == seen["torch"][k], (t, k)
            timeline.append(seen["torch"])
            clock.now += 0.01
        return sides, timeline
    except BaseException:
        shutdown_sides(sides)
        raise


def test_multipaxos_leader_indicted_demotes_lockstep(tmp_path, monkeypatch):
    """Replica 0 leads; from tick 14 its fsyncs take 40 ms.  Both
    packages indict it at the same evaluation, arm the same ``demote``
    input for 12 ticks, and another replica wins every group; the
    demotion counts once."""
    sides, tl = health_run(tmp_path, monkeypatch, "MultiPaxos",
                           HEALTH_CFG, ticks=70, slow_at=14)
    try:
        dem = [t for t, s in enumerate(tl) if s["health"][0][4]]
        assert dem, "the leader was never demoted"
        assert tl[-1]["health"][0][4] == 1
        assert tl[12]["leader"][0] == [True, True]
        assert not any(tl[-1]["leader"][0])
        assert any(all(x) for x in tl[-1]["leader"][1:])
        assert any(s["demote"][0] and any(map(any, s["demote"][0]))
                   for s in tl)
        assert all(s["health"][r][4] == 0 for s in tl for r in (1, 2))
    finally:
        shutdown_sides(sides)


QL_CFG = dict(HEALTH_CFG, hear_timeout_lo=16, hear_timeout_hi=32)


def ql_requests(pkg, t, r):
    """Puts at the leader early on, gets everywhere."""
    base = 1000 * t + 10 * r
    Req, Cmd = pkg.msg.ApiRequest, pkg.sm.Command
    out = []
    if r == 0 and t < 5:
        out.append((100, Req("req", req_id=base,
                             cmd=Cmd("put", f"k{t % 3}", f"v{t}"))))
    out.append((200 + r, Req("req", req_id=base + 1,
                             cmd=Cmd("get", f"k{(t + r) % 3}"))))
    return out


@pytest.mark.parametrize("heal", [False, True], ids=["demote", "false_alarm"])
def test_quorum_leases_revoke_then_demote_lockstep(tmp_path, monkeypatch,
                                                   heal):
    """QuorumLeases: responders {0, 1, 2} installed at tick 4; from tick
    20 the leader limps.  Indicted, it first revokes its lease responders
    (an empty-responders conf through the log).  Limping on, it demotes
    once the revoke installed; healed right after the indictment (a false
    alarm), it restores the responders instead and stays leader."""
    sides, tl = health_run(tmp_path, monkeypatch, "QuorumLeases", QL_CFG,
                           ticks=90, slow_at=20,
                           heal_at=None if not heal else 27,
                           conf_tick=(4, 0), reqs=ql_requests)
    try:
        revoked = [t for t, s in enumerate(tl)
                   if s["health"][0][3] is not None]
        assert revoked, "no lease revoke before the demotion"
        assert tl[revoked[0]]["health"][0][3] == [0, 1, 2]
        dems = tl[-1]["health"][0][4]
        if heal:
            assert dems == 0
            assert tl[-1]["leader"][0] == [True, True]
            reps = sides["torch"][0]
            assert reps[0]._current_responders() == [0, 1, 2]
        else:
            assert dems == 1
            assert not any(tl[-1]["leader"][0])
    finally:
        shutdown_sides(sides)
