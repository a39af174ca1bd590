"""Nemesis soak of the port: seeded fault schedules against a live port
cluster, verified by linearizability and bounded recovery (the
counterpart of ``scripts/nemesis_soak.py``'s ``run_one``, ``--matrix``
and ``--failslow``).

Per (protocol, seed) cell:

1. bring up an in-process port cluster (``summerset_tpu_torch.cluster``:
   a manager and N ``ServerReplica`` loops over localhost TCP) on
   ``--device`` with ``--groups`` groups;
2. generate the seed's ``FaultPlan`` and check that regenerating it is
   byte-identical (the repro contract);
3. (``soak``, which also runs on a cluster its caller brought up, as
   ``chip_smoke.py``'s phase 21 does) start closed-loop recorder
   clients, play the schedule through the manager (``NemesisRunner``),
   then force a final heal;
4. check bounded recovery (a checked write within the budget after the
   heal), the WAL and window bounds, only injected crashes (a torn WAL
   append, a failed fsync, the snapshot crash point: their errors say
   "injected"; any other crash or failed bring-up fails the cell), and
   the linearizability of the recorded history.

A failed cell writes its repro bundle (timeline, executed actions, the
history, flight tails, replica states) beside ``--out``, or into the
temp directory.  Re-running with the same ``--seed`` replays the same
schedule.

Usage::

    python -m summerset_tpu_torch.nemesis_soak --protocol MultiPaxos \\
        --seed 1 --device cpu
    python -m summerset_tpu_torch.nemesis_soak --matrix --device cpu
    python -m summerset_tpu_torch.nemesis_soak --failslow slow_disk \\
        --protocol Raft --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from typing import Optional, Sequence

import numpy as np

from .client.drivers import DriverClosedLoop
from .client.endpoint import GenericEndpoint, scrape_metrics
from .client.tester import start_recorded_clients
from .cluster import Cluster
from .host.messages import CtrlRequest
from .host.nemesis import SLOW_PEER_BW, FaultPlan, NemesisRunner
from .utils.linearize import check_history

MATRIX_PROTOCOLS = ("MultiPaxos", "Raft", "RSPaxos")
# QuorumLeases drives real lease revoke-then-adopt barriers through the
# schedules' conf_change events
MATRIX_EXTRA = ("QuorumLeases",)
MATRIX_SEEDS = (1, 2, 3)
SOAK_CLASSES = (
    "crash", "partition", "isolate", "one_way", "drop", "pause",
    "wal_torn", "wal_fsync", "clock_skew",
    "device_reset", "conf_change", "take_snapshot",
    "range_change",
)
# compaction events must keep every survivor's WAL bounded
WAL_BOUND_BYTES = 8 << 20
DEFAULT_TICKS = 120
DEFAULT_BUDGET_TICKS = 4000

# the gray-failure twins: each fail-slow class against a protocol with
# the health plane's mitigation armed and with it off; the mitigated
# twin's throughput while the victim limps must beat the other's by
# FAILSLOW_TPUT_RATIO
FAILSLOW_CLASSES = ("slow_disk", "slow_peer", "mem_pressure")
FAILSLOW_PROTOCOLS = ("MultiPaxos", "Raft", "QuorumLeases")
FAILSLOW_SEED = 1
FAILSLOW_TICKS = 80
FAILSLOW_TPUT_RATIO = 2.0
FAILSLOW_STEADY_S = 2.5    # pre-fault throughput baseline
FAILSLOW_DETECT_S = 10.0   # detection and demotion budget after onset
FAILSLOW_MEASURE_S = 8.0   # fault-active throughput window


def protocol_config(protocol: str) -> dict:
    if protocol in ("RSPaxos", "CRaft", "Crossword"):
        # 3-replica coded family: majority-quorum shards, no extra FT
        return {"fault_tolerance": 0}
    return {}


def history_doc(ops: list) -> list:
    return [
        {"client": o.client, "kind": o.kind, "key": o.key,
         "value": o.value, "t_inv": o.t_inv,
         "t_resp": None if o.t_resp == float("inf") else o.t_resp,
         "acked": o.acked}
        for o in sorted(ops, key=lambda o: o.t_inv)
    ]


def _dump_bundle(result: dict, plan, runner, ops: list,
                 out: Optional[str], name: str) -> str:
    doc = {**result, "timeline": plan.timeline(),
           "executed": runner.executed if runner is not None else [],
           "history": history_doc(ops)}
    base = (os.path.splitext(out)[0] if out
            else os.path.join(tempfile.gettempdir(), "nemesis_soak"))
    path = f"{base}_{name}_fail.json"
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, default=str)
    print(f"FAIL bundle -> {path}", flush=True)
    return path


def _bounds(cluster) -> dict:
    """Each live replica's WAL bytes and live window span (the highest
    frontier its windows must hold minus its applied floor)."""
    wal_bytes, spans, win = {}, {}, cluster.window
    for me, r in sorted(cluster.replicas.items()):
        try:
            wal_bytes[me] = int(r.wal.size)
            fr = np.zeros(r.G, np.int64)
            for k in ("vote_bar", "next_slot", "log_end", "prop_bar"):
                if k in r.state:
                    fr = np.maximum(fr, r._np_state(k)[:, r.me])
            spans[me] = max(
                0, int((fr - np.asarray(r.applied, np.int64)).max()))
        except Exception:
            pass  # a replica mid-restart has no stable view
    return {"wal_bytes": wal_bytes, "window_span": spans, "window": win}


def recover(manager_addr, key: str, value: str, budget_s: float) -> float:
    """Seconds until a put of ``key`` is acked after a heal, or -1.0 if
    none is within ``budget_s``."""
    t_heal = time.monotonic()
    ep = GenericEndpoint(manager_addr)
    ep.connect()
    try:
        drv = DriverClosedLoop(ep, timeout=min(5.0, budget_s))
        while time.monotonic() - t_heal < budget_s:
            r = drv.put(key, value)
            if r.kind == "success":
                return time.monotonic() - t_heal
            drv._failover(r)
        return -1.0
    finally:
        ep.leave()


def soak(cluster, runner, result: dict, ops: list, *, seed: int,
         clients: int = 3, keys: Sequence[str] = ("nem0", "nem1", "nem2"),
         recovery_budget_s: float, min_ops: int = 20, plane=None) -> dict:
    """The soak on a live ``cluster``: a warm put, ``clients`` closed-loop
    recorders over ``keys`` (their ops land in ``ops``), ``runner``'s plan
    played through the manager and a final heal, then the checks: a
    checked put within ``recovery_budget_s`` of the heal, more than
    ``min_ops`` ops, only injected crashes, the WAL and window bounds and
    a linearizable history.  ``plane`` (a ``host/ingress.ServingPlane``
    in front of the cluster) receives the plan's ``proxy_crash`` and
    ``proxy_restart`` actions; without one they are action errors.
    Fills ``result`` (``ok``, ``error``, the readings) and returns it;
    the recorders are stopped on return."""
    if plane is not None:
        runner.proxy_ctl = plane.proxy_ctl
    stop = threading.Event()
    threads: list = []
    try:
        wep = GenericEndpoint(cluster.manager_addr)
        wep.connect()
        DriverClosedLoop(wep, timeout=10.0).checked_put("warm", "1",
                                                        retries=40)
        wep.leave()
        threads = start_recorded_clients(
            cluster.manager_addr, clients, list(keys), stop, ops, seed=seed)
        t = time.monotonic()
        runner.play()
        runner.heal_all()
        result["play_s"] = round(time.monotonic() - t, 3)
        result["executed"] = [d for _t, d in runner.executed]
        result["action_errors"] = [d for _t, d in runner.executed
                                   if "!error" in d]
        rec_s = recover(cluster.manager_addr, "nem_recovery", f"s{seed}",
                        recovery_budget_s)
        result["recovery_s"] = round(rec_s, 3)
        result["recovery_ticks"] = (int(rec_s / cluster.tick)
                                    if rec_s >= 0 else None)
        if rec_s < 0:
            result["error"] = (f"no recovery within {recovery_budget_s:.1f} "
                               f"s of the heal")
            return result
        deadline = time.monotonic() + 30
        while len(ops) <= min_ops and time.monotonic() < deadline:
            time.sleep(0.5)
        stop.set()
        for th in threads:
            th.join(timeout=30)
        result["server_metrics"] = scrape_metrics(cluster.manager_addr,
                                                  compact=True)
        result["num_ops"] = len(ops)
        result["crashes"] = [f["error"] for f in cluster.crash_reports]
        real = cluster.uninjected_faults()
        if real:
            result["error"] = f"crashes the plan did not inject: {real}"
            return result
        if len(ops) <= min_ops:
            result["error"] = f"history too small: {len(ops)}"
            return result
        b = _bounds(cluster)
        result.update(wal_bytes=b["wal_bytes"],
                      window_span=b["window_span"])
        if not b["wal_bytes"]:
            result["error"] = ("boundedness unmeasurable: no replica gave "
                               "wal/window readings")
            return result
        over = {m: v for m, v in b["wal_bytes"].items()
                if v > WAL_BOUND_BYTES}
        wide = {m: s for m, s in b["window_span"].items()
                if s > b["window"]}
        if over or wide:
            result["error"] = (f"unbounded growth: wal_bytes over "
                               f"{WAL_BOUND_BYTES} = {over}, window spans "
                               f"over W = {wide}")
            return result
        ok, diag = check_history(ops)
        result["ok"] = bool(ok)
        if not ok:
            result["error"] = diag
        return result
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=10)


def run_one(protocol: str, seed: int, *, replicas: int = 3,
            clients: int = 3, ticks: int = DEFAULT_TICKS,
            tick_len: float = 0.25, tick: float = 0.005,
            budget_ticks: int = DEFAULT_BUDGET_TICKS, min_ops: int = 20,
            classes: Sequence[str] = SOAK_CLASSES, groups: int = 1,
            window: int = 32, device=None, out: Optional[str] = None,
            keys: Sequence[str] = ("nem0", "nem1", "nem2")) -> dict:
    """One soak cell: a fresh cluster and the seed's plan through
    ``soak``; returns its verdict row (``ok``, ``error``)."""
    plan = FaultPlan.generate(seed, replicas, ticks, classes=classes)
    again = FaultPlan.generate(seed, replicas, ticks, classes=classes)
    assert plan.timeline() == again.timeline(), "non-deterministic plan"
    print(f"--- {protocol} seed={seed} digest={plan.digest()}", flush=True)
    print(plan.timeline(), end="", flush=True)
    tmp = tempfile.mkdtemp(prefix=f"nemsoak_{protocol.lower()}_{seed}_")
    result = {"protocol": protocol, "seed": seed, "digest": plan.digest(),
              "groups": groups, "device": str(device), "ok": False}
    cluster = None
    ops: list = []
    runner = None
    try:
        cluster = Cluster(protocol, replicas, tmp,
                          config=protocol_config(protocol), tick=tick,
                          num_groups=groups, window=window, device=device)
        runner = NemesisRunner(cluster.manager_addr, plan,
                               tick_len=tick_len)
        runner.range_keys = tuple(keys)
        return soak(cluster, runner, result, ops, seed=seed,
                    clients=clients, keys=keys,
                    recovery_budget_s=budget_ticks * tick, min_ops=min_ops)
    finally:
        if not result["ok"] and runner is not None:
            result["flight"] = runner.flight_tails(last_n=256)
        if runner is not None:
            runner.close()
        if not result["ok"] and cluster is not None:
            result["replica_states"] = {
                me: repr(r.debug_state())
                for me, r in sorted(cluster.replicas.items())
            }
            result["faults"] = cluster.faults()
        if cluster is not None:
            cluster.stop()
        if not result["ok"]:
            _dump_bundle(result, plan, runner, ops, out,
                         f"{protocol}_s{seed}")
        shutil.rmtree(tmp, ignore_errors=True)


def _failslow_spec(ev) -> dict:
    """The ``inject_faults`` payload of one fail-slow event, with per-op
    cost floors that make the limp dominate the tick on a tmpfs WAL."""
    if ev.kind == "slow_disk":
        return {"wal": {"slow": ev.arg, "slow_floor": 0.002}}
    if ev.kind == "mem_pressure":
        return {"wal": {"mem": int(ev.arg), "mem_stall": 0.15}}
    return {"net": {"bw": SLOW_PEER_BW, "starve": ev.arg,
                    "stall_cap": 0.25}}


def _acked_in_window(ops, t0: float, t1: float) -> int:
    return sum(1 for o in list(ops)
               if o.acked and o.t_resp != float("inf")
               and t0 <= o.t_resp <= t1)


def run_failslow(protocol: str, cls: str, mitigated: bool, *,
                 clients: int = 3, tick: float = 0.005,
                 budget_ticks: int = DEFAULT_BUDGET_TICKS, groups: int = 1,
                 device=None, out: Optional[str] = None) -> dict:
    """One gray-failure cell: inject ``cls`` at the live leader, give the
    health plane its detection budget, then measure throughput while the
    victim limps; heal, recover, check the history."""
    seed, replicas = FAILSLOW_SEED, 3
    plan = FaultPlan.failslow(cls, seed, replicas, FAILSLOW_TICKS)
    again = FaultPlan.failslow(cls, seed, replicas, FAILSLOW_TICKS)
    assert plan.timeline() == again.timeline(), "non-deterministic plan"
    ev = plan.events[0]
    tag = f"{protocol}/{cls}/{'mitigated' if mitigated else 'unmitigated'}"
    print(f"--- failslow {tag} seed={seed} digest={plan.digest()}",
          flush=True)
    tmp = tempfile.mkdtemp(prefix=f"failslow_{cls}_{int(mitigated)}_")
    result = {"failslow": True, "protocol": protocol, "seed": seed,
              "class": cls, "mitigated": mitigated,
              "digest": plan.digest(), "ok": False}
    cluster = None
    stop = threading.Event()
    ops: list = []
    threads: list = []
    ep = None
    try:
        cfg = dict(protocol_config(protocol), health_mitigation=mitigated)
        cluster = Cluster(protocol, replicas, tmp, config=cfg, tick=tick,
                          num_groups=groups, device=device)
        ep = GenericEndpoint(cluster.manager_addr)
        ep.connect()
        drv = DriverClosedLoop(ep, timeout=10.0)
        drv.checked_put("warm", "1")
        if protocol == "QuorumLeases":
            drv.conf_change({"responders": list(range(replicas))},
                            retries=4)
        threads = start_recorded_clients(
            cluster.manager_addr, clients, [f"fs{i}" for i in range(3)],
            stop, ops, seed=seed)
        t0 = time.monotonic()
        time.sleep(FAILSLOW_STEADY_S)
        t1 = time.monotonic()
        tput_steady = _acked_in_window(ops, t0, t1) / (t1 - t0)
        info = ep.ctrl.request(CtrlRequest("query_info"))
        victim = info.leader if info.leader is not None else 0
        result["victim"] = victim
        ep.ctrl.request(CtrlRequest("inject_faults", servers=[victim],
                                    payload=_failslow_spec(ev)))
        t_deadline = time.monotonic() + FAILSLOW_DETECT_S
        while time.monotonic() < t_deadline:
            time.sleep(0.5)
            vic = cluster.replicas.get(victim)
            if mitigated and vic is not None and \
                    vic.metrics.counter_value("leader_demotions") > 0:
                cur = ep.ctrl.request(CtrlRequest("query_info")).leader
                if cur is not None and cur != victim:
                    break
        t2 = time.monotonic()
        time.sleep(FAILSLOW_MEASURE_S)
        t3 = time.monotonic()
        tput_fault = _acked_in_window(ops, t2, t3) / (t3 - t2)
        vic = cluster.replicas.get(victim)
        result["demotions"] = (0 if vic is None else
                               vic.metrics.counter_value("leader_demotions"))
        result["health_score_victim"] = (
            None if vic is None
            else vic.metrics.gauge_value("health_score", None))
        result["leader_after"] = ep.ctrl.request(
            CtrlRequest("query_info")).leader
        result["tput_steady"] = round(tput_steady, 2)
        result["tput_fault"] = round(tput_fault, 2)
        ep.ctrl.request(CtrlRequest("inject_faults", servers=[victim],
                                    payload={"net": None, "wal": None}))
        rec_s = recover(cluster.manager_addr, "fs_recovery", f"s{seed}",
                        budget_ticks * tick)
        result["recovery_s"] = round(rec_s, 3)
        if rec_s < 0:
            result["error"] = "no recovery after heal"
            return result
        stop.set()
        for t in threads:
            t.join(timeout=30)
        result["num_ops"] = len(ops)
        if cluster.uninjected_faults():
            result["error"] = (f"crashes the plan did not inject: "
                               f"{cluster.uninjected_faults()}")
            return result
        if mitigated:
            if result["demotions"] < 1:
                result["error"] = "mitigation armed but no demotion fired"
                return result
            if result["leader_after"] == victim:
                result["error"] = ("demotion fired but the limping leader "
                                   "still leads")
                return result
        ok, diag = check_history(ops)
        result["ok"] = bool(ok)
        if not ok:
            result["error"] = diag
        return result
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        if ep is not None:
            try:
                ep.leave()
            except Exception:
                pass
        if cluster is not None:
            cluster.stop()
        if not result["ok"]:
            _dump_bundle(result, plan, None, ops, out,
                         f"failslow_{protocol}_{cls}_"
                         f"{'m' if mitigated else 'u'}")
        shutil.rmtree(tmp, ignore_errors=True)


def run_failslow_pairs(pairs, **kw) -> list:
    """Mitigated and unmitigated twins per (protocol, class); the
    mitigated twin must recover FAILSLOW_TPUT_RATIO x the other's
    throughput."""
    rows = []
    for protocol, cls in pairs:
        mit = run_failslow(protocol, cls, True, **kw)
        unmit = run_failslow(protocol, cls, False, **kw)
        ratio = None
        if mit.get("tput_fault") is not None \
                and unmit.get("tput_fault") is not None:
            ratio = round(mit["tput_fault"] / max(unmit["tput_fault"], 1e-9),
                          2)
            mit["tput_ratio"] = ratio
            if mit["ok"] and ratio < FAILSLOW_TPUT_RATIO:
                mit["ok"] = False
                mit["error"] = (f"mitigated throughput only {ratio}x the "
                                f"unmitigated twin (need >= "
                                f"{FAILSLOW_TPUT_RATIO}x)")
        for r in (mit, unmit):
            status = "PASS" if r["ok"] else f"FAIL ({r.get('error')})"
            print(f"=== failslow {r['protocol']}/{r['class']}/"
                  f"{'mit' if r['mitigated'] else 'unmit'}: {status} "
                  f"(steady={r.get('tput_steady')} fault="
                  f"{r.get('tput_fault')} ratio={ratio} "
                  f"demotions={r.get('demotions')})", flush=True)
        rows += [mit, unmit]
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="nemesis soak of the port")
    ap.add_argument("--protocol", default="MultiPaxos")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--matrix", action="store_true",
                    help=f"run {MATRIX_SEEDS} x "
                         f"{MATRIX_PROTOCOLS + MATRIX_EXTRA}")
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--ticks", type=int, default=DEFAULT_TICKS,
                    help="schedule horizon in nemesis ticks")
    ap.add_argument("--tick-len", type=float, default=0.25,
                    help="wall seconds per nemesis tick")
    ap.add_argument("--tick", type=float, default=0.005,
                    help="server tick interval")
    ap.add_argument("--budget-ticks", type=int, default=DEFAULT_BUDGET_TICKS,
                    help="recovery budget in server ticks after the heal")
    ap.add_argument("--min-ops", type=int, default=20)
    ap.add_argument("--groups", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="replica device (default cuda; cpu to run here)")
    ap.add_argument("--failslow", default=None, metavar="CLASS",
                    help=f"one gray-failure twin pair of this class "
                         f"{FAILSLOW_CLASSES} against --protocol")
    ap.add_argument("--failslow-matrix", action="store_true",
                    help=f"{FAILSLOW_CLASSES} x {FAILSLOW_PROTOCOLS}")
    ap.add_argument("--out", default=None,
                    help="write the verdict rows here as JSON")
    args = ap.parse_args(argv)

    if args.failslow or args.failslow_matrix:
        pairs = ([(p, c) for c in FAILSLOW_CLASSES
                  for p in FAILSLOW_PROTOCOLS] if args.failslow_matrix
                 else [(args.protocol, args.failslow)])
        for _p, c in pairs:
            if c not in FAILSLOW_CLASSES:
                ap.error(f"unknown fail-slow class {c!r}")
        results = run_failslow_pairs(
            pairs, clients=args.clients, tick=args.tick,
            budget_ticks=args.budget_ticks, groups=args.groups,
            device=args.device, out=args.out)
    else:
        runs = ([(p, s) for p in MATRIX_PROTOCOLS + MATRIX_EXTRA
                 for s in MATRIX_SEEDS] if args.matrix
                else [(args.protocol, args.seed)])
        results = []
        for protocol, seed in runs:
            r = run_one(protocol, seed, replicas=args.replicas,
                        clients=args.clients, ticks=args.ticks,
                        tick_len=args.tick_len, tick=args.tick,
                        budget_ticks=args.budget_ticks,
                        min_ops=args.min_ops, groups=args.groups,
                        device=args.device, out=args.out)
            status = "PASS" if r["ok"] else f"FAIL ({r.get('error')})"
            print(f"=== {protocol} seed={seed}: {status} "
                  f"(ops={r.get('num_ops')}, "
                  f"recovery={r.get('recovery_s')} s)", flush=True)
            results.append(r)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
        print(f"wrote {args.out}", flush=True)
    sys.stdout.flush()
    sys.stderr.flush()
    # replica threads are daemons; leave without joining them
    os._exit(0 if all(r["ok"] for r in results) else 1)


if __name__ == "__main__":
    sys.exit(main())
