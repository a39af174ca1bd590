"""The tracing and metrics planes of the port against the JAX package.

Each case feeds the same seeded stream to the JAX object and the port's:
the registry and its histograms (snapshots, quantiles, windows, merges,
burn fractions), slot traces, the flight recorder (wall-clock stamps
normalized, every other field exact), graftwatch's emitter, fleet ring,
windows and SLO policy (the schedules of ``tests/test_graftwatch.py``),
the device lanes' ``snapshot_row``, and a serving lockstep of three
replicas per package with the flight recorder, slot traces and graftwatch
on, compared tick by tick.
"""

import json
import os
import random
import sys
import time

import numpy as np
import pytest
import torch

from summerset_tpu.core import telemetry as jcore
from summerset_tpu.host import graftwatch as jgw
from summerset_tpu.host import telemetry as jtel
from summerset_tpu.host import tracing as jtr
from summerset_tpu_torch.core import telemetry as tcore
from summerset_tpu_torch.host import graftwatch as tgw
from summerset_tpu_torch.host import telemetry as ttel
from summerset_tpu_torch.host import tracing as ttr

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_cluster import (  # noqa: E402
    lockstep_sides, lockstep_tick, shutdown_sides,
)
from test_torch_server import SIDES, lock_cfg  # noqa: E402

torch.set_num_threads(1)

PKGS = {"jax": (jtel, jtr, jgw), "torch": (ttel, ttr, tgw)}

NAMES = ("api_request_latency_us", "wal_fsync_us", "api_requests_total",
         "api_shed", "scan_served", "scan_shed", "commits_applied_total")


def registry_ops(seed, n=400):
    """A seeded stream of registry writes: (kind, name, value, labels)."""
    rng = random.Random(seed)
    ops = []
    for _ in range(n):
        kind = rng.choice("cgh")
        name = rng.choice(NAMES)
        labels = {} if rng.random() < 0.6 else {"peer": rng.randrange(3)}
        if kind == "h":
            # samples spanning many power-of-two buckets, zeros included
            v = 0 if rng.random() < 0.05 else int(rng.lognormvariate(8, 2))
        elif kind == "c":
            v = rng.randrange(0, 5)
        else:
            v = round(rng.random() * 100, 3)
        ops.append((kind, name, v, labels))
    return ops


def run_ops(tel, ops, reg=None):
    reg = reg if reg is not None else tel.MetricsRegistry()
    for kind, name, v, labels in ops:
        if kind == "c":
            reg.counter_add(name, v, **labels)
        elif kind == "g":
            reg.gauge_set(name, v, **labels)
        else:
            reg.observe(name, v, **labels)
    return reg


def hist_views(tel, reg, prev):
    """Every derived view of every histogram in ``reg``."""
    out = {}
    for key in sorted(reg.snapshot()["histograms"]):
        name, _, rest = key.partition("{")
        labels = dict(kv.split("=") for kv in rest.rstrip("}").split(",")
                      if kv)
        labels = {k: int(v) for k, v in labels.items()}
        h = reg.hist(name, **labels)
        p = prev.get(key)
        win = h.since(p)
        back = (p.copy() if p is not None else tel.Histogram()).merge(win)
        snap = json.loads(json.dumps(h.snapshot()))
        out[key] = {
            "q": [h.quantile(q) for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0)],
            "over": [h.frac_over(t) for t in (0, 1, 100, 3000, 10 ** 6)],
            "win": win.snapshot(),
            "back": back.snapshot(),
            "json": tel.Histogram.from_snapshot(snap).snapshot(),
        }
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_registry_and_histograms_equal_jax(seed):
    got = {}
    for name, (tel, _tr, _gw) in PKGS.items():
        ops = registry_ops(seed)
        reg = run_ops(tel, ops[:200])
        _c, _g, prev = reg.export_raw()
        prev = {k: h for k, h in prev.items()}
        run_ops(tel, ops[200:], reg)
        counters, gauges, hists = reg.export_raw()
        got[name] = {
            "snap": reg.snapshot(),
            "names": sorted(reg.names()),
            "raw": (counters, gauges,
                    {k: h.snapshot() for k, h in hists.items()}),
            "views": hist_views(tel, reg, prev),
        }
        json.dumps(got[name]["snap"])
    assert got["jax"] == got["torch"]


def trace_stream(seed, n=300):
    """Seeded slot-trace events with explicit times (no wall clock)."""
    rng = random.Random(seed)
    ev = []
    for i in range(n):
        g, vid = rng.randrange(4), rng.randrange(1, 40)
        t = rng.randrange(1, 100)
        kind = rng.choice(["start", "start", "commit", "apply", "reply"])
        ev.append((kind, g, vid, t, 1000.0 + i * 0.001,
                   rng.randrange(10), rng.randrange(1000)))
    return ev


def norm_dump(d):
    """A flight dump with its wall-clock stamps taken out."""
    d = dict(d)
    for k in ("t_start_us", "t_dump_us"):
        d.pop(k, None)
    d["events"] = [{k: v for k, v in e.items() if k != "t_us"}
                   for e in d["events"]]
    return d


@pytest.mark.parametrize("sample_every", [1, 3])
def test_slot_traces_equal_jax(sample_every):
    got = {}
    for name, (tel, tr, _gw) in PKGS.items():
        reg = tel.MetricsRegistry()
        flight = tr.FlightRecorder(capacity=64, me=1)
        traces = tel.SlotTraces(reg, sample_every=sample_every,
                                flight=flight)
        for kind, g, vid, t, now, client, rid in trace_stream(7):
            if kind == "start":
                traces.maybe_start(g, vid, t, now, client=client,
                                   req_id=rid)
            elif kind == "commit":
                traces.mark_committed(g, vid, t)
            elif kind == "apply":
                traces.mark_applied(g, vid, t)
            else:
                traces.mark_replied(g, vid, now + 0.0125)
        got[name] = (traces.sampled(), reg.snapshot(),
                     norm_dump(flight.dump()))
    assert got["jax"] == got["torch"]
    assert got["torch"][0], "no trace completed"


def flight_stream(seed, n=500):
    rng = random.Random(seed)
    types = list(jtr.EVENT_TYPES)
    out = []
    for i in range(n):
        # a skewed type mix: frames dominate, as on a leader's ring
        et = (rng.choice(["frame_tx", "frame_rx", "tick"])
              if rng.random() < 0.8 else rng.choice(types))
        out.append((et, {"tick": i, "peer": rng.randrange(3),
                         "seq": rng.randrange(1000)}))
    return out


@pytest.mark.parametrize("capacity,enabled", [(16, True), (64, True),
                                              (8192, True), (64, False)])
def test_flight_recorder_equal_jax(capacity, enabled):
    assert ttr.EVENT_TYPES == jtr.EVENT_TYPES
    assert ttr.SCHEMA_VERSION == jtr.SCHEMA_VERSION == 2
    got = {}
    for name, (tel, tr, _gw) in PKGS.items():
        fr = tr.FlightRecorder(capacity=capacity, enabled=enabled, me=2)
        reg = tel.MetricsRegistry()
        views = []
        for i, (et, fields) in enumerate(flight_stream(capacity)):
            fr.record(et, **fields)
            if i % 97 == 0:
                fr.publish_drops(reg)
                views.append(norm_dump(fr.dump(last_n=5)))
        fr.publish_drops(reg)
        fr.publish_drops(reg)  # a repeated scrape adds nothing
        d = fr.dump()
        assert sum(d["dropped_by_type"].values()) == d["dropped"]
        assert d["dropped"] == d["count"] - len(d["events"])
        tail = [line.split(" ", 2)[0] + " " + line.split(" ", 2)[2]
                for line in fr.tail(8)]
        got[name] = (norm_dump(d), views, reg.snapshot(), tail,
                     norm_dump(fr.dump(last_n=0)))
        with pytest.raises(KeyError):
            if enabled:
                fr.record("no_such_type")
            else:
                raise KeyError("off")
    assert got["jax"] == got["torch"]


def plain(x):
    """Histograms (of either package) as their snapshots, recursively."""
    if hasattr(x, "snapshot") and hasattr(x, "buckets"):
        return x.snapshot()
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def watch_run(tel, gw, seed, span=10, ticks=120, sids=(0, 1, 2),
              drop=None):
    """Three servers' registries written from one seeded stream, one
    frame per span, ingested into a fleet ring (``drop`` = (sid, widx)
    frames lost, a crashed replica's partial window)."""
    rng = random.Random(seed)
    regs = {s: tel.MetricsRegistry() for s in sids}
    ems = {s: gw.WatchEmitter(regs[s], s, span_ticks=span) for s in sids}
    fleet = gw.FleetSeries(retain=8)
    frames = []
    for t in range(1, ticks + 1):
        for s in sids:
            reg = regs[s]
            reg.counter_add("api_requests_total", rng.randrange(5))
            if rng.random() < 0.2:
                reg.counter_add("api_shed", rng.randrange(3))
            if rng.random() < 0.3:
                reg.counter_add("scan_served", 1)
            if rng.random() < 0.05:
                reg.counter_add("scan_shed", 1)
            for _ in range(rng.randrange(3)):
                reg.observe("api_request_latency_us",
                            int(rng.lognormvariate(10, 1.5)),
                            plane="api" if rng.random() < 0.5 else "p2p")
            reg.observe("wal_fsync_us", int(rng.lognormvariate(7, 1)))
            reg.gauge_set("api_queue_depth", rng.randrange(10))
            if t % span == 0:
                fr = ems[s].frame(t)
                frames.append(fr)
                if drop is None or (s, fr["widx"]) != drop:
                    fleet.ingest(s, json.loads(json.dumps(fr)))
    exp = fleet.export()
    return regs, frames, exp


@pytest.mark.parametrize("seed,drop", [(1, None), (2, (1, 5))])
def test_watch_fleet_and_slo_equal_jax(seed, drop):
    got = {}
    for name, (tel, _tr, gw) in PKGS.items():
        regs, frames, exp = watch_run(tel, gw, seed, drop=drop)
        wins = gw.windows(exp)
        pol = gw.SloPolicy(fast_windows=2, slow_windows=4)
        for w in wins:
            pol.observe_window(w)
        got[name] = plain({
            "frames": frames, "export": exp, "windows": wins,
            "status": pol.status(), "history": pol.history,
            "series": gw.evaluate_series(exp),
            "tier": gw.windows(exp, tier="proxy"),
            "base": [gw.base_name(k) for k in
                     ("a", "api_shed{peer=1}", "x{a=1,b=2}")],
            "burn": [gw.SloPolicy.window_burn(o, w)
                     for o in gw.DEFAULT_OBJECTIVES for w in wins],
        })
        if drop is None:
            # lossless: the frames' deltas add up to the cumulative
            # counters of the last frame's registry state
            for s, reg in regs.items():
                tot = sum(f["counters"].get("api_requests_total", 0)
                          for f in frames if f["sid"] == s)
                assert tot == reg.counter_value("api_requests_total")
    assert got["jax"] == got["torch"]
    assert tgw.DEFAULT_OBJECTIVES == jgw.DEFAULT_OBJECTIVES


@pytest.mark.parametrize("G", [8, 100])
def test_snapshot_row_equal_jax(G):
    import jax.numpy as jnp

    rng = np.random.default_rng(G)
    block = rng.integers(0, 2 ** 30, size=(G, 3, tcore.K), dtype=np.int32)
    assert tcore.LANES == jcore.LANES
    for me in range(3):
        want = jcore.snapshot_row(jnp.asarray(block), me)
        assert tcore.snapshot_row(torch.from_numpy(block), me) == want
        assert tcore.snapshot_row(block, me) == want
    json.dumps(want)


# ------------------------------------------------ serving lockstep, planes on
TRACE_CFG = {"flight_record": True, "trace_sample": 2, "graftwatch": True,
             "watch_ticks": 5, "health_enabled": False}
#: histograms whose samples are wall-clock durations (compared by count)
TIMED = ("loop_stage_us", "wal_fsync_us", "watch_emit_us",
         "api_request_latency_us", "reshard_cutover_us")
#: flight event fields that carry wall-clock durations
TIMED_FIELDS = ("dur_us", "wait_us")


def norm_watch(frame):
    f = dict(frame)
    f["hists"] = {k: (v if k.split("{")[0] not in TIMED else v["count"])
                  for k, v in f["hists"].items()}
    return f


def norm_event(e):
    e = {k: v for k, v in e.items() if k not in ("t_us",) + TIMED_FIELDS}
    if e["type"] == "tick":
        # stage durations: which stages ran, not how long they took
        e = {k: (v if k in ("n", "type", "tick", "pipelined") else 0)
             for k, v in e.items()}
    return e


def norm_metrics(snap):
    host = dict(snap["host"])
    # pp_bytes meters pickled payload sizes, and the two packages pickle
    # different class paths; pp_items holds the count exactly
    host["gauges"] = {k: v for k, v in host["gauges"].items()
                      if not k.startswith("pp_bytes")}
    host["histograms"] = {
        k: (v if k.split("{")[0] not in TIMED else v["count"])
        for k, v in host["histograms"].items()
    }
    traces = [{k: v for k, v in tr.items() if k != "latency_ms"}
              for tr in snap["traces"]]
    return dict(snap, host=host, traces=traces)


def test_tracing_planes_serving_lockstep(tmp_path):
    """MultiPaxos, three replicas per package, the flight recorder, slot
    traces (every second batch) and graftwatch (every 5 ticks) on: frames,
    replies, WAL records, state digests, the watch frames each replica
    sends the manager and the final ``metrics_dump``/``flight_dump``
    scrapes are equal per tick (durations normalized)."""
    cfg = dict(lock_cfg("MultiPaxos"), **TRACE_CFG)
    sides = lockstep_sides(tmp_path, "MultiPaxos", SIDES, cfg, 2, 3, 16)
    try:
        for t in range(30):
            seen = lockstep_tick(sides, t, mute=0 if 12 <= t < 20 else None)
            for k in ("frames", "state", "wal", "replies", "kv"):
                assert seen["jax"][k] == seen["torch"][k], (t, k)
            ctrl = {}
            for name, s in seen.items():
                ctrl[name] = [[(kind, norm_watch(p) if kind == "watch_frame"
                                else p) for kind, p in sent]
                              for sent in s["ctrl"]]
            assert ctrl["jax"] == ctrl["torch"], t
        scrape = {}
        for name, (reps, *_rest) in sides.items():
            scrape[name] = [
                (norm_metrics(rep.metrics_snapshot()),
                 [norm_event(e) for e in
                  rep.flight_snapshot(last_n=200)["events"]],
                 rep.flight_snapshot()["device_lanes"])
                for rep in reps
            ]
            for rep in reps:
                json.dumps(rep.metrics_snapshot())
                json.dumps(rep.flight_snapshot())
        assert scrape["jax"] == scrape["torch"]
        snap = sides["torch"][0][0].metrics_snapshot()
        assert snap["traces"], "no slot trace completed"
        assert all(tr["tick_committed"] <= tr["tick_applied"]
                   for tr in snap["traces"])
        assert snap["device"]["lanes"]["commits"] > 0
    finally:
        shutdown_sides(sides)


def test_port_defaults_equal_jax(tmp_path):
    """The plane knobs' defaults equal the JAX server's: one replica of
    each package built with no config."""
    from test_torch_cluster import build

    import summerset_tpu.host.server as jsrv
    import summerset_tpu_torch.host.server as tsrv

    reps = []
    for name, mod, kw in (("jax", jsrv, {}), ("torch", tsrv,
                                               {"device": "cpu"})):
        reps.append(build(mod, "MultiPaxos", 0, 3, 1, 16,
                          tmp_path / name, {}, **kw))
    try:
        keys = ("health_enabled", "health_mitigation", "health_eval_ticks",
                "health_demote_ticks", "health_cooldown_ticks", "graftwatch",
                "watch_ticks", "seal_ttl_ticks")
        j, t = reps
        assert {k: getattr(j, k) for k in keys} == \
            {k: getattr(t, k) for k in keys}
        assert (j.flight.enabled, j.flight.capacity, j.traces.sample_every) \
            == (t.flight.enabled, t.flight.capacity, t.traces.sample_every)
        assert j.health is not None and t.health is not None
        assert j.metrics.snapshot()["counters"].keys() <= \
            t.metrics.snapshot()["counters"].keys() | {"wire_bytes_saved"}
    finally:
        for rep in reps:
            rep.shutdown()


# ---------------------------------------------- a live port cluster, G = 4
@pytest.fixture(scope="module")
def planes_cluster(tmp_path_factory):
    from summerset_tpu_torch.cluster import Cluster

    c = Cluster("MultiPaxos", 3, tmp_path_factory.mktemp("torch_planes"),
                num_groups=4, window=32,
                config={"hear_timeout_lo": 10, "hear_timeout_hi": 20,
                        "watch_ticks": 20}, device="cpu")
    c.manager.settle_delay = 0.2
    yield c
    c.stop()
    assert not c.faults(), f"replica faults: {c.faults()}"


class TestTorchPlanesCluster:
    """The port's manager and three port replicas (threads, sockets):
    the scrapes return every replica and are JSON-able, a gather names a
    replica that missed its deadline, and a ``range_change`` installs at
    all three with every acked key read back through its new group."""

    def _driver(self, c):
        from summerset_tpu_torch.client import DriverClosedLoop

        ep = c.endpoint()
        return ep, DriverClosedLoop(ep, timeout=3.0)

    def test_scrapes_return_every_replica(self, planes_cluster):
        from summerset_tpu_torch.client.endpoint import (
            scrape_fleet, scrape_flight, scrape_metrics,
        )

        c = planes_cluster
        ep, drv = self._driver(c)
        try:
            acked = sum(drv.checked_put(f"s{i}", f"v{i}", retries=40)
                        .kind == "success" for i in range(12))
        finally:
            ep.leave()
        assert acked == 12
        m = scrape_metrics(c.manager_addr)
        assert sorted(m) == ["0", "1", "2"]
        json.dumps(m)
        for snap in m.values():
            assert set(snap["device"]["lanes"]) == set(tcore.LANES)
            assert snap["host"]["counters"]["leader_demotions"] == 0
            assert snap["host"]["histograms"]["loop_stage_us{stage=intake}"]
        lead = max(m.values(), key=lambda s: s["device"]["lanes"]["commits"])
        assert lead["host"]["counters"]["commits_applied_total"] >= acked
        f = scrape_flight(c.manager_addr, last_n=40)
        assert sorted(f) == ["0", "1", "2"]
        json.dumps(f)
        for d in f.values():
            assert d["v"] == 2 and len(d["events"]) == 40
            assert sum(d["dropped_by_type"].values()) == d["dropped"]
        deadline = time.monotonic() + 30
        while True:
            fleet = scrape_fleet(c.manager_addr)
            sids = {s["sid"] for s in (fleet or {}).get("series", ())}
            if sids == {0, 1, 2} or time.monotonic() > deadline:
                break
            time.sleep(0.5)
        assert sids == {0, 1, 2}
        json.dumps(fleet)

    def test_gather_names_the_server_past_its_deadline(self,
                                                       planes_cluster):
        from summerset_tpu_torch.client.endpoint import scrape_metrics
        from summerset_tpu_torch.host.messages import CtrlRequest

        c = planes_cluster
        slow = c.replicas[2]
        orig = slow.metrics_snapshot

        def limping():
            time.sleep(2.5)
            return orig()

        slow.metrics_snapshot = limping
        c.manager.gather_timeout = 1.0
        try:
            ep = c.endpoint()
            try:
                t0 = time.monotonic()
                rep = ep.ctrl.request(CtrlRequest("metrics_dump"),
                                      timeout=30)
                took = time.monotonic() - t0
            finally:
                ep.leave()
            assert rep.missing == [2] and sorted(rep.payloads) == [0, 1]
            assert took < 2.4
        finally:
            slow.metrics_snapshot = orig
            c.manager.gather_timeout = 5.0
            time.sleep(2.0)  # the late reply drains
        assert sorted(scrape_metrics(c.manager_addr)) == ["0", "1", "2"]

    def test_range_change_installs_everywhere(self, planes_cluster):
        from summerset_tpu_torch.host.messages import CtrlRequest
        from summerset_tpu_torch.host.resharding import single_key_range

        c = planes_cluster
        key = "rk7"
        home = c.replicas[0].group_of(key)
        dst = (home + 1) % 4
        ep, drv = self._driver(c)
        try:
            assert drv.checked_put(key, "before", retries=40).kind == \
                "success"
            start, end = single_key_range(key)
            rep = ep.ctrl.request(CtrlRequest("range_change", payload={
                "op": "split", "start": start, "end": end,
                "dst_group": dst}), timeout=60)
            rc_id = rep.conf["rc_id"]
            assert sorted(rep.done) == [0, 1, 2]
            deadline = time.monotonic() + 60
            while True:
                info = ep.ctrl.request(CtrlRequest("query_info"))
                ok = any(e["rc_id"] == rc_id for e in info.ranges or ())
                routed = all(r.route_group(key) == dst
                             for r in c.replicas.values())
                if (ok and routed) or time.monotonic() > deadline:
                    break
                time.sleep(0.2)
            assert ok and routed
            assert drv.checked_get(key, "before", retries=40)
            assert drv.checked_put(key, "after", retries=40).kind == \
                "success"
            assert drv.checked_get(key, "after", retries=40)
        finally:
            ep.leave()


#: the modules this slice added to the port, each imported alone in a
#: clean interpreter (``tests/conftest.py`` imports jax into this one)
PLANE_MODULES = tuple("summerset_tpu_torch." + m for m in (
    "host.tracing", "host.graftwatch", "host.health", "host.resharding",
    "host.autopilot", "utils.keyrange",
))


@pytest.mark.parametrize("module", PLANE_MODULES)
def test_plane_module_alone_imports_no_jax(module):
    from test_torch_isolation import _ALONE, _run

    proc = _run(["-c", _ALONE, module])
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
