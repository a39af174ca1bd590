"""The port's ingress proxy tier (``summerset_tpu_torch/host/ingress.py``,
``client/muxfleet.py``, the manager's proxy registry, the endpoint's
proxy mode) against the JAX package's, on the CPU.

Units, each run through the JAX object and the port's on the same inputs
and compared at every step: ``RoutingTable`` (the update sequences of
``tests/test_ingress.py``: owner per key, write target, read-tier
upstream, leader, version), ``LearnerReadTier`` (probe, reply and expiry
sequences against a fake proxy in each package: replies, fallbacks,
counters, the backlog gauge, flight events), ``Bitmap`` and
``RespondersConf``, the manager's ``proxy_join`` handling and the
endpoint's proxy-mode selection and failover walk for the same
``query_info`` replies.  The mux fleet runs against an echo
``ExternalApi``.  The live tier runs on a port cluster on the CPU with
two proxies in front: round trips, a pinned client bypassing the tier,
dedupe, range-override steering, the commit feed, a proxy crash with
rediscovery and restart, the same crash played by ``NemesisRunner``
from ``FaultPlan.proxy_crash``, and QuorumLeases learner reads.
"""

import asyncio
import collections
import json
import os
import socket
import subprocess
import sys
import threading
import time
import types

import pytest

from summerset_tpu.client import endpoint as jep
from summerset_tpu.client import muxfleet as jmux
from summerset_tpu.host import ingress as jing
from summerset_tpu.host import messages as jmsg
from summerset_tpu.host import statemach as jsm
from summerset_tpu.host import telemetry as jtel
from summerset_tpu.host import tracing as jtr
from summerset_tpu.manager import clusman as jman
from summerset_tpu.utils import bitmap as jbm
from summerset_tpu.utils import keyrange as jkr
from summerset_tpu.utils.errors import SummersetError as JError
from summerset_tpu_torch.client import endpoint as tep
from summerset_tpu_torch.client import muxfleet as tmux
from summerset_tpu_torch.client.drivers import DriverClosedLoop
from summerset_tpu_torch.cluster import Cluster, free_ports
from summerset_tpu_torch.host import ingress as ting
from summerset_tpu_torch.host import messages as tmsg
from summerset_tpu_torch.host import statemach as tsm
from summerset_tpu_torch.host import telemetry as ttel
from summerset_tpu_torch.host import tracing as ttr
from summerset_tpu_torch.host.external import ExternalApi
from summerset_tpu_torch.host.messages import ApiReply, ApiRequest, CtrlRequest
from summerset_tpu_torch.host.nemesis import FaultPlan, NemesisRunner
from summerset_tpu_torch.host.statemach import Command, CommandResult
from summerset_tpu_torch.manager import clusman as tman
from summerset_tpu_torch.utils import bitmap as tbm
from summerset_tpu_torch.utils import keyrange as tkr
from summerset_tpu_torch.utils import safetcp
from summerset_tpu_torch.utils.errors import SummersetError as TError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = types.SimpleNamespace(ing=jing, msg=jmsg, sm=jsm, tel=jtel, tr=jtr,
                            bm=jbm, kr=jkr, err=JError, ep=jep, man=jman)
PORT = types.SimpleNamespace(ing=ting, msg=tmsg, sm=tsm, tel=ttel, tr=ttr,
                             bm=tbm, kr=tkr, err=TError, ep=tep, man=tman)


def test_constants_and_declared_series_equal_jax():
    assert ting.LEARNER_ID_OFFSET == jing.LEARNER_ID_OFFSET == 500_000
    assert ting.SCRAPE_CLIENT_ID == jing.SCRAPE_CLIENT_ID == 900_000
    assert tmux.FLEET_ID_BASE == jmux.FLEET_ID_BASE == 10_000_000
    assert ttel.PROXY_DECLARED == jtel.PROXY_DECLARED
    assert len(ttel.PROXY_DECLARED) == len(set(ttel.PROXY_DECLARED))


# ------------------------------------------------------------ RoutingTable
S2 = {0: ("h", 1), 1: ("h", 2)}
S3 = {0: ("h", 1), 1: ("h", 2), 2: ("h", 3)}
RANGES = [("a", "c", 1), ("c", "d", 2)]
#: the update sequences of tests/test_ingress.py::TestRoutingTable
ROUTING_CASES = {
    "default_full_range_to_leader": [("update", S3, 1, None)],
    "no_leader_falls_back_to_lowest_sid": [
        ("update", {2: ("h", 3), 0: ("h", 1)}, None, None)],
    "note_leader_rebuilds_but_keeps_overrides": [
        ("update", S2, 0, None), ("set_owner", "a", "m", 1), ("note", 1)],
    "negative_hint_ignored": [("update", {0: ("h", 1)}, 0, None),
                              ("note", -1)],
    "reader_prefers_non_leader_responder": [
        ("update", S3, 0, [0, 2]), ("update", S3, 0, []),
        ("update", {0: ("h", 1)}, 0, [])],
    "set_owner_same_span_replaces": [
        ("update", S2, 0, None), ("set_owner", "a", "b", 1),
        ("set_owner", "a", "b", 0), ("set_owner", "a", "b", 1)],
    "dead_sid_override_falls_back": [
        ("update", S2, 0, None), ("set_owner", "a", "b", 1),
        ("update", {0: ("h", 1)}, 0, None), ("update", S2, 0, None)],
    "installed_ranges_below_manual_overrides": [
        ("update", S3, 0, None), ("set_ranges", RANGES),
        ("set_owner", "a", "b", 2), ("set_ranges", RANGES)],
    "scan_start_key_routes_to_range_owner": [
        ("update", S3, 0, None), ("set_ranges", RANGES)],
}
#: per case, after the last step: (key, owner), write target, reader
ROUTING_EXPECT = {
    "default_full_range_to_leader": ([("", 1), ("zzz", 1)], 1, None),
    "no_leader_falls_back_to_lowest_sid": ([("k", 0)], None, None),
    "note_leader_rebuilds_but_keeps_overrides": ([("x", 1), ("b", 1)], 1,
                                                 None),
    "negative_hint_ignored": ([("k", 0)], 0, None),
    "reader_prefers_non_leader_responder": ([("k", 0)], 0, "none"),
    "set_owner_same_span_replaces": ([("a", 1)], 0, None),
    "dead_sid_override_falls_back": ([("a", 1)], 0, None),
    "installed_ranges_below_manual_overrides": (
        [("a", 2), ("b", 1), ("c", 2)], 0, None),
    "scan_start_key_routes_to_range_owner": (
        [("a", 1), ("b\x00", 1), ("c", 2), ("d", 0)], 0, None),
}
KEYS = ("", "a", "b", "b\x00", "c", "d", "k", "m", "x", "zzz")


def _route_observe(rt):
    return (tuple(rt.owner_for(k) for k in KEYS), rt.write_target(),
            rt.reader_sid(), rt.leader, rt.version, len(rt._overrides),
            list(rt.responders))


def _route_run(pkg, steps):
    rt = pkg.ing.RoutingTable()
    trace = [_route_observe(rt)]
    for op, *args in steps:
        if op == "update":
            servers, leader, responders = args
            rt.update(servers, leader=leader, responders=responders)
        elif op == "note":
            rt.note_leader(args[0])
        elif op == "set_owner":
            rt.set_owner(*args)
        else:
            rt.set_ranges(list(args[0]))
        trace.append(_route_observe(rt))
    return rt, trace


@pytest.mark.parametrize("case", sorted(ROUTING_CASES))
def test_routing_table_equals_jax(case):
    """The same update sequence through the JAX ``RoutingTable`` and the
    port's: owners, write target, reader, leader, version and override
    count equal after every step; the JAX test's expectations hold."""
    steps = ROUTING_CASES[case]
    _jrt, jtrace = _route_run(JAX, steps)
    rt, ptrace = _route_run(PORT, steps)
    assert ptrace == jtrace
    owners, target, reader = ROUTING_EXPECT[case]
    for key, sid in owners:
        assert rt.owner_for(key) == sid, (case, key)
    assert rt.write_target() == target if target is not None else True
    if reader == "none":
        assert rt.reader_sid() is None
    if case == "reader_prefers_non_leader_responder":
        assert ptrace[1][2] == 2 and ptrace[2][2] in (1, 2)
    if case == "set_owner_same_span_replaces":
        assert len(rt._overrides) == 1
    if case == "dead_sid_override_falls_back":
        assert ptrace[2][0][KEYS.index("a")] == 1
        assert ptrace[3][0][KEYS.index("a")] == 0
    if case == "installed_ranges_below_manual_overrides":
        assert ptrace[-1][4] == ptrace[-2][4]  # unchanged ranges: no churn
    if case == "negative_hint_ignored":
        assert ptrace[-1][4] == ptrace[-2][4]


# --------------------------------------------------------- LearnerReadTier
class FakeProxy:
    """Duck-typed ``IngressProxy`` core for ``LearnerReadTier`` (the
    routing table is empty, so the learner thread idles)."""

    def __init__(self, pkg):
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._requeue = collections.deque()
        self._pends = {}
        self.cid = 1234
        self.metrics = pkg.tel.MetricsRegistry()
        self.flight = pkg.tr.FlightRecorder(enabled=True, me=1234)
        self.routing = pkg.ing.RoutingTable()
        self.replies = []

    def _pop_pend(self, prid):
        return self._pends.pop(prid, None)

    def _drop_pend(self, prid):
        self._pop_pend(prid)

    def _reply_client(self, pend, reply, cache=True):
        self.replies.append((pend["client"], reply))


def _pend(pkg, cmd):
    return {"client": 3, "req_id": 40, "cmd": cmd}


def _seed_scan_state(lt):
    lt.kv = {"w1": "v1", "w2": "v2", "w3": "v3", "x9": "z"}
    lt._keys = sorted(lt.kv)
    lt.seq = 5


def _probe_reply(pkg, p, lt, cmd, ok, seq, learned_seq=5):
    lt.seq = learned_seq
    p._pends[9] = _pend(pkg, cmd)
    with p._lock:
        lt._probes[9] = time.monotonic() + 2
    lt._on_probe_reply(pkg.msg.ApiReply("probe", req_id=9, success=ok,
                                        seq=seq))


def _lt_not_ready(pkg, p, lt):
    return [lt.try_probe(1, pkg.sm.Command("get", "k"))]


def _lt_serves(pkg, p, lt):
    lt.kv = {"k": "v7"}
    _probe_reply(pkg, p, lt, pkg.sm.Command("get", "k"), True, 5)
    return []


def _lt_refused(pkg, p, lt):
    lt.kv = {}
    lt.ready = True
    lt._sock = object()  # never used: the refusal path only
    _probe_reply(pkg, p, lt, pkg.sm.Command("get", "k"), False, 5)
    # refusal backoff: the next probe is suppressed
    return [lt.try_probe(10, pkg.sm.Command("get", "k"))]


def _lt_stale(pkg, p, lt):
    _probe_reply(pkg, p, lt, pkg.sm.Command("get", "k"), True, 8,
                 learned_seq=3)
    return []


def _lt_expired(pkg, p, lt):
    p._pends[9] = _pend(pkg, pkg.sm.Command("get", "k"))
    with p._lock:
        lt._probes[9] = time.monotonic() - 1
    lt.expire_probes(time.monotonic())
    return [9 in p._pends, dict(lt._probes)]


def _lt_scan(pkg, p, lt):
    _seed_scan_state(lt)
    _probe_reply(pkg, p, lt, pkg.sm.Command("scan", "w1", end="w4",
                                            limit=2), True, 5)
    return []


def _lt_scan_stale(pkg, p, lt):
    _seed_scan_state(lt)
    _probe_reply(pkg, p, lt, pkg.sm.Command("scan", "w1", end="w4",
                                            limit=8), True, 8,
                 learned_seq=3)
    return []


def _lt_scan_learned(pkg, p, lt):
    _seed_scan_state(lt)
    return [lt.scan_learned("w2", None, 0), lt.scan_learned("w2", "w3", 0),
            lt.scan_learned("zz", None, 0), lt.scan_learned("w1", "x", 2)]


#: the unit cases of tests/test_ingress.py::TestLearnerUnit
LEARNER_CASES = {
    "not_ready_refuses_probe": _lt_not_ready,
    "probe_reply_serves_from_learned_state": _lt_serves,
    "refused_probe_falls_back_and_backs_off": _lt_refused,
    "stale_seq_falls_back": _lt_stale,
    "expired_probe_drops_pend": _lt_expired,
    "probe_reply_serves_scan_from_ordered_index": _lt_scan,
    "scan_stale_seq_falls_back_to_owner_path": _lt_scan_stale,
    "scan_learned_open_end_and_no_limit": _lt_scan_learned,
}


def _norm_api_reply(rep):
    res = rep.result
    return (rep.kind, rep.req_id, rep.success, rep.local, rep.seq,
            None if res is None else (res.kind, res.value, res.items))


def _learner_run(pkg, case):
    p = FakeProxy(pkg)
    lt = pkg.ing.LearnerReadTier(p)
    try:
        extra = LEARNER_CASES[case](pkg, p, lt)
    finally:
        p._stop.set()
    return {
        "extra": extra,
        "replies": [(c, _norm_api_reply(r)) for c, r in p.replies],
        "requeue": list(p._requeue),
        "pends": sorted(p._pends),
        "probes": sorted(lt._probes),
        "served": p.metrics.counter_value("read_tier_served"),
        "scans": p.metrics.counter_value("read_tier_scans"),
        "backlog": p.metrics.gauge_value("read_tier_backlog", -1.0),
        "events": [e["type"] for e in p.flight.dump()["events"]],
    }


@pytest.mark.parametrize("case", sorted(LEARNER_CASES))
def test_learner_read_tier_equals_jax(case):
    """The same probe, reply and expiry sequence through the JAX
    ``LearnerReadTier`` and the port's: equal replies, fallbacks,
    counters, backlog gauge and flight events."""
    j = _learner_run(JAX, case)
    p = _learner_run(PORT, case)
    assert p == j
    if case == "probe_reply_serves_from_learned_state":
        assert p["replies"] == [(3, ("reply", 40, True, True, 0,
                                     ("get", "v7", None)))]
        assert p["served"] == 1
    elif case in ("refused_probe_falls_back_and_backs_off",
                  "stale_seq_falls_back",
                  "scan_stale_seq_falls_back_to_owner_path"):
        assert p["requeue"] == [9] and not p["replies"]
        assert p["scans"] == 0
        if case.startswith("refused"):
            assert p["extra"] == [False]
    elif case == "expired_probe_drops_pend":
        assert p["extra"] == [False, {}]
    elif case == "probe_reply_serves_scan_from_ordered_index":
        assert p["replies"][0][1][5] == ("scan", None,
                                         (("w1", "v1"), ("w2", "v2")))
        assert p["served"] == p["scans"] == 1
        assert "scan_serve" in p["events"]
    elif case == "scan_learned_open_end_and_no_limit":
        assert p["extra"][:3] == [
            (("w2", "v2"), ("w3", "v3"), ("x9", "z")), (("w2", "v2"),), ()]
    else:
        assert p["extra"] == [False]


# ------------------------------------------------- Bitmap, RespondersConf
def _bitmap_ops(pkg):
    bm = pkg.bm.Bitmap(5)
    out = [bm.to_u32()]
    for i in (0, 3, 4):
        bm.set(i)
    out += [bm.to_u32(), bm.count(), bm.get(3), list(bm.iter_ones()),
            bm.to_list(), repr(bm)]
    bm.clear(3)
    bm.flip()
    out += [bm.to_u32(), list(bm.iter_ones())]
    other = pkg.bm.Bitmap.from_ids(5, [0, 2])
    bm.union(other)
    out += [bm.to_u32(), pkg.bm.Bitmap.from_u32(5, 0xFFFF).to_u32(),
            pkg.bm.Bitmap(3, ones=True).to_u32(),
            pkg.bm.Bitmap.from_ids(3, [1]) == pkg.bm.Bitmap.from_u32(3, 2)]
    bm.clear_all()
    out.append(bm.to_u32())
    bm.set_all()
    out.append(bm.to_u32())
    for bad in (lambda: pkg.bm.Bitmap(0), lambda: bm.get(5),
                lambda: bm.union(pkg.bm.Bitmap(4))):
        with pytest.raises(pkg.err):
            bad()
    return out


def test_bitmap_equals_jax():
    assert _bitmap_ops(PORT) == _bitmap_ops(JAX)


def _responders_ops(pkg):
    out = []
    rc = pkg.kr.RespondersConf(3)
    rc.set_leader(1)
    out += [rc.is_leader(1), rc.is_leader(0)]
    rc.set_responders(("a", "m"), pkg.bm.Bitmap.from_ids(3, [0, 2]))
    out += [rc.is_responder_by_key(k, r) for k in ("b", "z", "a", "m")
            for r in range(3)]
    rc2 = pkg.kr.RespondersConf(3)
    rc2.set_responders(None, pkg.bm.Bitmap.from_ids(3, [2]), leader=0)
    out += [rc2.is_responder_by_key("anything", 2), rc2.leader,
            rc2.responders_for_key("q").to_u32(), repr(rc2)]
    rc2.set_responders(("c", "e"), pkg.bm.Bitmap.from_ids(3, [1]))
    out += [rc2.responders_for_key(k).to_u32() for k in ("b", "c", "e")]
    with pytest.raises(pkg.err):
        rc.set_leader(3)
    with pytest.raises(pkg.err):
        rc.set_responders(None, pkg.bm.Bitmap.from_ids(4, [0]))
    return out


def test_responders_conf_equals_jax():
    out = _responders_ops(PORT)
    assert out == _responders_ops(JAX)
    # the JAX test's expectations: leader, range membership, full range
    assert out[:2] == [True, False]
    assert out[2:5] == [True, False, True]       # "b": responders {0, 2}
    assert out[5:8] == [False, False, False]     # "z": outside the range


# ----------------------------------------------------------- the manager
def _manager_replies(pkg):
    async def run():
        m = pkg.man.ClusterManager("MultiPaxos", ("127.0.0.1", 1),
                                   ("127.0.0.1", 2), 3)
        out = []
        for cid, payload in ((1005, {"api_addr": ["127.0.0.1", 4100]}),
                             (1006, {"api_addr": ["127.0.0.1"]}),
                             (None, {"api_addr": ["127.0.0.1", 4101]}),
                             (1007, None)):
            rep = await m._handle_request(
                pkg.msg.CtrlRequest("proxy_join", payload=payload), cid=cid)
            out.append((rep.kind, rep.done))
        info = await m._handle_request(pkg.msg.CtrlRequest("query_info"))
        out.append(info.proxies)
        return out

    return asyncio.run(run())


def test_manager_proxy_join_equals_jax():
    """``proxy_join`` registers a proxy under its ctrl cid (refusing a
    malformed address or an unknown connection), and ``query_info``
    lists it, in both packages alike."""
    out = _manager_replies(PORT)
    assert out == _manager_replies(JAX)
    assert out[0] == ("proxy_join", [1005])
    assert out[-1] == {1005: ("127.0.0.1", 4100)}


# ------------------------------------------------------------ the endpoint
def _info(pkg, servers, leader, proxies):
    return pkg.msg.CtrlReply("info", population=3, servers=servers,
                             leader=leader, proxies=proxies)


SERVERS = {0: (("127.0.0.1", 5000), "p0"), 1: (("127.0.0.1", 5001), "p1"),
           2: (("127.0.0.1", 5002), "p2")}
PROXIES = {1001: ("127.0.0.1", 6001), 1004: ("127.0.0.1", 6004),
           1002: ("127.0.0.1", 6002)}


def _endpoint_walk(pkg, cid, via_proxy, prefer, proxies, leader, dead):
    """Connect, then rotate twice, on an endpoint whose ctrl stub answers
    ``query_info`` with the given membership and whose connects to the
    targets in ``dead`` fail; returns what it chose at every step."""
    infos = [_info(pkg, SERVERS, leader, dict(proxies)),
             _info(pkg, SERVERS, leader, dict(proxies)),
             _info(pkg, SERVERS, leader, {})]
    ep = object.__new__(pkg.ep.GenericEndpoint)
    ep.__dict__.update(id=cid, prefer=prefer, via_proxy=via_proxy,
                       wire_codec=None, api=None, servers={}, proxies={},
                       proxy_mode=False, current=None, leader_cache=None)
    ep.ctrl = types.SimpleNamespace(
        request=lambda req, timeout=None: infos.pop(0) if infos
        else _info(pkg, SERVERS, leader, {}))
    tried = []

    def connect_to(sid, timeout=None):
        pool = ep.proxies if ep.proxy_mode else ep.servers
        tried.append((sid, ep.proxy_mode, pool[sid] if ep.proxy_mode
                      else pool[sid][0]))
        if sid in dead:
            raise OSError("refused")
        ep.current = sid

    ep._connect_to = connect_to
    ep.connect()
    steps = [(ep.proxy_mode, ep.current)]
    for _ in range(2):
        ep.rotate()
        steps.append((ep.proxy_mode, ep.current))
    return tried, steps


@pytest.mark.parametrize("cid", [1000, 1003])
@pytest.mark.parametrize("via_proxy,prefer", [
    ("auto", None), ("auto", 2), (True, 2), (False, None)])
@pytest.mark.parametrize("proxies", [{}, PROXIES], ids=["none", "three"])
def test_endpoint_proxy_mode_equals_jax(cid, via_proxy, prefer, proxies):
    """For the same ``query_info`` replies (proxies registered, then the
    tier gone) the JAX endpoint and the port's choose the same mode and
    the same targets on connect and on every rotate."""
    args = (cid, via_proxy, prefer, proxies, 1, {1004})
    got = _endpoint_walk(PORT, *args)
    assert got == _endpoint_walk(JAX, *args)
    mode = bool(proxies) and (via_proxy is True or (
        via_proxy == "auto" and prefer is None))
    assert got[1][0][0] == mode
    if mode:
        assert got[1][0][1] == sorted(PROXIES)[cid % 3]
    assert got[1][-1][0] is False  # the tier is gone: back to replicas


# ----------------------------------------------------------- the mux fleet
@pytest.fixture()
def echo_api():
    """A bare port ``ExternalApi`` answering every ``req`` with a get
    result."""
    port = free_ports(1)[0]
    api = ExternalApi(("127.0.0.1", port), max_pending=64)
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            for client, req in api.get_req_batch(timeout=0.05):
                if req.kind == "req":
                    api.send_reply(ApiReply(
                        "reply", req_id=req.req_id,
                        result=CommandResult("get", value="x")), client)

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    yield ("127.0.0.1", port)
    stop.set()
    api.stop()


def test_fleet_frames_equal_jax():
    """The fleet's id frame and codec request frames are the JAX fleet's
    bytes (the codec encodes by struct id, not class path)."""
    assert tmux._frame(10_000_007) == jmux._frame(10_000_007)
    for cmd in (("put", "mk3", "abc"), ("get", "mk1", None)):
        t = tmux._frame(ApiRequest("req", req_id=5, cmd=Command(*cmd)),
                        codec=True)
        j = jmux._frame(jmsg.ApiRequest("req", req_id=5,
                                        cmd=jsm.Command(*cmd)), codec=True)
        assert t == j


def test_closed_loop_fleet(echo_api):
    out = tmux.run_fleet([echo_api], clients=50, secs=1.5, seed=3)
    assert out["connected_peak"] == 50
    assert out["acked"] > 50          # multiple rounds per client
    assert out["issued"] >= out["acked"]
    assert out["timeouts"] == 0
    assert out["lat_p50_ms"] > 0


def test_think_time_paces_offered_rate(echo_api):
    out = tmux.run_fleet([echo_api], clients=40, secs=2.0, seed=3,
                         think=1.0)
    assert out["connected_peak"] == 40
    # staggered first ops: ~secs/think * clients ops total, far below
    # the unpaced hot loop
    assert 0 < out["acked"] < 40 * 6


def test_fleet_worker_process(echo_api):
    """``python -m summerset_tpu_torch.client.muxfleet SPEC`` runs one
    worker: it logs its nofile limit and prints one FLEET_RESULT line."""
    spec = {"addrs": [list(echo_api)], "clients": 20, "secs": 1.0,
            "seed": 5, "id_base": 11_000_000}
    proc = subprocess.run(
        [sys.executable, "-m", "summerset_tpu_torch.client.muxfleet",
         json.dumps(spec)], cwd=REPO, capture_output=True, text=True,
        timeout=60, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert int(lines[0].split()[1]) >= 20 + 64
    out = json.loads(lines[-1][len("FLEET_RESULT "):])
    assert out["connected_peak"] == 20 and out["acked"] > 20


# ----------------------------------------------------------- the live tier
@pytest.fixture(scope="module")
def proxied_cluster(tmp_path_factory):
    """One MultiPaxos port cluster on the CPU with a 2-proxy serving plane
    in front (thread mode)."""
    c = Cluster("MultiPaxos", 3, tmp_path_factory.mktemp("ingress"),
                device="cpu")
    plane = ting.ServingPlane(c.manager_addr, proxies=2,
                              ports=free_ports(2)).start()
    yield c, plane
    plane.stop()
    c.stop()
    assert not c.faults(), c.faults()


def _fresh_ep(cluster, **kw):
    ep = tep.GenericEndpoint(cluster.manager_addr, **kw)
    ep.connect()
    return ep


def _proxy_counter(plane, name):
    return sum(p.metrics.counter_value(name)
               for p in plane.proxies if p is not None)


class TestLiveProxyServing:
    def test_roundtrips_through_proxy(self, proxied_cluster):
        cluster, plane = proxied_cluster
        ep = _fresh_ep(cluster)
        assert ep.proxy_mode, "client must auto-discover the proxy tier"
        drv = DriverClosedLoop(ep, timeout=10.0)
        for i in range(8):
            drv.checked_put(f"ik{i}", f"iv{i}")
        for i in range(8):
            drv.checked_get(f"ik{i}", expect=f"iv{i}")
        assert _proxy_counter(plane, "proxy_routed") > 0
        snaps = plane.scrape()
        assert sorted(snaps) == ["p0", "p1"]
        assert all(s["tier"] == "proxy" for s in snaps.values())
        # the proxy's embedded ExternalApi reports under proxy_*
        counters = [s["host"]["counters"] for s in snaps.values()]
        assert sum(c.get("proxy_requests_total", 0) for c in counters) > 0
        ep.leave()

    def test_direct_server_pin_bypasses_proxies(self, proxied_cluster):
        cluster, _plane = proxied_cluster
        ep = _fresh_ep(cluster, server_id=0)
        assert not ep.proxy_mode
        drv = DriverClosedLoop(ep, timeout=10.0)
        drv.checked_put("pin", "direct")
        ep.leave()

    def test_dedupe_replays_cached_reply(self, proxied_cluster):
        cluster, plane = proxied_cluster
        ep = _fresh_ep(cluster)
        assert ep.proxy_mode
        before = _proxy_counter(plane, "proxy_dedupe_hits")
        for _ in range(2):
            ep.api.send_req(ApiRequest(
                "req", req_id=1, cmd=Command("put", "ded", "v1")))
            rep = ep.recv_reply(timeout=10)
            assert rep.kind == "reply" and rep.req_id == 1
        assert _proxy_counter(plane, "proxy_dedupe_hits") == before + 1
        ep.leave()

    def test_range_override_steers_forwarded_batches(self, proxied_cluster):
        """A per-range owner override steers forwarded batches: the op
        forwards to the overridden follower first, survives the redirect
        retry, and the override holds across a routing refresh."""
        cluster, plane = proxied_cluster
        ep = _fresh_ep(cluster)
        assert ep.proxy_mode
        info = ep.ctrl.request(CtrlRequest("query_info"))
        leader = info.leader if info.leader is not None else 0
        follower = next(s for s in sorted(info.servers) if s != leader)
        live = [p for p in plane.proxies if p is not None]

        def fwd_to(sid):
            return sum(1 for p in live for e in p.flight.dump()["events"]
                       if e["type"] == "proxy_fwd" and e.get("sid") == sid)

        before = fwd_to(follower)
        for p in live:
            p.routing.set_owner("ovq", "ovr", follower)
        time.sleep(0.8)  # one refresh cycle must not drop the override
        assert all(p.routing.owner_for("ovq1") == follower for p in live)
        drv = DriverClosedLoop(ep, timeout=10.0)
        drv.checked_put("ovq1", "steered")
        drv.checked_get("ovq1", expect="steered")
        assert fwd_to(follower) > before
        for p in live:
            p.routing.set_owner("ovq", "ovr", leader)
        ep.leave()

    def test_commit_feed_subscribe_note_probe(self, proxied_cluster):
        """The read-tier seam raw: subscribe to a follower's commit feed,
        watch an applied put stream as a note, and probe (refused on
        MultiPaxos, which holds no leases, but carrying the feed seq)."""
        cluster, _plane = proxied_cluster
        ep = _fresh_ep(cluster)
        drv = DriverClosedLoop(ep, timeout=10.0)
        drv.checked_put("feedk", "feedv0")
        info = ep.ctrl.request(CtrlRequest("query_info"))
        leader = info.leader if info.leader is not None else 0
        sid = next(s for s in sorted(info.servers) if s != leader)
        sock = socket.create_connection(tuple(info.servers[sid][0]),
                                        timeout=5)
        sock.settimeout(10)
        safetcp.send_msg_sync(sock, 999_999 + ting.LEARNER_ID_OFFSET)
        safetcp.send_msg_sync(sock, ApiRequest("sub", req_id=3))
        sub = safetcp.recv_msg_sync(sock)
        assert sub.kind == "sub" and sub.success
        seq0 = sub.seq
        learned = dict(sub.notes or {})
        deadline = time.monotonic() + 20
        while learned.get("feedk") != "feedv0":
            assert time.monotonic() < deadline, "catch-up note never came"
            rep = safetcp.recv_msg_sync(sock)
            if rep.kind == "note":
                for _s, k, v in rep.notes:
                    learned[k] = v
        drv.checked_put("feedk", "feedv1")
        deadline = time.monotonic() + 20
        seen = None
        while seen is None and time.monotonic() < deadline:
            rep = safetcp.recv_msg_sync(sock)
            if rep.kind == "note":
                for s, k, v in rep.notes:
                    if k == "feedk" and v == "feedv1":
                        seen = (s, rep.seq)
        assert seen is not None, "commit note never arrived"
        assert seen[0] > seq0 and seen[1] >= seen[0]
        safetcp.send_msg_sync(sock, ApiRequest(
            "probe", req_id=4, cmd=Command("get", "feedk")))
        probe = None
        while probe is None:
            rep = safetcp.recv_msg_sync(sock)
            if rep.kind == "probe":
                probe = rep
        assert not probe.success
        assert probe.seq >= seen[0]
        sock.close()
        ep.leave()

    def test_manager_lists_and_drops_a_joined_proxy(self, proxied_cluster):
        """A ``proxy_join`` over a ctrl connection appears in
        ``query_info`` and is gone once that connection closes."""
        cluster, _plane = proxied_cluster
        stub = tep.ClientCtrlStub(cluster.manager_addr)
        rep = stub.request(CtrlRequest(
            "proxy_join", payload={"api_addr": ["127.0.0.1", 1]}))
        assert rep.done == [stub.id]
        probe = tep.ClientCtrlStub(cluster.manager_addr)
        try:
            info = probe.request(CtrlRequest("query_info"))
            assert info.proxies[stub.id] == ("127.0.0.1", 1)
            stub.close()
            deadline = time.monotonic() + 5
            while stub.id in (info.proxies or {}):
                assert time.monotonic() < deadline
                time.sleep(0.05)
                info = probe.request(CtrlRequest("query_info"))
            assert len(info.proxies) == 2
        finally:
            probe.close()

    def test_proxy_crash_rediscovery_and_restart(self, proxied_cluster):
        cluster, plane = proxied_cluster
        ep = _fresh_ep(cluster)
        assert ep.proxy_mode
        drv = DriverClosedLoop(ep, timeout=10.0)
        drv.checked_put("ck", "cv")
        victim = plane.ports.index(ep.api.sock.getpeername()[1])
        plane.crash_proxy(victim)
        drv.checked_put("ck", "cv2", retries=40)
        drv.checked_get("ck", expect="cv2")
        info = ep.ctrl.request(CtrlRequest("query_info"))
        assert len(info.proxies or {}) == 1
        plane.restart_proxy(victim)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            info = ep.ctrl.request(CtrlRequest("query_info"))
            if len(info.proxies or {}) == 2:
                break
            time.sleep(0.2)
        assert len(info.proxies or {}) == 2
        ep.leave()

    def test_nemesis_proxy_crash_plan(self, proxied_cluster):
        """``FaultPlan.proxy_crash`` played by ``NemesisRunner`` with
        ``proxy_ctl`` wired to the plane: no action error; between the
        crash and the restart the proxy is gone from ``query_info`` and a
        put acks through the survivor; after the restart both proxies are
        registered again."""
        cluster, plane = proxied_cluster
        plan = FaultPlan.proxy_crash(4, 3, 12, proxies=2, at=2,
                                     restart_after=4)
        seen, during = [], {}
        ep = _fresh_ep(cluster)
        # one driver for the whole test: a second one on the same client
        # would reuse request ids, which the proxies' dedupe answers from
        # their cache
        drv = DriverClosedLoop(ep, timeout=5.0)

        def check_down(_t, desc):
            seen.append(desc)
            if "proxy_crash" in desc:
                info = ep.ctrl.request(CtrlRequest("query_info"))
                during["proxies"] = len(info.proxies or {})
                t0 = time.monotonic()
                drv.checked_put("nemp", "v", retries=40)
                during["put_s"] = time.monotonic() - t0

        runner = NemesisRunner(cluster.manager_addr, plan, tick_len=0.25,
                               on_action=check_down)
        runner.proxy_ctl = plane.proxy_ctl
        try:
            runner.play()
        finally:
            runner.close()
        errors = [d for _t, d in runner.executed if "!error" in d]
        assert not errors, errors
        assert any("proxy_crash" in d for d in seen), seen
        assert during["proxies"] == 1 and during["put_s"] < 30
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            info = ep.ctrl.request(CtrlRequest("query_info"))
            if len(info.proxies or {}) == 2:
                break
            time.sleep(0.2)
        assert len(info.proxies or {}) == 2
        drv.checked_get("nemp", expect="v")
        ep.leave()

    def test_proxy_crash_without_a_plane_is_an_action_error(
            self, proxied_cluster):
        cluster, _plane = proxied_cluster
        plan = FaultPlan.proxy_crash(4, 3, 4, proxies=2, at=0,
                                     restart_after=1)
        runner = NemesisRunner(cluster.manager_addr, plan, tick_len=0.05)
        try:
            runner.play()
        finally:
            runner.close()
        errors = [d for _t, d in runner.executed if "!error" in d]
        assert len(errors) == 2, runner.executed


def _scan_items(drv, start, end, tries=40):
    """A scan retried through sheds and redirects; its items."""
    for _ in range(tries):
        rep = drv.scan(start, end)
        if rep.kind == "success":
            return tuple(rep.result.items)
        time.sleep(0.1)
    raise AssertionError(f"scan [{start}, {end}) never answered")


def test_quorum_leases_learner_reads(tmp_path):
    """QuorumLeases: once leases are granted everywhere, the learner read
    tier serves gets from its learned state (probe-gated), off the
    leader, and stays fresh across interleaved writes; one scan is
    served from learned state and equals a direct scan."""
    c = Cluster("QuorumLeases", 3, tmp_path, device="cpu")
    plane = ting.ServingPlane(c.manager_addr, proxies=1,
                              ports=free_ports(1)).start()
    try:
        ep = _fresh_ep(c)
        assert ep.proxy_mode
        drv = DriverClosedLoop(ep, timeout=10.0)
        drv.conf_change({"responders": [0, 1, 2]})
        time.sleep(2.0)  # learner subscribe + lease grants settle
        for i in range(3):
            drv.checked_put(f"qk{i}", f"qv{i}")
        time.sleep(1.5)
        for _ in range(3):
            for i in range(3):
                drv.checked_get(f"qk{i}", expect=f"qv{i}")
        proxy = plane.proxies[0]
        assert proxy.metrics.counter_value("read_tier_served") > 0
        snap = proxy.metrics_snapshot()
        assert snap["read_tier_upstream"] not in (None, c.leader_of(0))
        for i in range(6):
            drv.checked_put("qhot", f"qh{i}")
            drv.checked_get("qhot", expect=f"qh{i}")
        want = tuple((f"qk{i}", f"qv{i}") for i in range(3))
        deadline = time.monotonic() + 20
        while proxy.metrics.counter_value("read_tier_scans") == 0:
            assert time.monotonic() < deadline, "no learned scan served"
            assert _scan_items(drv, "qk", "ql") == want
            time.sleep(0.2)
        pin = _fresh_ep(c, server_id=c.leader_of(0))
        assert _scan_items(DriverClosedLoop(pin, timeout=10.0),
                           "qk", "ql") == want
        pin.leave()
        ep.leave()
    finally:
        plane.stop()
        c.stop()
    assert not c.faults(), c.faults()
